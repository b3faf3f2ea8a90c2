"""The JAX package's own ``b_cg`` iteration counts for ``chip_smoke.py``
phase 4k ``block_cg``, on the CPU with Pallas off (the float32 run with
JAX's x64 mode off, its TPU semantics):

    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/block_cg_jax_counts.py 64

The coupled two-field system, for each dtype: the 2 x 2 ``BMatrix``
[[A, C], [C, S]] with A = ``plaplacian_fdm((n, n, n), (2, 2, 2))``, S the
same operator shifted by 0.5 I (its centre value 6 (n+1)^3 + 0.5, through
``stencil_psparse``) and C = 0.1 I on A's rows (``sparse_diag_matrix``);
b = G x* in float64 on the host (G the global block matrix, x* from
``default_rng(14).standard_normal(2 n^3)``), rounded to the dtype; CG to
rtol 1e-8 (maxiter 3000).  Prints the iterations, the recurrence's and the
true relative residual (float64 product of the blocks) and the seconds.
This script runs the JAX package only; the port never imports it.
"""
import contextlib
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import scipy.sparse as sp  # noqa: E402

from partitionedarrays_tpu import config  # noqa: E402
from partitionedarrays_tpu.backends import SerialBackend  # noqa: E402
from partitionedarrays_tpu.block_arrays import BMatrix, BVector, b_cg  # noqa: E402
from partitionedarrays_tpu.ops.stencil import stencil_psparse  # noqa: E402
from partitionedarrays_tpu.psparse import sparse_diag_matrix, to_global_scipy  # noqa: E402
from partitionedarrays_tpu.pvector import collect, pfill, pvector_from_own  # noqa: E402

PARTS = (2, 2, 2)
SHIFT, COUPLING, SEED, RTOL, MAXITER = 0.5, 0.1, 14, 1e-8, 3000


def stencil(n: int, shift: float):
    alpha = float((n + 1) ** 3)
    out = [((0, 0, 0), 6 * alpha + shift)]
    for d in range(3):
        for step in (-1, 1):
            out.append((tuple(step if k == d else 0 for k in range(3)), -alpha))
    return out


def main(n: int) -> None:
    config.use_pallas = False
    for dtype in (np.float64, np.float32):
        mode = jax.enable_x64(False) if dtype == np.float32 else contextlib.nullcontext()
        with mode:
            t0 = time.time()
            backend = SerialBackend(8)
            A = stencil_psparse(PARTS, (n, n, n), stencil(n, 0.0), backend, dtype=dtype)
            S = stencil_psparse(PARTS, (n, n, n), stencil(n, SHIFT), backend, dtype=dtype)
            C = sparse_diag_matrix(pfill(COUPLING, A.row_prange, backend, dtype))
            M = BMatrix([[A, C], [C, S]])
            G = sp.bmat([[to_global_scipy(B).astype(np.float64) for B in row]
                         for row in M.blocks]).tocsr()
            N = A.shape[0]
            xs = np.random.default_rng(SEED).standard_normal(2 * N)
            bg = G @ xs
            parts = A.row_prange.partition()
            b = BVector([pvector_from_own([bg[k * N + li.own_to_global].astype(dtype)
                                           for li in parts], A.row_prange, backend)
                         for k in range(2)])
            x, iters, relres = b_cg(M, b, rtol=RTOL, maxiter=MAXITER)
            xg = np.concatenate([collect(xb) for xb in x.blocks]).astype(np.float64)
            bh = np.concatenate([collect(bb) for bb in b.blocks]).astype(np.float64)
            true = float(np.linalg.norm(bh - G @ xg) / np.linalg.norm(bh))
            print(dtype.__name__, f"n={n}", "iterations", iters, "relres", relres,
                  "true relres", true, "seconds", round(time.time() - t0, 1), flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 64)
