"""The JAX package's own CG iteration counts for ``chip_smoke.py`` phase 4j,
on the CPU with Pallas off (the float32 runs with JAX's x64 mode off, its
TPU semantics):

    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/unequal_parts_jax_counts.py 65

For each dtype: ``plaplacian_fdm((n, n, n), (2, 2, 2))`` (part boxes of
unequal shape when the parts do not divide n), the AMG of
``AMGParams(coarse_size=200)`` (the box aggregation must decline), CG to
rtol 1e-8 on ones in the first 10 own entries of part 0
(``amg_unequal_parts``); then ``repartition_system`` onto eight contiguous
blocks of ids, the AMG set up again and CG (``repartitioned``).  Prints the
offsets, rows per part, levels, iterations and the true residual.  This
script runs the JAX package only; the port never imports it.
"""
import contextlib
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

from partitionedarrays_tpu import config  # noqa: E402
from partitionedarrays_tpu.backends import SerialBackend  # noqa: E402
from partitionedarrays_tpu.models.gallery import plaplacian_fdm  # noqa: E402
from partitionedarrays_tpu.parallel.p_range import (  # noqa: E402
    PRange, local_range, variable_partition,
)
from partitionedarrays_tpu.psparse import repartition_system, to_global_scipy  # noqa: E402
from partitionedarrays_tpu.pvector import collect, pvector_from_own  # noqa: E402
from partitionedarrays_tpu.solvers.amg import (  # noqa: E402
    AMGParams, AMGPreconditioner, box_aggregate_psparse,
)
from partitionedarrays_tpu.solvers.krylov import cg  # noqa: E402


def true_relres(A, x, b) -> float:
    G = to_global_scipy(A).astype(np.float64)
    bg, xg = collect(b).astype(np.float64), collect(x).astype(np.float64)
    return float(np.linalg.norm(bg - G @ xg) / np.linalg.norm(bg))


def main(n: int) -> None:
    config.use_pallas = False
    for dtype in (np.float64, np.float32):
        mode = jax.enable_x64(False) if dtype == np.float32 else contextlib.nullcontext()
        with mode:
            t0 = time.time()
            A = plaplacian_fdm((n, n, n), (2, 2, 2), SerialBackend(8), dtype=dtype)
            parts = A.row_prange.partition()
            print(dtype.__name__, "offsets", A.device().oo.offsets, "rows per part",
                  [li.n_own for li in parts], flush=True)
            assert box_aggregate_psparse(A) is None
            own = [np.zeros(li.n_own, dtype=dtype) for li in parts]
            own[0][:10] = 1.0
            b = pvector_from_own(own, A.row_prange, A.backend)
            for key in ("amg_unequal_parts", "repartitioned"):
                if key == "repartitioned":
                    N = A.shape[0]
                    sizes = [len(local_range(p, 8, N)) for p in range(8)]
                    A, b = repartition_system(A, b, PRange(variable_partition(sizes)))
                M = AMGPreconditioner(A, AMGParams(coarse_size=200))
                x, info = cg(A, b, M=M, rtol=1e-8, maxiter=200)
                print(dtype.__name__, key, "levels", [lev.A.shape[0] for lev in M.levels],
                      "iterations", int(info.iterations), "true relres", true_relres(A, x, b),
                      "seconds", round(time.time() - t0, 1), flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 65)
