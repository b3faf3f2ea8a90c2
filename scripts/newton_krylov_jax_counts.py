"""The JAX package's own ``newton_krylov`` counts for ``chip_smoke.py``
phase 4l, on the CPU with Pallas off, in float64:

    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/newton_krylov_jax_counts.py 64

The reference's test problem (``tests/test_interfaces.py:409-455``) at
``n^3`` nodes: F(x) = A x + x^3 - b with A = ``plaplacian_fdm((n, n, n),
(2, 2, 2))``, x* = 0.3 N(0, 1) drawn part by part from
``default_rng(0)`` (each part's own values in part order) and b = A x* +
x*^3; x0 = 0.  For the exact product (``jvp="auto"``: rtol 1e-10, inner
rtol 1e-6) and the finite-difference one (``"fd"``: rtol 1e-6, inner rtol
1e-4), each without a preconditioner and with ``GaussSeidel(A, 1,
"symmetric")`` (30 outer and 300 inner steps at most), prints the outer
iterations, |F(x)|, max |x - x*| and the seconds.  This script runs the
JAX package only; the port never imports it.
"""
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from partitionedarrays_tpu import config  # noqa: E402
from partitionedarrays_tpu.backends import SerialBackend  # noqa: E402
from partitionedarrays_tpu.models.gallery import plaplacian_fdm  # noqa: E402
from partitionedarrays_tpu.psparse import spmv  # noqa: E402
from partitionedarrays_tpu.pvector import PVector, collect, pvector_from_own  # noqa: E402
from partitionedarrays_tpu.solvers.nonlinear import newton_krylov  # noqa: E402
from partitionedarrays_tpu.solvers.smoothers import GaussSeidel  # noqa: E402

PARTS = (2, 2, 2)
SEED = 0
# (rtol, inner_rtol) of the reference's test for each product
SETTINGS = {"auto": (1e-10, 1e-6), "fd": (1e-6, 1e-4)}


def main(n: int) -> None:
    config.use_pallas = False
    backend = SerialBackend(8)
    A = plaplacian_fdm((n, n, n), PARTS, backend, dtype=np.float64)
    parts = A.row_prange.partition()
    rng = np.random.default_rng(SEED)
    x_star = pvector_from_own([0.3 * rng.standard_normal(li.n_own) for li in parts],
                              A.row_prange, backend, dtype=np.float64)
    ax = spmv(A, x_star)
    b = ax.own + x_star.own ** 3

    def residual(x):
        ax = spmv(A, x)
        return PVector(ax.own + x.own ** 3 - b, jnp.zeros_like(ax.ghost), ax.layout, ax.backend)

    x0 = pvector_from_own([np.zeros(li.n_own) for li in parts], A.row_prange, backend,
                          dtype=np.float64)
    xs = collect(x_star)
    for jvp, (rtol, inner_rtol) in SETTINGS.items():
        for name, M in (("none", None), ("gs", GaussSeidel(A, 1, "symmetric"))):
            t0 = time.time()
            x, iters, rn = newton_krylov(residual, x0, M=M, rtol=rtol, maxiters=30,
                                         inner_rtol=inner_rtol, inner_maxiter=300, jvp=jvp)
            err = float(np.abs(collect(x) - xs).max())
            print(f"n={n} jvp={jvp} M={name} iterations {int(iters)} rn {float(rn)!r} "
                  f"err {err!r} seconds {time.time() - t0:.1f}", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 64)
