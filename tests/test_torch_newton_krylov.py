"""The matrix-free Newton (``newton_krylov``) of the port against the JAX
package's, float64: F(x) = A x + x^3 - b with A the FDM Laplacian and b =
A x* + x*^3 (the reference's ``tests/test_interfaces.py`` problem), on
(12, 12) over (2, 2) parts and on 8^3 over (2, 2, 2) parts, with the exact
(forward AD) and the finite-difference Jacobian-vector product, without and
with a symmetric Gauss-Seidel preconditioner.  The outer iterations equal
the JAX package's, and x agrees within 1e-10 ("auto") and 1e-6 ("fd").  The
forward derivatives of K1 and K5 (``DeviceBlock.spmv``/``spmv_add``) are
held against a finite difference of their plain products.
"""
import importlib

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import torch.autograd.forward_ad as fwAD
from threadpoolctl import threadpool_limits

from partitionedarrays_tpu import config as jax_config
from partitionedarrays_tpu.backends import SerialBackend as JaxSerialBackend
from partitionedarrays_tpu.parallel.p_range import PRange as JaxPRange

from partitionedarrays_tpu_torch.backends import SerialBackend
from partitionedarrays_tpu_torch.models.gallery import laplacian_fdm
from partitionedarrays_tpu_torch.ops.blocks import freeze_block
from partitionedarrays_tpu_torch.psparse import psparse, spmv
from partitionedarrays_tpu_torch.pvector import PVector, collect, pvector_from_own
from partitionedarrays_tpu_torch.solvers.nonlinear import newton_krylov
from partitionedarrays_tpu_torch.solvers.smoothers import GaussSeidel

jax_ps = importlib.import_module("partitionedarrays_tpu.psparse")
jax_pv = importlib.import_module("partitionedarrays_tpu.pvector")
jax_nl = importlib.import_module("partitionedarrays_tpu.solvers.nonlinear")
jax_sm = importlib.import_module("partitionedarrays_tpu.solvers.smoothers")

jax_config.use_pallas = False

CASES = {"2d": ((12, 12), (2, 2)), "3d": ((8, 8, 8), (2, 2, 2))}
# (rtol, inner_rtol) of the reference's test for each product
SETTINGS = {"auto": (1e-10, 1e-6), "fd": (1e-6, 1e-4)}
X_TOL = {"auto": 1e-10, "fd": 1e-6}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield


def _x_star(parts_of):
    rng = np.random.default_rng(0)
    return [0.3 * rng.standard_normal(li.n_own) for li in parts_of]


def _port_problem(case):
    nodes, parts = CASES[case]
    I, J, V, rows, cols = laplacian_fdm(nodes, parts)
    A = psparse(I, J, V, rows, cols, SerialBackend(int(np.prod(parts))), assembled=True,
                device="cpu")
    pr = A.row_prange
    x_star = pvector_from_own(_x_star(pr.parts), pr, A.backend, device="cpu")
    bv = spmv(A, x_star)
    b = bv.own + x_star.own ** 3

    def residual(x):
        ax = spmv(A, x)
        return PVector(ax.own + x.own ** 3 - b, torch.zeros_like(ax.ghost), ax.layout,
                       ax.backend)

    x0 = pvector_from_own([np.zeros(li.n_own) for li in pr.parts], pr, A.backend, device="cpu")
    return A, residual, x0, x_star


def _jax_problem(case):
    import jax.numpy as jnp

    nodes, parts = CASES[case]
    I, J, V, rows, cols = laplacian_fdm(nodes, parts)
    A = jax_ps.psparse(I, J, V, JaxPRange(rows), JaxPRange(cols),
                       JaxSerialBackend(int(np.prod(parts))), assembled=True)
    pr = A.row_prange
    x_star = jax_pv.pvector_from_own(_x_star(pr.partition()), pr, A.backend, dtype=np.float64)
    bv = jax_ps.spmv(A, x_star)
    b = jax_pv.PVector(bv.own + x_star.own ** 3, bv.ghost, bv.layout, bv.backend)

    def residual(x):
        ax = jax_ps.spmv(A, x)
        return jax_pv.PVector(ax.own + x.own ** 3 - b.own, jnp.zeros_like(ax.ghost),
                              ax.layout, ax.backend)

    x0 = jax_pv.pvector_from_own([np.zeros(li.n_own) for li in pr.partition()], pr, A.backend,
                                 dtype=np.float64)
    return A, residual, x0


@pytest.mark.parametrize("with_m", [False, True], ids=["plain", "gs"])
@pytest.mark.parametrize("jvp", ["auto", "fd"])
@pytest.mark.parametrize("case", list(CASES))
def test_newton_krylov_matches_jax(case, jvp, with_m):
    rtol, inner_rtol = SETTINGS[jvp]
    kw = dict(rtol=rtol, maxiters=30, inner_rtol=inner_rtol, inner_maxiter=300, jvp=jvp)
    A, residual, x0, x_star = _port_problem(case)
    M = GaussSeidel(A, 1, "symmetric") if with_m else None
    x, iters, rn = newton_krylov(residual, x0, M=M, **kw)
    Aj, residual_j, x0_j = _jax_problem(case)
    Mj = jax_sm.GaussSeidel(Aj, 1, "symmetric") if with_m else None
    xj, iters_j, rn_j = jax_nl.newton_krylov(residual_j, x0_j, M=Mj, **kw)
    assert iters.dim() == 0 and rn.dim() == 0
    assert int(iters) == int(iters_j) <= 12
    xg, xg_j = collect(x), np.asarray(jax_pv.collect(xj))
    np.testing.assert_allclose(xg, xg_j, rtol=0, atol=X_TOL[jvp])
    # the reference's own limits against the known solution
    assert np.abs(xg - collect(x_star)).max() < (1e-6 if jvp == "auto" else 1e-3)
    rn0 = float(torch.sqrt((residual(x0).own ** 2).sum()))
    assert float(rn) <= rtol * rn0


def test_newton_krylov_rejects_an_unknown_product():
    A, residual, x0, _ = _port_problem("2d")
    with pytest.raises(ValueError, match="jvp"):
        newton_krylov(residual, x0, jvp="reverse")


def _blocks(kind):
    """Per-part host blocks that freeze as DIA (K1) or compressed rows (K5)."""
    rng = np.random.default_rng(3)
    if kind == "dia":
        mats = [sp.diags([rng.standard_normal(40 - abs(o)) for o in (-3, 0, 2)], (-3, 0, 2),
                         shape=(40, 40), format="csr") for _ in range(2)]
        return mats, 40, 40
    mats = [sp.random(40, 24, 0.15, random_state=k, format="csr") for k in range(2)]
    return mats, 40, 24


@pytest.mark.parametrize("kind", ["dia", "ell"])
def test_block_products_tangent_is_the_product_of_the_tangent(kind):
    """The forward derivative of ``spmv`` and ``spmv_add`` equals a central
    difference of the plain products (exact up to rounding: they are
    linear in x), and forward AD through the block keeps the primal."""
    mats, n_rows, n_cols = _blocks(kind)
    block = freeze_block(mats, n_rows, n_cols, device="cpu", dtype=torch.float64)
    assert block.kind == kind
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.standard_normal((2, n_cols)))
    v = torch.tensor(rng.standard_normal((2, n_cols)))
    y = torch.tensor(rng.standard_normal((2, n_rows)))
    w = torch.tensor(rng.standard_normal((2, n_rows)))
    h = 1e-3
    fd = (block.spmv(x + h * v) - block.spmv(x - h * v)) / (2 * h)
    with fwAD.dual_level():
        out = block.spmv(fwAD.make_dual(x, v))
        primal, tangent = fwAD.unpack_dual(out)
        out2 = block.spmv_add(fwAD.make_dual(x, v), fwAD.make_dual(y.clone(), w.clone()))
        primal2, tangent2 = fwAD.unpack_dual(out2)
    np.testing.assert_allclose(primal.numpy(), block.spmv(x).numpy(), rtol=0, atol=0)
    np.testing.assert_allclose(tangent.numpy(), fd.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(primal2.numpy(), (y + block.spmv(x)).numpy(), rtol=0, atol=1e-14)
    np.testing.assert_allclose(tangent2.numpy(), (w + fd).numpy(), rtol=0, atol=1e-12)
