"""Shared cases of the additive Schwarz parity tests
(``test_torch_schwarz_{f64,f32}.py``): ``AdditiveSchwarz`` in each mode, its
ILU(0) factors on K6's one-direction triangular solves, CG and SA-AMG with
Schwarz level smoothers, the PyTorch port on the CPU (kernel K6's plain
version) against the JAX reference on the CPU with Pallas off (its XLA
twin of the wave sweep), from bit-equal gallery triplets and right-hand
sides made with numpy from a seed.

The reference's float32 runs with JAX's x64 mode off, as on its TPU.
"""
import contextlib
import importlib
from math import prod

import jax
import numpy as np
import torch
import torch_amg_cases

from partitionedarrays_tpu.backends import SerialBackend as JaxSerialBackend
from partitionedarrays_tpu.models import gallery as jax_gallery
from partitionedarrays_tpu.parallel.p_range import PRange as JaxPRange
from partitionedarrays_tpu.solvers import krylov as jax_krylov
from partitionedarrays_tpu.solvers import smoothers as jax_smoothers
from partitionedarrays_tpu.solvers.amg import AMGParams as JaxAMGParams
from partitionedarrays_tpu.solvers.amg import AMGPreconditioner as JaxAMG

from partitionedarrays_tpu_torch.backends import SerialBackend
from partitionedarrays_tpu_torch.models import gallery
from partitionedarrays_tpu_torch.psparse import psparse, spmv
from partitionedarrays_tpu_torch.pvector import pvector_from_own
from partitionedarrays_tpu_torch.solvers import krylov
from partitionedarrays_tpu_torch.solvers.amg import AMGParams, AMGPreconditioner
from partitionedarrays_tpu_torch.solvers.smoothers import AdditiveSchwarz

jax_psparse = importlib.import_module("partitionedarrays_tpu.psparse")
jax_pvector = importlib.import_module("partitionedarrays_tpu.pvector")

# a Schwarz application, a V-cycle, relative to the largest reference entry:
# the same operations in another order (LAPACK's LU solves, the sweeps' and
# products' sums)
RTOL = {np.float32: 1e-5, np.float64: 1e-12}
# the 2-D FEM Laplacian on (4,1) parts: 576 rows (5 tiles) a part, whose
# ILU(0) factors take W >= 3 waves (the reference's guard,
# tests/test_solvers.py:163-195)
FEM_TRI = ("laplacian_fem", (48, 48), (4, 1))
# the 16 x 16 FDM Laplacian on (2,2) parts (tests/test_solvers.py:197-222)
FDM_CG = ("laplacian_fdm", (16, 16), (2, 2))
# AMG with Schwarz level smoothers: the 2-D FDM of tests/test_amg.py:259-285
# (dense tier on every level), the 40 x 40 FDM on one part (1,600 rows: the
# ilu0 tier on level 0, dense below) and the 8^3 box Laplacian (box
# aggregation: the level keeps no struct and applies P as a matrix)
AMG_CASES = {
    "fdm2d_parts": (("laplacian_fdm", (16, 16), (2, 2)), dict(coarse_size=20)),
    "fdm2d_ilu0": (("laplacian_fdm", (40, 40), (1, 1)), dict(coarse_size=20)),
    "box3d": (("laplacian_fdm", (8, 8, 8), (1, 1, 1)), dict(coarse_size=10)),
}


def reference_mode(dtype):
    """x64 off for float32 (the reference's TPU semantics)."""
    return jax.enable_x64(False) if dtype == np.float32 else contextlib.nullcontext()


def pair(case, dtype, **kw):
    """The port's and the reference's matrix of ``case`` (gallery name,
    nodes, parts), from the same triplets."""
    name, nodes, parts = case
    P = prod(parts)
    I, J, V, rows, cols = getattr(gallery, name)(nodes, parts, dtype=dtype)
    A = psparse(I, J, V, rows, cols, SerialBackend(P), device="cpu", **kw)
    I, J, V, rows, cols = getattr(jax_gallery, name)(nodes, parts, dtype=dtype)
    A_ref = jax_psparse.psparse(I, J, V, JaxPRange(rows), JaxPRange(cols),
                                JaxSerialBackend(P), **kw)
    return A, A_ref


def scaled(case, dtype, factor):
    """``pair`` of the case's operator times ``factor`` (new values, the
    same sparsity)."""
    name, nodes, parts = case
    P = prod(parts)
    out = []
    for gal, make in ((gallery, lambda *t: psparse(*t, SerialBackend(P), device="cpu")),
                      (jax_gallery, lambda I, J, V, r, c: jax_psparse.psparse(
                          I, J, V, JaxPRange(r), JaxPRange(c), JaxSerialBackend(P)))):
        I, J, V, rows, cols = getattr(gal, name)(nodes, parts, dtype=dtype)
        out.append(make(I, J, [(factor * v).astype(dtype) for v in V], rows, cols))
    return tuple(out)


def vectors(A, A_ref, dtype, seed):
    """A random vector on A's rows in both packages."""
    rng = np.random.default_rng(seed)
    own = [rng.standard_normal(li.n_own).astype(dtype) for li in A.row_prange.parts]
    return (pvector_from_own(own, A.row_prange, A.backend, device="cpu"),
            jax_pvector.pvector_from_own(own, A_ref.row_prange, A_ref.backend))


def own(v, A):
    """The own values of a vector of either package as one host array in
    part order."""
    o = v.own.numpy() if isinstance(v.own, torch.Tensor) else np.asarray(v.own)
    return np.concatenate([o[p, : li.n_own] for p, li in enumerate(A.row_prange.parts)])


def assert_close(got, want, rtol):
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), (err, np.abs(want).max())


def schwarz_pair(A, A_ref, **kw):
    return AdditiveSchwarz(A, **kw), jax_smoothers.AdditiveSchwarz(A_ref, **kw)


def cg_iterations(A, A_ref, M, M_ref, b, b_ref, rtol, maxiter=300):
    """CG to ``rtol`` with both packages: (port x, its iterations), (the
    reference's)."""
    x, info = krylov.cg(A, b, M=M, rtol=rtol, maxiter=maxiter)
    x_ref, info_ref = jax_krylov.cg(A_ref, b_ref, M=M_ref, rtol=rtol, maxiter=maxiter)
    return (x, int(info.iterations)), (x_ref, int(np.asarray(info_ref.iterations)))


def pcg_iterations(A, A_ref, M, M_ref, b, b_ref, rtol, maxiter=300):
    """Preconditioned CG to ``rtol`` in both packages, step for step as the
    reference's ``_cg_loop``, eagerly (the reference reuses the programs
    its preconditioner compiled): the iteration counts and the residual
    histories."""
    _, h = torch_amg_cases.pcg_history(krylov, A, b, M, rtol, maxiter)
    _, h_ref = torch_amg_cases.pcg_history(jax_krylov, A_ref, b_ref, M_ref, rtol, maxiter)
    return (len(h) - 1, h), (len(h_ref) - 1, h_ref)


def amg_pair(name, dtype):
    """Port and reference AMG with Schwarz level smoothers of the case."""
    case, params = AMG_CASES[name]
    A, A_ref = pair(case, dtype, assembled=True)
    M = AMGPreconditioner(A, AMGParams(smoother="schwarz", **params))
    M_ref = JaxAMG(A_ref, JaxAMGParams(smoother="schwarz", **params))
    return A, A_ref, M, M_ref


def level_tiers(M):
    """Each smoothed level's Schwarz tier."""
    return [lev.smoother.mode for lev in M.levels if lev.smoother is not None]


def rhs(A, A_ref, dtype, seed=3):
    """b = A x for a random x, in both packages."""
    x, x_ref = vectors(A, A_ref, dtype, seed)
    return spmv(A, x), jax_psparse.spmv(A_ref, x_ref)


def check_hierarchy(M, M_ref):
    """The same levels, host operators bit for bit, the same tiers and
    no structured transfer on a Schwarz level."""
    assert M.statistics() == M_ref.statistics()
    assert len(M.levels) == len(M_ref.levels)
    for lev, lev_ref in zip(M.levels, M_ref.levels):
        for b, b_ref in zip(lev.A.blocks, lev_ref.A.blocks):
            a, a_ref = b["oo"].tocsr(), b_ref["oo"].tocsr()
            np.testing.assert_array_equal(a.indptr, a_ref.indptr)
            np.testing.assert_array_equal(a.indices, a_ref.indices)
            np.testing.assert_array_equal(a.data, a_ref.data)
        assert lev.struct is None and lev_ref.struct is None
        if lev.smoother is None:
            assert lev_ref.smoother is None
            continue
        assert isinstance(lev.smoother, AdditiveSchwarz)
        assert lev.smoother.mode == lev_ref.smoother.mode
        if lev.smoother.mode == "ilu0":
            assert lev.smoother.sgsL.schedules == lev_ref.smoother.sgsL.schedules
            assert lev.smoother.sgsU.schedules == lev_ref.smoother.sgsU.schedules
    assert M.coarse_kind == M_ref.coarse_kind


def smoother_operands(S):
    """The device operands of a Schwarz smoother: the dense LU factors and
    pivots, or the two K6 operand sets."""
    if S.mode == "dense":
        return [S.lu, S.piv]
    return [t for tg in (S.sgsL, S.sgsU) for t in tg.operands() + (tg.tile_lanes,)]
