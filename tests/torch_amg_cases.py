"""Shared cases of the elasticity SA-AMG parity tests
(``test_torch_amg_elasticity_{f32,f64,2d}.py``, ``test_torch_amg_host.py``):
Q1 linear elasticity on one part with the rigid-body nullspace, built by
both packages from their (bit-equal) galleries, the port on the CPU (plain
kernel versions) and the JAX reference on the CPU with Pallas off.

- The hierarchy (host setup): aggregates, omega, P and every coarse
  operator are the same numpy/scipy operations in both packages, so they
  are held equal bit for bit (omega to 1e-12), with the same smoother
  tiers and coarse solve.
- One V-cycle and the preconditioned CG: the device cycle, held to the
  dtype's tolerance.  The reference's jitted CG returns no history (and
  would compile the whole cycle once more), so both packages run the same
  eager PCG loop (``pcg_history``, the reference's ``_cg_loop`` step for
  step) on their own operators, preconditioners and reductions, the
  reference reusing the programs its first V-cycle compiled.

The reference's float32 hierarchy keeps float64 prolongators on the host
(the nullspace is float64) and runs float32 on its TPU, which has no
float64.  The tests run it the same way, with JAX's x64 mode off; the port
freezes those levels in float32 (``PSparseMatrix.device_dtype``).
"""
import contextlib
import importlib

import jax
import numpy as np
import torch

from partitionedarrays_tpu.backends import SerialBackend as JaxSerialBackend
from partitionedarrays_tpu.models import gallery as jax_gallery
from partitionedarrays_tpu.parallel.p_range import PRange as JaxPRange
from partitionedarrays_tpu.solvers import krylov as jax_krylov
from partitionedarrays_tpu.solvers.amg import AMGParams as JaxAMGParams
from partitionedarrays_tpu.solvers.amg import AMGPreconditioner as JaxAMG

from partitionedarrays_tpu_torch.backends import SerialBackend
from partitionedarrays_tpu_torch.models import gallery
from partitionedarrays_tpu_torch.psparse import psparse
from partitionedarrays_tpu_torch.pvector import pvector_from_own
from partitionedarrays_tpu_torch.solvers import krylov
from partitionedarrays_tpu_torch.solvers.amg import AMGParams, AMGPreconditioner

jax_psparse = importlib.import_module("partitionedarrays_tpu.psparse")
jax_pvector = importlib.import_module("partitionedarrays_tpu.pvector")

# 7^3 nodes (1,029 rows): the fine level is the 99-diagonal DIA band
# (colored tier, m = 27), level 1 the 162-row Galerkin operator (tile tier,
# 2 tiles), level 2 the 6-row coarse inverse
CASE_3D = ((7, 7, 7), dict(coarse_size=30, block_size=3, max_levels=4))
# 12 x 12 nodes, block size 2 (3 rigid-body modes): 288 -> 48 -> 9 rows
CASE_2D = ((12, 12), dict(coarse_size=20, block_size=2, max_levels=4))
RTOL_CG = 1e-8
MAXITER = 200


def reference_mode(dtype):
    """The context the reference runs in: x64 off for float32 (its TPU
    semantics), on (the test session's setting) for float64."""
    return jax.enable_x64(False) if dtype == np.float32 else contextlib.nullcontext()


def build(case, dtype, seed=5):
    """Port and reference AMG preconditioners for the case, and one rhs
    made with numpy: ((A, M, b), (A_ref, M_ref, b_ref))."""
    nodes, params = case
    parts = (1,) * len(nodes)
    out = []
    for gal, make_A, make_M, Params, make_b in (
        (gallery, lambda I, J, V, r, c: psparse(I, J, V, r, c, SerialBackend(1), device="cpu"),
         AMGPreconditioner, AMGParams,
         lambda own, A: pvector_from_own(own, A.row_prange, A.backend, device="cpu")),
        (jax_gallery,
         lambda I, J, V, r, c: jax_psparse.psparse(I, J, V, JaxPRange(r), JaxPRange(c), JaxSerialBackend(1)),
         JaxAMG, JaxAMGParams,
         lambda own, A: jax_pvector.pvector_from_own(own, A.row_prange, A.backend)),
    ):
        I, J, V, rows, cols = gal.linear_elasticity_fem(nodes, parts, dtype=dtype)
        A = make_A(I, J, V, rows, cols)
        coords, _ = gal.node_coordinates_unit_cube(nodes, parts)
        ns = gal.nullspace_linear_elasticity(coords, A.row_prange)
        M = make_M(A, Params(**params), nullspace=ns)
        own = [np.random.default_rng(seed).standard_normal(A.shape[0]).astype(dtype)]
        out.append((A, M, make_b(own, A)))
    return out


def _same_csr(a, b):
    a, b = a.tocsr(), b.tocsr()
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.data, b.data)


def check_hierarchy(M, M_ref):
    assert M.statistics() == M_ref.statistics()
    assert len(M.levels) == len(M_ref.levels) >= 3
    for l, (lev, lev_ref) in enumerate(zip(M.levels, M_ref.levels)):
        _same_csr(lev.A.blocks[0]["oo"], lev_ref.A.blocks[0]["oo"])
        if lev.P is None:
            assert lev_ref.P is None
            continue
        aggs, coarse = M.aggregates[l]
        aggs_ref, coarse_ref, struct = M_ref._aggs[l]
        assert struct is None
        np.testing.assert_array_equal(aggs[0], aggs_ref[0])
        assert coarse.n_global == coarse_ref.n_global
        omega_ref = M_ref._galerkin[l].omega
        assert abs(M.omegas[l] - omega_ref) <= 1e-12 * abs(omega_ref)
        _same_csr(lev.P.blocks[0]["oo"], lev_ref.P.blocks[0]["oo"])
        gs, gs_ref = lev.smoother, lev_ref.smoother
        assert (gs.colored is None) == (gs_ref.colored is None)
        assert (gs.tile_gs is None) == (gs_ref.slot_gs is None)
        assert gs.n_colors == gs_ref.n_colors
        if gs.tile_gs is not None:
            assert gs.tile_gs.schedules == gs_ref.slot_gs.schedules
    assert M.coarse_kind == M_ref.coarse_kind


def tiers(M):
    """The smoother tier of each level: "colored", "tile" or None."""
    return [
        None if lev.smoother is None else ("colored" if lev.smoother.colored is not None else "tile")
        for lev in M.levels
    ]


def pcg_history(K, A, b, M, rtol=RTOL_CG, maxiter=MAXITER):
    """Preconditioned CG step for step as the reference's ``_cg_loop``,
    eagerly, with the Krylov module ``K`` of either package (the same
    helper names): returns (x, the residual norms |r_k|)."""
    x = K.PVector(b.own * 0, b.ghost * 0, b.layout, b.backend)
    r = K._residual(A, b, x)
    z = M(r)
    p = z
    rz = K.pdot(r, z)
    norms = [float(K.pnorm(r))]
    tol = rtol * norms[0]
    while len(norms) - 1 < maxiter and norms[-1] > tol:
        Ap = K._as_row_vector(A, K.spmv(A, K._as_col_vector(A, p)))
        alpha = rz / K.pdot(p, Ap)
        x = K.axpy(alpha, p, x)
        r = K.axpy(-alpha, Ap, r)
        z = M(r)
        rz_new = K.pdot(r, z)
        p = K._combine(z, rz_new / rz, p)
        rz = rz_new
        norms.append(float(K.pnorm(r)))
    return x, np.array(norms)


def histories(port, ref):
    (A, M, b), (A_ref, M_ref, b_ref) = port, ref
    x, h = pcg_history(krylov, A, b, M)
    x_ref, h_ref = pcg_history(jax_krylov, A_ref, b_ref, M_ref)
    return (x, h), (x_ref, h_ref)


def own(v, n):
    o = v.own
    return (o.numpy() if isinstance(o, torch.Tensor) else np.asarray(o))[0, :n]
