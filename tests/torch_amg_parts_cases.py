"""Shared cases of the SA-AMG parity tests across parts
(``test_torch_amg_parts_{f64,f32}.py``): the port on the CPU (plain kernel
versions) against the JAX reference on the CPU with Pallas off, both built
from their (bit-equal) galleries on the serial backend.

- ``2d``: 2-D Q1 elasticity with the rigid-body nullspace on (2,2) parts
  (the reference's test_amg_elasticity_with_nullspace, at 12 x 12 nodes:
  288 -> 48 -> 12 rows, colored levels): the generic cycle.
- ``3d``: 3-D Q1 elasticity with the rigid-body nullspace on (2,2,2) parts
  at 7^3 nodes, parts of 3 or 4 nodes per direction, two levels (1,029 ->
  162 rows): the fine level on the tile tier with P = 8 parts of unequal
  size (K6; the parts' bands differ, so the own block is compressed rows),
  the coarse inverse gathered from parts of unequal size.  (A third level
  would smooth the 162 rows with a 48-color sweep, which the reference
  compiles for about a minute and a half.)
- ``box``: the 7-point ``laplacian_fdm`` on (2,2,2) parts at 18^3 (5,832
  -> 216 -> 8 rows): 3x3x3 box aggregation on every part and the ghosted
  flat cycle on both smoothed levels.

The host setup (aggregation per part, the power method with its host
exchanges, the distributed Galerkin products) is the same numpy/scipy work
in the same order in both packages, so every level's blocks, ghosts and
aggregates are held equal bit for bit and omega to 1e-12.  The cycles and
the CG are device work, held to the dtype's tolerance.  The reference's
float32 AMG runs with JAX's x64 mode off (``torch_amg_cases.
reference_mode``).
"""
import importlib

import numpy as np

from partitionedarrays_tpu.backends import SerialBackend as JaxSerialBackend
from partitionedarrays_tpu.models import gallery as jax_gallery
from partitionedarrays_tpu.parallel.p_range import PRange as JaxPRange
from partitionedarrays_tpu.solvers import amg as jax_amg
from partitionedarrays_tpu.solvers import krylov as jax_krylov

from partitionedarrays_tpu_torch import convert
from partitionedarrays_tpu_torch.backends import SerialBackend
from partitionedarrays_tpu_torch.models import gallery
from partitionedarrays_tpu_torch.psparse import host_blocks, psparse, spmv, to_global_scipy
from partitionedarrays_tpu_torch.pvector import collect, pvector_from_own
from partitionedarrays_tpu_torch.solvers import amg, krylov

import torch_amg_cases

jax_psparse = importlib.import_module("partitionedarrays_tpu.psparse")
jax_pvector = importlib.import_module("partitionedarrays_tpu.pvector")

# name -> (generator, nodes, parts, AMGParams, whether a rigid-body nullspace)
CASES = {
    "2d": ("linear_elasticity_fem", (12, 12), (2, 2), dict(coarse_size=30, block_size=2), True),
    "3d": ("linear_elasticity_fem", (7, 7, 7), (2, 2, 2),
           dict(coarse_size=30, block_size=3, max_levels=2), True),
    "box": ("laplacian_fdm", (18, 18, 18), (2, 2, 2), dict(coarse_size=20), False),
}
RTOL_CG = 1e-8
# one cycle, relative to the largest reference entry
CYCLE_ATOL = {np.float64: 1e-10, np.float32: 1e-5}
# the float32 CG histories: compared while the relres is above 1e-5
F32_HISTORY = (1e-3, 1e-5)


def build(name, dtype, seed=11):
    """((A, M, b), (A_ref, M_ref, b_ref)) with a rhs made with numpy."""
    gen, nodes, parts, params, with_ns = CASES[name]
    P = int(np.prod(parts))
    kw = dict(assembled=True) if gen == "laplacian_fdm" else {}
    out = []
    for gal, make_A, make_M, Params, make_b in (
        (gallery, lambda I, J, V, r, c: psparse(I, J, V, r, c, SerialBackend(P), device="cpu", **kw),
         amg.AMGPreconditioner, amg.AMGParams,
         lambda own, A: pvector_from_own(own, A.row_prange, A.backend, device="cpu")),
        (jax_gallery,
         lambda I, J, V, r, c: jax_psparse.psparse(I, J, V, JaxPRange(r), JaxPRange(c),
                                                   JaxSerialBackend(P), **kw),
         jax_amg.AMGPreconditioner, jax_amg.AMGParams,
         lambda own, A: jax_pvector.pvector_from_own(own, A.row_prange, A.backend)),
    ):
        I, J, V, rows, cols = getattr(gal, gen)(nodes, parts, dtype=dtype)
        A = make_A(I, J, V, rows, cols)
        ns = None
        if with_ns:
            coords, _ = gal.node_coordinates_unit_cube(nodes, parts)
            ns = gal.nullspace_linear_elasticity(coords, A.row_prange)
        M = make_M(A, Params(**params), nullspace=ns)
        rng = np.random.default_rng(seed)
        own = [rng.standard_normal(li.n_own).astype(dtype) for li in _parts(A.row_prange)]
        out.append((A, M, make_b(own, A)))
    return out


def _parts(pr):
    return pr.parts if hasattr(pr, "parts") else pr.partition()


def same_matrix(A, A_ref):
    """Every part's ghost ids and owners and every host block, bit for bit."""
    for pr, pr_ref in ((A.row_prange, A_ref.row_prange), (A.col_prange, A_ref.col_prange)):
        for li, li_ref in zip(pr.parts, pr_ref.partition()):
            np.testing.assert_array_equal(li.own_to_global, li_ref.own_to_global)
            np.testing.assert_array_equal(li.ghost_to_global, li_ref.ghost_to_global)
            np.testing.assert_array_equal(li.ghost_to_owner, li_ref.ghost_to_owner)
    for b, b_ref in zip(host_blocks(A), A_ref.blocks):
        for k in ("oo", "oh"):
            torch_amg_cases._same_csr(b[k], b_ref[k])


def check_hierarchy(M, M_ref):
    """Rows and nnz per level, every level's operator and P bit for bit,
    the aggregates of every part, omega, the box transfers, the smoother
    tier of each level (and K6's schedule per part), the cycle's branch and
    the coarse solve's kind."""
    assert M.statistics() == M_ref.statistics()
    assert len(M.levels) == len(M_ref.levels) >= 2
    for l, (lev, lev_ref) in enumerate(zip(M.levels, M_ref.levels)):
        same_matrix(lev.A, lev_ref.A)
        if lev.P is None:
            assert lev_ref.P is None
            continue
        same_matrix(lev.P, lev_ref.P)
        aggs, coarse = M.aggregates[l]
        aggs_ref, coarse_ref, shapes_ref = M_ref._aggs[l]
        assert len(aggs) == len(aggs_ref) == lev.A.row_prange.n_parts
        for a, a_ref in zip(aggs, aggs_ref):
            np.testing.assert_array_equal(a, a_ref)
        assert [li.n_own for li in coarse.parts] == [li.n_own for li in coarse_ref.partition()]
        omega_ref = M_ref._galerkin[l].omega
        assert abs(M.omegas[l] - omega_ref) <= 1e-12 * abs(omega_ref)
        assert (lev.struct is None) == (lev_ref.struct is None) == (shapes_ref is None)
        if lev.struct is not None:
            assert (lev.struct.fine, lev.struct.coarse) == tuple(lev_ref.struct[:2]) == shapes_ref
            assert lev.struct.omega == M.omegas[l]
            np.testing.assert_array_equal(lev.struct.dinv.numpy(), np.asarray(lev_ref.struct[3]))
        gs, gs_ref = lev.smoother, lev_ref.smoother
        assert (gs.colored is None) == (gs_ref.colored is None)
        assert (gs.tile_gs is None) == (gs_ref.slot_gs is None)
        assert gs.n_colors == gs_ref.n_colors
        if gs.tile_gs is not None:
            assert gs.tile_gs.schedules == gs_ref.slot_gs.schedules
            assert (gs.tile_gs.W, gs.tile_gs.B) == (gs_ref.slot_gs.W, gs_ref.slot_gs.B)
        assert M._flat_ok(l) == M_ref._flat_ok(l)
    assert M.coarse_kind == M_ref.coarse_kind


def tiers(M):
    return torch_amg_cases.tiers(M)


def host_part(li):
    """A reference part as ``convert.psparse_from_host_blocks`` takes it."""
    return dict(n_global=li.n_global, own_to_global=li.own_to_global,
                ghost_to_global=li.ghost_to_global, ghost_to_owner=li.ghost_to_owner)


def converted(A_ref, dtype):
    """The reference's matrix carried across by ``convert.py``."""
    return convert.psparse_from_host_blocks(
        [{k: b[k] for k in ("oo", "oh")} for b in A_ref.blocks],
        [host_part(li) for li in A_ref.row_prange.partition()],
        [host_part(li) for li in A_ref.col_prange.partition()],
        device="cpu", device_dtype=dtype,
    )


def level_vectors(lev, lev_ref, dtype, seed):
    rng = np.random.default_rng(seed)
    own = [rng.standard_normal(li.n_own).astype(dtype) for li in lev.A.row_prange.parts]
    return (pvector_from_own(own, lev.A.row_prange, lev.A.backend, device="cpu"),
            jax_pvector.pvector_from_own(own, lev_ref.A.row_prange, lev_ref.A.backend))


def check_levels(M, M_ref, dtype, w=False, cycle_levels=None):
    """Level by level: the reference's level operator through ``convert``
    equals the port's own and applies as the reference's; then one cycle
    from that level (a W-cycle with ``w``) on the same rhs agrees, on the
    levels ``cycle_levels`` (default: all)."""
    atol = CYCLE_ATOL[dtype]
    for l, (lev, lev_ref) in enumerate(zip(M.levels, M_ref.levels)):
        A_c = converted(lev_ref.A, dtype)
        same_matrix(A_c, lev_ref.A)
        torch_amg_cases._same_csr(to_global_scipy(A_c), to_global_scipy(lev.A))
        b, b_ref = level_vectors(lev, lev_ref, dtype, seed=20 + l)
        x_c = spmv(A_c, _col(A_c, b))
        want = collect(spmv(lev.A, _col(lev.A, b)))
        np.testing.assert_allclose(collect(x_c), want, rtol=0, atol=atol * np.abs(want).max())
        if cycle_levels is not None and l not in cycle_levels:
            continue
        z = collect(M._cycle(l, b, w))
        z_ref = jax_pvector.collect(M_ref._cycle(l, b_ref, w))
        np.testing.assert_allclose(z, z_ref, rtol=0, atol=atol * np.abs(z_ref).max())


def _col(A, v):
    return amg._col_view(A, v)


def histories(port, ref, cycle=None):
    """The PCG residual histories of both packages (the reference's
    ``_cg_loop`` step for step, eagerly); ``cycle``: "w" applies a W-cycle
    through the V-cycle hierarchy."""
    (A, M, b), (A_ref, M_ref, b_ref) = port, ref
    if cycle == "w":
        M_run = lambda r: M._cycle(0, r, True)
        M_ref_run = lambda r: M_ref._cycle(0, r, True)
    else:
        M_run, M_ref_run = M, M_ref
    x, h = torch_amg_cases.pcg_history(krylov, A, b, M_run, rtol=RTOL_CG)
    x_ref, h_ref = torch_amg_cases.pcg_history(jax_krylov, A_ref, b_ref, M_ref_run, rtol=RTOL_CG)
    return (collect(x), h), (jax_pvector.collect(x_ref), h_ref)


def true_relres(A, x, b):
    G = to_global_scipy(A).astype(np.float64)
    bg = collect(b).astype(np.float64)
    return np.linalg.norm(bg - G @ x.astype(np.float64)) / np.linalg.norm(bg)
