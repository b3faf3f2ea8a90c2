"""``AMGPreconditioner.update`` of the port against the JAX package's and
against a fresh build, float64, on the serial backend:

- the generic path: the 2-D Q1 Laplacian (8 x 8 nodes) on (2,2) parts with
  ``epsilon=0.01``, refilled with 3 V;
- the box path: the 7-point ``laplacian_fdm`` on (2,2,2) parts of 8^3
  (box aggregation, the ghosted flat cycle), refilled with a diagonal
  shift, so that P really changes;
- the tile tier: the generic case with each part's own ids shuffled (the
  own blocks are not banded, so they freeze as compressed rows and smooth
  on K6's tile tier), refilled with 3 V; and, on the
  port alone, 3-D elasticity on (2,2,2) parts of unequal size at 7^3
  nodes refilled with a mass-like diagonal shift: there the reference's
  refill fails (its refilled products assume scipy's pattern of the
  build, which dropped the entries whose terms cancelled exactly; ROADMAP
  Queue 3);
- a box Laplacian and that elasticity set up at constant coefficients and
  refilled with variable ones: the first updates, the second raises where
  its build's products cancelled exactly (ROADMAP Queue 3).

Each updated hierarchy (every level's operator and P, omega, the box
transfers' D^-1, the coarse factors) equals the reference's updated one
and a fresh ``_GalerkinCache`` at the frozen omegas; the refreshed
smoother operands equal a fresh ``GaussSeidel`` of a fresh copy of the new
operator bit for bit on both tiers; one CG after the update takes the
reference's iterations.
"""
import importlib
import os
import sys

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from partitionedarrays_tpu import config as jax_config
from partitionedarrays_tpu.backends import SerialBackend as JaxSerialBackend
from partitionedarrays_tpu.models import gallery as jax_gallery
from partitionedarrays_tpu.parallel.p_range import PRange as JaxPRange
from partitionedarrays_tpu.solvers import amg as jax_amg
from partitionedarrays_tpu.solvers import krylov as jax_krylov

from partitionedarrays_tpu_torch import psparse as ps
from partitionedarrays_tpu_torch.backends import SerialBackend
from partitionedarrays_tpu_torch.models import gallery
from partitionedarrays_tpu_torch.pvector import collect, pvector_from_own
from partitionedarrays_tpu_torch.solvers import amg, krylov
from partitionedarrays_tpu_torch.solvers.gs_slot import NaturalTileGS
from partitionedarrays_tpu_torch.solvers.smoothers import GaussSeidel

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "examples"))
import implicit_reuse  # noqa: E402

jax_ps = importlib.import_module("partitionedarrays_tpu.psparse")
jax_pv = importlib.import_module("partitionedarrays_tpu.pvector")

jax_config.use_pallas = False

# name -> (generator, nodes, parts, psparse keywords, AMGParams, nullspace, refill)
CASES = {
    "generic": ("laplacian_fem", (8, 8), (2, 2), {}, dict(coarse_size=10, epsilon=0.01), False,
                lambda I, J, V: 3.0 * V),
    "box": ("laplacian_fdm", (16, 16, 16), (2, 2, 2), dict(assembled=True),
            dict(coarse_size=20), False,
            lambda I, J, V: V + (I == J) * (0.5 + (I % 7) / 7.0) * V),
    "tile": ("laplacian_fem", (8, 8), (2, 2), {}, dict(coarse_size=10, epsilon=0.01), False,
             lambda I, J, V: 3.0 * V),
}
# the tile tier under a mass-like shift, on the port alone
ELASTICITY = ((7, 7, 7), (2, 2, 2), dict(coarse_size=30, block_size=3, max_levels=2))
# constant-coefficient builds refilled with variable coefficients:
# name -> (generator, nodes, parts, psparse keywords, AMGParams, nullspace)
CONSTANT_BUILDS = {
    "box": ("laplacian_fdm", (12, 12, 12), (2, 2, 2), dict(assembled=True),
            dict(coarse_size=20), False),
    "elasticity": ("linear_elasticity_fem", ELASTICITY[0], ELASTICITY[1], {}, ELASTICITY[2],
                   True),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield


def _parts(pr):
    return pr.parts if hasattr(pr, "parts") else pr.partition()


def build(name):
    """Both packages' matrices, AMG, and the refilled matrices (refilled in
    place through the psparse caches) before any update."""
    gen, nodes, parts, kw, params, with_ns, refill = CASES[name]
    P = int(np.prod(parts))
    out = []
    for gal, make_A, AMG, Params, refill_fn in (
        (gallery, lambda I, J, V, r, c: ps.psparse(I, J, V, r, c, SerialBackend(P), reuse=True,
                                                   device="cpu", **kw),
         amg.AMGPreconditioner, amg.AMGParams, ps.psparse_refill),
        (jax_gallery,
         lambda I, J, V, r, c: jax_ps.psparse(I, J, V, JaxPRange(r), JaxPRange(c),
                                              JaxSerialBackend(P), reuse=True,
                                              **(kw or dict(assembled=False))),
         jax_amg.AMGPreconditioner, jax_amg.AMGParams, jax_ps.psparse_refill),
    ):
        I, J, V, rows, cols = getattr(gal, gen)(nodes, parts)
        if name == "tile":
            I, J = _shuffled_ids(I, J, rows)
        A, cache = make_A(I, J, V, rows, cols)
        ns = None
        if with_ns:
            coords, _ = gal.node_coordinates_unit_cube(nodes, parts)
            ns = gal.nullspace_linear_elasticity(coords, A.row_prange)
        M = AMG(A, Params(**params), nullspace=ns)
        V2 = [refill(np.asarray(i), np.asarray(j), np.asarray(v)) for i, j, v in zip(I, J, V)]
        out.append((A, M, lambda A=A, V2=V2, cache=cache, f=refill_fn: f(A, V2, cache)))
    return out


def _shuffled_ids(I, J, rows):
    """The triplets with each part's own ids permuted among themselves (a
    seeded shuffle): the own blocks are no longer banded, so they freeze
    as compressed rows and smooth on the tile tier."""
    rng = np.random.default_rng(8)
    n = sum(li.own_to_global.size for li in rows)
    sigma = np.arange(n)
    for li in rows:
        sigma[li.own_to_global] = rng.permutation(li.own_to_global)
    return [sigma[np.asarray(i)] for i in I], [sigma[np.asarray(j)] for j in J]


def _same_blocks(A, A_ref):
    for b, b_ref in zip(ps.host_blocks(A), A_ref.blocks):
        for k in ("oo", "oh"):
            x, y = b[k].tocsr(), b_ref[k].tocsr()
            x.sort_indices()
            y.sort_indices()
            np.testing.assert_array_equal(x.indptr, y.indptr)
            np.testing.assert_array_equal(x.indices, y.indices)
            np.testing.assert_array_equal(x.data, y.data)


def _close_global(A, B, rtol):
    G1, G2 = ps.to_global_scipy(A), ps.to_global_scipy(B)
    d = abs(G1 - G2)
    assert (d.max() if d.nnz else 0.0) <= rtol * abs(G1).max()


def check_update(M, M_ref=None):
    """The updated hierarchies agree with each other (``M_ref`` None: the
    port's alone) and with a fresh Galerkin product at the frozen omegas;
    every refreshed operand equals a fresh build's."""
    assert M.omegas == [gk.omega for gk in M._galerkin]
    refs = M_ref.levels if M_ref is not None else [None] * len(M.levels)
    assert len(M.levels) == len(refs)
    current = M.levels[0].A
    for l, (lev, lev_ref, gk) in enumerate(zip(M.levels, refs, M._galerkin)):
        assert gk.P is lev.P
        if M_ref is not None:
            _same_blocks(lev.A, lev_ref.A)
            _same_blocks(lev.P, lev_ref.P)
            assert gk.omega == M_ref._galerkin[l].omega
        fresh = amg._GalerkinCache(current.copy(), gk.P0, gk.omega)
        _close_global(fresh.P, lev.P, 1e-12)
        _close_global(fresh.Ac, gk.Ac, 1e-12)
        current = gk.Ac
        if lev.struct is not None:
            if M_ref is not None:
                np.testing.assert_array_equal(lev.struct.dinv.numpy(),
                                              np.asarray(lev_ref.struct[3]))
            assert torch.equal(lev.struct.dinv, amg._box_dinv(lev.A.copy()))
        A_new = lev.A.copy()
        gs, gs_new = lev.smoother, GaussSeidel(A_new, lev.smoother.iterations, "symmetric")
        assert gs.A is lev.A
        if gs.colored is not None:
            assert torch.equal(gs.colored.vals_d, gs_new.colored.vals_d)
            assert torch.equal(gs.colored.invd_d, gs_new.colored.invd_d)
        else:
            for name in ("pack", "rows", "cols", "vals", "tile_ptr", "wave_tiles", "tile_lanes"):
                assert torch.equal(getattr(gs.tile_gs, name), getattr(gs_new.tile_gs, name)), name
        dev, dev_new = lev.A.device(), A_new.device()
        for name in ("oo", "oh"):
            assert torch.equal(getattr(dev, name).vals, getattr(dev_new, name).vals)
    G = ps.to_global_scipy(M.levels[-1].A).toarray()
    if M.coarse_kind == "inv":
        np.testing.assert_allclose(M._coarse[0].numpy() @ G, np.eye(G.shape[0]), atol=1e-10)
    if M_ref is None:
        return
    _same_blocks(M.levels[-1].A, M_ref.levels[-1].A)
    np.testing.assert_allclose(M._coarse[0].numpy(), np.asarray(M_ref.coarse_inv
                                                                if M.coarse_kind == "inv"
                                                                else M_ref.coarse_lu),
                               rtol=0, atol=1e-12 * np.abs(M._coarse[0].numpy()).max())


def _cg_pair(port, ref, seed=3):
    (A, M, _), (A_ref, M_ref, _) = port, ref
    rng = np.random.default_rng(seed)
    own = [rng.standard_normal(li.n_own) for li in A.row_prange.parts]
    b = pvector_from_own(own, A.row_prange, A.backend, device="cpu")
    b_ref = jax_pv.pvector_from_own(own, A_ref.row_prange, A_ref.backend)
    x, info = krylov.cg(A, b, M=M, rtol=1e-10, maxiter=100)
    x_ref, info_ref = jax_krylov.cg(A_ref, b_ref, M=M_ref, rtol=1e-10, maxiter=100)
    assert int(info.iterations) == int(info_ref.iterations)
    np.testing.assert_allclose(collect(x), np.asarray(jax_pv.collect(x_ref)), rtol=0,
                               atol=1e-8 * np.abs(np.asarray(jax_pv.collect(x_ref))).max())
    return int(info.iterations)


@pytest.mark.parametrize("name", ["generic", "box", "tile"])
def test_update_matches_jax_and_fresh(name):
    port, ref = build(name)
    (A, M, refill), (A_ref, M_ref, refill_ref) = port, ref
    aggs = [a[0] for a in M._aggs]
    galerkin = list(M._galerkin)
    G0 = ps.to_global_scipy(A)
    refill()
    refill_ref()
    assert abs(ps.to_global_scipy(A) - G0).max() > 0.1 * abs(G0).max()
    assert M.update(A) is M
    M_ref.update(A_ref)
    assert all(a is b[0] for a, b in zip(aggs, M._aggs)) and M._galerkin == galerkin
    if name == "box":
        assert all(lev.struct is not None for lev in M.levels[:-1]) and not M._flat_ok(0)
    if name == "tile":
        assert any(lev.smoother.tile_gs is not None for lev in M.levels[:-1])
    check_update(M, M_ref)
    if name == "generic":
        _cg_pair(port, ref)


def test_update_mass_shift_tile():
    """The elasticity case refilled with a mass-like diagonal shift: the
    refilled prolongator's product leaves rounding residues where the
    build's terms cancelled exactly (scipy dropped those entries); the
    port's update keeps the frozen pattern, equals a fresh Galerkin product
    at the frozen omega and a fresh smoother, and preconditions the new
    operator."""
    nodes, parts, params = ELASTICITY
    I, J, V, rows, cols = gallery.linear_elasticity_fem(nodes, parts)
    A, cache = ps.psparse(I, J, V, rows, cols, SerialBackend(8), reuse=True, device="cpu")
    coords, _ = gallery.node_coordinates_unit_cube(nodes, parts)
    null = gallery.nullspace_linear_elasticity(coords, A.row_prange)
    M = amg.AMGPreconditioner(A, amg.AMGParams(**params), nullspace=null)
    ps.psparse_refill(A, [v + 0.1 * (i == j) for i, j, v in zip(I, J, V)], cache)
    M.update(A)
    check_update(M)
    fresh = amg.AMGPreconditioner(A.copy(), amg.AMGParams(**params), nullspace=null)
    rng = np.random.default_rng(5)
    b = pvector_from_own([rng.standard_normal(li.n_own) for li in A.row_prange.parts],
                         A.row_prange, A.backend, device="cpu")
    its = [int(krylov.cg(A, b, M=m, rtol=1e-10, maxiter=200)[1].iterations) for m in (M, fresh)]
    assert abs(its[0] - its[1]) <= 1, its


def test_update_then_cg_box_matches_jax():
    """One CG on the updated ghosted flat box hierarchy takes the
    reference's iterations, and its P changed on the update (the shift
    moves the diagonal against the off-diagonals)."""
    port, ref = build("box")
    P_before = ps.to_global_scipy(port[1].levels[0].P).copy()
    port[2]()
    ref[2]()
    port[1].update(port[0])
    ref[1].update(ref[0])
    assert abs(ps.to_global_scipy(port[1].levels[0].P) - P_before).max() > 1e-3
    assert _cg_pair(port, ref) > 3


def test_tile_refresh_equals_build():
    """The tile tier's values half alone (``refresh``) equals a whole build
    on new values, on a level whose smoother is forced onto it (the box
    fine level, as ``force_tile_tier`` does), and keeps the plan."""
    I, J, V, rows, cols = gallery.laplacian_fdm((12, 12, 12), (2, 2, 2))
    A, cache = ps.psparse(I, J, V, rows, cols, SerialBackend(8), assembled=True, reuse=True,
                          device="cpu")
    tg = NaturalTileGS.build(A)
    plan = (tg.rows, tg.cols, tg.tile_ptr, tg.wave_tiles, tg.tile_lanes, tg.schedules)
    rng = np.random.default_rng(2)
    ps.psparse_refill(A, [v * (1.0 + 0.3 * rng.random(v.size)) for v in V], cache)
    tg.refresh(A)
    fresh = NaturalTileGS.build(A.copy())
    assert torch.equal(tg.pack, fresh.pack) and torch.equal(tg.vals, fresh.vals)
    assert all(a is b for a, b in zip(plan, (tg.rows, tg.cols, tg.tile_ptr, tg.wave_tiles,
                                              tg.tile_lanes, tg.schedules)))
    gs = GaussSeidel(A)
    gs.colored, gs.tile_gs, gs.n_colors = None, tg, 1
    with pytest.raises(ValueError, match="another smoother tier"):
        gs.refresh_values(A)


@pytest.mark.parametrize("name", ["box", "elasticity"])
def test_update_after_a_constant_coefficient_build(name):
    """A hierarchy set up at constant coefficients and refilled with
    variable ones (D A D, D a seeded random diagonal).  No product of the
    box Laplacian's build cancels exactly, so ``update`` equals a fresh
    build.  The elasticity build's products cancel exactly at some entries
    (scipy's pattern, the reference's, lacks them); the refilled products
    are real there, outside the frozen sparsity, so ``update`` sets up anew
    on the same aggregates: its hierarchy equals ``_setup(A,
    reuse_aggregates=True)`` of a copy, and ``n_resetups`` counts it.  (The
    reference raises here.)"""
    gen, nodes, parts, kw, params, with_ns = CONSTANT_BUILDS[name]
    I, J, V, rows, cols = getattr(gallery, gen)(nodes, parts)
    A, cache = ps.psparse(I, J, V, rows, cols, SerialBackend(8), reuse=True, device="cpu", **kw)
    null = None
    if with_ns:
        coords, _ = gallery.node_coordinates_unit_cube(nodes, parts)
        null = gallery.nullspace_linear_elasticity(coords, A.row_prange)
    M = amg.AMGPreconditioner(A, amg.AMGParams(**params), nullspace=null)
    d = 1.0 + 0.5 * np.random.default_rng(6).random(A.shape[0])
    ps.psparse_refill(A, [v * d[np.asarray(i)] * d[np.asarray(j)] for i, j, v in zip(I, J, V)],
                      cache)
    aggs = M._aggs
    if name == "elasticity":
        # the frozen products alone keep their contract (spmm_into's and
        # spmtm_into's refills): a real entry outside the build's sparsity
        # raises
        with pytest.raises(ValueError, match="outside the sparsity of its build"):
            M._galerkin[0].refill(A)
    M.update(A)
    check_update(M)
    assert M.n_resetups == (1 if name == "elasticity" else 0)
    if name == "box":
        return
    fresh = amg.AMGPreconditioner.__new__(amg.AMGPreconditioner)
    fresh.params, fresh.nullspace, fresh._aggs = M.params, M.nullspace, aggs
    fresh._setup(A.copy(), reuse_aggregates=True)
    assert M._aggs == aggs and M.omegas == fresh.omegas
    assert len(M.levels) == len(fresh.levels)
    for lev, lev_f in zip(M.levels, fresh.levels):
        _same_blocks(lev.A, lev_f.A)
        if lev.P is not None:
            _same_blocks(lev.P, lev_f.P)


@pytest.mark.slow
def test_elasticity_update_24_nodes_sets_up_anew():
    """The user case of ``examples/implicit_reuse.py``: ``elasticity_update``
    at 24^3 nodes in float32 (one part, a mass-like shift) refills products
    whose terms cancelled at the build; ``update`` sets up anew once and the
    CG takes no more than one iteration beyond a fresh setup's.  The port
    alone: the reference raises here."""
    r = implicit_reuse.elasticity_update(implicit_reuse.port("cpu"), nodes=(24, 24, 24))
    assert r["M"].n_resetups == 1
    assert abs(r["iterations"] - r["fresh_iterations"]) <= 1 and r["relres"] <= 1e-5
