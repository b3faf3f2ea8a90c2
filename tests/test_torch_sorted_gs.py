"""The sorted-by-color Gauss-Seidel tier (the reference's tier 2) and
``ops/ell.py`` of the PyTorch port against the JAX reference on the CPU.

The operator is 2-D Q1 elasticity at 10 x 10 nodes on (2,2) parts, its ids
permuted at random inside each part, so that the own-own block is no band:
both packages freeze it as rows, not DIA, and take the tile tier unless it
is declined.  The reference is forced onto tier 2 by its own budget
(``ops/slot_spmv.py::_MAX_SLOT_BYTES`` set to 0, which its
``gs_slot.py:276`` reads at call time), the port by its hook
(``GaussSeidel(..., _sorted=True)``) or its budget
(``smoothers.MAX_TILE_PACK_BYTES`` set to 0).  The coloring, the rows and
the ELL planes are equal bit for bit; the sweeps, ``refresh_values`` and the
AMG-CG (float64) agree to 1e-13 relative to the largest reference entry and
take the same iterations.  On the CPU the port's K5 runs its plain version.
"""
import importlib

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from threadpoolctl import threadpool_limits

from partitionedarrays_tpu import config as jax_config
from partitionedarrays_tpu.backends import SerialBackend as JaxSerialBackend
from partitionedarrays_tpu.models import gallery as jax_gallery
from partitionedarrays_tpu.ops import ell as jax_ell
from partitionedarrays_tpu.ops import slot_spmv as jax_slot_spmv
from partitionedarrays_tpu.parallel.p_range import PRange as JaxPRange
from partitionedarrays_tpu.solvers import amg as jax_amg
from partitionedarrays_tpu.solvers import krylov as jax_krylov
from partitionedarrays_tpu.solvers.smoothers import GaussSeidel as JaxGaussSeidel

from partitionedarrays_tpu_torch import convert
from partitionedarrays_tpu_torch.backends import SerialBackend
from partitionedarrays_tpu_torch.models import gallery
from partitionedarrays_tpu_torch.ops import ell
from partitionedarrays_tpu_torch.psparse import psparse, psparse_refill
from partitionedarrays_tpu_torch.pvector import collect, pvector_from_own
from partitionedarrays_tpu_torch.solvers import amg, krylov, smoothers
from partitionedarrays_tpu_torch.solvers.smoothers import GaussSeidel

jax_psparse = importlib.import_module("partitionedarrays_tpu.psparse")
jax_pvector = importlib.import_module("partitionedarrays_tpu.pvector")

NODES, PARTS = (10, 10), (2, 2)
RTOL = 1e-13
SWEEPS = ["forward", "backward", "symmetric"]


@pytest.fixture(scope="module", autouse=True)
def reference_on_tier_2():
    """Pallas off, numpy's BLAS on one thread, and the reference's slot
    budget at 0 for the whole module (its tile tier declines)."""
    torch.set_num_threads(1)
    saved = jax_config.use_pallas
    jax_config.use_pallas = False
    with threadpool_limits(limits=1), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_slot_spmv, "_MAX_SLOT_BYTES", 0)
        yield
    jax_config.use_pallas = saved


def _permuted_elasticity(gal):
    """The triplets with each part's ids permuted (seeded), the parts, and
    the permutation."""
    I, J, V, rows, cols = gal.linear_elasticity_fem(NODES, PARTS, dtype=np.float64)
    rng = np.random.default_rng(5)
    perm = np.arange(2 * int(np.prod(NODES)))
    for li in rows:
        o = np.asarray(li.own_to_global)
        perm[o] = rng.permutation(o)
    return ([perm[np.asarray(i)] for i in I], [perm[np.asarray(j)] for j in J], V, rows, cols)


@pytest.fixture(scope="module")
def operators():
    """(A, cache, triplets) of the port and of the reference, built with
    ``reuse`` for the refill test."""
    P = int(np.prod(PARTS))
    I, J, V, rows, cols = _permuted_elasticity(gallery)
    A, cache = psparse(I, J, V, rows, cols, SerialBackend(P), reuse=True, device="cpu")
    Ij, Jj, Vj, rj, cj = _permuted_elasticity(jax_gallery)
    Aj, cache_j = jax_psparse.psparse(Ij, Jj, Vj, JaxPRange(rj), JaxPRange(cj),
                                      JaxSerialBackend(P), reuse=True)
    return (A, cache, (I, J, V)), (Aj, cache_j, (Ij, Jj, Vj))


def _vectors(A, Aj, seed):
    rng = np.random.default_rng(seed)
    own = [rng.standard_normal(li.n_own) for li in A.row_prange.parts]
    return (pvector_from_own(own, A.row_prange, A.backend, device="cpu"),
            jax_pvector.pvector_from_own(own, Aj.row_prange, Aj.backend))


def _close(z, z_ref, rtol=RTOL):
    z_ref = np.asarray(z_ref)
    np.testing.assert_allclose(z, z_ref, rtol=0, atol=rtol * np.abs(z_ref).max())


def _random_csr(seed, shape=(37, 29), density=0.2, dtype=np.float64):
    return sp.random(*shape, density=density, format="csr", random_state=seed, dtype=dtype)


@pytest.mark.parametrize("fn", ["csr_to_ell", "stack_ell", "stack_ell_values", "ell_spmv",
                                "ell_spmv_masked_diag"])
def test_ell_functions_match_reference(fn):
    """``ops/ell.py``'s host functions equal the reference's bit for bit,
    its products agree to 1e-13 (one part and stacked parts)."""
    blocks = [_random_csr(s) for s in (1, 2, 3)] + [sp.csr_matrix((37, 29))]
    if fn == "csr_to_ell":
        for b in blocks:
            for k in (None, int(np.diff(b.indptr).max()) + 3):
                for got, want in zip(ell.csr_to_ell(b, 40, k), jax_ell.csr_to_ell(b, 40, k)):
                    np.testing.assert_array_equal(got, want)
        return
    cols, vals = ell.stack_ell(blocks, 40)
    cols_j, vals_j = jax_ell.stack_ell(blocks, 40)
    np.testing.assert_array_equal(cols, cols_j)
    np.testing.assert_array_equal(vals, vals_j)
    if fn == "stack_ell_values":
        twice = [b * 2 for b in blocks]
        np.testing.assert_array_equal(ell.stack_ell_values(twice, 40, cols.shape[-1]),
                                      jax_ell.stack_ell_values(twice, 40, cols.shape[-1]))
        return
    x = np.random.default_rng(7).standard_normal((len(blocks), 29))
    c, v, xt = torch.from_numpy(cols), torch.from_numpy(vals), torch.from_numpy(x)
    if fn == "ell_spmv":
        got = ell.ell_spmv(c, v, xt).numpy()
        want = np.stack([np.asarray(jax_ell.ell_spmv(cols[p], vals[p], x[p]))
                         for p in range(len(blocks))])
        _close(got, want)
        _close(ell.ell_spmv(c[0], v[0], xt[0]).numpy(), want[0])
        assert ell.ell_spmv(c, v, xt[:, :0]).abs().sum() == 0
        return
    diag = np.random.default_rng(8).integers(0, cols.shape[-1], size=(len(blocks), 40))
    got = ell.ell_spmv_masked_diag(c, v, torch.from_numpy(diag), xt).numpy()
    want = np.stack([np.asarray(jax_ell.ell_spmv_masked_diag(cols[p], vals[p], diag[p], x[p]))
                     for p in range(len(blocks))])
    _close(got, want)


def test_color_tabs_equal_reference(operators):
    """Both packages decline their tile tier the same way; the port's
    coloring, rows, ELL planes and inverse diagonals equal the reference's
    ``color_tabs`` bit for bit."""
    (A, _, _), (Aj, _, _) = operators
    gs, gs_j = GaussSeidel(A, 1, "symmetric", _sorted=True), JaxGaussSeidel(Aj, 1, "symmetric")
    assert gs_j.colored is None and gs_j.slot_gs is None
    assert gs.colored is None and gs.tile_gs is None and gs.sorted is not None
    assert gs.n_colors == gs_j.n_colors == len(gs_j.color_tabs) > 1
    tabs = smoothers._sorted_tabs(A)
    for t, t_j in zip(tabs, gs_j.color_tabs):
        for a, a_j in zip(t, t_j):
            np.testing.assert_array_equal(a, np.asarray(a_j))


@pytest.mark.parametrize("sweep", SWEEPS)
def test_sorted_sweeps_match_reference(operators, sweep):
    """The iterates of a sweep from a random guess (``apply``) and from zero
    (the preconditioner form), the port's K5 path and its ``ell_spmv``
    path, against the reference's tier 2."""
    (A, _, _), (Aj, _, _) = operators
    gs, gs_j = GaussSeidel(A, 2, sweep, _sorted=True), JaxGaussSeidel(Aj, 2, sweep)
    b, b_j = _vectors(A, Aj, 3)
    x, x_j = _vectors(A, Aj, 4)
    want = jax_pvector.collect(gs_j.apply(x_j, b_j))
    _close(collect(gs.apply(x, b)), want)
    _close(collect(gs._apply_sorted(x, b, plain=True)), want)
    _close(collect(gs(b)), jax_pvector.collect(gs_j(b_j)))


def test_convert_loads_reference_color_tabs(operators):
    """``convert.sorted_gs_from_color_tabs`` carries the reference's six
    arrays of each color across; its sweep equals the port's own tier bit
    for bit and the reference's to 1e-13."""
    (A, _, _), (Aj, _, _) = operators
    gs_j = JaxGaussSeidel(Aj, 1, "symmetric")
    gs_c = convert.sorted_gs_from_color_tabs(A, gs_j.color_tabs)
    gs = GaussSeidel(A, 1, "symmetric", _sorted=True)
    assert gs_c.n_colors == gs.n_colors
    b, b_j = _vectors(A, Aj, 5)
    z = collect(gs_c(b))
    np.testing.assert_array_equal(z, collect(gs(b)))
    _close(z, jax_pvector.collect(gs_j(b_j)))


@pytest.mark.parametrize("refill", ["scaled", "dad"])
def test_refresh_values_matches_reference(operators, refill):
    """New values at fixed sparsity, 4 A or D A D (D a seeded random
    diagonal): the refreshed smoother equals a fresh build bit for bit and
    sweeps as the reference's refreshed one.  The values are restored
    afterwards."""
    (A, cache, (I, J, V)), (Aj, cache_j, (Ij, Jj, Vj)) = operators
    gs, gs_j = GaussSeidel(A, 1, "symmetric", _sorted=True), JaxGaussSeidel(Aj, 1, "symmetric")
    d = (np.full(A.shape[0], 2.0) if refill == "scaled"
         else 1.0 + 0.5 * np.random.default_rng(6).random(A.shape[0]))
    try:
        psparse_refill(A, [v * d[i] * d[j] for i, j, v in zip(I, J, V)], cache)
        Aj2 = jax_psparse.psparse_refill(Aj, [v * d[i] * d[j] for i, j, v in zip(Ij, Jj, Vj)],
                                         cache_j)
        Aj2 = Aj if Aj2 is None else Aj2
        gs.refresh_values(A)
        gs_j.refresh_values(Aj2)
        fresh = GaussSeidel(A, 1, "symmetric", _sorted=True)
        assert gs.n_colors == fresh.n_colors == len(gs_j.color_tabs)
        for t, t_f in zip(gs.sorted.tabs, fresh.sorted.tabs):
            assert all(torch.equal(a, a_f) for a, a_f in zip(t, t_f))
        b, b_j = _vectors(A, Aj, 9)
        z = collect(gs(b))
        np.testing.assert_array_equal(z, collect(fresh(b)))
        _close(z, jax_pvector.collect(gs_j(b_j)))
    finally:
        psparse_refill(A, V, cache)
        jax_psparse.psparse_refill(Aj, Vj, cache_j)


def test_refresh_colors_anew_where_new_values_cancel():
    """The coloring is that of A + A^T's nonzero values, as the
    reference's: refilled with D A D, the unpermuted 10 x 10 elasticity
    cancels other entries exactly and takes another color count; the
    refreshed state is the fresh build's."""
    I, J, V, rows, cols = gallery.linear_elasticity_fem(NODES, PARTS, dtype=np.float64)
    A, cache = psparse(I, J, V, rows, cols, SerialBackend(4), reuse=True, device="cpu")
    gs = GaussSeidel(A, 1, "symmetric", _sorted=True)
    d = 1.0 + 0.5 * np.random.default_rng(6).random(A.shape[0])
    psparse_refill(A, [v * d[i] * d[j] for i, j, v in zip(I, J, V)], cache)
    n_before = gs.n_colors
    gs.refresh_values(A)
    fresh = GaussSeidel(A, 1, "symmetric", _sorted=True)
    assert gs.n_colors == fresh.n_colors != n_before
    for t, t_f in zip(gs.sorted.tabs, fresh.sorted.tabs):
        assert all(torch.equal(a, a_f) for a, a_f in zip(t, t_f))


def test_gate_declines_the_tile_tier_beyond_its_budget(operators, monkeypatch):
    """Under the budget the block takes the tile tier (K6); with the budget
    at 0 the sorted tier, whose sweep equals the forced one bit for bit."""
    (A, _, _), _ = operators
    nt = -(-A.row_layout().n_own_pad // 128)
    assert smoothers.tile_pack_bytes(A) == 4 * nt * 2 * 128 * 128 * 8
    assert GaussSeidel(A).tile_gs is not None
    monkeypatch.setattr(smoothers, "MAX_TILE_PACK_BYTES", 0)
    gs = GaussSeidel(A)
    assert gs.tile_gs is None and gs.sorted is not None
    b = pvector_from_own([np.ones(li.n_own) for li in A.row_prange.parts], A.row_prange,
                         A.backend, device="cpu")
    np.testing.assert_array_equal(collect(gs(b)),
                                  collect(GaussSeidel(A, _sorted=True)(b)))


def test_amg_cg_with_sorted_level_smoothers_matches_reference(operators, monkeypatch):
    """SA-AMG with the rigid-body nullspace, every level smoother on tier 2
    in both packages (their budgets at 0): the same hierarchy, the
    reference's CG iterations to 1e-8, and x to 1e-10."""
    (A, _, _), (Aj, _, _) = operators
    monkeypatch.setattr(smoothers, "MAX_TILE_PACK_BYTES", 0)
    params = dict(coarse_size=30, block_size=2)
    coords, _ = gallery.node_coordinates_unit_cube(NODES, PARTS)
    coords_j, _ = jax_gallery.node_coordinates_unit_cube(NODES, PARTS)
    M = amg.AMGPreconditioner(A, amg.AMGParams(**params),
                              nullspace=gallery.nullspace_linear_elasticity(coords, A.row_prange))
    M_j = jax_amg.AMGPreconditioner(
        Aj, jax_amg.AMGParams(**params),
        nullspace=jax_gallery.nullspace_linear_elasticity(coords_j, Aj.row_prange))
    smoothed = [lev.smoother for lev in M.levels[:-1]]
    assert smoothed and all(s.sorted is not None for s in smoothed)
    assert all(lev.smoother.colored is None and lev.smoother.slot_gs is None
               for lev in M_j.levels[:-1])
    assert [lev.A.shape for lev in M.levels] == [tuple(lev.A.shape) for lev in M_j.levels]
    b, b_j = _vectors(A, Aj, 10)
    x, info = krylov.cg(A, b, M=M, rtol=1e-8, maxiter=200)
    x_j, info_j = jax_krylov.cg(Aj, b_j, M=M_j, rtol=1e-8, maxiter=200)
    assert info.iterations == int(info_j.iterations) > 0
    _close(collect(x), jax_pvector.collect(x_j), 1e-10)
