"""The ghost coupling in the core layout
(``GaussSeidel.ghost_couple_core``, ``ExchangePlan.apply(src_core=...)``,
``GaussSeidel.apply`` and ``__call__``, ``hpcg_cg_flat_g``, the MG's
``_vcycle``, the AMG flat cycle) against the standard-order composition it
replaces (``tests/torch_ghost_core_cases.py``), bit for bit, on (2,2,2) and
(1,1,4) parts in float64 and float32 at every level of the MG and of a
box-aggregated AMG, on the CPU (K5's plain version); the core rows table,
the spans' ``layout`` attribute and the exchange count."""
from collections import Counter
from functools import lru_cache

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torch_ghost_core_cases as cases
from partitionedarrays_tpu_torch.models.hpcg.cg import hpcg_cg_flat_g
from partitionedarrays_tpu_torch.parallel.exchange_plan import core_slot
from partitionedarrays_tpu_torch.pvector import PVector
from partitionedarrays_tpu_torch.utils import profiling

N = 16
LEVELS = 4


@lru_cache(maxsize=None)
def _mg(parts, dtype):
    return cases.build_mg(N, parts, dtype, levels=LEVELS)


def _core(gs, seed, dtype):
    """A random core of level ``gs`` (random padding slots too)."""
    col = gs.colored
    g = torch.Generator().manual_seed(seed)
    return torch.randn(gs.A.row_layout().n_parts, col.m, col.Lq, generator=g,
                       dtype=torch.float64).to(dtype)


def _x_core(gs, seed, dtype):
    """A random x as the flat pipeline holds it: de-interleaved own values."""
    lay = gs.A.row_layout()
    g = torch.Generator().manual_seed(seed)
    own = torch.randn(lay.n_parts, lay.n_own_pad, generator=g, dtype=torch.float64).to(dtype)
    return gs.flat_deinterleave(own)


@pytest.mark.parametrize("subtract", [False, True])
@pytest.mark.parametrize("level", range(LEVELS))
@pytest.mark.parametrize("dtype", cases.DTYPES)
@pytest.mark.parametrize("parts", cases.PARTS)
def test_couple_core_equals_std_composition(parts, dtype, level, subtract):
    gs = _mg(parts, dtype).gss[level]
    assert not gs.flat_viable()
    x = _x_core(gs, 10 + level, dtype)
    y = _core(gs, 20 + level, dtype)
    want = cases.std_couple(gs, x, y, subtract)
    got = gs.ghost_couple_core(x, y.clone(), subtract=subtract)
    assert torch.equal(got, want)
    # in place: the returned tensor is the one handed in
    y2 = y.clone()
    assert gs.ghost_couple_core(x, y2, subtract=subtract) is y2


@pytest.mark.parametrize("level", range(1, LEVELS))  # (2,2,2)'s 2^3 level is banded
@pytest.mark.parametrize("parts", cases.PARTS)
def test_core_rows_keep_padding_rows(parts, level):
    gs = _mg(parts, torch.float64).gss[level]
    assert gs.A.device().oh.kind == "ell"
    rows = gs.A.device().oh.rows
    core = gs.core_rows()
    col = gs.colored
    assert core.dtype == torch.int32 and core.shape == rows.shape
    pad = rows < 0
    assert torch.equal(core < 0, pad) and bool((core[pad] == -1).all())
    live = rows[~pad].long()
    assert torch.equal(core[~pad].long(), (live % col.m) * col.Lq + live // col.m)
    assert int(core.max()) < col.m * col.Lq
    assert gs.core_rows() is core  # built once


@pytest.mark.parametrize("level", range(LEVELS))
@pytest.mark.parametrize("dtype", cases.DTYPES)
@pytest.mark.parametrize("parts", cases.PARTS)
def test_exchange_from_core_equals_std_exchange(parts, dtype, level):
    gs = _mg(parts, dtype).gss[level]
    A = gs.A
    clay = A.col_layout()
    plan = clay.consistent_plan
    x = _core(gs, 30 + level, dtype)
    g0 = torch.randn(x.shape[0], clay.n_ghost_pad, dtype=torch.float64,
                     generator=torch.Generator().manual_seed(40 + level)).to(dtype)
    want = plan.apply(gs.flat_interleave(x), g0, "set", A.backend)
    before = Counter(profiling.COUNTS)
    got = plan.apply(x, g0, "set", A.backend, src_core=(gs.colored.m, gs.colored.Lq))
    assert torch.equal(got, want)
    # the same exchange: one more, as many bytes
    sent = profiling.COUNTS["exchange_bytes.set"] - before["exchange_bytes.set"]
    assert profiling.COUNTS["exchanges.set"] - before["exchanges.set"] == 1
    plan.apply(gs.flat_interleave(x), g0, "set", A.backend)
    assert profiling.COUNTS["exchange_bytes.set"] - before["exchange_bytes.set"] == 2 * sent


def test_exchange_refuses_a_core_of_another_size():
    gs = _mg((2, 2, 2), torch.float64).gss[-1]
    x = _core(gs, 1, torch.float64)
    g0 = x.new_zeros(x.shape[0], gs.A.col_layout().n_ghost_pad)
    with pytest.raises(ValueError, match="core"):
        gs.A.col_layout().consistent_plan.apply(x, g0, "set", gs.A.backend,
                                                src_core=(gs.colored.m, gs.colored.Lq + 1))


def test_core_slot_is_the_deinterleave_map():
    gs = _mg((1, 1, 4), torch.float64).gss[-1]
    col = gs.colored
    i = torch.arange(col.R)
    own = torch.arange(col.R, dtype=torch.float64).unsqueeze(0)
    flat = col.deinterleave(own).reshape(-1)
    assert torch.equal(flat[core_slot(i, (col.m, col.Lq))], i.double())


@pytest.mark.parametrize("dtype", cases.DTYPES)
@pytest.mark.parametrize("parts", cases.PARTS)
def test_cg_equals_std_composition(parts, dtype):
    mg = _mg(parts, dtype)
    b = cases.random_rhs(mg, 7)
    x_want, n_want = cases.std_cg(mg, b, 20)
    x, norms = hpcg_cg_flat_g(mg, b, iterations=20)
    assert torch.equal(norms, n_want)
    assert torch.equal(x.own, x_want)
    assert float(norms[-1] / norms[0]) < 1e-3  # it converges


@pytest.mark.parametrize("parts", cases.PARTS)
def test_mg_cycle_on_pvector_equals_std_composition(parts):
    """The generic ``_cycle`` callers (through ``_cycle_flat_g``, the
    V-cycle on a standard-order rhs) get the standard-order cycle's result,
    bit for bit."""
    mg = _mg(parts, torch.float64)
    b = cases.random_rhs(mg, 8)
    got = mg(b)
    want = cases._std_cycle(mg, mg.n_levels - 1, b)
    assert torch.equal(got.own, want.own)


@pytest.mark.parametrize("level", range(LEVELS))
@pytest.mark.parametrize("dtype", cases.DTYPES)
@pytest.mark.parametrize("parts", cases.PARTS)
def test_gauss_seidel_apply_and_call_equal_std_composition(parts, dtype, level):
    """``apply`` from a random x and ``__call__`` from the zero guess, on a
    colored level with ghost columns: ``b.own - ghost_contrib(x.own)``'s
    sweeps, bit for bit."""
    mg = _mg(parts, dtype)
    gs = mg.gss[level]
    assert gs.colored is not None and not gs.flat_viable()
    lay = gs.A.row_layout()
    g = torch.Generator().manual_seed(50 + level)
    x_own, b_own = (torch.randn(lay.n_parts, lay.n_own_pad, generator=g,
                                dtype=torch.float64).to(dtype) for _ in range(2))
    x = PVector(x_own, x_own.new_zeros((lay.n_parts, lay.n_ghost_pad)), lay, mg.backend)
    b = PVector(b_own, torch.zeros_like(x.ghost), lay, mg.backend)
    assert torch.equal(gs.apply(x, b).own, cases.std_gs(gs, x_own, b_own, False))
    assert torch.equal(gs(b).own, cases.std_gs(gs, torch.zeros_like(b_own), b_own, True))


@lru_cache(maxsize=None)
def _amg(parts, dtype):
    return cases.build_amg_box(parts, dtype)


@pytest.mark.parametrize("w", [False, True], ids=["v", "w"])
@pytest.mark.parametrize("dtype", cases.DTYPES)
@pytest.mark.parametrize("parts", cases.PARTS)
def test_amg_flat_cycle_equals_std_composition(parts, dtype, w):
    """The AMG cycle whose box levels couple in the core equals the
    standard-order ghosted flat cycle, V and W, from every level."""
    A, M = _amg(parts, dtype)
    smoothed = M.levels[:-1]
    assert len(smoothed) >= 2
    assert all(lev.struct is not None and lev.smoother.colored is not None
               and not lev.smoother.flat_viable() for lev in smoothed)
    for l in range(len(smoothed)):
        lev = M.levels[l]
        b = cases.amg_rhs(lev.A, 60 + l)
        want = cases.std_amg_cycle(M, l, b, w)
        assert torch.equal(M._cycle(l, b, w).own, want.own), l
    if not w:  # the preconditioner's own call: a V-cycle on the CPU, eager
        b = cases.amg_rhs(A, 70)
        assert torch.equal(M(b).own, cases.std_amg_cycle(M, 0, b, False).own)


def test_span_layout_and_exchange_count():
    parts, its = (2, 2, 2), 3
    mg = _mg(parts, torch.float64)
    profiling.reset_counts()
    with profile(activities=[ProfilerActivity.CPU]):
        profiling._clear_spans()
        hpcg_cg_flat_g(mg, mg.b, iterations=its)
        recorded = profiling.spans()
    cycles = its + 1
    # per V-cycle two couplings on each ghosted level above the coarsest and
    # the coarsest's zero-guess one, one per A-apply: all in the core
    n_core = cycles * (2 * (LEVELS - 1) + 1) + its
    tags = Counter(s.attrs.get("layout") for s in recorded if s.name == "ghost")
    assert tags == {"core": n_core}
    assert profiling.COUNTS["exchanges.set"] == n_core
