"""The port's spans and counters (``utils/profiling.py``) on the CPU.

Off (no profiler session): a solve records no span and ``span`` hands out
one shared no-op.  On, under ``torch.profiler``: the AMG-CG's ``cg``,
``cg.converged`` and ``amg.cycle`` spans and the HPCG set's ``hpcg.cg`` and
``mg.level`` spans, each child inside its parent with the parent's
request; ``trace()`` writes the spans on the trace's own clock.  The
counter registry: launches counted at ``_build.check``, exchanges and their
bytes at ``ExchangePlan.apply``."""
import json
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from partitionedarrays_tpu_torch import _build
from partitionedarrays_tpu_torch.backends import SerialBackend
from partitionedarrays_tpu_torch.models.gallery import (
    linear_elasticity_fem, node_coordinates_unit_cube, nullspace_linear_elasticity)
from partitionedarrays_tpu_torch.models.hpcg.cg import hpcg_cg_flat
from partitionedarrays_tpu_torch.models.hpcg.mg import HPCGMGPreconditioner
from partitionedarrays_tpu_torch.models.hpcg.problem import build_hpcg_problem
from partitionedarrays_tpu_torch.psparse import psparse, spmv
from partitionedarrays_tpu_torch.pvector import pones
from partitionedarrays_tpu_torch.solvers.amg import AMGParams, AMGPreconditioner
from partitionedarrays_tpu_torch.solvers.krylov import cg
from partitionedarrays_tpu_torch.utils import profiling

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _one_blas_thread():
    from threadpoolctl import threadpool_limits

    with threadpool_limits(1):
        yield


@pytest.fixture(scope="module")
def amg_case():
    """The 5^3-node elasticity AMG-CG (coarse 30, at most 4 levels)."""
    nodes = (5, 5, 5)
    A = psparse(*linear_elasticity_fem(nodes, (1, 1, 1)), SerialBackend(1), device="cpu")
    coords, _ = node_coordinates_unit_cube(nodes, (1, 1, 1))
    M = AMGPreconditioner(A, AMGParams(coarse_size=30, block_size=3, max_levels=4),
                          nullspace=nullspace_linear_elasticity(coords, A.row_prange))
    b = spmv(A, pones(A.col_prange, A.backend, dtype=A.dtype, device="cpu"))
    return A, M, b


def _recorded(fn):
    """``fn()`` under a CPU profiler session: (its result, the spans it
    recorded, by their index in ``profiling.spans()``)."""
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, dict(enumerate(profiling.spans()))


def _new(spans, first):
    return {i: s for i, s in spans.items() if i >= first}


def _assert_nested(spans):
    """Every span closed, each child inside its parent's interval with its
    parent's request; a root is its own request."""
    for i, s in spans.items():
        assert s.start_ns is not None and s.end_ns is not None and s.start_ns <= s.end_ns
        if s.parent == -1:
            assert s.request == i
            continue
        parent = spans[s.parent]
        assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns
        assert s.request == parent.request


def test_span_off_is_one_shared_no_op(amg_case):
    A, M, b = amg_case
    assert profiling.span("cg") is profiling.span("amg.cycle", level=3)
    before = len(profiling.spans())
    cg(A, b, M=M, rtol=1e-8, maxiter=2)
    assert len(profiling.spans()) == before


def test_amg_cg_spans(amg_case):
    A, M, b = amg_case
    first = len(profiling.spans())
    (_, info), spans = _recorded(lambda: cg(A, b, M=M, rtol=1e-8))
    mine = _new(spans, first)
    _assert_nested(mine)
    names = Counter(s.name for s in mine.values())
    its = int(info.iterations)
    assert its > 0 and names["cg"] == 1 and names["cg.converged"] == its + 1
    cycles = Counter(s.attrs["level"] for s in mine.values() if s.name == "amg.cycle")
    # one V-cycle a preconditioner application on every level, the
    # coarsest's being its solve
    assert cycles == {l: its + 1 for l in range(len(M.levels))}
    smooths = Counter((s.attrs["level"], s.attrs["phase"]) for s in mine.values()
                      if s.name == "amg.smooth")
    smoothed = range(len(M.levels) - 1)
    assert smooths == {(l, p): its + 1 for l in smoothed for p in ("pre", "post")}
    root = next(i for i, s in mine.items() if s.name == "cg")
    assert all(s.request == root for s in mine.values())
    for s in mine.values():
        if s.name in ("cg.converged", "amg.cycle") and s.attrs.get("level", 0) == 0:
            assert s.parent == root
    assert all(s.launches == 0 for s in mine.values())  # no kernel on the CPU


def test_hpcg_flat_set_spans():
    mg = HPCGMGPreconditioner((16, 16, 16), (1, 1, 1), SerialBackend(1), n_levels=4,
                              dtype=np.float64, device="cpu")
    first = len(profiling.spans())
    _, spans = _recorded(lambda: hpcg_cg_flat(mg, mg.b, iterations=10))
    mine = _new(spans, first)
    _assert_nested(mine)
    assert Counter(s.name for s in mine.values() if s.name != "mg.level") == {"hpcg.cg": 1}
    levels = Counter(s.attrs["level"] for s in mine.values() if s.name == "mg.level")
    assert levels == {l: 11 for l in range(4)}
    # each level's visit inside the next finer level's (the finest: the set)
    for s in mine.values():
        if s.name == "mg.level" and s.attrs["level"] < 3:
            assert mine[s.parent].attrs["level"] == s.attrs["level"] + 1


def test_amg_setup_spans():
    nodes = (4, 4, 4)
    A = psparse(*linear_elasticity_fem(nodes, (1, 1, 1)), SerialBackend(1), device="cpu")
    coords, _ = node_coordinates_unit_cube(nodes, (1, 1, 1))
    ns = nullspace_linear_elasticity(coords, A.row_prange)
    first = len(profiling.spans())
    M, spans = _recorded(lambda: AMGPreconditioner(
        A, AMGParams(coarse_size=30, block_size=3, max_levels=4), nullspace=ns))
    mine = _new(spans, first)
    _assert_nested(mine)
    setup = next(i for i, s in mine.items() if s.name == "amg.setup")
    phases = Counter((s.name, s.attrs.get("level")) for s in mine.values()
                     if s.parent == setup)
    coarsened = range(len(M.levels) - 1)
    want = {(n, l): 1 for l in coarsened for n in (
        "amg.aggregate", "amg.tentative", "amg.spectral_radius", "amg.galerkin",
        "amg.smoother_build")}
    want.update({("amg.coarse_factorize", None): 1, ("amg.freeze", None): 1})
    assert phases == want


def test_trace_writes_spans_on_the_trace_clock(tmp_path):
    x = torch.randn(256, 256)
    with profiling.trace(tmp_path, device="cpu"):
        for _ in range(3):  # the first call of a region pays the profiler's set-up
            with profiling.span("pat_clock", level=7):
                with record_function("pat_clock_rf"):
                    x @ x
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    spans = [e for e in events if e.get("cat") == profiling.SPAN_CAT]
    regions = [e for e in events if e.get("name") == "pat_clock_rf" and e.get("ph") == "X"
               and e.get("cat") != "gpu_user_annotation"]
    assert [e["name"] for e in spans] == ["pat_clock"] * 3 and len(regions) == 3
    assert all(e["args"]["level"] == 7 and e["args"]["launches"] == 0 for e in spans)
    assert [e["args"]["index"] for e in spans] == [0, 1, 2]  # trace() starts with none
    by_start = lambda e: e["ts"]  # noqa: E731
    # each region inside its span on the trace's clock, with 50 us of slack
    # for the two clocks' offset (under ~5 us on the card's host): a thread
    # delayed between the span's and the region's edges only widens the margin
    slack = 50.0
    for s, r in zip(sorted(spans, key=by_start), sorted(regions, key=by_start)):
        assert s["ts"] - slack <= r["ts"]
        assert r["ts"] + r["dur"] <= s["ts"] + s["dur"] + slack


def test_launch_counter_at_the_c_entry_check():
    before = profiling.launches(), profiling.launches("pat_entry")
    _build.check(0, "pat_entry")
    _build.check(0, "pat_entry")
    assert (profiling.launches(), profiling.launches("pat_entry")) == (before[0] + 2,
                                                                       before[1] + 2)
    with pytest.raises(RuntimeError, match="pat_entry: CUDA error 719"):
        _build.check(719, "pat_entry")
    assert profiling.launches("pat_other") == 0


def test_exchange_counter_on_eight_parts():
    A, _ = build_hpcg_problem((4, 4, 4), (2, 2, 2), SerialBackend(8), device="cpu")
    lay = A.col_layout()
    n_ghost = int(lay.n_ghost.sum())  # one value a ghost, each way
    assert n_ghost > 0
    own = torch.randn(8, lay.n_own_pad, dtype=torch.float64)
    ghost = torch.zeros(8, lay.n_ghost_pad, dtype=torch.float64)
    before = Counter(profiling.COUNTS)
    lay.consistent_plan.apply(own, ghost, "set")
    lay.assemble_plan.apply(ghost, own, "add")
    lay.assemble_plan.apply(ghost.float(), own.float(), "add")
    grew = Counter(profiling.COUNTS)
    grew.subtract(before)
    assert {k: v for k, v in grew.items() if k.startswith("exchange")} == {
        "exchanges.set": 1, "exchange_bytes.set": 8 * n_ghost,
        "exchanges.add": 2, "exchange_bytes.add": (8 + 4) * n_ghost,
    }
