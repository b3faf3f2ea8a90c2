"""The AMG cycle's CUDA graph (``AMGPreconditioner.__call__``) on the CPU,
where it never engages: every call runs the cycle eagerly, leaves no graph
and tags its level-0 ``amg.cycle`` span ``graph="eager"``; setup and
``update`` empty the graph cache; ``graph_engages`` is false for a CPU
tensor, a backend of several processes, a capturing stream, a forward-AD
level and a gradient.  The dispatch of the captured path (the first call
captured, later ones replayed, a refused capture eager from then on, a
refill starting over) and a replay's counters and fresh output run here
through a stand-in for the capture whose "graph" runs the eager cycle into
the static output.  The cycle on the card is held by
``tests/test_torch_amg_graph_gpu.py``."""
from collections import Counter
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import forward_ad
from torch.profiler import ProfilerActivity, profile

from partitionedarrays_tpu_torch.backends import SerialBackend
from partitionedarrays_tpu_torch.models.gallery import (
    linear_elasticity_fem, node_coordinates_unit_cube, nullspace_linear_elasticity)
from partitionedarrays_tpu_torch.psparse import psparse, psparse_refill, spmv
from partitionedarrays_tpu_torch.pvector import PVector, pones
from partitionedarrays_tpu_torch.solvers import amg
from partitionedarrays_tpu_torch.solvers.amg import AMGParams, AMGPreconditioner, graph_engages
from partitionedarrays_tpu_torch.solvers.krylov import cg
from partitionedarrays_tpu_torch.solvers.smoothers import GaussSeidel
from partitionedarrays_tpu_torch.utils import profiling

torch.set_num_threads(1)
@pytest.fixture(scope="module", autouse=True)
def _one_blas_thread():
    from threadpoolctl import threadpool_limits

    with threadpool_limits(1):
        yield


def _elasticity(nodes=(5, 5, 5), reuse=False):
    I, J, V, rows, cols = linear_elasticity_fem(nodes, (1, 1, 1))
    out = psparse(I, J, V, rows, cols, SerialBackend(1), reuse=reuse, device="cpu")
    A, cache = out if reuse else (out, None)
    coords, _ = node_coordinates_unit_cube(nodes, (1, 1, 1))
    M = AMGPreconditioner(A, AMGParams(coarse_size=30, block_size=3, max_levels=4),
                          nullspace=nullspace_linear_elasticity(coords, A.row_prange))
    b = spmv(A, pones(A.col_prange, A.backend, dtype=A.dtype, device="cpu"))
    return A, M, b, (V, cache)


@pytest.fixture(scope="module")
def case():
    return _elasticity()


def _tags(M, b, calls):
    """The ``graph`` tags of ``calls`` calls' level-0 cycles, and their outputs."""
    first = len(profiling.spans())
    with profile(activities=[ProfilerActivity.CPU]):
        outs = [M(b) for _ in range(calls)]
    tags = [s.attrs["graph"] for s in profiling.spans()[first:]
            if s.name == "amg.cycle" and s.attrs["level"] == 0 and "graph" in s.attrs]
    return tags, outs


def test_cpu_calls_run_eagerly_and_are_counted(case):
    """Each call runs the eager cycle and counts its launches as a direct
    call does; no graph is kept."""
    A, M, b, _ = case
    z = M(b)
    assert torch.equal(z.own, M._cycle(0, b, False).own)
    before = profiling.COUNTS.copy()
    M(b)
    direct = profiling.COUNTS.copy()
    M._cycle(0, b, False)
    assert profiling.COUNTS - direct == direct - before  # one cycle's launches, as a direct call
    cg(A, b, M=M, rtol=1e-8, maxiter=2)
    assert M._graphs == {}


def test_cpu_level0_span_is_tagged_eager(case):
    A, M, b, _ = case
    first = len(profiling.spans())
    with profile(activities=[ProfilerActivity.CPU]):
        M(b), M(b)
        M._cycle(0, b, False)  # a direct call carries no tag
    cycles = [s for s in profiling.spans()[first:] if s.name == "amg.cycle"]
    tags = Counter((s.attrs["level"], s.attrs.get("graph")) for s in cycles)
    assert tags[(0, "eager")] == 2 and tags[(0, None)] == 1
    assert all(s.attrs.get("graph") is None for s in cycles if s.attrs["level"] > 0)


def test_setup_and_update_advance_the_generation():
    """Setup and ``update`` start a new generation of the hierarchy: the
    graph cache is emptied, so no older graph can replay."""
    A, M, b, (V, cache) = _elasticity(reuse=True)
    M._graphs[("stale",)] = amg._EAGER
    psparse_refill(A, [v * 1.5 for v in V], cache)
    M.update(A)
    assert M._graphs == {}
    M._graphs[("stale",)] = amg._EAGER
    M._setup(A, reuse_aggregates=True)
    assert M._graphs == {}


def _stand_in(requires_grad=False, backend=None):
    """A vector's stand-in on a CUDA device (no card here)."""
    t = SimpleNamespace(device=torch.device("cuda"), requires_grad=requires_grad)
    return SimpleNamespace(own=t, ghost=SimpleNamespace(device=t.device, requires_grad=False),
                           backend=backend or SerialBackend(8))


def test_engages_on_a_cuda_input_of_one_process(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    assert graph_engages(_stand_in())


@pytest.mark.parametrize("why", ["cpu", "multiprocess", "capturing", "forward_ad", "grad"])
def test_engagement_is_false(monkeypatch, case, why):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: why == "capturing")
    if why == "cpu":
        assert not graph_engages(case[2])
        return
    r = _stand_in(requires_grad=why == "grad",
                  backend=SimpleNamespace(is_multiprocess=True) if why == "multiprocess" else None)
    if why == "forward_ad":
        with forward_ad.dual_level():
            assert not graph_engages(r)
        assert graph_engages(r)
        return
    assert not graph_engages(r)


class _StandInGraph:
    """A "graph" whose replay runs the eager cycle on the static input into
    the static output, as a captured cycle would."""

    def __init__(self, M, x, w, like):
        self.M, self.x, self.w = M, x, w
        self.z = PVector(torch.zeros_like(like.own), torch.zeros_like(like.ghost),
                         like.layout, like.backend)
        self.replays = 0

    def replay(self):
        self.replays += 1
        z = self.M._cycle(0, self.x, self.w)
        self.z.own.copy_(z.own)
        self.z.ghost.copy_(z.ghost)


@pytest.fixture
def captured(monkeypatch):
    """The 5^3 elasticity preconditioner with every input engaging and the
    capture replaced by ``_StandInGraph`` (its launches: a K3 and a K6)."""
    A, M, b, _ = _elasticity()
    monkeypatch.setattr(amg, "graph_engages", lambda r: True)
    made = []

    def capture(r, w):
        x = PVector(r.own.clone(), r.ghost.clone(), r.layout, r.backend)
        out = M._cycle(0, x, w)  # the warm-up, which the call returns
        g = _StandInGraph(M, x, w, out)
        made.append(g)
        counts = Counter({"launches": 2, "launches.gs_sweeps": 1, "launches.tile_gs_sweeps": 1})
        return amg._CycleGraph(g, x, g.z, counts, M._hierarchy()), out

    monkeypatch.setattr(M, "_capture", capture)
    return A, M, b, made


def test_dispatch_eager_then_capture_then_replay(captured, monkeypatch):
    """A call that does not engage runs eagerly; the first engaging call of
    a key captures (and returns its warm-up cycle), the later ones replay."""
    A, M, b, made = captured
    want = M._cycle(0, b, False).own
    monkeypatch.setattr(amg, "graph_engages", lambda r: False)
    eager, first = _tags(M, b, 1)
    monkeypatch.setattr(amg, "graph_engages", lambda r: True)
    tags, outs = _tags(M, b, 4)
    assert eager + tags == ["eager", "capture", "replay", "replay", "replay"]
    assert len(made) == 1 and made[0].replays == 3
    assert torch.equal(first[0].own, want)
    for z in outs:
        assert torch.equal(z.own, want)
    # each call's output is its own storage
    ptrs = {z.own.data_ptr() for z in outs} | {z.ghost.data_ptr() for z in outs if z.ghost.numel()}
    assert len(ptrs) == len(outs) + sum(z.ghost.numel() > 0 for z in outs)
    assert made[0].z.own.data_ptr() not in ptrs


def test_a_replay_credits_its_capture_counts(captured):
    A, M, b, made = captured
    before = profiling.COUNTS.copy()
    M(b)  # the capture: nothing of the recorded counts is credited
    assert profiling.COUNTS == before
    M(b)
    before = profiling.COUNTS.copy()
    M(b)
    diff = {k: profiling.COUNTS[k] - before[k] for k in profiling.COUNTS
            if k.startswith("launches") and profiling.COUNTS[k] != before[k]}
    assert diff == {"launches": 2, "launches.gs_sweeps": 1, "launches.tile_gs_sweeps": 1}


def test_replay_and_capture_spans_are_tagged(captured):
    A, M, b, made = captured
    first = len(profiling.spans())
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            M(b)
    cycles = [s for s in profiling.spans()[first:] if s.name == "amg.cycle"]
    assert [s.attrs.get("graph") for s in cycles if "graph" in s.attrs] == [
        "capture", "replay", "replay"]
    # only the level-0 cycle of a call carries the tag
    assert all(s.attrs["level"] == 0 for s in cycles if "graph" in s.attrs)


def test_a_refused_capture_leaves_the_key_eager(captured, monkeypatch):
    A, M, b, made = captured
    monkeypatch.setattr(M, "_capture", lambda r, w: (amg._EAGER, M._cycle(0, r, w)))
    want = M._cycle(0, b, False).own
    tags, outs = _tags(M, b, 4)
    assert tags == ["capture", "eager", "eager", "eager"]
    for z in outs:
        assert torch.equal(z.own, want)
    assert list(M._graphs.values()) == [amg._EAGER]


def test_a_refill_or_update_starts_over(captured):
    A, M, b, made = captured
    tags, _ = _tags(M, b, 3)
    A.invalidate_device()  # a refill's mark: the frozen blocks restack
    more, _ = _tags(M, b, 2)
    assert len(made) == 2 and len(M._graphs) == 1
    M._drop_graphs()
    last, _ = _tags(M, b, 1)
    assert tags + more + last == ["capture", "replay", "replay", "capture", "replay", "capture"]
    assert len(made) == 3


def test_a_swapped_smoother_captures_anew(captured):
    """A level's smoother replaced after a capture (a new object, as a
    user's or a check's swap of tiers): the next call captures the new
    hierarchy, and the older graph and its objects are let go."""
    A, M, b, made = captured
    tags, _ = _tags(M, b, 2)
    lev = M.levels[0]
    old = lev.smoother
    lev.smoother = GaussSeidel(lev.A, old.iterations, "symmetric")
    more, outs = _tags(M, b, 2)
    assert tags + more == ["capture", "replay", "capture", "replay"]
    assert len(made) == 2 and len(M._graphs) == 1
    assert old not in list(M._graphs.values())[0].hierarchy
    assert torch.equal(outs[-1].own, M._cycle(0, b, False).own)
