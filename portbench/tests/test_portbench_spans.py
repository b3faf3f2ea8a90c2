"""The span metrics' readers on a synthetic trace and synthetic spans (the
program's spans replaced): idle split at span edges, device operations
given to the span around their launching call by correlation, the idle
time closing, None without spans, and the spans of an earlier attempt
outside the window dropped."""
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import run as harness  # noqa: E402
from portbench import spans  # noqa: E402
from portbench.tracing import WINDOW, Trace  # noqa: E402

BASE = 1_790_000_000_000_000_000  # the trace's baseTimeNanoseconds
AMG = ("cycle_idle_ms.amg", "krylov_idle_ms.amg", "readback_wait_ms.amg",
       "host_us_per_launch.amg", "port_launches_per_solve.amg")


def _span(name, a, b, parent=-1, request=0, launches=0, **attrs):
    """A recorded span over [a, b) us of the trace's clock."""
    return SimpleNamespace(name=name, attrs=attrs, start_ns=BASE + int(a * 1000),
                           end_ns=BASE + int(b * 1000), parent=parent, request=request,
                           launches=launches)


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launch(ts, kernel_ts, dur, corr, name="k"):
    return [_x("cuda_runtime", "cudaLaunchKernel", ts, 5.0, corr),
            _x("kernel", name, kernel_ts, dur, corr)]


def _window(*ops):
    events = [_x("user_annotation", WINDOW, 0.0, 1000.0)]
    for op in ops:
        events += op
    return events


def _read(tmp_path, monkeypatch, cell, events, recorded, names):
    (tmp_path / f"trace_{cell}.json").write_text(
        json.dumps({"baseTimeNanoseconds": BASE, "traceEvents": events}))
    monkeypatch.setattr(spans, "BUILD", tmp_path)
    monkeypatch.setattr(spans, "_program_spans", lambda: recorded)
    run = SimpleNamespace(cell=cell, trace=Trace(events), traced_units=[7])
    out = {}
    for name in names:
        reader = harness.load_module(harness.PB / "metrics" / f"{name}.py")
        out[name] = reader.read(run)
    return out, run


# one solve: cg [100, 900) with a cycle [200, 500) (its smoother [250, 300))
# and the convergence test [800, 850); a retried attempt's solve long before
SOLVE = [
    _span("cg", 100, 900, launches=7),
    _span("amg.cycle", 200, 500, parent=0, level=0),
    _span("amg.smooth", 250, 300, parent=1, level=0, phase="pre"),
    _span("cg.converged", 800, 850, parent=0),
    _span("cg", -5000, -4000, request=4, launches=3),
]
KERNELS = _window(
    _launch(120, 150, 100, 1),   # from cg, runs on into the cycle
    _launch(260, 300, 100, 2),   # from the smoother
    _launch(550, 600, 100, 3),   # from cg after the cycle
    _launch(855, 860, 20, 4),    # from cg after the test
)


def test_idle_split_at_span_edges_and_closing(tmp_path, monkeypatch):
    got, run = _read(tmp_path, monkeypatch, "amg_elasticity.40", KERNELS, SOLVE, AMG)
    # gaps [0,150) [250,300) [400,600) [700,860) [880,1000): 680 us
    st = spans.of(run)
    assert sorted(st.named("cg")) == [0]  # the earlier attempt's solve dropped
    by = {st.label(i): round(us, 6) for i, us in st.idle_us.items()}
    assert by == {"(no span)": 200.0, "cg": 280.0, "amg.cycle level=0": 100.0,
                  "amg.smooth level=0 phase=pre": 50.0, "cg.converged": 50.0}
    assert got["cycle_idle_ms.amg"] == pytest.approx(0.150)
    assert got["krylov_idle_ms.amg"] == pytest.approx(0.330)
    outside = st.idle_us[spans.NONE] / 1e3
    idle_ms = (run.trace.window_s - run.trace.busy_s()) * 1e3
    assert got["cycle_idle_ms.amg"] + got["krylov_idle_ms.amg"] + outside == pytest.approx(idle_ms)
    assert got["readback_wait_ms.amg"] == pytest.approx(0.050)
    # (800 us of cg - 50 of its test) over its 4 operations
    assert got["host_us_per_launch.amg"] == pytest.approx(187.5)
    assert got["port_launches_per_solve.amg"] == 7


def test_device_work_goes_to_the_span_of_its_launching_call(tmp_path, monkeypatch):
    _, run = _read(tmp_path, monkeypatch, "amg_elasticity.40", KERNELS, SOLVE, ())
    st = spans.of(run)
    assert {st.label(i): us for i, us in st.device_us.items()} == {
        "cg": 220.0, "amg.smooth level=0 phase=pre": 100.0}
    assert {st.label(i): n for i, n in st.ops.items()} == {
        "cg": 3, "amg.smooth level=0 phase=pre": 1}
    assert st.launch_calls_outside == 0


def test_coarse_levels_device_ms_per_set(tmp_path, monkeypatch):
    # a set [50, 950); the finest level 3 holds 2, 2 holds 1, 1 holds 0
    recorded = [
        _span("hpcg.cg", 50, 950),
        _span("mg.level", 100, 900, parent=0, level=3),
        _span("mg.level", 200, 800, parent=1, level=2),
        _span("mg.level", 300, 700, parent=2, level=1),
        _span("mg.level", 400, 600, parent=3, level=0),
    ]
    events = _window(
        _launch(110, 120, 30, 1),   # level 3
        _launch(210, 220, 40, 2),   # level 2
        _launch(310, 320, 50, 3),   # level 1
        _launch(410, 420, 60, 4),   # level 0
        _launch(650, 660, 7, 5),    # level 1 again
        _launch(910, 915, 20, 6),   # the set's own
    )
    got, _ = _read(tmp_path, monkeypatch, "hpcg.256", events, recorded,
                   ("coarse_ms_per_set.hpcg",))
    assert got["coarse_ms_per_set.hpcg"] == pytest.approx((40 + 50 + 60 + 7) / 1e3)


@pytest.mark.parametrize("recorded", [None, [], [_span("cg", -5000, -4000)]])
def test_no_span_reads_none(tmp_path, monkeypatch, recorded):
    names = AMG + ("coarse_ms_per_set.hpcg",)
    got, _ = _read(tmp_path, monkeypatch, "amg_elasticity.40", KERNELS, recorded, names)
    assert got == {name: None for name in names}


def test_spans_of_another_kind_read_none(tmp_path, monkeypatch):
    got, _ = _read(tmp_path, monkeypatch, "amg_elasticity.40", KERNELS,
                   [_span("hpcg.cg", 100, 900)], AMG + ("coarse_ms_per_set.hpcg",))
    assert got == {name: None for name in AMG + ("coarse_ms_per_set.hpcg",)}


def test_the_programs_spans_are_read(monkeypatch):
    from partitionedarrays_tpu_torch.utils import profiling

    assert spans._program_spans() == profiling.spans()
