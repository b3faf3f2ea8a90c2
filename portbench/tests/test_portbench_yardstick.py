"""The benchmark's yardstick on the CPU: the frozen FLOP model, the sweeps'
work, the trace reductions, and BENCHMARK.json against the files the
harness finds by name."""
import json
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import work  # noqa: E402
from portbench.hpcg_flops import flops, stencil27_nnz  # noqa: E402
from portbench.tracing import Trace  # noqa: E402

PB = ROOT / "portbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("n", [16, 32])
def test_flop_model_equals_the_ports_report(n):
    import numpy as np

    from partitionedarrays_tpu_torch.backends import SerialBackend
    from partitionedarrays_tpu_torch.models.hpcg.mg import HPCGMGPreconditioner
    from partitionedarrays_tpu_torch.models.hpcg.report import HPCGReport

    mg = HPCGMGPreconditioner((n, n, n), (1, 1, 1), SerialBackend(1), n_levels=4,
                              dtype=np.float64, device="cpu")
    nnz_levels = mg.nnz_per_level()  # coarsest first, the port's own counts
    report = HPCGReport(nrow=mg.A.shape[0], nnz=mg.A.nnz(), nnz_per_level=nnz_levels,
                        iterations=50, ref_iterations=50, n_sets=3, time_solve=1.0)
    shapes = [(n >> l,) * 3 for l in range(4)][::-1]
    mine = flops(n ** 3, stencil27_nnz((n,) * 3), [stencil27_nnz(s) for s in shapes], 50, 3)
    assert nnz_levels == [stencil27_nnz(s) for s in shapes]
    assert mine["total"] == report.flops()["total"]


def test_pass_work_hand_counted():
    # 10 rows, 28 entries, float64 values and vectors, banded: 28 * 8 bytes
    # of values and 4 vectors of 10 * 8 bytes; from a zero guess 3 vectors
    assert work.pass_work(10, 28, 8, 8, True, False) == (28 * 8 + 4 * 80, 2 * 28 + 2 * 10)
    assert work.pass_work(10, 28, 8, 8, True, True) == (28 * 8 + 3 * 80, 2 * 28 + 2 * 10)
    # not banded: a 4-byte column index an entry; float32 values
    assert work.pass_work(10, 28, 4, 8, False, False) == (28 * 8 + 4 * 80, 2 * 28 + 2 * 10)


def test_smoother_work_sums_each_pass():
    lev = {"rows": 10, "nnz": 28, "value_bytes": 8, "vector_bytes": 8, "banded": True,
           "applications": [(True, 2), (False, 2)]}
    nbytes, ops = work.smoother_work([lev])
    # four passes of values; vectors 3 + 4 (first call) and 4 + 4 (second)
    assert nbytes == 4 * 28 * 8 + (3 + 4 + 4 + 4) * 80
    assert ops == 4 * (2 * 28 + 2 * 10)
    coarse = dict(lev, applications=[(True, 2)])
    assert work.smoother_work([lev, coarse])[0] == nbytes + 2 * 28 * 8 + (3 + 4) * 80


def test_bound_takes_the_larger_of_bytes_and_operations():
    assert work.bound_s(3.35e12, 1.0, 8) == pytest.approx(1.0)
    assert work.bound_s(1.0, 34e12, 8) == pytest.approx(1.0)
    assert work.bound_s(1.0, 67e12, 4) == pytest.approx(1.0)


def _event(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _synthetic_trace():
    # window [100, 200) us; kernels at [110, 130) and [120, 140) overlap,
    # [160, 170); a memset at [175, 180); one kernel outside the window
    return [
        _event("user_annotation", "portbench.traced_window", 100.0, 100.0),
        _event("gpu_user_annotation", "portbench.traced_window", 100.0, 100.0),
        _event("kernel", "void gs_seq_grid_kernel<double, double, 4>(double const*)", 110.0, 20.0),
        _event("kernel", "ax_core_rows_kernel<double>", 120.0, 20.0),
        _event("kernel", "void (anonymous namespace)::gs_seq_grid_kernel<double, double, 4>("
               "double const*)", 160.0, 10.0),
        _event("gpu_memset", "Memset (Device)", 175.0, 5.0),
        _event("kernel", "late_kernel", 250.0, 5.0),
        _event("cpu_op", "aten::item", 140.0, 15.0),
        _event("cuda_runtime", "cudaStreamSynchronize", 141.0, 13.0),
        _event("cpu_op", "aten::add", 185.0, 10.0),
    ]


def test_trace_reductions_on_a_synthetic_event_list():
    t = Trace(_synthetic_trace())
    assert t.window_s == pytest.approx(100e-6)
    assert t.launches() == 4
    # busy: [110, 140) + [160, 170) + [175, 180) = 45 us
    assert t.busy_s() == pytest.approx(45e-6)
    assert t.idle_pct() == pytest.approx(55.0)
    assert t.device_s(("gs_seq_grid_kernel",)) == pytest.approx(30e-6)
    assert t.gaps() == [(100.0, 110.0), (140.0, 160.0), (170.0, 175.0), (180.0, 200.0)]
    b = t.breakdown()
    assert b["device_ops"][0] == ["gs_seq_grid_kernel<double, double, 4>", pytest.approx(30e-6)]
    gaps = dict((k, v) for k, v in b["idle_gaps"])
    # the gap [140, 160) has its middle in the synchronise, inside aten::item
    assert gaps["cudaStreamSynchronize"] == pytest.approx(20e-6)
    assert gaps["aten::add"] == pytest.approx(20e-6)
    assert gaps["host idle"] == pytest.approx(15e-6)


def test_trace_window_from_the_runtime_calls_without_the_annotation():
    events = [e for e in _synthetic_trace() if e["cat"] != "user_annotation"]
    events += [_event("cuda_runtime", "cudaLaunchKernel", 100.0, 2.0),
               _event("cuda_runtime", "cudaDeviceSynchronize", 185.0, 15.0)]
    t = Trace(events)
    assert (t.t0, t.t1) == (100.0, 200.0)
    assert t.launches() == 4 and t.busy_s() == pytest.approx(45e-6)


def test_trace_without_a_window_is_refused():
    with pytest.raises(ValueError):
        Trace([_event("kernel", "k", 0.0, 1.0)])


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_names_and_files():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        data = json.loads((ROOT / c["file"]).read_text())
        assert all(k in data for k in c["reduced"])
        assert (PB / "systems" / f"{data['kind']}.py").is_file()
        assert (PB / "reference" / f"{data['kind']}.py").is_file()
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert (PB / "e2e" / f"{m['name']}.py").is_file()
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert (PB / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in e2e
    for cell in BENCH["workloads"]:
        assert NAME.match(cell["name"]) and cell["config"] in configs and cell["chips"] in (1, 4)
        assert (PB / "traffic" / f"{cell['traffic']}.json").is_file()
        mine = [m for m in BENCH["end_to_end"]
                if cell["name"] in m.get("workloads", [cell["name"]])]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        layer = [m for m in BENCH["per_layer"] if cell["name"] in m.get("workloads", ())]
        assert layer and all(cell["name"] in e2e[m["moves"]].get("workloads", [cell["name"]])
                             for m in layer)
