"""The HPCG cell on a grid of parts on the CPU at a tiny size: a whole run
of the harness comes out correct, a planted fault in the ghost coupling and
the float32 control do not; the geometry's own-ghost block is the port's;
the new span metrics read their spans on a synthetic trace and None
without them."""
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from portbench import run, spans  # noqa: E402
from portbench.tracing import Trace  # noqa: E402
from portbench.work_parts import k5_bound_s, own_ghost  # noqa: E402
from test_portbench_spans import BASE, KERNELS, _launch, _read, _span, _window  # noqa: E402

BENCH = run.load_json(ROOT / "BENCHMARK.json")
CELL = {c["name"]: c for c in BENCH["workloads"]}["hpcg.parts8x128"]
TINY = {"local_grid": [8, 8, 8], "levels": 3, "iterations_per_set": 10}
METRICS = ("exchange_ms_per_set.hpcg_parts", "ghost_ms_per_set.hpcg_parts",
           "ghost_roofline.hpcg_parts")


def _run(**override):
    entry = {c["name"]: c for c in BENCH["configs"]}[CELL["config"]]
    config = dict(run.load_json(ROOT / entry["file"]), **TINY, **override)
    mix = run.load_json(run.PB / "traffic" / f"{CELL['traffic']}.json")
    result, lines = run.run_cell(BENCH, CELL, config, mix, 2**31 + 11, 0.05, False,
                                 torch.device("cpu"), time.perf_counter())
    json.dumps(result)
    return result


def test_sound_run_is_correct():
    result = _run()
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"hpcg_gflops", "setup_s"}
    assert all(v["value"] <= v["limit"] for v in result["checks"].values())


def test_control_one_precision_below_is_not_correct():
    result = _run(dtype="float32")
    assert not result["correct"]
    assert result["checks"]["history_gap"]["value"] > result["checks"]["history_gap"]["limit"]


def test_post_smooth_without_its_ghost_term_is_caught(monkeypatch):
    from partitionedarrays_tpu_torch.models.hpcg.mg import HPCGMGPreconditioner

    real = HPCGMGPreconditioner._cycle_flat_g

    def faulty(self, l, b):
        if l != 1:
            return real(self, l, b)
        gs = self.gss[l]
        bd0 = gs.make_bd(b)
        xflat = gs.smooth_bd(None, bd0)
        gc = gs.ghost_contrib(gs.flat_interleave(xflat))
        r_std = gs.flat_interleave(gs.flat_residual(xflat, bd0)) - gc
        xc = self._cycle(l - 1, self._restrict(l, r_std))
        xflat = gs.flat_add_std(xflat, self._prolong(l, xc.own, r_std.shape[1]))
        return gs.smooth_bd(xflat, bd0)  # the post-smooth's ghost term left out

    monkeypatch.setattr(HPCGMGPreconditioner, "_cycle_flat_g", faulty)
    result = _run()
    assert result["failed"] == 0 and not result["correct"]
    assert result["checks"]["history_gap"]["value"] > result["checks"]["history_gap"]["limit"]


def test_one_part_is_refused():
    with pytest.raises(ValueError, match="flat_g"):
        _run(parts_per_dir=[1, 1, 1])


@pytest.mark.parametrize("local, parts", [((8, 8, 8), (2, 2, 2)), ((4, 6, 8), (2, 2, 2)),
                                          ((8, 8, 8), (1, 2, 3))])
def test_own_ghost_geometry_is_the_ports_block(local, parts):
    import numpy as np

    from partitionedarrays_tpu_torch.backends import SerialBackend
    from partitionedarrays_tpu_torch.models.hpcg.problem import build_hpcg_problem

    A, _ = build_hpcg_problem(local, parts, SerialBackend(int(np.prod(parts))), device="cpu")
    oh = A.device().oh
    assert own_ghost(local, parts) == {"entries": int((oh.cols >= 0).sum()),
                                      "ghosts": int(A.col_layout().n_ghost.sum()),
                                      "rows": int((oh.rows >= 0).sum())}


def test_readers_none_without_their_spans(tmp_path, monkeypatch):
    recorded = [_span("hpcg.cg", 100, 900), _span("mg.level", 200, 500, parent=0, level=1)]
    got, _ = _read(tmp_path, monkeypatch, CELL["name"], KERNELS, recorded, METRICS)
    assert got == {m: None for m in METRICS}
    got, _ = _read(tmp_path, monkeypatch, CELL["name"], KERNELS, None, METRICS)
    assert got == {m: None for m in METRICS}


def test_readers_on_their_spans(tmp_path, monkeypatch):
    # one set: a ghost coupling of level 1 [200, 500) with its exchange [210, 300);
    # the exchange's copy, then K5 from the ghost span, then K5 from the set
    recorded = [_span("hpcg.cg", 100, 900), _span("ghost", 200, 500, parent=0, level=1),
                _span("exchange", 210, 300, parent=1, combine="set")]
    events = _window(_launch(220, 230, 40, 1, "Memcpy DtoD"),
                     _launch(320, 330, 50, 2, "void ghost_spmv_kernel<double, 8>(int)"),
                     _launch(600, 610, 30, 3, "void ghost_spmv_kernel<double, 8>(int)"))
    (tmp_path / f"trace_{CELL['name']}.json").write_text(
        json.dumps({"baseTimeNanoseconds": BASE, "traceEvents": events}))
    monkeypatch.setattr(spans, "BUILD", tmp_path)
    monkeypatch.setattr(spans, "_program_spans", lambda: recorded)
    lev = dict(own_ghost((8, 8, 8), (2, 2, 2)), value_bytes=8, vector_bytes=8)
    runs = SimpleNamespace(cell=CELL["name"], trace=Trace(events), traced_units=[3],
                           facts={"ghost_levels": {1: lev}})
    got = {m: run.load_module(run.PB / "metrics" / f"{m}.py").read(runs) for m in METRICS}
    assert got["exchange_ms_per_set.hpcg_parts"] == pytest.approx(0.040)
    assert got["ghost_ms_per_set.hpcg_parts"] == pytest.approx(0.090)
    assert got["ghost_roofline.hpcg_parts"] == pytest.approx(
        100 * k5_bound_s(lev, 8, 8) / 50e-6)
