"""Whole traced runs of the harness on the card at small sizes: correct, and
every per-layer metric of the cell read from the trace.  Skipped without a
card (decided in the fixture)."""
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import run  # noqa: E402

BENCH = run.load_json(ROOT / "BENCHMARK.json")
CELLS = {c["name"]: c for c in BENCH["workloads"]}
SMALL = {
    "hpcg.256": {"local_grid": [64, 64, 64]},
    "amg_elasticity.40": {"nodes_per_dir": [16, 16, 16]},
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SMALL))
def test_traced_run_on_the_card(card, name):
    cell = CELLS[name]
    entry = {c["name"]: c for c in BENCH["configs"]}[cell["config"]]
    config = dict(run.load_json(ROOT / entry["file"]), **SMALL[name])
    mix = run.load_json(run.PB / "traffic" / f"{cell['traffic']}.json")
    result, _ = run.run_cell(BENCH, cell, config, mix, 2**31 + 3, 1.0, True, card,
                             time.perf_counter())
    assert result["correct"], result["checks"]
    assert result["device"]["busy_s"] > 0 and result["device"]["window_s"] > 0
    wanted = {m["name"] for m in run.cell_metrics(BENCH, name, "per_layer")}
    assert wanted == set(result["metrics"])
    for m in result["metrics"]:
        if m.endswith("roofline") or "_roofline." in m:
            assert 0 < result["metrics"][m]["value"] <= 105
