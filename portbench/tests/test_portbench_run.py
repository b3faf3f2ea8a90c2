"""Whole runs of the harness on the CPU at tiny sizes (the look for a card
skipped): sound runs come out correct; the control (the port's float32
path) and the faults planted in the timed path come out not correct."""
import json
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
TINY = {
    "hpcg.256": {"local_grid": [16, 16, 16], "iterations_per_set": 10},
    "amg_elasticity.40": {"nodes_per_dir": [5, 5, 5],
                          "amg": {"coarse_size": 30, "block_size": 3, "max_levels": 4}},
}


def _run(name, seed=2**31 + 7, **override):
    cell = CELLS[name]
    entry = {c["name"]: c for c in BENCH["configs"]}[cell["config"]]
    config = dict(run.load_json(ROOT / entry["file"]), **TINY[name], **override)
    mix = run.load_json(run.PB / "traffic" / f"{cell['traffic']}.json")
    result, lines = run.run_cell(BENCH, cell, config, mix, seed, 0.05, False,
                                 torch.device("cpu"), time.perf_counter())
    json.dumps(result)  # the result line is JSON
    return result, lines


@pytest.mark.parametrize("name", sorted(TINY))
def test_sound_run_is_correct(name):
    result, lines = _run(name)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "checks"
    assert {m["name"] for m in BENCH["end_to_end"] if name in m.get("workloads", [name])} \
        == set(result["metrics"])
    assert all(v["value"] <= v["limit"] for v in result["checks"].values())
    assert lines[-1].startswith("check failed_units")


def test_same_seed_same_inputs():
    from portbench import generator

    mix = {"rhs": {"dist": "normal", "pool": 3}}
    a = generator.rhs_pool(mix, 10, 2**31 + 99, "cpu")
    assert torch.equal(a, generator.rhs_pool(mix, 10, 2**31 + 99, "cpu"))
    assert not torch.equal(a, generator.rhs_pool(mix, 10, 2**31 + 98, "cpu"))


@pytest.mark.parametrize("name", sorted(TINY))
def test_control_one_precision_below_is_not_correct(name):
    result, _ = _run(name, dtype="float32")
    assert not result["correct"]
    assert any(v["value"] > v["limit"] for v in result["checks"].values())


def _fault(kind):
    def alter(own):
        if kind == "unchanged":
            return torch.zeros_like(own)
        if kind == "altered":
            return own * (1 + 1e-6)
        out = own.clone()  # "half": the second half of the rows left out
        out[:, own.shape[1] // 2:] = 0
        return out
    return alter


@pytest.mark.parametrize("kind", ["unchanged", "altered", "half"])
def test_faults_in_the_hpcg_set_are_caught(monkeypatch, kind):
    from partitionedarrays_tpu_torch.models.hpcg import cg as hcg
    from partitionedarrays_tpu_torch.pvector import PVector

    real, alter = hcg.hpcg_cg_flat, _fault(kind)

    def faulty(mg, b, iterations=50):
        x, norms = real(mg, b, iterations=iterations)
        if kind == "unchanged":  # the state returned as it came: x0, |r0|
            norms = torch.full_like(norms, float(norms[0]))
        return PVector(alter(x.own), x.ghost, x.layout, x.backend), norms

    monkeypatch.setattr(hcg, "hpcg_cg_flat", faulty)
    result, _ = _run("hpcg.256")
    assert not result["correct"]


@pytest.mark.parametrize("kind", ["unchanged", "altered", "half"])
def test_faults_in_the_amg_solve_are_caught(monkeypatch, kind):
    from partitionedarrays_tpu_torch.pvector import PVector
    from partitionedarrays_tpu_torch.solvers import krylov

    real, alter = krylov.cg, _fault(kind)

    def faulty(A, b, **kw):
        x, info = real(A, b, **kw)
        return PVector(alter(x.own), x.ghost, x.layout, x.backend), info

    monkeypatch.setattr(krylov, "cg", faulty)
    result, _ = _run("amg_elasticity.40")
    assert not result["correct"]


def test_narrow_hpcg_values_are_caught(monkeypatch):
    """HPCG's 26 and -1 are exact in float32, so a smoother that stores
    them narrower leaves the history and x as they are: the stated
    precision is held by the stored types."""
    from partitionedarrays_tpu_torch.models.hpcg import mg

    real = mg.HPCGMGPreconditioner
    monkeypatch.setattr(mg, "HPCGMGPreconditioner",
                        lambda *a, **kw: real(*a, precond_dtype="float32", **kw))
    result, _ = _run("hpcg.256")
    assert not result["correct"]
    assert result["checks"]["values_bits_short"]["value"] == 32
    assert result["checks"]["x_gap"]["value"] <= result["checks"]["x_gap"]["limit"]


def test_narrow_amg_smoother_values_are_caught(monkeypatch):
    from partitionedarrays_tpu_torch.solvers import amg

    real = amg.GaussSeidel
    monkeypatch.setattr(amg, "GaussSeidel",
                        lambda *a, **kw: real(*a, values_dtype=torch.float32, **kw))
    result, _ = _run("amg_elasticity.40")
    assert not result["correct"]
    assert result["checks"]["values_bits_short"]["value"] == 32


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this sandbox test needs a machine without a card")
    assert run.main(["--workload", "hpcg.256", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
