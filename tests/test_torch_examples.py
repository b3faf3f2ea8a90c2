"""The port's examples (``examples/torch_*.py``, ``torch_per_process_example``
among them) on the CPU against the JAX package's examples they follow: the same problem, the same iteration
counts, the reference's acceptance checks.  The JAX examples run in this
process (Pallas off) and their printed lines are read.

``reuse_example``: the JAX example's cached CG keeps the first hierarchy's
box-level D^-1 after ``M.update`` (ROADMAP Queue 3), so it takes 10, 12
and 12 iterations; with its compiled programs cleared before each solve
it takes the port's 10, 10 and 10, with the same residuals."""
import os
import re
import runpy
import sys

import jax
import numpy as np
import pytest
import torch

import partitionedarrays_tpu as jax_pat
from partitionedarrays_tpu import config as jax_config

torch.set_num_threads(1)

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
sys.path.insert(0, EXAMPLES)


@pytest.fixture(scope="module", autouse=True)
def reference_without_pallas():
    saved = jax_config.use_pallas
    jax_config.use_pallas = False
    yield
    jax_config.use_pallas = saved


def _jax_example(name, capsys, monkeypatch=None, fresh_cg=False):
    """Run examples/<name>.py of the JAX package; its printed lines."""
    if fresh_cg:
        cg = jax_pat.cg

        def fresh(*args, **kwargs):
            jax.clear_caches()
            return cg(*args, **kwargs)

        monkeypatch.setattr(jax_pat, "cg", fresh)
    capsys.readouterr()
    ns = runpy.run_path(os.path.join(EXAMPLES, f"{name}.py"), run_name="not_main")
    if "main" in ns:
        ns["main"]()
    return capsys.readouterr().out


def _iters(out: str):
    return [int(k) for k in re.findall(r"iters=(\d+)", out)]


@pytest.mark.parametrize("name", ["fdm_example", "fem_example", "amg_example",
                                  "jacobi_tutorial"])
def test_example_matches_jax(name, capsys):
    mod = __import__(f"torch_{name}")
    got = mod.main(device="cpu")
    want = _jax_example(name, capsys)
    assert [got["iterations"]] == _iters(want)
    err = float(re.findall(r"\|(?:x-x\*|err)\|=([0-9.e+-]+)", want)[0])
    limit = 1e-10 if name == "jacobi_tutorial" else 1e-5
    assert got["error"] < limit and err < limit
    if name == "amg_example":
        stats = eval(re.findall(r"amg hierarchy: (\{.*\})", want)[0])
        assert got["statistics"] == stats


def test_reuse_example_matches_jax_with_fresh_cg(capsys, monkeypatch):
    import torch_reuse_example

    got = torch_reuse_example.main(device="cpu")
    want = _jax_example("reuse_example", capsys, monkeypatch, fresh_cg=True)
    assert got["iterations"] == _iters(want) == [10, 10, 10]
    relres = [float(r) for r in re.findall(r"relres=([0-9.e+-]+)", want)]
    np.testing.assert_allclose(got["relres"], relres, rtol=0.05)
    assert max(got["relres"]) < 1e-8


def test_per_process_example_matches_jax(capsys):
    """``torch_per_process_example``: per-process construction, ``spmm``,
    ``repartition_system`` and the AMG-CG as the JAX package's example: the
    same iterations, spmm nonzeros and repartitioned rows, |x - x*| < 1e-6."""
    import torch_per_process_example

    got = torch_per_process_example.main(device="cpu")
    want = _jax_example("per_process_example", capsys)
    assert [got["iterations"]] == _iters(want)
    assert got["spmm_nnz"] == int(re.findall(r"spmm nnz=(\d+)", want)[0])
    assert got["rows0"] == int(re.findall(r"part0=(\d+)", want)[0])
    assert got["error"] < 1e-6
