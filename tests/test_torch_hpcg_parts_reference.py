"""The port's HPCG set on a grid of parts (``hpcg_cg_flat_g``: the ghosted
V-cycle's hybrid Gauss-Seidel) against the benchmark's plain reference of
it (``portbench/reference/hpcg_parts.py``), float64 on the CPU; the one-part
reference and a float32 set told apart from it by the configuration's
limits; and the spans of the ghost coupling (``ghost``, ``exchange``) with
the counts the cycle implies."""
import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from partitionedarrays_tpu_torch.backends import SerialBackend
from partitionedarrays_tpu_torch.models.hpcg.cg import hpcg_cg_flat, hpcg_cg_flat_g
from partitionedarrays_tpu_torch.models.hpcg.mg import HPCGMGPreconditioner
from partitionedarrays_tpu_torch.utils import profiling
from portbench.layout import from_pvector, to_pvector
from portbench.reference import hpcg as ref_one
from portbench.reference import hpcg_parts as ref_parts

PARTS = (2, 2, 2)
CONFIG = json.loads((Path(__file__).resolve().parents[1] / "portbench" / "configs"
                     / "hpcg_parts8.json").read_text())
LIMITS = CONFIG["limits"]


@pytest.fixture(scope="module", autouse=True)
def _one_blas_thread():
    from threadpoolctl import threadpool_limits

    with threadpool_limits(1):
        yield


def _gaps(norms, x, n_ref, x_ref):
    return (float((norms.double() - n_ref).abs().max() / n_ref[0]),
            float((x - x_ref).norm() / x_ref.norm()))


def _port_set(n, levels, iterations, b, dtype=np.float64):
    mg = HPCGMGPreconditioner((n, n, n), PARTS, SerialBackend(8), n_levels=levels, dtype=dtype,
                              device="cpu")
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    x, norms = hpcg_cg_flat_g(mg, to_pvector(b, mg.A, tdtype), iterations=iterations)
    return from_pvector(x, mg.A), norms


def _rhs(n, seed):
    return torch.randn(8 * n ** 3, dtype=torch.float64, generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("n, seed", [(8, 3), (16, 4)])
def test_ghosted_set_equals_the_reference(n, seed):
    b = _rhs(n, seed)
    x, norms = _port_set(n, 4, 20, b)
    x_ref, n_ref = ref_parts.hpcg_parts_set((n, n, n), PARTS, 4, 20, b)
    history_gap, x_gap = _gaps(norms, x, n_ref, x_ref)
    assert history_gap < 1e-13 and x_gap < 1e-13


def test_one_part_reference_is_told_apart():
    """Gauss-Seidel over the whole box is another smoother than the block
    one: its history leaves the parts' beyond the configuration's limit."""
    n, b = 8, _rhs(8, 5)
    x, norms = _port_set(n, 4, 20, b)
    x_one, n_one = ref_one.hpcg_set((2 * n,) * 3, 4, 20, b)
    history_gap, _ = _gaps(norms, x, n_one, x_one)
    assert history_gap > LIMITS["history_gap"]


def test_float32_set_fails_the_limits():
    n, b = 8, _rhs(8, 6)
    x, norms = _port_set(n, 4, 20, b, dtype=np.float32)
    x_ref, n_ref = ref_parts.hpcg_parts_set((n, n, n), PARTS, 4, 20, b)
    history_gap, x_gap = _gaps(norms, x, n_ref, x_ref)
    assert history_gap > LIMITS["history_gap"] and x_gap > LIMITS["x_gap"]


def _recorded(fn):
    first = len(profiling.spans())
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    return {i: s for i, s in enumerate(profiling.spans()) if i >= first}


def test_ghosted_set_spans():
    levels, its = 3, 6
    mg = HPCGMGPreconditioner((8, 8, 8), PARTS, SerialBackend(8), n_levels=levels,
                              dtype=np.float64, device="cpu")
    mine = _recorded(lambda: hpcg_cg_flat_g(mg, mg.b, iterations=its))
    cycles = its + 1
    ghost = Counter(s.attrs["level"] for s in mine.values() if s.name == "ghost")
    # two a finer level's visit, one the coarsest's; the finest once more an A-apply
    assert ghost == {0: cycles, 1: 2 * cycles, 2: 2 * cycles + its}
    exchanges = [s for s in mine.values() if s.name == "exchange"]
    assert len(exchanges) == sum(ghost.values())
    assert all(s.attrs == {"combine": "set"} and mine[s.parent].name == "ghost"
               for s in exchanges)
    # inside its level's visit, or (the A-apply) in the set's loop
    parents = Counter((mine[s.parent].name, mine[s.parent].attrs.get("level"), s.attrs["level"])
                      for s in mine.values() if s.name == "ghost")
    assert parents == {("mg.level", l, l): n - (its if l == levels - 1 else 0)
                       for l, n in ghost.items()} | {("hpcg.cg", None, levels - 1): its}


def test_one_part_set_records_no_ghost_span():
    mg = HPCGMGPreconditioner((16, 16, 16), (1, 1, 1), SerialBackend(1), n_levels=4,
                              dtype=np.float64, device="cpu")
    mine = _recorded(lambda: hpcg_cg_flat(mg, mg.b, iterations=5))
    assert mine and not {"ghost", "exchange"} & {s.name for s in mine.values()}
