"""K4's host side: the launch plan (``ops/dia_rows.py::ax_plan``) at the
levels the paths run, the plan a narrow-valued call takes, and the operand
check (``check_rows``) that refuses what the row engine's loads cannot
read.

The plan is host arithmetic and the wrapper's checks run before any
launch, so these tests run on the CPU: the wrapper's launch path is driven
with a recording stand-in for the C entry (no kernel runs here; the kernel
against its plain version is ``tests/test_torch_kernels_gpu.py``).
"""
import pytest
import torch

from partitionedarrays_tpu_torch import _build
from partitionedarrays_tpu_torch.ops import gs_dia_kernels
from partitionedarrays_tpu_torch.ops.dia_rows import (
    AX_CHUNK, AX_TARGET_THREADS, LANES_MAX, AxPlan, ax_plan, check_rows, row_lanes, vec_of,
)
from partitionedarrays_tpu_torch.ops.gs_dia_kernels import TapTable, ax_core
from partitionedarrays_tpu_torch.utils import profiling

# (P, m, n_off, Lq, itemsize) of every level K4 runs on the paths, and the
# lanes of the rule: row_lanes over every color's row groups at K4's own
# thread target, capped where a lane would hold less than one chunk of taps
# (27 taps: 8 lanes)
AX_PLAN_CASES = [
    # the one-part 128^3 HPCG hierarchy, float32 and float64
    ((1, 9, 27, 245760, 4), 1),
    ((1, 9, 27, 245760, 8), 1),
    ((1, 11, 27, 24576, 4), 1),
    ((1, 11, 27, 24576, 8), 1),
    ((1, 9, 27, 4096, 4), 2),
    ((1, 9, 27, 4096, 8), 1),
    ((1, 9, 27, 1024, 4), 8),  # row_lanes gives 16: 2 taps a lane, capped
    ((1, 9, 27, 1024, 8), 4),
    # the (2,2,2) x 64^3 hierarchy (8 parts of 64^3 .. 8^3)
    ((8, 11, 27, 24576, 4), 1),
    ((8, 9, 27, 4096, 8), 1),
    ((8, 9, 27, 1024, 4), 1),
    ((8, 10, 27, 1024, 8), 1),
    # the box AMG of the 64^3 Laplacian: 7-point fine level, 22^3, 8^3
    ((1, 3, 7, 98304, 4), 1),
    ((1, 3, 7, 98304, 8), 1),
    ((1, 8, 27, 2048, 4), 8),
    ((1, 8, 27, 2048, 8), 4),
    ((1, 10, 27, 1024, 4), 8),
    # the box AMG of the 48^3 Laplacian: 7-point fine level, 16^3, 6^3
    ((1, 5, 7, 22528, 4), 1),
    ((1, 5, 7, 22528, 8), 1),
    ((1, 9, 27, 1024, 8), 4),
    ((1, 8, 27, 1024, 4), 8),
    # few taps: 7 taps keep 2 lanes at most (4 taps each)
    ((1, 3, 7, 1024, 4), 2),
]
NARROW = [(torch.bfloat16, torch.float32), (torch.bfloat16, torch.float64),
          (torch.float32, torch.float64)]
NARROW_IDS = ["bf16-f32", "bf16-f64", "f32-f64"]


@pytest.mark.parametrize("shape, lanes", AX_PLAN_CASES, ids=[str(c[0]) for c in AX_PLAN_CASES])
def test_ax_plan_per_level(shape, lanes):
    P, m, n_off, Lq, itemsize = shape
    plan = ax_plan(*shape)
    assert plan == AxPlan(lanes)
    groups = P * m * (Lq // vec_of(itemsize))
    # row_lanes over every color's row groups, then halved while a lane
    # would hold less than a full chunk of taps
    wanted = row_lanes(groups, n_off, AX_TARGET_THREADS)
    assert plan.lanes <= wanted <= LANES_MAX
    assert plan.lanes == 1 or -(-n_off // plan.lanes) >= AX_CHUNK
    assert plan.lanes == wanted or -(-n_off // (2 * plan.lanes)) < AX_CHUNK


class _Launch:
    """A stand-in for K4's C entry that records its arguments."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def launch(monkeypatch):
    """K4's wrapper on CPU tensors down to its launch: the device check
    passes, the stream is 0 and the C entry is a recorder."""
    def on_card(name, vals, cores, tap):
        _build.check_pair(name, vals.dtype, cores[0].dtype)
        return True

    rec = _Launch()
    monkeypatch.setattr(gs_dia_kernels, "_check", on_card)
    monkeypatch.setattr(_build, "entry", lambda base, dtype, values=None: rec)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    return rec


def _operands(values, vectors, P=1, m=9, n_off=27, Lq=4096):
    taps = TapTable([[k - n_off // 2 for k in range(n_off)] for _ in range(m)])
    vals = torch.zeros(P, m, n_off, Lq, dtype=values)
    x = torch.zeros(P, m, Lq, dtype=vectors)
    return vals, x, taps


@pytest.mark.parametrize("values, vectors", NARROW, ids=NARROW_IDS)
def test_narrow_values_take_the_full_value_plan(launch, values, vectors):
    """The wrapper plans from the vectors' item size alone: narrow values
    launch with the lanes of the full-value call, so the sums run in the
    same order (a plan from the values' width would differ at the 32^3 or
    the 16^3 level and change the order)."""
    for P, m, Lq in ((1, 9, 4096), (1, 9, 1024), (1, 8, 2048), (1, 11, 24576)):
        full = _operands(vectors, vectors, P, m, 27, Lq)
        narrow = _operands(values, vectors, P, m, 27, Lq)
        ax_core(*full)
        ax_core(*narrow)
        lanes_full, lanes_narrow = launch.calls[-2][-2], launch.calls[-1][-2]
        assert lanes_narrow == lanes_full == ax_plan(P, m, 27, Lq, narrow[1].element_size()).lanes
    isz = torch.empty((), dtype=values).element_size()
    vsz = torch.empty((), dtype=vectors).element_size()
    assert any(ax_plan(1, 9, 27, Lq, isz) != ax_plan(1, 9, 27, Lq, vsz) for Lq in (1024, 4096))
    ax_core(*narrow, _plan=AxPlan(16))  # the private hook overrides the plan
    assert launch.calls[-1][-2] == 16


@pytest.mark.parametrize("values, vectors", NARROW + [(torch.float32, torch.float32),
                                                      (torch.float64, torch.float64)],
                         ids=NARROW_IDS + ["f32", "f64"])
def test_k4_refuses_operands_its_loads_cannot_read(launch, values, vectors):
    """``check_rows`` as K4's wrapper calls it, on values and x: whole
    loads pass; values or an x that start one element into their storage,
    or rows that are not whole row groups, raise ValueError before any
    launch and leave the counter alone."""
    vals, x, taps = _operands(values, vectors, P=2, m=3, n_off=5, Lq=64)
    vec = vec_of(x.element_size())
    check_rows("ax_core", 64, (vals, x), vec)
    ax_core(vals, x, taps)
    assert len(launch.calls) == 1

    def shifted(t):
        buf = torch.zeros(t.numel() + 1, dtype=t.dtype)
        return buf[1:].view(t.shape)

    launches = profiling.launches("ax_core")
    for bad_vals, bad_x in ((shifted(vals), x), (vals, shifted(x))):
        with pytest.raises(ValueError, match="no scalar form"):
            check_rows("ax_core", 64, (bad_vals, bad_x), vec)
        with pytest.raises(ValueError, match="ax_core"):
            ax_core(bad_vals, bad_x, taps)
    rows = 64 + vec // 2
    bad_vals, bad_x, _ = _operands(values, vectors, P=2, m=3, n_off=5, Lq=rows)
    with pytest.raises(ValueError, match="ax_core"):
        ax_core(bad_vals, bad_x, taps)
    assert profiling.launches("ax_core") == launches and len(launch.calls) == 1
