"""The host plan of the compressed-row engine (``ops/ell_rows.py``) and
K6's step array (``ops/tile_gs.py::tile_steps``), on the CPU.

- The per-group lane counts of K5 (the live lanes of each group of 32
  compressed rows' longest row) and the per-tile counts of K6, on the
  blocks of the 8^3-node elasticity SA-AMG hierarchy, against a count in
  numpy; the live lanes of every row are a prefix of its lanes, which the
  counts rely on.
- The warps per group the rule gives each block of the paths (the 40^3
  elasticity hierarchy's P, P^T and coarse A, the HPCG own-ghost block).
- K6's step array for forward, backward, symmetric and twice symmetric
  sequences, from a guess and from a zero guess, decoded against the wave
  schedule of the JAX reference's tile smoother
  (``partitionedarrays_tpu/solvers/gs_slot.py``, Pallas off) on the same
  matrix.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from threadpoolctl import threadpool_limits

from partitionedarrays_tpu import config as jax_config
from partitionedarrays_tpu.backends import SerialBackend as JaxSerialBackend
from partitionedarrays_tpu.parallel.p_range import PRange as JaxPRange
from partitionedarrays_tpu.parallel.p_range import variable_partition as jax_variable_partition
from partitionedarrays_tpu.psparse import psparse as jax_psparse
from partitionedarrays_tpu.solvers.smoothers import GaussSeidel as JaxGaussSeidel

from partitionedarrays_tpu_torch.backends import SerialBackend
from partitionedarrays_tpu_torch.models import gallery
from partitionedarrays_tpu_torch.ops.ell_rows import (
    GROUP_ROWS, LANES_MAX, MIN_LANES_PER_WARP, TARGET_THREADS, group_lane_counts,
    tile_lane_counts, warps_per_group,
)
from partitionedarrays_tpu_torch.ops.tile_gs import steps_on, tile_steps
from partitionedarrays_tpu_torch.parallel.partition import variable_partition
from partitionedarrays_tpu_torch.psparse import psparse
from partitionedarrays_tpu_torch.solvers.amg import AMGParams, AMGPreconditioner
from partitionedarrays_tpu_torch.solvers.smoothers import GaussSeidel

torch.set_num_threads(1)


# numpy's BLAS on one thread (the hierarchy's QR and LU): its idle threads
# spin beside the suite's other workers
@pytest.fixture(scope="module", autouse=True)
def one_blas_thread():
    saved = jax_config.use_pallas
    jax_config.use_pallas = False
    with threadpool_limits(limits=1):
        yield
    jax_config.use_pallas = saved


@pytest.fixture(scope="module")
def hierarchy():
    """SA-AMG of 3-D elasticity at 8^3 nodes, float64, on the CPU."""
    nodes = (8, 8, 8)
    A = psparse(*gallery.linear_elasticity_fem(nodes, (1, 1, 1)), SerialBackend(1), device="cpu")
    coords, _ = gallery.node_coordinates_unit_cube(nodes, (1, 1, 1))
    return AMGPreconditioner(A, AMGParams(coarse_size=100, block_size=3),
                             nullspace=gallery.nullspace_linear_elasticity(coords))


def _blocks(M):
    out = {}
    for l, lev in enumerate(M.levels):
        if lev.P is None:
            continue
        if l > 0:
            out[f"A{l}"] = lev.A.device().oo
        out[f"P{l}"] = lev.P.device().oo
        out[f"P{l}^T"] = lev.P.device_transpose()[0]
    return {k: b for k, b in out.items() if b.kind == "ell"}


def _live_prefix(cols):
    """Per row, its live lanes, after checking they are a prefix."""
    live = cols >= 0
    n_live = live.sum(axis=1)
    prefix = np.arange(cols.shape[1]).reshape(1, -1, 1) < n_live[:, None, :]
    assert np.array_equal(live, prefix), "live lanes are a prefix of each row"
    return n_live


def test_group_lane_counts_match_numpy(hierarchy):
    blocks = _blocks(hierarchy)
    assert {"P0", "P0^T", "A1", "P1", "P1^T"} <= set(blocks)
    for name, blk in blocks.items():
        cols = blk.cols.numpy()
        P, K, Nr = cols.shape
        n_live = _live_prefix(cols)
        n_groups = -(-Nr // GROUP_ROWS)
        want = np.zeros((P, n_groups), dtype=np.int32)
        for p in range(P):
            for g in range(n_groups):
                want[p, g] = n_live[p, g * GROUP_ROWS:(g + 1) * GROUP_ROWS].max(initial=0)
        assert np.array_equal(group_lane_counts(cols), want), name
        # the plan frozen with the block: the counts and the rule's count
        assert blk.plan.group_lanes.dtype == torch.int32
        assert np.array_equal(blk.plan.group_lanes.numpy(), want), name
        assert blk.plan.lanes == warps_per_group(want.size, float(want.mean())), name
        assert want.max() <= K and (K == 0 or want.max() == K), "the longest row sets K"


def test_tile_lane_counts_match_numpy(hierarchy):
    tg = hierarchy.levels[1].smoother.tile_gs
    cols, ptr = tg.cols.numpy(), tg.tile_ptr.numpy()
    n_live = _live_prefix(cols)
    want = np.array([[n_live[0, ptr[0, t]:ptr[0, t + 1]].max(initial=0)
                      for t in range(tg.n_real_tiles)]])
    assert np.array_equal(tile_lane_counts(cols, ptr), want)
    assert np.array_equal(tg.tile_lanes.numpy(), want)
    assert want.max() > 0


# (row groups, mean group lanes) of the blocks the paths give K5 (the
# float32 40^3 elasticity hierarchy and the HPCG own-ghost block, computed
# by ops/ell_rows.py::group_lane_counts) and the warps per group the rule
# picks for them: at each, the fastest of chip_smoke.py's float32 timings
# of every count (P2, 2-4% off the fastest, excepted)
RULE_CASES = {
    "40^3 P0": ((6000, 34.056), 1),
    "40^3 P0^T": ((515, 335.264), 8),
    "40^3 A1": ((515, 147.635), 8),
    "40^3 P1": ((515, 30.454), 8),
    "40^3 P1^T": ((24, 613.75), 32),
    "40^3 A2": ((24, 127.5), 32),
    "40^3 P2": ((24, 25.5), 8),
    "40^3 P2^T": ((2, 336.0), 32),
    "HPCG own-ghost, (2,2,2) x 64^3": ((3032, 10.978), 1),
}


@pytest.mark.parametrize("case", list(RULE_CASES))
def test_warps_per_group_on_the_path_shapes(case):
    (groups, mean), lanes = RULE_CASES[case]
    G = warps_per_group(groups, mean)
    assert G == lanes
    # the smallest power of two that reaches the target, unless the cap or
    # the lanes left to a warp stop it first
    assert G & (G - 1) == 0 and 1 <= G <= LANES_MAX
    assert (G == LANES_MAX or groups * GROUP_ROWS * G >= TARGET_THREADS
            or mean / (2 * G) < MIN_LANES_PER_WARP)
    assert G == 1 or (groups * GROUP_ROWS * G // 2 < TARGET_THREADS
                      and mean / G >= MIN_LANES_PER_WARP)


def _banded():
    """1024 rows in 8 tiles, 9 entries per row within +-100, symmetrised
    and diagonally dominant: waves of several tiles."""
    n = 1024
    rng = np.random.default_rng(100)
    rows = np.repeat(np.arange(n), 9)
    cols = np.clip(rows + rng.integers(-100, 101, size=rows.size), 0, n - 1)
    B = sp.csr_matrix((rng.standard_normal(rows.size), (rows, cols)), shape=(n, n))
    return (B + B.T + sp.diags(np.abs(B + B.T).sum(1).A1 + 1.0)).tocoo()


@pytest.fixture(scope="module")
def tile_pair():
    """The port's tile smoother and the reference's, on the same matrix."""
    G = _banded()
    n = G.shape[0]
    tri = ([G.row.astype(np.int64)], [G.col.astype(np.int64)], [G.data])
    A = psparse(*tri, variable_partition([n]), variable_partition([n]), SerialBackend(1),
                device="cpu")
    A_ref = jax_psparse(*tri, JaxPRange(jax_variable_partition([n])),
                        JaxPRange(jax_variable_partition([n])), JaxSerialBackend(1), assembled=True)
    ref = JaxGaussSeidel(A_ref).slot_gs
    assert ref is not None, "the reference took the tile tier"
    return GaussSeidel(A).tile_gs, ref


@pytest.mark.parametrize("zero_guess", [False, True], ids=["guess", "zero"])
@pytest.mark.parametrize("dir_seq", [("f",), ("b",), ("f", "b"), ("f", "b", "f", "b")],
                         ids=["forward", "backward", "symmetric", "symmetric x2"])
def test_k6_steps_follow_the_reference_schedule(tile_pair, dir_seq, zero_guess):
    """Each step decodes to (direction, zero-guess flag, wave); the waves'
    tiles in step order are the reference's schedule, forward in order and
    backward reversed, and only the first direction of a zero-guess call
    carries the flag."""
    tg, ref = tile_pair
    assert tg.W == len(ref.schedules[0]) and tg.B > 1
    waves = tg.wave_tiles[0].tolist()
    steps = tile_steps(tg.W, dir_seq, zero_guess)
    got = [("fb"[st & 1], (st >> 1) & 1, [t for t in waves[st >> 2] if t >= 0]) for st in steps]
    want = []
    for s, d in enumerate(dir_seq):
        order = ref.schedules[0] if d == "f" else ref.schedules[0][::-1]
        want += [(d, int(zero_guess and s == 0), list(wave)) for wave in order]
    assert got == want
    on = steps_on(tg.W, dir_seq, zero_guess, "cpu")
    assert on.dtype == torch.int32 and on.tolist() == list(steps)
    assert steps_on(tg.W, list(dir_seq), zero_guess, torch.device("cpu")) is on
