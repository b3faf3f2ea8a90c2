"""Host-side planning for the compressed-row engine (``csrc/ell_rows.cuh``)
that K5 ``ghost_spmv`` and K6's off-tile step share.

The engine reads a block in the layout of ``ops/blocks.py::stack_rows``:
lanes column-major ``[P, K, Nr]``, each row's live lanes a prefix of its K
lanes.  Rows go in groups of 32 consecutive compressed rows; ``lanes`` (G)
warps share a group, warp j taking the lanes k = j, j + G, ..., and each
warp stops at its group's lane count, the live lanes of the group's longest
row, instead of at the block's K.  This module computes those counts, once
per block (``freeze_block`` keeps the plan with the block), and picks G:

- ``warps_per_group``: the smallest power of two G (at most ``LANES_MAX``)
  at which the block's row groups give a call ``TARGET_THREADS`` threads,
  unless a warp would be left fewer than ``MIN_LANES_PER_WARP`` lanes of
  the mean group.  Many short rows (the HPCG own-ghost block, the 40^3
  prolongator P0) keep one or two warps per group; few long rows (the
  restrictions P0^T and P1^T, the coarse operators) get up to 32.  The two
  constants were chosen from ``chip_smoke.py``'s timings of every G at
  every AMG shape and at the own-ghost block.
- K6 runs one tile's compressed rows (at most 128) per CTA, with the
  warps per group fixed by its CTA (``csrc/tile_gs.cu``); its count is per
  tile (``tile_lane_counts``).

Nothing here touches a device except to place the counts: the CPU tests
check the plans.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

GROUP_ROWS = 32  # compressed rows of a group: one warp's threads
LANES_MAX = 32  # warps per group: a CTA holds max(G, 8) warps, at most 1024 threads
# from chip_smoke.py's timings of every G (PERF.md, section 6): the fastest
# G of every 40^3 AMG block gives it at least 80 Ki threads or 2 lanes a
# warp, and the HPCG own-ghost block (97,024 threads at G = 1) is fastest
# at G = 1
TARGET_THREADS = 80 * 1024
MIN_LANES_PER_WARP = 2


class EllPlan(NamedTuple):
    """How K5 runs one block: ``lanes`` warps per group of 32 compressed
    rows, and ``group_lanes`` int32 ``[P, ceil(Nr / 32)]`` on the block's
    device, the live lanes of each group's longest row."""

    lanes: int
    group_lanes: torch.Tensor


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def live_lanes(cols) -> np.ndarray:
    """Per compressed row, one past its last live lane (columns ``[P, K,
    Nr]``, host or device): ``[P, Nr]`` int32, 0 for a padding row."""
    c = _host(cols)
    P, K, Nr = c.shape
    k = np.arange(1, K + 1, dtype=np.int32).reshape(1, K, 1)
    return np.where(c >= 0, k, 0).max(axis=1, initial=0).astype(np.int32)


def group_lane_counts(cols) -> np.ndarray:
    """``[P, ceil(Nr / 32)]`` int32: the lanes each 32-row group's warps
    walk (its longest row's live lanes)."""
    per_row = live_lanes(cols)
    P, Nr = per_row.shape
    n_groups = -(-Nr // GROUP_ROWS)
    padded = np.zeros((P, n_groups * GROUP_ROWS), dtype=np.int32)
    padded[:, :Nr] = per_row
    return padded.reshape(P, n_groups, GROUP_ROWS).max(axis=2, initial=0)


def tile_lane_counts(cols, tile_ptr) -> np.ndarray:
    """``[P, nt]`` int32: the live lanes of each tile's longest compressed
    row (tile t's rows are ``tile_ptr[p, t] .. tile_ptr[p, t + 1] - 1``)."""
    per_row = live_lanes(cols)
    ptr = _host(tile_ptr)
    P, nt = ptr.shape[0], ptr.shape[1] - 1
    out = np.zeros((P, nt), dtype=np.int32)
    for p in range(P):
        for t in range(nt):
            lo, hi = int(ptr[p, t]), int(ptr[p, t + 1])
            if hi > lo:
                out[p, t] = per_row[p, lo:hi].max()
    return out


def warps_per_group(groups: int, mean_lanes: float) -> int:
    """The smallest power of two G (at most ``LANES_MAX``) at which
    ``groups`` row groups give ``TARGET_THREADS`` threads, keeping at least
    ``MIN_LANES_PER_WARP`` lanes of a ``mean_lanes`` group per warp."""
    lanes = 1
    while (
        lanes < LANES_MAX
        and groups * GROUP_ROWS * lanes < TARGET_THREADS
        and mean_lanes / (2 * lanes) >= MIN_LANES_PER_WARP
    ):
        lanes *= 2
    return lanes


def plan_of(cols, device: Optional[torch.device] = None, agree=None) -> EllPlan:
    """The plan of a block from its columns ``[P, K, Nr]`` (host or
    device; the counts go to ``device``, by default the columns').
    ``agree``: on several processes, maps this process's (groups a part,
    lanes summed over its groups) to the whole block's (groups, lanes
    summed) over every part, so that every process picks the G of the
    serial backend's block and sums each row in its order
    (``psparse._agreed_ell_groups``)."""
    counts = group_lane_counts(cols)
    if device is None:
        device = cols.device if isinstance(cols, torch.Tensor) else torch.device("cpu")
    groups, total = counts.size, int(counts.sum())
    if agree is not None:
        groups, total = agree(counts.shape[1], total)
    mean = total / groups if groups else 0.0
    return EllPlan(warps_per_group(groups, mean), torch.from_numpy(counts).to(device))
