"""Host-side planning for the DIA row engine (``csrc/dia_rows.cuh``) that
K2 ``dia_spmv_strided``, K3 ``gs_sweeps`` and K4 ``ax_core`` share.

A thread of the engine takes ``vec`` consecutive rows (16 bytes of the
vectors) and ``lanes`` threads of one warp may share those rows, each
summing every ``lanes``-th tap.  ``row_lanes`` picks ``lanes``: the
smallest power of two (up to 16, and at most the taps) that gives a call
``TARGET_THREADS`` threads.  Many rows and few taps (the HPCG fine level)
get one lane; few rows and many taps (the 40^3 elasticity level, the
coarse HPCG levels) get up to 16.  The plans take the vectors' item size
alone: narrow values (bfloat16 values under float32 vectors read in 8-byte
loads) keep the rows per thread of their vectors and get the full-value
plan, so the sums run in the same order.

K3 runs a whole color sequence in one persistent cooperative launch over
(CTAs per part, parts), with ``grid.sync()`` between color steps.
``sweep_plan`` asks for as many CTAs as one step has work for; the launch
caps that at the CTAs the card holds at once, so a small level gets a
small grid.  (A cluster form that kept x in every CTA's shared memory was
timed on the card and lost to this form on every level where it fits; see
``csrc/gs_dia.cu``.)

K4 runs every color of the core in one ordinary launch over (row tiles,
colors, parts), each lane keeping ``AX_CHUNK`` taps in flight; ``ax_plan``
gives it ``row_lanes`` over the row groups of all colors and parts at once
(``AX_TARGET_THREADS``), halved while a lane would hold less than one full
chunk of taps (27 taps: at most 8 lanes).

The engine has one form: ``check_rows`` refuses an operand that its
whole-row-group loads cannot read (the three wrappers call it; no scalar
form).

Nothing here touches a device: the CPU tests check the plans.
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

VEC_BYTES = 16  # one load of values per tap and thread
LANES_MAX = 16  # keeps a tap's loads of one warp on whole 32-byte sectors
THREADS = 256  # per CTA: csrc/gs_dia.cu and csrc/dia_spmv.cu kThreads
# threads of one step worth aiming for: at every level timed
# (chip_smoke.py phase 3c) the fastest lane count gives a step about this
# many
TARGET_THREADS = 24 * 1024
AX_CHUNK = 4  # K4's taps per lane in flight: csrc/gs_dia.cu kAxChunk
# K4's threads worth aiming for: at the coarse levels of the 128^3 HPCG
# hierarchy (values hot in L2, as after the smoother on the path), the
# fastest lane count gives about this many in float32 (chip_smoke.py
# phase 3d)
AX_TARGET_THREADS = 18 * 1024


class AxPlan(NamedTuple):
    """How K4 runs: ``lanes`` threads per row group (the launch's grid
    follows from it: row tiles of ``THREADS`` threads, colors, parts)."""

    lanes: int


class SweepPlan(NamedTuple):
    """How K3 runs one color sequence: ``lanes`` threads per row group and
    ``width`` CTAs per part (wanted; the launch caps it)."""

    lanes: int
    width: int


def vec_of(itemsize: int) -> int:
    """Rows per thread: 16 bytes of the vectors."""
    return VEC_BYTES // itemsize


def check_rows(name: str, rows: int, tensors, vec: int) -> None:
    """Raise ValueError unless the engine's loads of ``vec`` rows (16 bytes
    of the vectors, ``vec_of``) can read ``tensors`` (values, bd, invd, a
    guess): ``rows`` per row and every part stride (dim 0) in whole ``vec``
    elements, every start a whole load (``vec`` elements of the tensor's
    dtype: 16 bytes, or 8 or 4 for narrow values)."""
    bad = rows % vec != 0 or any(
        t.data_ptr() % (vec * t.element_size()) or (t.shape[0] > 1 and t.stride(0) % vec)
        for t in tensors
    )
    if bad:
        raise ValueError(
            f"{name}: rows of {rows} and every operand's part stride must be whole "
            f"{vec} elements and every start a whole load of {vec} elements (the row "
            f"engine has no scalar form)"
        )


@lru_cache(maxsize=None)
def row_lanes(groups: int, n_off: int, target: int) -> int:
    """The smallest power of two ``lanes`` (at most ``LANES_MAX``, at most
    ``n_off``) at which ``groups`` row groups give ``target`` threads."""
    lanes = 1
    while lanes < LANES_MAX and 2 * lanes <= n_off and groups * lanes < target:
        lanes *= 2
    return lanes


@lru_cache(maxsize=None)
def sweep_plan(P: int, m: int, n_off: int, Lq: int, itemsize: int) -> SweepPlan:
    """The plan of one K3 launch over vals ``[P, m, n_off, Lq]`` with
    vectors of ``itemsize`` bytes (the values' may be narrower):
    ``row_lanes`` lanes and CTAs enough for one pass over a step."""
    groups = Lq // vec_of(itemsize)
    lanes = row_lanes(P * groups, n_off, TARGET_THREADS)
    return SweepPlan(lanes, -(-groups * lanes // THREADS))


@lru_cache(maxsize=None)
def ax_plan(P: int, m: int, n_off: int, Lq: int, itemsize: int) -> AxPlan:
    """The plan of one K4 launch over vals ``[P, m, n_off, Lq]`` with
    vectors of ``itemsize`` bytes (the values' may be narrower, and get the
    same plan): ``row_lanes`` over the row groups of every color and part,
    which the one launch runs at once, and no more lanes than leave each
    lane ``AX_CHUNK`` taps."""
    groups = Lq // vec_of(itemsize)
    lanes = row_lanes(P * m * groups, n_off, AX_TARGET_THREADS)
    while lanes > 1 and -(-n_off // lanes) < AX_CHUNK:  # a lane keeps a full chunk
        lanes //= 2
    return AxPlan(lanes)
