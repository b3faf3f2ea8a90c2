"""Host-side planning for the DIA row engine (``csrc/dia_rows.cuh``) that
K2 ``dia_spmv_strided`` and K3 ``gs_sweeps`` share.

A thread of the engine takes ``vec`` consecutive rows (16 bytes of values
per tap) and ``lanes`` threads of one warp may share those rows, each
summing every ``lanes``-th tap.  ``row_lanes`` picks ``lanes``: the
smallest power of two (up to 16, and at most the taps) that gives a call
``TARGET_THREADS`` threads.  Many rows and few taps (the HPCG fine level)
get one lane; few rows and many taps (the 40^3 elasticity level, the
coarse HPCG levels) get up to 16.

K3 runs a whole color sequence in one persistent cooperative launch over
(CTAs per part, parts), with ``grid.sync()`` between color steps.
``sweep_plan`` asks for as many CTAs as one step has work for; the launch
caps that at the CTAs the card holds at once, so a small level gets a
small grid.  (A cluster form that kept x in every CTA's shared memory was
timed on the card and lost to this form on every level where it fits; see
``csrc/gs_dia.cu``.)

The engine has one form: ``check_rows`` refuses an operand that its
16-byte loads cannot read (both wrappers call it; no scalar form).

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


class SweepPlan(NamedTuple):
    """How K3 runs one color sequence: ``lanes`` threads per row group and
    ``width`` CTAs per part (wanted; the launch caps it)."""

    lanes: int
    width: int


def vec_of(itemsize: int) -> int:
    """Rows per thread: 16 bytes of one tap's values."""
    return VEC_BYTES // itemsize


def check_rows(name: str, rows: int, tensors) -> None:
    """Raise ValueError unless the engine's 16-byte loads can read
    ``tensors`` (values, bd, invd, a guess): ``rows`` per row, every start
    and every part stride (dim 0) in whole 16-byte steps."""
    vec = vec_of(tensors[0].element_size())
    bad = rows % vec != 0 or any(
        t.data_ptr() % VEC_BYTES or (t.shape[0] > 1 and t.stride(0) % vec) for t in tensors
    )
    if bad:
        raise ValueError(
            f"{name}: rows of {rows} and every operand's start and part stride must be "
            f"whole {VEC_BYTES}-byte steps (the row engine has no scalar form)"
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
    """The plan of one K3 launch over vals ``[P, m, n_off, Lq]``:
    ``row_lanes`` lanes and CTAs enough for one pass over a step."""
    groups = Lq // vec_of(itemsize)
    lanes = row_lanes(P * groups, n_off, TARGET_THREADS)
    return SweepPlan(lanes, -(-groups * lanes // THREADS))
