"""The work a smoother's sweeps need, and the card's published peaks: the
yardstick of the ``*_roofline`` metrics.

The work is fixed by the algorithm and the level sizes, never by a
kernel's launch plan, padding, tiles or lanes, so that a kernel that fuses,
splits or renames launches is held to the same work.  A pass (one forward
or one backward sweep over every row of a level) needs:

- every stored value of the level once, at its stored width, and on a
  level that is not banded one 4-byte column index per stored entry;
- the vectors it reads and writes, once each: the right-hand side, the
  inverse diagonal, x in (not where the pass starts from a zero guess)
  and x out;
- 2 operations per stored entry and 2 per row.

The first color step of a zero-guess pass needs no values; it is counted
anyway (1/m of one pass in four, under 3% of a colored level's bytes at
m = 9), so the bound may sit that much high, never low.
"""
from __future__ import annotations

from typing import Iterable, Mapping, Tuple

# NVIDIA H100 SXM data sheet, 700 W: HBM3 rate, and the float64 and float32
# rates outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {8: 34e12, 4: 67e12}


def pass_work(rows: int, nnz: int, value_bytes: int, vector_bytes: int, banded: bool,
              zero_guess: bool) -> Tuple[float, float]:
    """(bytes, operations) of one pass over a level."""
    index_bytes = 0 if banded else 4
    vectors = 4 - int(bool(zero_guess))
    nbytes = nnz * (value_bytes + index_bytes) + vectors * rows * vector_bytes
    return float(nbytes), float(2 * nnz + 2 * rows)


def smoother_work(levels: Iterable[Mapping]) -> Tuple[float, float]:
    """(bytes, operations) of the smoothing in one V-cycle.  Each level is a
    mapping with ``rows``, ``nnz``, ``value_bytes``, ``vector_bytes``,
    ``banded`` and ``applications``: a list of (zero_guess, passes), one
    entry per smoother call in the cycle; a call's first pass starts from
    the guess, its later passes from the state before them."""
    nbytes = ops = 0.0
    for lev in levels:
        for zero_guess, passes in lev["applications"]:
            for k in range(int(passes)):
                b, o = pass_work(lev["rows"], lev["nnz"], lev["value_bytes"],
                                 lev["vector_bytes"], lev["banded"], zero_guess and k == 0)
                nbytes += b
                ops += o
    return nbytes, ops


def bound_s(nbytes: float, ops: float, vector_bytes: int) -> float:
    """The least seconds the card can take: the larger of the bytes over
    the memory rate and the operations over the rate of the vectors' type."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FLOPS_PER_S[int(vector_bytes)])
