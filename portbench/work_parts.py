"""The work of K5 on a level of HPCG's grid of parts, from the geometry
alone: the yardstick of ``ghost_roofline.hpcg_parts``.

On ``parts`` equal boxes of ``local`` points the 27-point operator's
own-ghost block (a part's rows against the neighbouring parts' points) has,
summed over the parts:

- ``entries``: the (row, column) pairs whose column lies in the global box
  but outside the row's part;
- ``ghosts``: the points of the global box one step outside a part's box;
- ``rows``: the part's rows with at least one such neighbour.

One product (``ops/ghost_spmv.py``) needs each entry's value and 4-byte
column index, the ghost vector read once and the output rows written once,
and 2 operations an entry.  The bound is ``work.bound_s`` of that, the
card's peaks of ``work.py``.
"""
from __future__ import annotations

from itertools import product
from math import prod
from typing import Dict, Sequence, Tuple

from portbench import work


def own_ghost(local: Sequence[int], parts: Sequence[int]) -> Dict[str, int]:
    """``entries``, ``ghosts`` and ``rows`` of the own-ghost block, summed
    over the parts."""
    local = [int(n) for n in local]
    parts = [int(p) for p in parts]
    out = {"entries": 0, "ghosts": 0, "rows": 0}
    for where in product(*(range(p) for p in parts)):
        # per axis: does the part have a neighbouring part below, above
        low = [w > 0 for w in where]
        high = [w < p - 1 for w, p in zip(where, parts)]
        inside = all_ = reach = interior = 1
        for n, lo, hi in zip(local, low, high):
            inside *= 3 * n - 2  # (point, leg) pairs inside the part
            all_ *= 3 * n - 2 + lo + hi  # inside the global box
            reach *= n + lo + hi  # the part's box grown by its ghost layers
            interior *= max(n - lo - hi, 0)  # rows with no neighbour in another part
        out["entries"] += all_ - inside
        out["ghosts"] += reach - prod(local)
        out["rows"] += prod(local) - interior
    return out


def k5_work(geometry: Dict[str, int], value_bytes: int, vector_bytes: int) -> Tuple[float, float]:
    """(bytes, operations) of one own-ghost product on a level."""
    nbytes = geometry["entries"] * (value_bytes + 4) + (
        geometry["ghosts"] + geometry["rows"]) * vector_bytes
    return float(nbytes), float(2 * geometry["entries"])


def k5_bound_s(geometry: Dict[str, int], value_bytes: int, vector_bytes: int) -> float:
    """The least seconds one own-ghost product on a level can take."""
    nbytes, ops = k5_work(geometry, value_bytes, vector_bytes)
    return work.bound_s(nbytes, ops, vector_bytes)
