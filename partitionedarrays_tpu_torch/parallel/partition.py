"""C-ordered Cartesian box partitions (numpy only).

The box geometry of ``partitionedarrays_tpu/parallel/p_range.py``
(``local_range`` :92 and ``uniform_partition`` :635), reduced to what the
closed-form stencil builder reads: each part's own global ids, box origin
and box shape.  Global ids linearize the grid in C order; parts linearize
``parts_shape`` in C order.  Ghost layers, periodicity and the index maps
come with the ghosted slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np


def local_range(p: int, np_parts: int, n: int) -> range:
    """Block range of part ``p`` among ``np_parts`` parts of ``range(n)``;
    the remainder ``n % np_parts`` goes to the last parts (as the
    reference's ``local_range``)."""
    l, rem = divmod(n, np_parts)
    offset = l * p
    if rem >= np_parts - p:
        l += 1
        offset += p - (np_parts - rem)
    return range(max(0, offset), min(n, offset + l))


@dataclass(frozen=True)
class BoxPart:
    """One part of a box partition: the own box ``origin + [0, shape)``."""

    part: int
    origin: Tuple[int, ...]
    shape: Tuple[int, ...]
    global_shape: Tuple[int, ...]

    @property
    def n_own(self) -> int:
        return int(np.prod(self.shape))

    @property
    def n_ghost(self) -> int:
        return 0

    @property
    def own_to_global(self) -> np.ndarray:
        axes = [np.arange(o, o + s) for o, s in zip(self.origin, self.shape)]
        mesh = np.meshgrid(*axes, indexing="ij")
        return np.ravel_multi_index(tuple(mesh), self.global_shape).ravel()


def uniform_partition(
    parts_shape: Sequence[int], global_shape: Sequence[int]
) -> List[BoxPart]:
    """N-D Cartesian block partition without ghost layers."""
    parts_shape = tuple(int(v) for v in parts_shape)
    gshape = tuple(int(v) for v in global_shape)
    if len(parts_shape) != len(gshape):
        raise ValueError(f"parts {parts_shape} and grid {gshape} differ in rank")
    out = []
    for p in range(int(np.prod(parts_shape))):
        pc = np.unravel_index(p, parts_shape)
        ranges = [
            local_range(int(pc[d]), parts_shape[d], gshape[d])
            for d in range(len(gshape))
        ]
        out.append(
            BoxPart(
                part=p,
                origin=tuple(r.start for r in ranges),
                shape=tuple(len(r) for r in ranges),
                global_shape=gshape,
            )
        )
    return out


class PRange:
    """A partition of ``range(n_global)`` into parts."""

    def __init__(self, parts: Sequence[BoxPart]):
        self.parts = list(parts)
        self.n_parts = len(self.parts)
        self.n_global = sum(p.n_own for p in self.parts)
        self._layout = None

    def __repr__(self):
        return f"PRange(n_global={self.n_global}, n_parts={self.n_parts})"
