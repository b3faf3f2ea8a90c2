"""Index partitions (numpy only).

Copied from ``partitionedarrays_tpu/parallel/p_range.py``: ``GlobalLookup``
(:45-91), ``local_range`` (:92), ``block_owner_1d`` (:118), the general
``LocalIndices`` (:140-361), ``matching_own_indices`` (:443),
``map_local_to_global`` (:464), ``find_owner`` (:495), the owner map of
``uniform_partition`` (:661-668), ``variable_partition`` (:718-747) and
``AssemblyGraph`` with the memoized ``PRange.assembly_graph`` (:520-601).

Two kinds of part:

- ``BoxPart``: a box ``origin + [0, shape)`` of a C-ordered global grid
  (the stencil operators; ``ops/stencil.py`` adds ghosts by
  ``union_ghost``).  Ghost layers of the partition constructor and
  periodicity are not copied.
- ``LocalIndices``: any set of own ids, with ghost ids, an optional local
  permutation and an optional global owner map (the COO path: the gallery's
  dof partitions, ``variable_partition`` for AMG coarse levels).

Global ids linearize a grid in C order; parts linearize ``parts_shape`` in
C order.  All of it is host setup code, run once.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

INT = np.int64


def _as1d(x, dtype=INT) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, dtype=dtype).ravel())


class GlobalLookup:
    """Vectorized global-id -> position lookup over an id set; queries not
    in the set map to -1."""

    def __init__(self, gids: np.ndarray):
        self.gids = _as1d(gids)
        n = self.gids.size
        # contiguous ranges need no sort; pre-sorted ids need no argsort
        self.contig = bool(
            n > 0
            and self.gids[-1] - self.gids[0] == n - 1
            and np.all(np.diff(self.gids) == 1)
        )
        if self.contig:
            self.start = int(self.gids[0])
            self.order = None
            self.sorted = None
        elif n and np.all(np.diff(self.gids) > 0):
            self.order = None
            self.sorted = self.gids
        else:
            self.order = np.argsort(self.gids, kind="stable")
            self.sorted = self.gids[self.order]

    def __call__(self, queries) -> np.ndarray:
        q = _as1d(queries)
        n = self.gids.size
        if n == 0:
            return np.full(q.shape, -1, dtype=INT)
        if self.contig:
            rel = q - self.start
            return np.where((rel >= 0) & (rel < n) & (q >= 0), rel, -1).astype(INT)
        pos = np.searchsorted(self.sorted, q)
        pos[pos >= n] = n - 1
        hit = self.sorted[pos] == q
        src = pos if self.order is None else self.order[pos]
        out = np.where(hit, src, -1)
        out[q < 0] = -1
        return out.astype(INT)


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


def block_owner_1d(np_parts: int, n: int, coords) -> np.ndarray:
    """Inverse of ``local_range``: the owner part of each 1-D coordinate."""
    c = _as1d(coords)
    l, rem = divmod(n, np_parts)
    cut = (np_parts - rem) * l  # first coordinate of the size-(l+1) blocks
    if l == 0:
        return (np_parts - rem + c).astype(INT)
    small = c // l
    big = (np_parts - rem) + (c - cut) // (l + 1)
    return np.where(c < cut, small, big).astype(INT)


class BoxPart:
    """One part of a box partition: the own box ``origin + [0, shape)`` of a
    ``global_shape`` grid, plus ghost ids and their owners.

    The index maps are those of the reference's ``LocalIndices`` without a
    local permutation: own positions follow the box in C order, ghost
    positions follow ``ghost_to_global``."""

    def __init__(
        self,
        part: int,
        n_parts: int,
        origin: Sequence[int],
        shape: Sequence[int],
        global_shape: Sequence[int],
        global_to_owner: Callable[[np.ndarray], np.ndarray],
        ghost_to_global=(),
        ghost_to_owner=(),
    ):
        self.part = int(part)
        self.n_parts = int(n_parts)
        self.origin = tuple(int(v) for v in origin)
        self.shape = tuple(int(v) for v in shape)
        self.global_shape = tuple(int(v) for v in global_shape)
        self.n_global = int(np.prod(self.global_shape))
        self.global_to_owner = global_to_owner
        self.ghost_to_global = _as1d(ghost_to_global)
        self.ghost_to_owner = _as1d(ghost_to_owner)
        if self.ghost_to_global.shape != self.ghost_to_owner.shape:
            raise ValueError("ghost ids and owners differ in length")
        axes = [np.arange(o, o + s) for o, s in zip(self.origin, self.shape)]
        mesh = np.meshgrid(*axes, indexing="ij")
        self.own_to_global = np.ravel_multi_index(tuple(mesh), self.global_shape).ravel()
        self._lookups = {}

    @property
    def n_own(self) -> int:
        return int(np.prod(self.shape))

    @property
    def n_ghost(self) -> int:
        return int(self.ghost_to_global.shape[0])

    def local_to_global(self) -> np.ndarray:
        """Own ids, then ghost ids (a box part has no local permutation)."""
        return np.concatenate([self.own_to_global, self.ghost_to_global])

    def _lookup(self, key: str, gids: np.ndarray) -> GlobalLookup:
        lk = self._lookups.get(key)
        if lk is None:
            lk = self._lookups[key] = GlobalLookup(gids)
        return lk

    def global_to_own(self, queries) -> np.ndarray:
        return self._lookup("own", self.own_to_global)(queries)

    def global_to_ghost(self, queries) -> np.ndarray:
        return self._lookup("ghost", self.ghost_to_global)(queries)

    def replace_ghost(self, gids, owners) -> "BoxPart":
        """The same box with the ghost ids ``gids`` owned by ``owners``."""
        return BoxPart(
            self.part, self.n_parts, self.origin, self.shape, self.global_shape,
            self.global_to_owner, gids, owners,
        )

    def filter_ghost(self, gids, owners) -> Tuple[np.ndarray, np.ndarray]:
        """The (gids, owners) that are neither own nor already ghost,
        deduplicated keeping the first occurrence."""
        gids = _as1d(gids)
        owners = _as1d(owners)
        is_own = self.global_to_own(gids) >= 0
        is_ghost = self.global_to_ghost(gids) >= 0
        new = ~(is_own | is_ghost) & (gids >= 0)
        g = gids[new]
        o = owners[new]
        _, first = np.unique(g, return_index=True)
        first.sort()
        return g[first], o[first]

    def union_ghost(self, gids, owners) -> "BoxPart":
        """Append the new ids among ``gids`` to the ghosts."""
        g_new, o_new = self.filter_ghost(gids, owners)
        return self.replace_ghost(
            np.concatenate([self.ghost_to_global, g_new]),
            np.concatenate([self.ghost_to_owner, o_new]),
        )

    def remove_ghost(self) -> "BoxPart":
        return self.replace_ghost((), ())

    def __repr__(self):
        return (
            f"BoxPart(part={self.part}/{self.n_parts}, origin={self.origin}, "
            f"shape={self.shape}, n_ghost={self.n_ghost})"
        )


class LocalIndices:
    """One part of a general partition: own ids, ghost ids and their
    owners, an optional local permutation and an optional global owner map.

    ``perm`` (if given) maps local position -> position in
    ``concat(own_to_global, ghost_to_global)``, so
    ``local_to_global = concat(own, ghost)[perm]``."""

    def __init__(
        self,
        n_global: int,
        part: int,
        n_parts: int,
        own_to_global,
        ghost_to_global=(),
        ghost_to_owner=(),
        perm: Optional[np.ndarray] = None,
        global_to_owner: Optional[Callable] = None,
    ):
        self.n_global = int(n_global)
        self.part = int(part)
        self.n_parts = int(n_parts)
        self.own_to_global = _as1d(own_to_global)
        self.ghost_to_global = _as1d(ghost_to_global)
        self.ghost_to_owner = _as1d(ghost_to_owner)
        if self.ghost_to_global.shape != self.ghost_to_owner.shape:
            raise ValueError("ghost ids and owners differ in length")
        self.perm = None if perm is None else _as1d(perm)
        self.global_to_owner = global_to_owner
        self._lookups = {}

    @property
    def n_own(self) -> int:
        return int(self.own_to_global.shape[0])

    @property
    def n_ghost(self) -> int:
        return int(self.ghost_to_global.shape[0])

    @property
    def n_local(self) -> int:
        return self.n_own + self.n_ghost

    def local_to_global(self) -> np.ndarray:
        cat = np.concatenate([self.own_to_global, self.ghost_to_global])
        return cat if self.perm is None else cat[self.perm]

    def local_to_owner(self) -> np.ndarray:
        cat = np.concatenate([np.full(self.n_own, self.part, dtype=INT), self.ghost_to_owner])
        return cat if self.perm is None else cat[self.perm]

    def _lookup(self, key: str, gids: np.ndarray) -> GlobalLookup:
        lk = self._lookups.get(key)
        if lk is None:
            lk = self._lookups[key] = GlobalLookup(gids)
        return lk

    def global_to_own(self, queries) -> np.ndarray:
        return self._lookup("own", self.own_to_global)(queries)

    def global_to_ghost(self, queries) -> np.ndarray:
        return self._lookup("ghost", self.ghost_to_global)(queries)

    def global_to_local(self, queries) -> np.ndarray:
        own = self.global_to_own(queries)
        ghost = self.global_to_ghost(queries)
        concat_pos = np.where(own >= 0, own, np.where(ghost >= 0, ghost + self.n_own, -1))
        if self.perm is None:
            return concat_pos.astype(INT)
        inv = np.empty(self.n_local, dtype=INT)
        inv[self.perm] = np.arange(self.n_local, dtype=INT)
        return np.where(concat_pos >= 0, inv[np.clip(concat_pos, 0, None)], -1).astype(INT)

    def replace_ghost(self, gids, owners) -> "LocalIndices":
        """The same own ids with the ghost ids ``gids`` owned by ``owners``
        (drops the permutation)."""
        return LocalIndices(
            self.n_global, self.part, self.n_parts, self.own_to_global, gids, owners,
            global_to_owner=self.global_to_owner,
        )

    def remove_ghost(self) -> "LocalIndices":
        return self.replace_ghost((), ())

    filter_ghost = BoxPart.filter_ghost

    def union_ghost(self, gids, owners) -> "LocalIndices":
        """Append the new ids among ``gids`` to the ghosts (drops the
        permutation)."""
        g_new, o_new = self.filter_ghost(gids, owners)
        return self.replace_ghost(
            np.concatenate([self.ghost_to_global, g_new]),
            np.concatenate([self.ghost_to_owner, o_new]),
        )

    def __repr__(self):
        return (
            f"LocalIndices(part={self.part}/{self.n_parts}, n_global={self.n_global}, "
            f"n_own={self.n_own}, n_ghost={self.n_ghost})"
        )


def matching_own_indices(a, b) -> bool:
    """Whether two parts own the same global ids in the same order."""
    return a is b or np.array_equal(a.own_to_global, b.own_to_global)


def map_local_to_global(lids, li) -> np.ndarray:
    """Local ids of part ``li`` -> global ids (negative ids stay -1)."""
    lids = _as1d(lids)
    l2g = li.local_to_global()
    return np.where(lids >= 0, l2g[np.clip(lids, 0, None)], -1).astype(INT)


def find_owner(partition: Sequence, gids_per_part) -> List[np.ndarray]:
    """The owner part of each queried global id, per part: the partition's
    ``global_to_owner`` where it has one, else an owner table assembled
    from every part's own ids."""
    g2o = next((li.global_to_owner for li in partition if li.global_to_owner is not None), None)
    if g2o is None:
        owner = np.empty(partition[0].n_global, dtype=INT)
        for li in partition:
            owner[li.own_to_global] = li.part
        g2o = lambda q: owner[_as1d(q)]
    return [np.asarray(g2o(_as1d(g)), dtype=INT) for g in gids_per_part]


def variable_partition(n_own_per_part: Sequence[int], n_global: Optional[int] = None):
    """1-D partition into consecutive blocks of the given sizes."""
    sizes = _as1d(n_own_per_part)
    starts = np.zeros(sizes.size + 1, dtype=INT)
    np.cumsum(sizes, out=starts[1:])
    if n_global is None:
        n_global = int(starts[-1])
    if starts[-1] != n_global:
        raise ValueError(f"part sizes sum to {starts[-1]}, not {n_global}")
    P = sizes.size

    def g2owner(q):
        q = _as1d(q)
        own = np.searchsorted(starts, np.clip(q, 0, None), side="right") - 1
        own = np.clip(own, 0, P - 1)
        return np.where(q >= 0, own, -1).astype(INT)

    return [
        LocalIndices(
            n_global, p, P, np.arange(starts[p], starts[p + 1], dtype=INT),
            global_to_owner=g2owner,
        )
        for p in range(P)
    ]


def uniform_partition(
    parts_shape: Sequence[int], global_shape: Sequence[int]
) -> List[BoxPart]:
    """N-D Cartesian block partition without ghosts."""
    parts_shape = tuple(int(v) for v in parts_shape)
    gshape = tuple(int(v) for v in global_shape)
    if len(parts_shape) != len(gshape):
        raise ValueError(f"parts {parts_shape} and grid {gshape} differ in rank")
    nd = len(gshape)
    n_global = int(np.prod(gshape))
    P = int(np.prod(parts_shape))

    def g2owner(q):
        q = _as1d(q)
        coords = np.unravel_index(np.clip(q, 0, n_global - 1), gshape)
        oc = [block_owner_1d(parts_shape[d], gshape[d], coords[d]) for d in range(nd)]
        own = np.ravel_multi_index(tuple(oc), parts_shape)
        return np.where(q >= 0, own, -1).astype(INT)

    out = []
    for p in range(P):
        pc = np.unravel_index(p, parts_shape)
        ranges = [local_range(int(pc[d]), parts_shape[d], gshape[d]) for d in range(nd)]
        out.append(
            BoxPart(
                p, P, tuple(r.start for r in ranges), tuple(len(r) for r in ranges),
                gshape, g2owner,
            )
        )
    return out


class AssemblyGraph:
    """Assembly communication graph and per-neighbour index lists.

    Part ``j`` sends the values in its ghost slots to their owners and
    receives contributions into its own slots (the consistent direction is
    the reverse):

    - ``neighbors_snd[j]``: destination parts;
    - ``snd_ghost[j][k]``: ghost positions on j sent to ``neighbors_snd[j][k]``
      (sorted by global id within each destination);
    - ``neighbors_rcv[j]``: source parts;
    - ``rcv_own[j][k]``: own positions on j where the data from
      ``neighbors_rcv[j][k]`` lands, in the sender's order.
    """

    def __init__(self, partition: Sequence[BoxPart]):
        P = len(partition)
        self.neighbors_snd: List[List[int]] = [[] for _ in range(P)]
        self.neighbors_rcv: List[List[int]] = [[] for _ in range(P)]
        self.snd_ghost: List[List[np.ndarray]] = [[] for _ in range(P)]
        self.rcv_own: List[List[np.ndarray]] = [[] for _ in range(P)]

        # sender side: group ghosts by owner, sort by global id inside a group
        pending: List[List[Tuple[int, np.ndarray]]] = [[] for _ in range(P)]
        for j, li in enumerate(partition):
            if li.n_ghost == 0:
                continue
            owners = li.ghost_to_owner
            gids = li.ghost_to_global
            order = np.lexsort((gids, owners))
            owners_s = owners[order]
            cuts = np.flatnonzero(np.diff(owners_s)) + 1
            for grp in np.split(np.arange(owners_s.size), cuts):
                o = int(owners_s[grp[0]])
                self.neighbors_snd[j].append(o)
                self.snd_ghost[j].append(order[grp].astype(INT))
                pending[o].append((j, gids[order[grp]]))

        # receiver side: map the sender's global ids to own positions
        for o in range(P):
            li = partition[o]
            for src, sent_gids in sorted(pending[o], key=lambda t: t[0]):
                pos = li.global_to_own(sent_gids)
                if not (pos >= 0).all():
                    raise ValueError("assembly graph: a ghost id is not owned by its owner")
                self.neighbors_rcv[o].append(src)
                self.rcv_own[o].append(pos.astype(INT))


class PRange:
    """A partition of ``range(n_global)`` into parts."""

    def __init__(self, parts: Sequence[BoxPart]):
        self.parts = list(parts)
        self.n_parts = len(self.parts)
        self.n_global = self.parts[0].n_global
        self._layout = None
        self._assembly_graph: Optional[AssemblyGraph] = None

    def assembly_graph(self) -> AssemblyGraph:
        """Built once and kept on the range."""
        if self._assembly_graph is None:
            self._assembly_graph = AssemblyGraph(self.parts)
        return self._assembly_graph

    def __repr__(self):
        return f"PRange(n_global={self.n_global}, n_parts={self.n_parts})"
