"""Index partitions (numpy only).

Copied from ``partitionedarrays_tpu/parallel/p_range.py``: ``GlobalLookup``
(:45-91), ``local_range`` with ghost layers and periodicity (:92),
``block_owner_1d`` (:118), the general ``LocalIndices`` with its index maps
(:140-361), the free index maps and ghost editing (:366-496, :799-863),
``find_owner`` (:495), ``AssemblyGraph`` with the memoized
``PRange.assembly_graph`` and ``assembly_neighbors`` (:520-621), and the
partition constructors ``uniform_partition`` with ghost layers and
periodicity (:635-716), ``variable_partition`` (:718-747),
``partition_from_color`` (:750), ``trivial_partition`` (:774),
``permute_indices`` (:819) and ``renumber_partition`` (:865).

Two kinds of part, with the same index maps (``_PartIndices``):

- ``BoxPart``: a box ``origin + [0, shape)`` of a C-ordered global grid,
  plus ghost ids (the stencil operators; ``ops/stencil.py`` adds ghosts by
  ``union_ghost``); ``uniform_partition`` without ghost layers makes these;
- ``LocalIndices``: any set of own ids, with ghost ids, an optional local
  permutation and an optional global owner map (the COO path: the gallery's
  dof partitions, ``variable_partition`` for AMG coarse levels, and
  ``uniform_partition`` with ghost layers, in box order).

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


def local_range(p: int, np_parts: int, n: int, ghost: int = 0, periodic: bool = False) -> range:
    """Block range of part ``p`` among ``np_parts`` parts of ``range(n)``;
    the remainder ``n % np_parts`` goes to the last parts (as the
    reference's ``local_range``), extended by ``ghost`` layers on each
    side: clipped to ``[0, n)``, or left unclipped with ``periodic`` (the
    caller wraps it modulo ``n``)."""
    ghost = int(ghost)
    l, rem = divmod(n, np_parts)
    offset = l * p
    if rem >= np_parts - p:
        l += 1
        offset += p - (np_parts - rem)
    start, stop = offset - ghost, offset + l + ghost
    if periodic:
        return range(start, stop)
    return range(max(0, start), min(n, stop))


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


class _PartIndices:
    """The index maps shared by both kinds of part, over ``own_to_global``,
    ``ghost_to_global``, ``ghost_to_owner`` and the optional local
    permutation ``perm`` (local position -> position in
    ``concat(own, ghost)``), as the reference's ``LocalIndices`` has them."""

    perm: Optional[np.ndarray] = None

    @property
    def n_own(self) -> int:
        return int(self.own_to_global.shape[0])

    @property
    def n_ghost(self) -> int:
        return int(self.ghost_to_global.shape[0])

    @property
    def n_local(self) -> int:
        return self.n_own + self.n_ghost

    def _permuted(self, cat: np.ndarray) -> np.ndarray:
        return cat if self.perm is None else cat[self.perm]

    def _inverse_perm(self) -> np.ndarray:
        inv = np.empty(self.n_local, dtype=INT)
        inv[self.perm] = np.arange(self.n_local, dtype=INT)
        return inv

    def local_to_global(self) -> np.ndarray:
        return self._permuted(np.concatenate([self.own_to_global, self.ghost_to_global]))

    def local_to_owner(self) -> np.ndarray:
        return self._permuted(
            np.concatenate([np.full(self.n_own, self.part, dtype=INT), self.ghost_to_owner]))

    def own_to_local(self) -> np.ndarray:
        if self.perm is None:
            return np.arange(self.n_own, dtype=INT)
        return self._inverse_perm()[: self.n_own]

    def ghost_to_local(self) -> np.ndarray:
        if self.perm is None:
            return np.arange(self.n_own, self.n_local, dtype=INT)
        return self._inverse_perm()[self.n_own :]

    def local_to_own(self) -> np.ndarray:
        """Own position of each local index, -1 for a ghost."""
        return self._permuted(np.concatenate(
            [np.arange(self.n_own, dtype=INT), np.full(self.n_ghost, -1, dtype=INT)]))

    def local_to_ghost(self) -> np.ndarray:
        """Ghost position of each local index, -1 for an own one."""
        return self._permuted(np.concatenate(
            [np.full(self.n_own, -1, dtype=INT), np.arange(self.n_ghost, dtype=INT)]))

    def own_to_owner(self) -> np.ndarray:
        return np.full(self.n_own, self.part, dtype=INT)

    def local_permutation(self) -> np.ndarray:
        return np.arange(self.n_local, dtype=INT) if self.perm is None else self.perm

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
        inv = self._inverse_perm()
        return np.where(concat_pos >= 0, inv[np.clip(concat_pos, 0, None)], -1).astype(INT)

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

    def union_ghost(self, gids, owners):
        """Append the new ids among ``gids`` to the ghosts (drops the
        permutation)."""
        g_new, o_new = self.filter_ghost(gids, owners)
        return self.replace_ghost(
            np.concatenate([self.ghost_to_global, g_new]),
            np.concatenate([self.ghost_to_owner, o_new]),
        )

    def remove_ghost(self):
        return self.replace_ghost((), ())


class BoxPart(_PartIndices):
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

    def replace_ghost(self, gids, owners) -> "BoxPart":
        """The same box with the ghost ids ``gids`` owned by ``owners``."""
        return BoxPart(
            self.part, self.n_parts, self.origin, self.shape, self.global_shape,
            self.global_to_owner, gids, owners,
        )

    def __repr__(self):
        return (
            f"BoxPart(part={self.part}/{self.n_parts}, origin={self.origin}, "
            f"shape={self.shape}, n_ghost={self.n_ghost})"
        )


class LocalIndices(_PartIndices):
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

    def replace_ghost(self, gids, owners) -> "LocalIndices":
        """The same own ids with the ghost ids ``gids`` owned by ``owners``
        (drops the permutation)."""
        return LocalIndices(
            self.n_global, self.part, self.n_parts, self.own_to_global, gids, owners,
            global_to_owner=self.global_to_owner,
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


def _tupled(x, nd: int, kind=int) -> tuple:
    if np.isscalar(x):
        return (kind(x),) * nd
    t = tuple(kind(v) for v in x)
    if len(t) != nd:
        raise ValueError(f"{t} has not {nd} entries")
    return t


def uniform_partition(parts_shape, global_shape, ghost=0, periodic=False) -> list:
    """N-D Cartesian block partition, with ``ghost`` layers (a thickness,
    per axis or for all) and ``periodic`` wrapping (per axis or for all).
    Without ghost layers every part is a ``BoxPart``; with them a
    ``LocalIndices`` whose local order is the box order (own and ghost
    interleaved, through its permutation), as the reference's."""
    parts_shape = _tupled(parts_shape, 1) if np.isscalar(parts_shape) else tuple(
        int(v) for v in parts_shape)
    nd = len(parts_shape)
    gshape = _tupled(global_shape, nd)
    ghost_t = _tupled(ghost, nd)
    per_t = _tupled(periodic, nd, bool)
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
        if not any(ghost_t):
            out.append(BoxPart(p, P, tuple(r.start for r in ranges),
                               tuple(len(r) for r in ranges), gshape, g2owner))
            continue
        box = [np.array(list(local_range(int(pc[d]), parts_shape[d], gshape[d], ghost_t[d],
                                         per_t[d])), dtype=INT) for d in range(nd)]
        # a box cell is own iff its unwrapped coordinates lie in the own ranges
        mesh = np.meshgrid(*[np.mod(a, gshape[d]) for d, a in enumerate(box)], indexing="ij")
        box_gids = np.ravel_multi_index(tuple(mesh), gshape).ravel()
        own_mask = np.ones(box_gids.shape, dtype=bool)
        for d, a in enumerate(np.meshgrid(*box, indexing="ij")):
            a = a.ravel()
            own_mask &= (a >= ranges[d].start) & (a < ranges[d].stop)
        ghost_gids = box_gids[~own_mask]
        n_own = int(own_mask.sum())
        perm = None
        if ghost_gids.size:
            perm = np.empty(box_gids.size, dtype=INT)
            perm[own_mask] = np.arange(n_own, dtype=INT)
            perm[~own_mask] = n_own + np.arange(box_gids.size - n_own, dtype=INT)
        out.append(LocalIndices(n_global, p, P, box_gids[own_mask], ghost_gids,
                                g2owner(ghost_gids), perm=perm, global_to_owner=g2owner))
    return out


def partition_from_color(n_parts: int, global_to_color) -> List[LocalIndices]:
    """A partition from an owner color per global id (a graph partitioner's
    output): part p owns the ids of color p."""
    color = _as1d(global_to_color)

    def g2owner(q):
        q = _as1d(q)
        return np.where(q >= 0, color[np.clip(q, 0, None)], -1).astype(INT)

    return [LocalIndices(color.size, p, n_parts, np.flatnonzero(color == p).astype(INT),
                         global_to_owner=g2owner) for p in range(n_parts)]


def trivial_partition(n_parts: int, n_global: int, main: int = 0) -> List[LocalIndices]:
    """Every id owned by part ``main``."""
    if main == 0:
        return variable_partition([n_global if p == main else 0 for p in range(n_parts)],
                                  n_global)

    def g2owner(q):
        return np.where(_as1d(q) >= 0, main, -1).astype(INT)

    return [LocalIndices(n_global, p, n_parts,
                         np.arange(n_global, dtype=INT) if p == main else (),
                         global_to_owner=g2owner) for p in range(n_parts)]


def renumber_partition(parts: Sequence) -> List[LocalIndices]:
    """Relabel the global ids so that each part's own ids are consecutive
    (part by part, in own order); the ghosts are kept, relabeled."""
    n_global = parts[0].n_global
    new_of_old = np.empty(n_global, dtype=INT)
    offset = 0
    for li in parts:
        new_of_old[li.own_to_global] = np.arange(offset, offset + li.n_own, dtype=INT)
        offset += li.n_own
    base = variable_partition([li.n_own for li in parts], n_global)
    return [nb.replace_ghost(new_of_old[li.ghost_to_global], li.ghost_to_owner)
            for li, nb in zip(parts, base)]


def permute_indices(li, perm) -> LocalIndices:
    """The part ``li`` with the local permutation ``perm``."""
    return LocalIndices(li.n_global, li.part, li.n_parts, li.own_to_global, li.ghost_to_global,
                        li.ghost_to_owner, perm=_as1d(perm), global_to_owner=li.global_to_owner)


def own_and_ghost_indices(n_global: int, part: int, n_parts: int, own_gids, ghost_gids=(),
                          ghost_owners=(), global_to_owner=None) -> LocalIndices:
    return LocalIndices(n_global, part, n_parts, own_gids, ghost_gids, ghost_owners,
                        global_to_owner=global_to_owner)


# -- the free index maps (the reference's module-level names) -----------------

def local_to_global(li) -> np.ndarray:
    return li.local_to_global()


def local_to_owner(li) -> np.ndarray:
    return li.local_to_owner()


def own_to_global(li) -> np.ndarray:
    return li.own_to_global


def ghost_to_global(li) -> np.ndarray:
    return li.ghost_to_global


def ghost_to_owner(li) -> np.ndarray:
    return li.ghost_to_owner


def own_to_owner(li) -> np.ndarray:
    return li.own_to_owner()


def own_to_local(li) -> np.ndarray:
    return li.own_to_local()


def ghost_to_local(li) -> np.ndarray:
    return li.ghost_to_local()


def local_to_own(li) -> np.ndarray:
    return li.local_to_own()


def local_to_ghost(li) -> np.ndarray:
    return li.local_to_ghost()


def global_to_local(li, q) -> np.ndarray:
    return li.global_to_local(q)


def global_to_own(li, q) -> np.ndarray:
    return li.global_to_own(q)


def global_to_ghost(li, q) -> np.ndarray:
    return li.global_to_ghost(q)


def part_id(li) -> int:
    return li.part


def own_length(li) -> int:
    return li.n_own


def ghost_length(li) -> int:
    return li.n_ghost


def local_length(li) -> int:
    return li.n_local


def global_length(li) -> int:
    return li.n_global


def local_permutation(li) -> np.ndarray:
    return li.local_permutation()


def replace_ghost(li, gids, owners):
    return li.replace_ghost(gids, owners)


def remove_ghost(li):
    return li.remove_ghost()


def union_ghost(li, gids, owners):
    return li.union_ghost(gids, owners)


def matching_local_indices(a, b) -> bool:
    """Whether two parts have the same local ids and owners, in order."""
    return a is b or (np.array_equal(a.local_to_global(), b.local_to_global())
                      and np.array_equal(a.local_to_owner(), b.local_to_owner()))


def matching_ghost_indices(a, b) -> bool:
    return a is b or (np.array_equal(a.ghost_to_global, b.ghost_to_global)
                      and np.array_equal(a.ghost_to_owner, b.ghost_to_owner))


def map_global_to_local(gids, li) -> np.ndarray:
    return li.global_to_local(gids)


def map_global_to_own(gids, li) -> np.ndarray:
    return li.global_to_own(gids)


def map_global_to_ghost(gids, li) -> np.ndarray:
    return li.global_to_ghost(gids)


def map_own_to_global(oids, li) -> np.ndarray:
    oids = _as1d(oids)
    return np.where(oids >= 0, li.own_to_global[np.clip(oids, 0, None)], -1).astype(INT)


def map_ghost_to_global(ghost_ids, li) -> np.ndarray:
    g = _as1d(ghost_ids)
    return np.where(g >= 0, li.ghost_to_global[np.clip(g, 0, None)], -1).astype(INT)


def to_local(gids_per_part, partition) -> List[np.ndarray]:
    return [map_global_to_local(g, li) for g, li in zip(gids_per_part, partition)]


def to_global(lids_per_part, partition) -> List[np.ndarray]:
    return [map_local_to_global(l, li) for l, li in zip(lids_per_part, partition)]


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

    def __init__(self, partition: Sequence):
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

    def __init__(self, parts: Sequence):
        self.parts = list(parts)
        self.n_parts = len(self.parts)
        self.n_global = self.parts[0].n_global
        self._layout = None
        self._assembly_graph: Optional[AssemblyGraph] = None
        self._repartition_plans = {}  # target PRange -> plan (pvector.repartition)

    def partition(self) -> list:
        return self.parts

    def assembly_graph(self) -> AssemblyGraph:
        """Built once and kept on the range."""
        if self._assembly_graph is None:
            self._assembly_graph = AssemblyGraph(self.parts)
        return self._assembly_graph

    def __repr__(self):
        return f"PRange(n_global={self.n_global}, n_parts={self.n_parts})"


def partition(pr: PRange) -> list:
    return pr.partition()


def _as_prange(x) -> PRange:
    return x if isinstance(x, PRange) else PRange(list(x))


def assembly_neighbors(partition_or_prange) -> Tuple[List[List[int]], List[List[int]]]:
    """(send, receive) neighbour lists per part of the assembly graph."""
    g = _as_prange(partition_or_prange).assembly_graph()
    return g.neighbors_snd, g.neighbors_rcv


def assembly_local_indices(partition_or_prange):
    """(send neighbours, ghost positions sent, receive neighbours, own
    positions received) per part of the assembly graph."""
    g = _as_prange(partition_or_prange).assembly_graph()
    return g.neighbors_snd, g.snd_ghost, g.neighbors_rcv, g.rcv_own
