"""Wave-scheduled tile Gauss-Seidel: the smoother of an own block that is not
a colorable DIA band.

Counterpart of ``partitionedarrays_tpu/solvers/gs_slot.py``:
``_wave_schedule`` (:73-105, copied verbatim) and ``NaturalTileGS.build``
(:259-495, with its ``topo`` schedule and its ``directions``) with its
sweeps (:542-641), split into its structure half (``_plan``) and its values
half (``refresh``), so that a refresh for new values at fixed sparsity
keeps the schedule and K6's tables.  The rows of a part are cut into
128-row tiles.  Tiles are packed greedily into waves of at most B mutually
uncoupled tiles (no off-tile nonzero joins two tiles of a wave), and a sweep
visits the waves in order, each tile solved exactly with dense triangular
factors: exact Gauss-Seidel in the wave-major row order (natural within a
tile), exposed as ``schedules``.  The sweep is kernel K6
(``ops/tile_gs.py``).

What is kept from the reference: the schedule and the occupancy shrink of B
(:321-330), so ``schedules``, ``W`` and ``B`` agree; the identity on empty
diagonals (:331-334); the host inverses of the tile blocks, packed in the
reference's transposed layout and cast to the working type (:379-389).
What is not: the slot plan (``ops/slot_spmv.py::build_slot_plan``, a TPU
layout; the off-tile coupling is compressed rows here) and the TPU's
VMEM/HBM viability gates (:356-362, :374-375, :401-419), so the port never
declines a block.

``topo=True`` serves the ILU(0) tier of ``smoothers.py::AdditiveSchwarz``:
the level schedule puts every tile in a wave after all its lower-index
neighbours, so a zero-guess forward sweep on a unit-lower factor L is its
exact forward substitution and a reverse sweep on an upper factor U its
exact backward one.  Each factor needs one direction only, so ``directions``
packs only those planes (``pack[P, D, nt, 128, 128]``, D = 1 or 2; a
one-direction pack keeps its planes at index 0 whatever the direction, as
the reference's slab 0), and a sweep in a direction that was not packed
raises (:509-512, :599-602).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import scipy.sparse as sp
import torch

from ..ops.blocks import stack_rows
from ..ops.ell_rows import tile_lane_counts
from ..ops.tile_gs import TILE, tile_gs_sweeps


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m if x > 0 else 0


def _wave_schedule(adj, nt: int, B: int, topo: bool = False) -> List[List[int]]:
    """Greedy first-fit capacity-B schedule: tiles in natural order land
    in the first wave with free capacity containing none of their
    neighbors.  Any such assignment yields an exact GS for the wave-major
    ordering (tiles within a wave are mutually uncoupled).

    ``topo=True`` additionally constrains every tile to a wave STRICTLY
    AFTER all its already-placed (lower-index) neighbors — i.e. classic
    level scheduling.  For a triangular matrix this makes the forward
    wave-major sweep from zero guess an EXACT lower-triangular solve
    (and the reverse sweep an exact upper solve): every dependency is
    computed in an earlier wave, every not-yet-needed value is still
    zero."""
    waves: List[List[int]] = []
    wave_sets: List[set] = []
    wave_of = {}
    for t in range(nt):
        at = adj[t]
        start = 0
        if topo:
            placed = [wave_of[s] for s in at if s in wave_of]
            start = max(placed) + 1 if placed else 0
        for w in range(start, len(waves)):
            if len(waves[w]) < B and not (at & wave_sets[w]):
                waves[w].append(t)
                wave_sets[w].add(t)
                wave_of[t] = w
                break
        else:
            waves.append([t])
            wave_sets.append({t})
            wave_of[t] = len(waves) - 1
    return waves


class NaturalTileGS:
    """Sweep state of one matrix: ``schedules[k]`` (the k-th local part's
    forward waves, tile ids), ``W`` waves of at most ``B`` tiles (agreed by
    every process of a multi-process backend), ``n_real_tiles`` tiles of
    ``TILE`` rows (``Rp`` rows with padding), and the device operands of K6
    (``pack`` with one plane per tile for each of ``directions``, ``rows``,
    ``cols``, ``vals``, ``tile_ptr``, ``wave_tiles``, and the off-tile
    lanes of each tile's longest row, ``tile_lanes``)."""

    @classmethod
    def build(cls, A, topo: bool = False, directions: Sequence[str] = ("f", "b")
              ) -> "NaturalTileGS":
        """From A's host own-own blocks (``psparse``), computed in their
        dtype as the reference does and stored on A's device in A's device
        dtype: the structure (``_plan``), then the values (``refresh``).
        ``topo``: the level schedule of the triangular solves;
        ``directions``: the sweep directions to pack planes for, ("f",),
        ("b",) or ("f", "b")."""
        directions = tuple(directions)
        if directions not in (("f",), ("b",), ("f", "b")):
            raise ValueError(f"NaturalTileGS: directions {directions}")
        self = cls.__new__(cls)
        self.topo = bool(topo)
        self.directions = directions
        self._plan(A)
        self.refresh(A)
        return self

    def _plan(self, A) -> None:
        """The structure half: the tiles, their wave schedule (``topo``:
        the level schedule), the off-tile compressed rows and K6's tables,
        from the sparsity of A's own-own blocks only."""
        from ..psparse import _agree_max_i32, host_blocks

        local = A.backend.local_parts()
        blocks = [host_blocks(A)[p] for p in local]
        lay = A.row_layout()
        Rp = _round_up(lay.n_own_pad, TILE)
        nt = Rp // TILE
        P = len(blocks)
        B = min(8, max(nt, 1))
        inside_at, off_src = [], []
        schedules: List[List[List[int]]] = []
        for b in blocks:
            oo = b["oo"].tocoo()
            tr = oo.row // TILE
            tc = oo.col // TILE
            inside = tr == tc
            inside_at.append((np.flatnonzero(inside), tr[inside], oo.row[inside] % TILE,
                              oo.col[inside] % TILE))
            # the off-tile entries as a CSR whose values are their positions
            # in oo's entries (+1: 0 marks a padding lane)
            out = np.flatnonzero(~inside)
            off_src.append(sp.csr_matrix((out.astype(np.int64) + 1, (oo.row[out], oo.col[out])),
                                         shape=(Rp, Rp)))
            # the tile graph from the distinct coupled tile pairs (numpy's
            # unique: the reference's set of zipped pairs, without a Python
            # tuple per off-tile entry)
            adj = [set() for _ in range(nt)]
            pairs = np.unique(tr[out].astype(np.int64) * nt + tc[out])
            for a, b_ in zip(*(v.tolist() for v in np.divmod(pairs, nt))):
                adj[a].add(b_)
                adj[b_].add(a)
            schedules.append(_wave_schedule(adj, nt, B, topo=self.topo))
        W = max(max((len(s) for s in schedules), default=1), 1)
        # shrink B to the largest wave: on densely coupled tile graphs the
        # waves degenerate toward single tiles
        B = max(max((len(w) for s in schedules for w in s), default=1), 1)
        # every process launches K6 with the same wave count and cluster
        # width (the reference's agreed dims, gs_slot.py:290)
        W, B = (int(v) for v in _agree_max_i32(A.backend, [W, B]))
        rows, cols, src = stack_rows(off_src, Rp)
        tile_ptr = np.zeros((P, nt + 1), dtype=np.int32)
        wave_tiles = np.full((P, W, B), -1, dtype=np.int32)
        for k in range(P):
            live = rows[k][rows[k] >= 0]
            tile_ptr[k] = np.searchsorted(live // TILE, np.arange(nt + 1))
            for w, wave in enumerate(schedules[k]):
                wave_tiles[k, w, : len(wave)] = wave
        self.Rp = Rp
        self.n_real_tiles = nt
        self.W = W
        self.B = B
        self.schedules = schedules
        self._inside_at = inside_at
        self._off_src = src  # [P, K, Nr]: position + 1 of each off-tile lane's entry
        dev = A.torch_device
        self.rows = torch.from_numpy(rows).to(dev)
        self.cols = torch.from_numpy(cols).to(dev)
        self.tile_ptr = torch.from_numpy(tile_ptr).to(dev)
        self.wave_tiles = torch.from_numpy(wave_tiles).to(dev)
        self.tile_lanes = torch.from_numpy(tile_lane_counts(cols, tile_ptr)).to(dev)

    def refresh(self, A) -> None:
        """The values half: the packed inverse planes ``pack`` (of the
        packed directions only) and the off-tile values ``vals`` of K6 from
        the values of A's own-own blocks, whose sparsity must be the one
        planned; the schedule and the tables are kept."""
        from ..psparse import host_blocks

        blocks = [host_blocks(A)[p] for p in A.backend.local_parts()]
        P, nt = len(blocks), self.n_real_tiles
        datas = [b["oo"].tocoo().data for b in blocks]
        dtype = datas[0].dtype
        if len(datas) != len(self._inside_at) or any(
            d.size != at[0].size + int(np.count_nonzero(s)) for d, at, s in
            zip(datas, self._inside_at, self._off_src)
        ):
            raise ValueError("NaturalTileGS.refresh: the own-own sparsity changed")
        dense = np.zeros((P, nt, TILE, TILE), dtype)
        for k, (data, (at, t, r, c)) in enumerate(zip(datas, self._inside_at)):
            np.add.at(dense[k], (t, r, c), data[at])
        # identity on empty diagonals (padding rows) so the factors exist
        di = np.arange(TILE)
        dvals = dense[:, :, di, di]
        dense[:, :, di, di] = np.where(dvals == 0, 1.0, dvals)
        # the packed planes, stored transposed as the reference's:
        # fwd = (D+L)^-T (q <= r) + U^T (q > r), bwd = (D+U)^-T + L^T
        planes = []
        for d in self.directions:
            if d == "f":
                m_t = np.swapaxes(np.linalg.inv(np.tril(dense)), -1, -2)
                n_t = np.swapaxes(np.triu(dense, 1), -1, -2)
            else:
                m_t = np.swapaxes(np.linalg.inv(np.triu(dense)), -1, -2)
                n_t = np.swapaxes(np.tril(dense, -1), -1, -2)
            planes.append((m_t + n_t).astype(dtype))
        # (stack keeps the transposed memory order: K6 reads the logical one)
        pack = np.ascontiguousarray(np.stack(planes, axis=1))
        vals = np.zeros(self._off_src.shape, dtype=dtype)
        for k, data in enumerate(datas):
            lanes = self._off_src[k] > 0
            vals[k][lanes] = data[self._off_src[k][lanes] - 1]
        dev, dt = A.torch_device, A.dtype
        self.pack = torch.from_numpy(pack).to(dev, dt)
        self.vals = torch.from_numpy(vals).to(dev, dt)

    def operands(self):
        """K6's operands, in the order of ``tile_gs_sweeps``."""
        return self.pack, self.rows, self.cols, self.vals, self.tile_ptr, self.wave_tiles

    def sweeps(self, xo: Optional[torch.Tensor], bo: torch.Tensor, dir_seq: Sequence[str]):
        """The sweeps of ``dir_seq`` on own values ``xo`` [P, n] (None: a
        zero guess) for the rhs ``bo`` [P, n]; returns the new own values
        [P, n].  x and b are padded to ``Rp`` rows with zeros.  A direction
        that was not packed raises."""
        for d in dir_seq:
            if d not in self.directions:
                raise ValueError(f"direction {d!r} was not packed (directions={self.directions})")
        P, n = bo.shape
        x = bo.new_zeros((P, self.Rp))
        if xo is not None:
            x[:, : xo.shape[1]] = xo
        b = bo.new_zeros((P, self.Rp))
        b[:, :n] = bo
        tile_gs_sweeps(*self.operands(), x, b, tuple(dir_seq), zero_guess=xo is None,
                       tile_lanes=self.tile_lanes)
        return x[:, :n].contiguous()
