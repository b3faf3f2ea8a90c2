"""Direct construction of constant-coefficient stencil operators.

Counterpart of ``partitionedarrays_tpu/ops/stencil.py`` (``stencil_psparse``
:109-423 and ``stencil_rhs_counts`` :426-447).  On a C-ordered box the
own-own block of a constant stencil is exactly DIA, one diagonal per
distinct local offset, and each diagonal's values are a product of 1-D
boundary masks.  When every part's box has the same shape, every part's
own-own block is the same, so the diagonals are built once on the device
from per-axis masks and broadcast over the parts, with no triplets, no
sort and no host copy of the values.  On boxes of unequal shape (a grid
that the parts do not divide: :358-415) each part's diagonals are built on
the host at its own box's offsets and stacked on the union of the parts'
offsets, a part's missing offsets and its padding rows zero.  Legs that
leave the global domain are dropped (zero-Dirichlet truncation).

Legs that leave the part's box but stay in the domain reach a neighbour's
own ids: they make the ghost columns and the own-ghost block ``oh``, built
on the host in O(surface) (:175-231) and frozen as a compressed-row ELL
(kernel K5).

The host mirrors of the blocks (:321-337) are the own-ghost CSR and a
scipy DIA own-own block: on equal boxes made from the closed form on
first access, for host consumers (``to_global_scipy``, ``dense_diag``, the
AMG setup); on unequal boxes made with the values.
``_host_dia_mirror`` and ``_LazyStencilBlocks`` are copied from
``partitionedarrays_tpu/ops/stencil.py`` (:60-106).
"""
from __future__ import annotations

from functools import reduce
from typing import Dict, List, Sequence, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from ..config import numpy_dtype, torch_dtype
from ..parallel.exchange_plan import layout_of
from ..parallel.partition import INT, PRange, uniform_partition
from ..psparse import DeviceSpMat, PSparseMatrix, _sorted_ghosts
from .blocks import freeze_block, make_dia_block
from .dia import host_dia
from .sparse_host import compresscoo


def _axis_masks(loc, org, gshape, delta):
    """Per-axis 1-D masks for the stencil leg ``delta`` from a box with local
    dims ``loc`` at global origin ``org``: (inside_local[d], inside_global[d])."""
    in_loc, in_glob = [], []
    for d in range(len(loc)):
        t = np.arange(loc[d], dtype=np.int64) + delta[d]
        in_loc.append((t >= 0) & (t < loc[d]))
        g = org[d] + t
        in_glob.append((g >= 0) & (g < gshape[d]))
    return in_loc, in_glob


def _outer_and(masks: Sequence[np.ndarray]) -> np.ndarray:
    """AND of 1-D boolean masks broadcast over the box (C order), raveled."""
    nd = len(masks)
    shaped = [
        m.reshape((1,) * d + (-1,) + (1,) * (nd - d - 1)) for d, m in enumerate(masks)
    ]
    return reduce(np.logical_and, shaped).ravel()


def _host_dia_mirror(loc, n_own_c, all_offs, terms, dtype) -> sp.dia_matrix:
    """scipy DIA mirror of the own-own block, built from the closed form."""
    R = int(np.prod(loc))
    rows = np.zeros((max(len(all_offs), 1), R), dtype=dtype)
    for k, o in enumerate(all_offs):
        for delta, value in terms[o]:
            in_loc, _ = _axis_masks(loc, (0,) * len(loc), loc, delta)
            rows[k] += _outer_and(in_loc) * np.asarray(value, dtype=dtype)
    return host_dia(all_offs, rows, R, n_own_c)


class _LazyStencilBlocks(dict):
    """Host block dict whose scipy 'oo' mirror materializes on first access.

    The closed-form constructor keeps the own_own diagonals device-resident;
    host-side algebra (generic AMG setup, centralize, spmm, ...) still works
    — it just pays the host materialization cost only when actually used.
    Every view holds both blocks: ``in``, ``len`` and the key order never
    materialize 'oo'; ``values`` and ``items`` do.
    """

    _KEYS = ("oh", "oo")

    def __init__(self, oh, builder):
        super().__init__(oh=oh)
        self._builder = builder

    def __getitem__(self, k):
        if k == "oo" and not dict.__contains__(self, "oo"):
            dict.__setitem__(self, "oo", self._builder())
        return dict.__getitem__(self, k)

    def get(self, k, default=None):
        return self[k] if k in self._KEYS else default

    def __contains__(self, k):
        return k in self._KEYS

    def __len__(self):
        return len(self._KEYS)

    def __iter__(self):
        return iter(self._KEYS)

    def keys(self):
        return list(self._KEYS)

    def values(self):
        return [self[k] for k in self._KEYS]

    def items(self):
        return [(k, self[k]) for k in self._KEYS]


def _terms_for(loc, stencil) -> Dict[int, List]:
    """Local offset -> [(delta, value), ...]: on small boxes distinct legs
    can share one offset (their masks never overlap)."""
    nd = len(loc)
    strides = [int(np.prod(loc[d + 1 :], dtype=np.int64)) for d in range(nd)]
    terms: Dict[int, list] = {}
    for delta, value in stencil:
        off = int(sum(d * s for d, s in zip(delta, strides)))
        terms.setdefault(off, []).append((delta, value))
    return terms


def _ghost_surface(part, gshape, stencil, np_dtype):
    """The part's column partition (ghosts appended by owner, then id) and
    its own-ghost block as CSR, from the legs that leave its box but stay in
    the domain."""
    org, loc = part.origin, part.shape
    nd = len(loc)
    gstrides = [int(np.prod(gshape[d + 1 :], dtype=np.int64)) for d in range(nd)]
    ghost_rows, ghost_gids, ghost_vals = [], [], []
    for delta, value in stencil:
        in_loc, in_glob = _axis_masks(loc, org, gshape, delta)
        if all(m.all() for m in in_loc):
            continue
        gmask = _outer_and(in_glob) & ~_outer_and(in_loc)
        rows = np.flatnonzero(gmask)
        if rows.size == 0:
            continue
        coords = np.unravel_index(rows, loc)
        gid = np.zeros(rows.size, dtype=np.int64)
        for d in range(nd):
            gid += (org[d] + coords[d] + delta[d]) * gstrides[d]
        ghost_rows.append(rows.astype(INT))
        ghost_gids.append(gid)
        ghost_vals.append(np.full(rows.size, value, dtype=np_dtype))
    if not ghost_gids:
        return part, sp.csr_matrix((part.n_own, 0), dtype=np_dtype)
    tg = np.concatenate(ghost_gids)
    gids = np.unique(tg)
    gids, owners = _sorted_ghosts(gids, part.global_to_owner(gids))
    col_part = part.union_ghost(gids, owners)
    oh = compresscoo(
        np.concatenate(ghost_rows), col_part.global_to_ghost(tg),
        np.concatenate(ghost_vals), part.n_own, col_part.n_ghost,
    )
    return col_part, oh


def stencil_psparse(
    parts_per_dir: Sequence[int],
    gshape: Sequence[int],
    stencil: Sequence[Tuple[Tuple[int, ...], float]],
    backend,
    dtype=np.float64,
    device="cuda",
):
    """Assembled PSparseMatrix of a constant-coefficient stencil operator.

    ``stencil``: iterable of (offset tuple, value), the center included.
    The own-own DIA values ``[P, n_off, n_own_pad]`` are built on ``device``,
    the own-ghost block on the host and then frozen onto ``device``; the
    host mirror of the own-own block is made when a host consumer first
    asks for it.  On a multi-process backend the device blocks hold the
    process's own parts; the host metadata (every part's ghosts) is built
    in full on every process.
    """
    gshape = tuple(int(v) for v in gshape)
    parts_per_dir = tuple(int(v) for v in parts_per_dir)
    stencil = [(tuple(int(x) for x in d), float(v)) for d, v in stencil]
    row_parts = uniform_partition(parts_per_dir, gshape)
    P = len(row_parts)
    if backend.n_parts != P:
        raise ValueError(f"{P} parts on a backend of {backend.n_parts}")
    np_dtype = numpy_dtype(dtype)
    surfaces = [_ghost_surface(p, gshape, stencil, np_dtype) for p in row_parts]
    row_pr = PRange(row_parts)
    col_pr = PRange([s[0] for s in surfaces])
    oh_csrs = [s[1] for s in surfaces]
    rlay = layout_of(row_pr)
    clay = layout_of(col_pr)
    if len({p.shape for p in row_parts}) != 1:
        return _unequal_boxes(row_pr, col_pr, oh_csrs, stencil, backend, np_dtype, device)
    loc = row_parts[0].shape
    nd = len(loc)
    R = int(np.prod(loc))

    # every part's own-own block is the same (legs that stay inside the box
    # never see the global boundary): build one part, broadcast over parts
    terms = _terms_for(loc, stencil)
    all_offs = sorted(terms)
    one = torch.zeros(
        (max(len(all_offs), 1), rlay.n_own_pad), dtype=torch_dtype(dtype), device=device
    )
    for k, o in enumerate(all_offs):
        for delta, value in terms[o]:
            in_loc, _ = _axis_masks(loc, (0,) * nd, loc, delta)
            fs = [torch.from_numpy(m.astype(np_dtype)).to(device) for m in in_loc]
            v = fs[0] * value
            for d in range(1, nd):
                v = v.reshape(v.shape + (1,)) * fs[d]
            one[k, :R] += v.reshape(-1)
    local = backend.local_parts()
    vals = one.unsqueeze(0).expand(len(local), -1, -1).contiguous()
    nnz = P * int(torch.count_nonzero(one)) + sum(m.nnz for m in oh_csrs)
    oo = make_dia_block(tuple(all_offs), clay.n_own_pad, vals)
    oh = freeze_block([oh_csrs[p] for p in local], rlay.n_own_pad, max(clay.n_ghost_pad, 1),
                      device=device)
    blocks = [
        _LazyStencilBlocks(oh_csr, lambda ncc=cp.n_own: _host_dia_mirror(
            loc, ncc, all_offs, terms, np_dtype))
        for oh_csr, cp in zip(oh_csrs, col_pr.parts)
    ]
    return PSparseMatrix(DeviceSpMat(oo, oh), row_pr, col_pr, backend, nnz, blocks=blocks)


def _unequal_boxes(row_pr, col_pr, oh_csrs, stencil, backend, np_dtype, device):
    """The own-own block on part boxes of unequal shape (a grid that the
    parts do not divide): each part's dense row-indexed diagonals on the
    host, at its own box's local offsets, stacked on the sorted union of
    the parts' offsets with zero diagonals (an offset a part lacks) and
    zero padding rows; kept on the host as ``A._oo_dia_host`` = (offsets,
    values ``[P, n_off, n_own_pad]``) and frozen as one DIA block."""
    rlay, clay = layout_of(row_pr), layout_of(col_pr)
    part_dia: List[Dict[int, np.ndarray]] = []
    for part in row_pr.parts:
        loc = part.shape
        R = part.n_own
        strides = [int(np.prod(loc[d + 1 :], dtype=np.int64)) for d in range(len(loc))]
        diags: Dict[int, np.ndarray] = {}
        for delta, value in stencil:
            off = int(sum(dd * s for dd, s in zip(delta, strides)))
            in_loc, _ = _axis_masks(loc, part.origin, part.global_shape, delta)
            own_mask = _outer_and(in_loc)
            if own_mask.any():
                diag = diags.setdefault(off, np.zeros(R, dtype=np_dtype))
                diag += own_mask * np.asarray(value, dtype=np_dtype)
        part_dia.append(diags)
    all_offs = sorted({o for d in part_dia for o in d})
    vals = np.zeros((row_pr.n_parts, max(len(all_offs), 1), rlay.n_own_pad), dtype=np_dtype)
    for p, diags in enumerate(part_dia):
        for k, o in enumerate(all_offs):
            if o in diags:
                vals[p, k, : diags[o].size] = diags[o]
    blocks = [{"oo": host_dia(all_offs, vals[p], rp.n_own, cp.n_own), "oh": oh}
              for p, (rp, cp, oh) in enumerate(zip(row_pr.parts, col_pr.parts, oh_csrs))]
    nnz = sum(int(np.count_nonzero(d)) for diags in part_dia for d in diags.values()) + sum(
        m.nnz for m in oh_csrs)
    local = backend.local_parts()
    vals = vals[backend.part_slice]
    oo = make_dia_block(tuple(all_offs), clay.n_own_pad, torch.from_numpy(vals).to(device))
    oh = freeze_block([oh_csrs[p] for p in local], rlay.n_own_pad, max(clay.n_ghost_pad, 1),
                      device=device)
    A = PSparseMatrix(DeviceSpMat(oo, oh), row_pr, col_pr, backend, nnz, blocks=blocks)
    A._oo_dia_host = (tuple(all_offs), vals)
    return A


def stencil_rhs_counts(
    parts_per_dir: Sequence[int],
    gshape: Sequence[int],
    offsets: Sequence[Tuple[int, ...]],
) -> List[np.ndarray]:
    """Per-part count of stencil legs that stay inside the global domain
    (per own row, C order), for right-hand sides like HPCG's
    ``b = 26 - n_offdiag``."""
    gshape = tuple(int(v) for v in gshape)
    counts = []
    for part in uniform_partition(parts_per_dir, gshape):
        acc = np.zeros(part.n_own, dtype=np.int64)
        for delta in offsets:
            _, in_glob = _axis_masks(part.shape, part.origin, gshape, delta)
            acc += _outer_and(in_glob)
        counts.append(acc)
    return counts
