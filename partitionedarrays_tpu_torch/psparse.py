"""PSparseMatrix: a row-partitioned sparse matrix, its COO constructor,
its state changes, its SpMVs and the distributed sparse products.

Counterpart of ``partitionedarrays_tpu/psparse.py``: ``_sorted_ghosts``
:54, ``DeviceSpMat`` and ``PSparseMatrix`` :63-360 with
``device_transpose``, its blockwise ``copy``, ``astype`` and arithmetic,
``_build_part_blocks`` and ``psparse`` :366-577, ``psparse_from_global``,
``centralize``, ``to_global_scipy`` and ``gather_global_scipy`` :885-977,
``_part_triplets`` :992, ``_hstack_local`` :1020, ``assemble_matrix``
:1349-1431 and ``consistent_matrix`` :1445-1552, ``spmv`` and ``spmtv``
:1568-1750, ``dense_diag`` :1757, ``sparse_diag_matrix`` :1779, ``spmm``
:1827, ``spmtm`` :1994, ``rap`` :2080, ``transpose_psparse`` :2102,
``identity_minus`` :2119, and the df64 SpMV ``device_df64``/``spmv_df64``
:2711-2783.

A matrix has frozen device blocks, the own-own block ``oo`` and the
own-ghost block ``oh`` (``ops/blocks.py``: DIA on kernel K1 or compressed
rows on K5), plus the ghost-own ``ho`` and ghost-ghost ``hh`` blocks of a
subassembled matrix (``assembled=False``), and host mirrors
``blocks[p]["oo"|"oh"|"ho"|"hh"]``: scipy CSR when it was assembled from
triplets (frozen on first use), a lazy scipy DIA ``oo`` for the
closed-form stencil matrices (``ops/stencil.py``), whose device blocks are
built directly.  The device blocks may hold another dtype than the host
mirrors (``device_dtype``): a float32 AMG hierarchy keeps the reference's
host products, whose prolongators are float64 (the nullspace is), and runs
its cycle in float32 as the reference does on its TPU, which has no
float64.

COO assembly runs on any number of parts of the serial backend, in the
three input states (disassembled, assembled, subassembled) and with local
ids; ghost columns are discovered from the triplets and ordered by owner,
then global id, after the partition's existing ghosts.  The sparse
products are the reference's distributed algorithms, part by part on the
host: the same scipy products on the same operands in the same order, so
the host blocks agree with the reference's number for number.  Left to
ROADMAP Queue 1: the reuse tier (``reuse=True``, the ``_into`` forms;
step 7, items 10 and 13), ``replicate_psparse``, ``split_format``,
``renumber_matrix``, ``repartition_*`` and ``psystem`` (item 10), and the
per-process matrices of the multi-process backend (item 15).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from .backends import SerialBackend
from .config import numpy_dtype, torch_dtype
from .ops import df64 as df
from .ops.blocks import DeviceBlock, block_spmv_df, freeze_block, freeze_block_pair
from .ops.sparse_host import compresscoo
from .parallel.exchange_plan import VectorLayout, layout_of
from .parallel.partition import INT, PRange, find_owner, map_local_to_global, matching_own_indices
from .pvector import PVector, Task, pvector_from_own

_REUSE = "the reuse tier: ROADMAP Queue 1 step 7 (items 10 and 13)"
_BLOCK_NAMES = ("oo", "oh", "ho", "hh")


def _sorted_ghosts(gids: np.ndarray, owners: np.ndarray):
    """Ghost ids ordered by owner, then global id."""
    order = np.lexsort((gids, owners))
    return gids[order], owners[order]


class DeviceSpMat:
    """Frozen device blocks: own-own ``oo`` and own-ghost ``oh`` (None for
    a matrix without ghost columns), and the ghost-own ``ho`` and
    ghost-ghost ``hh`` of a subassembled matrix (None when assembled)."""

    def __init__(self, oo: DeviceBlock, oh: Optional[DeviceBlock] = None,
                 ho: Optional[DeviceBlock] = None, hh: Optional[DeviceBlock] = None):
        self.oo = oo
        self.oh = oh
        self.ho = ho
        self.hh = hh


class PSparseMatrix:
    """A matrix with rows partitioned by ``row_prange`` and columns by
    ``col_prange``: assembled (every row's values on its owner) or
    subassembled (``assembled=False``: ghost rows hold contributions that
    belong to their owners).  Built from frozen device blocks
    (``device_blocks``) or from host blocks (``blocks``, frozen on
    ``device`` at first use, with values of ``device_dtype``, by default the
    host blocks' dtype)."""

    def __init__(
        self,
        device_blocks: Optional[DeviceSpMat],
        row_prange: PRange,
        col_prange: PRange,
        backend: SerialBackend,
        nnz: Optional[int] = None,
        blocks: Optional[List[dict]] = None,
        device="cuda",
        device_dtype: Optional[torch.dtype] = None,
        assembled: bool = True,
    ):
        if device_blocks is None and blocks is None:
            raise ValueError("PSparseMatrix needs device blocks or host blocks")
        self._device = device_blocks
        self.blocks = blocks
        self._target = device
        self._device_dtype = device_dtype
        self.row_prange = row_prange
        self.col_prange = col_prange
        self.backend = backend
        self.assembled = bool(assembled)
        if nnz is None:
            nnz = sum(m.nnz for b in blocks for m in b.values())
        self._nnz = int(nnz)
        self._device_T = None  # the frozen transposes of oo and oh, built once
        self._device_df = None  # the (hi, lo) pair of device_df64, built once

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.row_prange.n_global, self.col_prange.n_global)

    @property
    def dtype(self) -> torch.dtype:
        """The dtype of the device blocks."""
        if self._device is not None:
            return self._device.oo.vals.dtype
        return self._device_dtype or torch_dtype(self.blocks[0]["oo"].dtype)

    @property
    def torch_device(self) -> torch.device:
        """Where the device blocks live (or will, once frozen)."""
        if self._device is not None:
            return self._device.oo.vals.device
        return torch.device(self._target)

    def nnz(self) -> int:
        return self._nnz

    def row_layout(self) -> VectorLayout:
        return layout_of(self.row_prange)

    def col_layout(self) -> VectorLayout:
        return layout_of(self.col_prange)

    def _freeze(self, name: str, n_rows: int, n_cols: int) -> DeviceBlock:
        return freeze_block([b[name] for b in self.blocks], n_rows, n_cols,
                            device=self._target, dtype=self.dtype)

    def device(self) -> DeviceSpMat:
        """The frozen blocks; a matrix built from host blocks freezes them
        on first call (``freeze_block``: DIA when banded, else compressed
        rows)."""
        if self._device is None:
            rlay, clay = self.row_layout(), self.col_layout()
            ngc = max(clay.n_ghost_pad, 1)
            oo = self._freeze("oo", rlay.n_own_pad, clay.n_own_pad)
            oh = self._freeze("oh", rlay.n_own_pad, ngc)
            ho = hh = None
            if not self.assembled:
                ngr = max(rlay.n_ghost_pad, 1)
                ho = self._freeze("ho", ngr, clay.n_own_pad)
                hh = self._freeze("hh", ngr, ngc)
            self._device = DeviceSpMat(oo, oh, ho, hh)
        return self._device

    def device_transpose(self) -> Tuple[DeviceBlock, Optional[DeviceBlock]]:
        """The frozen transposes ``(oo^T, oh^T)`` of the own blocks (the
        products of ``spmtv``; ``oh^T`` is None without ghost columns),
        built once from the host blocks."""
        if self._device_T is None:
            if not self.assembled:
                raise ValueError("the transpose SpMV needs an assembled matrix")
            rlay, clay = self.row_layout(), self.col_layout()
            blocks = host_blocks(self)
            freeze = lambda name, n_rows: freeze_block(
                [b[name].T.tocsr() for b in blocks], n_rows, rlay.n_own_pad,
                device=self.torch_device, dtype=self.dtype,
            )
            ohT = freeze("oh", clay.n_ghost_pad) if clay.n_ghost_pad else None
            self._device_T = (freeze("oo", clay.n_own_pad), ohT)
        return self._device_T

    def __repr__(self):
        return (
            f"PSparseMatrix({self.shape[0]}x{self.shape[1]}, P="
            f"{self.row_prange.n_parts}, nnz={self.nnz()})"
        )

    # -- blockwise algebra on the host blocks ------------------------------
    def _map_blocks(self, f, dtype: Optional[torch.dtype] = None) -> "PSparseMatrix":
        """The matrix whose host blocks are ``f`` of these, on the same
        partitions; it freezes on first use, on this matrix's device, with
        device values of ``dtype`` (default: this matrix's)."""
        blocks = [{k: f(b[k]) for k in _BLOCK_NAMES if k in b} for b in host_blocks(self)]
        return PSparseMatrix(
            None, self.row_prange, self.col_prange, self.backend, blocks=blocks,
            device=self.torch_device, device_dtype=dtype or self.dtype, assembled=self.assembled,
        )

    def _zip_blocks(self, other: "PSparseMatrix", f) -> "PSparseMatrix":
        if other.shape != self.shape:
            raise ValueError("matrix shapes/partitions do not match")
        blocks = [
            {k: f(ba[k], bb[k]) for k in _BLOCK_NAMES if k in ba}
            for ba, bb in zip(host_blocks(self), host_blocks(other))
        ]
        return PSparseMatrix(
            None, self.row_prange, self.col_prange, self.backend, blocks=blocks,
            device=self.torch_device, device_dtype=torch.promote_types(self.dtype, other.dtype),
            assembled=self.assembled,
        )

    def copy(self) -> "PSparseMatrix":
        return self._map_blocks(lambda m: m.copy())

    def astype(self, dtype) -> "PSparseMatrix":
        """Blockwise host dtype conversion, frozen in ``dtype`` (e.g. the
        float32 preconditioner copy of a float64 operator for ``cg_df64``)."""
        return self._map_blocks(lambda m: m.astype(numpy_dtype(dtype)), torch_dtype(dtype))

    def __mul__(self, a):
        if not np.isscalar(a):
            return NotImplemented
        return self._map_blocks(lambda m: (m * a).tocsr())

    __rmul__ = __mul__

    def __truediv__(self, a):
        if not np.isscalar(a):
            return NotImplemented
        return self * (1.0 / a)

    def __neg__(self):
        return self * -1.0

    def __add__(self, other):
        if not isinstance(other, PSparseMatrix):
            return NotImplemented
        return self._zip_blocks(other, lambda a, b: (a + b).tocsr())

    def __sub__(self, other):
        if not isinstance(other, PSparseMatrix):
            return NotImplemented
        return self._zip_blocks(other, lambda a, b: (a - b).tocsr())


def host_blocks(A: PSparseMatrix) -> List[dict]:
    """A's host blocks (a stencil matrix's ``oo`` mirror is made on first
    access); a matrix adopted from device arrays (``convert.py``) has
    none."""
    if A.blocks is None:
        raise NotImplementedError(
            "host blocks of a matrix adopted from device arrays: ROADMAP Queue 1 item 10"
        )
    return A.blocks


# -- construction ------------------------------------------------------------

def _as_prange(x) -> PRange:
    return x if isinstance(x, PRange) else PRange(list(x))


def _build_part_blocks(li_row, li_col, I, J, V, subassembled: bool, dtype):
    """One part's triplets (global ids) -> its split blocks ``{"oo", "oh"}``
    (and ``"ho"``, ``"hh"`` when ``subassembled``), with the row and column
    parts extended by the ghosts the triplets touch (new ghosts by owner,
    then global id, after the existing ones).  ``compresscoo`` sums
    duplicates in triplet order and sorts the columns.  Negative ids mark
    entries to skip.  Returns (blocks, row part, column part)."""
    I = np.asarray(I, dtype=INT)
    J = np.asarray(J, dtype=INT)
    V = np.asarray(V, dtype=dtype)
    keep = (I >= 0) & (J >= 0)
    if not keep.all():
        I, J, V = I[keep], J[keep], V[keep]
    iro = li_row.global_to_own(I)
    row_is_own = iro >= 0
    li_row2 = li_row
    if subassembled:
        gids = np.unique(I[~row_is_own])
        new_g = gids[li_row.global_to_ghost(gids) < 0]
        if new_g.size:
            if li_row.global_to_owner is None:
                raise ValueError("subassembled psparse needs global_to_owner on the rows")
            li_row2 = li_row.union_ghost(*_sorted_ghosts(new_g, li_row.global_to_owner(new_g)))
        irg = li_row2.global_to_ghost(I)
    elif not row_is_own.all():
        raise ValueError("psparse: an assembled triplet row is not owned by its part")
    jco = li_col.global_to_own(J)
    col_is_own = jco >= 0
    ghost_j = np.unique(J[~col_is_own])
    new_j = ghost_j[li_col.global_to_ghost(ghost_j) < 0]
    li_col2 = li_col
    if new_j.size:
        if li_col.global_to_owner is None:
            raise ValueError("psparse needs global_to_owner on the columns")
        li_col2 = li_col.union_ghost(*_sorted_ghosts(new_j, li_col.global_to_owner(new_j)))
    jcg = li_col2.global_to_ghost(J)

    def block(sel, ri, ci, m, n):
        return compresscoo(ri[sel], ci[sel], V[sel], m, n)

    blocks = {
        "oo": block(row_is_own & col_is_own, iro, jco, li_row2.n_own, li_col2.n_own),
        "oh": block(row_is_own & ~col_is_own, iro, jcg, li_row2.n_own, li_col2.n_ghost),
    }
    if subassembled:
        blocks["ho"] = block(~row_is_own & col_is_own, irg, jco, li_row2.n_ghost, li_col2.n_own)
        blocks["hh"] = block(~row_is_own & ~col_is_own, irg, jcg, li_row2.n_ghost, li_col2.n_ghost)
    return blocks, li_row2, li_col2


def _shuffle_to_owners(rows_pr: PRange, I_parts, J_parts, V_parts, dtype):
    """The disassembled triplets moved to their row owners: for each
    destination part, the triplets of every source part in source-part
    order (a stable argsort by owner within each source), so that
    ``compresscoo`` sums the duplicates in the reference's order."""
    P = rows_pr.n_parts
    owners = find_owner(rows_pr.parts, I_parts)
    by_src = []
    for p in range(P):
        o = owners[p]
        order = np.argsort(o, kind="stable")
        bounds = np.searchsorted(o[order], np.arange(P + 1))
        by_src.append((np.asarray(I_parts[p], dtype=INT)[order],
                       np.asarray(J_parts[p], dtype=INT)[order],
                       np.asarray(V_parts[p], dtype=dtype)[order], bounds))
    tri = []
    for d in range(P):
        segs = [(sI[b[d]:b[d + 1]], sJ[b[d]:b[d + 1]], sV[b[d]:b[d + 1]])
                for sI, sJ, sV, b in by_src if b[d + 1] > b[d]]
        if segs:
            tri.append(tuple(np.concatenate([s[k] for s in segs]) for k in range(3)))
        else:
            tri.append((np.zeros(0, INT), np.zeros(0, INT), np.zeros(0, dtype)))
    return tri


def psparse(
    I_parts: Sequence[np.ndarray],
    J_parts: Sequence[np.ndarray],
    V_parts: Sequence[np.ndarray],
    rows,
    cols,
    backend: SerialBackend,
    assembled: bool = False,
    assemble: bool = True,
    reuse: bool = False,
    dtype=None,
    indices: str = "global",
    device="cuda",
    device_dtype=None,
) -> PSparseMatrix:
    """The COO constructor: per-part triplets (I, J, V), duplicates summed,
    on ``rows`` and ``cols`` (PRanges or lists of parts).

    - ``assembled=True``: every triplet lies in a row its part owns;
    - the default (disassembled): a part may contribute to rows of other
      parts; with ``assemble=True`` the triplets are moved to their row
      owners first (the result is assembled), with ``assemble=False`` they
      stay in ghost rows (the result is subassembled, with ``ho``/``hh``
      blocks and a row partition that has those ghosts).

    ``indices="local"``: I and J are local ids of ``rows`` and ``cols``,
    whose parts already hold every ghost the triplets touch.  The columns
    the triplets reach on other parts become ghost columns.  The blocks are
    frozen on ``device`` at first use, in ``device_dtype`` (default: the
    host dtype).  ``reuse=True`` (the fixed-sparsity refill) is not ported
    (ROADMAP Queue 1 step 7)."""
    if reuse:
        raise NotImplementedError(f"psparse(reuse=True), {_REUSE}")
    if indices not in ("global", "local"):
        raise ValueError(f"indices must be 'global' or 'local', got {indices!r}")
    rows_pr = _as_prange(rows)
    cols_pr = _as_prange(cols)
    P = rows_pr.n_parts
    dtype = numpy_dtype(np.asarray(V_parts[0]).dtype if dtype is None else dtype)
    if indices == "local":
        I_parts = [map_local_to_global(I_parts[p], rows_pr.parts[p]) for p in range(P)]
        J_parts = [map_local_to_global(J_parts[p], cols_pr.parts[p]) for p in range(P)]
    if assembled or not assemble:
        tri = [(I_parts[p], J_parts[p], np.asarray(V_parts[p], dtype=dtype)) for p in range(P)]
    else:
        tri = _shuffle_to_owners(rows_pr, I_parts, J_parts, V_parts, dtype)
    subassembled = not (assembled or assemble)
    built = [
        _build_part_blocks(rows_pr.parts[p], cols_pr.parts[p], *tri[p], subassembled, dtype)
        for p in range(P)
    ]
    return PSparseMatrix(
        None, PRange([b[1] for b in built]) if subassembled else rows_pr,
        PRange([b[2] for b in built]), backend, blocks=[b[0] for b in built],
        device=device, device_dtype=None if device_dtype is None else torch_dtype(device_dtype),
        assembled=not subassembled,
    )


def psparse_from_global(G: sp.spmatrix, rows, cols, backend: SerialBackend,
                        device="cuda") -> PSparseMatrix:
    """A global host matrix split into an assembled matrix on ``rows`` and
    ``cols``."""
    rows_pr = _as_prange(rows)
    G = G.tocsr()
    I_parts, J_parts, V_parts = [], [], []
    for li in rows_pr.parts:
        coo = G[li.own_to_global].tocoo()
        I_parts.append(li.own_to_global[coo.row])
        J_parts.append(coo.col.astype(INT))
        V_parts.append(coo.data)
    return psparse(I_parts, J_parts, V_parts, rows_pr, cols, backend, assembled=True,
                   device=device)


def _part_triplets(b: dict, li_r, li_c, names=("oo", "oh")):
    """Global-id (I, J, V) triplets of the named blocks of one part."""
    maps = {
        "oo": (li_r.own_to_global, li_c.own_to_global),
        "oh": (li_r.own_to_global, li_c.ghost_to_global),
        "ho": (li_r.ghost_to_global, li_c.own_to_global),
        "hh": (li_r.ghost_to_global, li_c.ghost_to_global),
    }
    Is, Js, Vs = [], [], []
    for name in names:
        blk = b.get(name)
        if blk is None or blk.nnz == 0:
            continue
        coo = blk.tocoo()
        Is.append(maps[name][0][coo.row])
        Js.append(maps[name][1][coo.col])
        Vs.append(coo.data)
    if not Is:
        return np.zeros(0, INT), np.zeros(0, INT), np.zeros(0, b["oo"].dtype)
    return np.concatenate(Is), np.concatenate(Js), np.concatenate(Vs)


def _hstack_local(b: dict, names=("oo", "oh")) -> sp.csr_matrix:
    """One part's rows as ``[own columns | ghost columns]`` CSR.  The
    entries keep each block's stored order, which fixes the rounding of
    the products' sums (the reference's setup products see the same
    order: its blocks are sorted there)."""
    mats = [b[k] for k in names if b.get(k) is not None]
    if len(mats) == 1:
        return mats[0].tocsr()
    return sp.hstack(mats, format="csr")


def _host_dtype(A: PSparseMatrix) -> np.dtype:
    return host_blocks(A)[0]["oo"].dtype


def to_global_scipy(A: PSparseMatrix) -> sp.csr_matrix:
    """All parts' blocks summed into one global CSR on the host."""
    m, n = A.shape
    Is, Js, Vs = [], [], []
    for b, li_r, li_c in zip(host_blocks(A), A.row_prange.parts, A.col_prange.parts):
        I, J, V = _part_triplets(b, li_r, li_c, _BLOCK_NAMES)
        Is.append(I)
        Js.append(J)
        Vs.append(V)
    G = sp.coo_matrix((np.concatenate(Vs), (np.concatenate(Is), np.concatenate(Js))),
                      shape=(m, n), dtype=_host_dtype(A))
    G.sum_duplicates()
    G = G.tocsr()
    G.sort_indices()
    return G


def centralize(A: PSparseMatrix) -> sp.csr_matrix:
    """The global host matrix (``to_global_scipy``)."""
    return to_global_scipy(A)


def gather_global_scipy(A: PSparseMatrix, max_rows: Optional[int] = None) -> sp.csr_matrix:
    """The global CSR of A on the host (``to_global_scipy``; a
    per-process matrix and its triplet gather are not ported)."""
    if max_rows is not None and A.shape[0] > max_rows:
        raise ValueError(f"gather_global_scipy: {A.shape[0]} rows exceeds max_rows={max_rows}")
    return to_global_scipy(A)


# -- state changes -------------------------------------------------------------

def assemble_matrix(A: PSparseMatrix) -> Task:
    """Subassembled -> assembled: each part sends the triplets of its ghost
    rows (``ho``, ``hh``) to their owners, which merge them after their own
    ``oo``/``oh`` triplets (source parts in order).  An assembled matrix is
    returned as it is.  ``reuse`` and ``assemble_matrix_into`` are the
    reuse tier (ROADMAP Queue 1 step 7)."""
    if A.assembled:
        return Task(A)
    dtype = _host_dtype(A)
    row_parts, col_parts = A.row_prange.parts, A.col_prange.parts
    msgs, own_tri = {}, []
    for p, (b, li_r, li_c) in enumerate(zip(host_blocks(A), row_parts, col_parts)):
        own_tri.append(_part_triplets(b, li_r, li_c, ("oo", "oh")))
        Ig, Jg, Vg = _part_triplets(b, li_r, li_c, ("ho", "hh"))
        if Ig.size:
            owners = li_r.ghost_to_owner[li_r.global_to_ghost(Ig)]
            order = np.argsort(owners, kind="stable")
            cuts = np.flatnonzero(np.diff(owners[order])) + 1
            for grp in np.split(order, cuts):
                msgs[(p, int(owners[grp[0]]))] = (Ig[grp], Jg[grp], Vg[grp])
    blocks, new_cols = [], []
    for p in range(A.row_prange.n_parts):
        chunks = [own_tri[p]] + [msgs[k] for k in sorted(msgs) if k[1] == p]
        b2, _, li_c2 = _build_part_blocks(
            row_parts[p].remove_ghost(), col_parts[p],
            *(np.concatenate([c[k] for c in chunks]) for k in range(3)), False, dtype,
        )
        blocks.append(b2)
        new_cols.append(li_c2)
    return Task(PSparseMatrix(
        None, PRange([li.remove_ghost() for li in row_parts]), PRange(new_cols), A.backend,
        blocks=blocks, device=A.torch_device, device_dtype=A.dtype,
    ))


def consistent_matrix(A: PSparseMatrix, rows_co) -> Task:
    """Assembled -> subassembled with the ghost rows of ``rows_co`` (a row
    partition with the wanted ghosts): each owner replies with the
    triplets of the rows other parts ghost, and each part classifies its
    own triplets and the fetched rows (by source part) into the four
    blocks, adding any new ghost column.  ``reuse`` and
    ``consistent_matrix_into`` are the reuse tier (ROADMAP Queue 1 step
    7)."""
    if not A.assembled:
        raise ValueError("consistent_matrix needs an assembled matrix")
    rows_co = _as_prange(rows_co)
    P = rows_co.n_parts
    dtype = _host_dtype(A)
    col_parts = A.col_prange.parts
    blocks_in = host_blocks(A)
    wanted = {}  # owner -> [(requester, gids)]
    for p, li in enumerate(rows_co.parts):
        if li.n_ghost == 0:
            continue
        owners = np.asarray(li.ghost_to_owner)
        order = np.argsort(owners, kind="stable")
        so = owners[order]
        cuts = np.flatnonzero(np.r_[True, so[1:] != so[:-1]])
        for k, start in enumerate(cuts):
            end = cuts[k + 1] if k + 1 < cuts.size else so.size
            o = int(so[start])
            if o != p:
                wanted.setdefault(o, []).append((p, li.ghost_to_global[order[start:end]]))
    msgs = {}
    for o, reqs in wanted.items():
        loc = _hstack_local(blocks_in[o])
        li_r, li_c = A.row_prange.parts[o], col_parts[o]
        col_g = np.concatenate([li_c.own_to_global, li_c.ghost_to_global])
        for p, gids in reqs:
            pos = li_r.global_to_own(gids)
            if not (pos >= 0).all():
                raise ValueError("consistent_matrix: a wanted row is not owned by its owner")
            sub = loc[pos].tocoo()
            msgs[(o, p)] = (gids[sub.row], col_g[sub.col], sub.data)
    blocks, new_cols = [], []
    for p in range(P):
        own = _part_triplets(blocks_in[p], A.row_prange.parts[p], col_parts[p])
        chunks = [own] + [msgs[k] for k in sorted(msgs) if k[1] == p]
        b2, _, li_c2 = _build_part_blocks(
            rows_co.parts[p], col_parts[p],
            *(np.concatenate([c[k] for c in chunks]) for k in range(3)), True, dtype,
        )
        blocks.append(b2)
        new_cols.append(li_c2)
    return Task(PSparseMatrix(
        None, PRange(list(rows_co.parts)), PRange(new_cols), A.backend, blocks=blocks,
        device=A.torch_device, device_dtype=A.dtype, assembled=False,
    ))


# -- derived operators (host) ------------------------------------------------

def dense_diag(A: PSparseMatrix) -> PVector:
    """The diagonal as a PVector on the row partition (entries of the
    own-own block whose global row and column ids agree)."""
    parts = []
    for b, li_r, li_c in zip(host_blocks(A), A.row_prange.parts, A.col_prange.parts):
        d = np.zeros(li_r.n_own, dtype=b["oo"].dtype)
        coo = b["oo"].tocoo()
        m = li_c.own_to_global[coo.col] == li_r.own_to_global[coo.row]
        d[coo.row[m]] = coo.data[m]
        parts.append(d)
    return pvector_from_own(parts, A.row_prange, A.backend, dtype=A.dtype, device=A.torch_device)


def sparse_diag_matrix(v: PVector, rows: Optional[PRange] = None) -> PSparseMatrix:
    """The diagonal matrix of v's own values, on ``rows`` (default: v's
    partition) without ghosts."""
    pr = PRange([li.remove_ghost() for li in (rows or v.layout.pr).parts])
    own = v.own.cpu().numpy()
    I_parts = [li.own_to_global for li in pr.parts]
    V_parts = [own[p, : li.n_own] for p, li in enumerate(pr.parts)]
    return psparse(I_parts, I_parts, V_parts, pr, pr, v.backend, assembled=True,
                   device=v.own.device)


def _check_assembled(*mats) -> None:
    if not all(M.assembled for M in mats):
        raise ValueError("the sparse products need assembled matrices")


def spmm(A: PSparseMatrix, B: PSparseMatrix) -> PSparseMatrix:
    """C = A @ B, part by part: ``consistent_matrix(B)`` fetches the rows
    of B at A's ghost columns, then each part multiplies its ``[oo|oh]``
    rows of A by its ``[[oo, oh], [ho, hh]]`` rows of the fetched B (A's
    local columns and B's local rows align by construction), and its
    product is re-split by ``compresscoo``.  C's host dtype is the result
    type of the operands', its device dtype A's.  The reuse form is not
    ported (ROADMAP Queue 1 step 7)."""
    _check_assembled(A, B)
    for lb, lc in zip(B.row_prange.parts, A.col_prange.parts):
        if not matching_own_indices(lb, lc):
            raise ValueError("spmm: A's column owners must match B's row owners")
    rows_co = PRange([
        lb.replace_ghost(lc.ghost_to_global, lc.ghost_to_owner)
        for lb, lc in zip(B.row_prange.parts, A.col_prange.parts)
    ])
    Bc = consistent_matrix(B, rows_co).wait()
    dtype = np.result_type(_host_dtype(A), _host_dtype(B))
    blocks, new_cols = [], []
    for ba, bb, li_ra, li_rb, li_cb in zip(host_blocks(A), Bc.blocks, A.row_prange.parts,
                                          Bc.row_prange.parts, Bc.col_prange.parts):
        B_loc = _hstack_local(bb, ("oo", "oh"))
        if li_rb.n_ghost:
            B_loc = sp.vstack([B_loc, _hstack_local(bb, ("ho", "hh"))], format="csr")
        C = _hstack_local(ba) @ B_loc
        C.sum_duplicates()
        C.sort_indices()
        C = C.tocoo()
        col_g = np.concatenate([li_cb.own_to_global, li_cb.ghost_to_global])
        b2, _, li_c2 = _build_part_blocks(
            li_ra.remove_ghost(), li_cb.remove_ghost(), li_ra.own_to_global[C.row],
            col_g[C.col], C.data.astype(dtype, copy=False), False, dtype,
        )
        blocks.append(b2)
        new_cols.append(li_c2)
    return PSparseMatrix(
        None, PRange([li.remove_ghost() for li in A.row_prange.parts]), PRange(new_cols),
        A.backend, blocks=blocks, device=A.torch_device, device_dtype=A.dtype,
    )


def spmtm(A: PSparseMatrix, B: PSparseMatrix) -> PSparseMatrix:
    """C = A^T @ B: each part's ``[oo|oh]_A^T @ [oo|oh]_B`` (rows on A's
    local columns, ghosts included), whose triplets the disassembled
    constructor moves to their owners.  Dtypes as ``spmm``.

    Each part's product is sorted before the move, as in the reference's
    Galerkin product (its reuse form): the order in which ``compresscoo``
    sums the parts' contributions to one entry fixes its rounding.  The
    reference's plain ``spmtm`` moves its products unsorted and may differ
    from this one by an ulp where three or more parts meet."""
    _check_assembled(A, B)
    if A.row_prange.n_global != B.row_prange.n_global:
        raise ValueError("spmtm: A and B must share the row partition")
    dtype = np.result_type(_host_dtype(A), _host_dtype(B))
    I_parts, J_parts, V_parts = [], [], []
    for ba, bb, li_ca, li_cb in zip(host_blocks(A), host_blocks(B), A.col_prange.parts,
                                    B.col_prange.parts):
        AT = _hstack_local(ba).T.tocsr()
        AT.sort_indices()
        C = AT @ _hstack_local(bb)
        C.sum_duplicates()
        C.sort_indices()
        C = C.tocoo()
        I_parts.append(np.concatenate([li_ca.own_to_global, li_ca.ghost_to_global])[C.row])
        J_parts.append(np.concatenate([li_cb.own_to_global, li_cb.ghost_to_global])[C.col])
        V_parts.append(C.data.astype(dtype, copy=False))
    return psparse(
        I_parts, J_parts, V_parts, PRange([li.remove_ghost() for li in A.col_prange.parts]),
        PRange([li.remove_ghost() for li in B.col_prange.parts]), A.backend, dtype=dtype,
        device=A.torch_device, device_dtype=A.dtype,
    )


def rap(R: PSparseMatrix, A: PSparseMatrix, Pm: PSparseMatrix) -> PSparseMatrix:
    """The triple product R @ A @ P as two ``spmm``."""
    return spmm(R, spmm(A, Pm))


def transpose_psparse(A: PSparseMatrix) -> PSparseMatrix:
    """A^T: each part's ``[oo|oh]`` triplets with rows and columns swapped,
    moved to the column owners by the disassembled constructor."""
    _check_assembled(A)
    I_parts, J_parts, V_parts = [], [], []
    for b, li_r, li_c in zip(host_blocks(A), A.row_prange.parts, A.col_prange.parts):
        I, J, V = _part_triplets(b, li_r, li_c)
        I_parts.append(J)
        J_parts.append(I)
        V_parts.append(V)
    return psparse(
        I_parts, J_parts, V_parts, PRange([li.remove_ghost() for li in A.col_prange.parts]),
        PRange([li.remove_ghost() for li in A.row_prange.parts]), A.backend,
        dtype=_host_dtype(A), device=A.torch_device, device_dtype=A.dtype,
    )


def identity_minus(A: PSparseMatrix) -> PSparseMatrix:
    """I - A, blockwise: the identity lands in the own-own block where the
    global row and column ids agree."""
    _check_assembled(A)
    dtype = _host_dtype(A)
    blocks = []
    for b, li_r, li_c in zip(host_blocks(A), A.row_prange.parts, A.col_prange.parts):
        jco = li_c.global_to_own(li_r.own_to_global)
        rows = np.flatnonzero(jco >= 0)
        D = sp.csr_matrix((np.ones(rows.size, dtype=dtype), (rows, jco[rows])), shape=b["oo"].shape)
        blocks.append({"oo": (D - b["oo"]).tocsr(), "oh": (-b["oh"]).tocsr()})
    return PSparseMatrix(None, A.row_prange, A.col_prange, A.backend, blocks=blocks,
                         device=A.torch_device, device_dtype=A.dtype)


# -- SpMV ----------------------------------------------------------------------

def _col_ghosts(A: PSparseMatrix, x: PVector):
    """x's column layout and ghost values: a vector on the row range of a
    square matrix with matching own parts is re-homed to the column layout
    with zero ghosts, which the exchange fills (keeping the row layout
    would drop every own-ghost term)."""
    if x.layout is not A.col_layout() and x.layout is A.row_layout():
        clay = A.col_layout()
        return clay, x.own.new_zeros((clay.n_parts, clay.n_ghost_pad))
    return x.layout, x.ghost


def _has_exchange(clay: VectorLayout) -> bool:
    return clay.n_ghost_pad > 0 and clay.consistent_plan.n_rounds > 0


def spmv(
    A: PSparseMatrix, x: PVector, alpha=1.0, beta=None, y: Optional[PVector] = None
) -> PVector:
    """``alpha * A @ x [+ beta * y]`` (the reference's 5-argument form;
    ``beta`` defaults to 1 when ``y`` is given).  x is partitioned by
    ``A.col_prange``, or by the row range of a square matrix (re-homed,
    see ``_col_ghosts``); y by ``A.row_prange``.

    With ghost columns, ``g = consistent(x)`` (one exchange) and
    ``A x = A_oo x + A_oh g``: the own-own product is kernel K1 and the
    own-ghost product, kernel K5, accumulates into K1's output.  A
    subassembled matrix also forms its ghost rows ``A_ho x + A_hh g`` and
    adds them to their owners (one assemble exchange).  The reference's
    ``dev`` substitute is not ported."""
    clay, xg = _col_ghosts(A, x)
    rlay = A.row_layout()
    dev = A.device()
    out = dev.oo.spmv(x.own)
    g = clay.consistent_plan.apply(x.own, xg, "set") if _has_exchange(clay) else xg
    if _has_exchange(clay):
        out = dev.oh.spmv_add(g, out)
    if not A.assembled and rlay.n_ghost_pad:
        yg = dev.ho.spmv(x.own)
        if clay.n_ghost_pad:
            yg = dev.hh.spmv_add(g, yg)
        out = rlay.assemble_plan.apply(yg[:, : rlay.n_ghost_pad], out, "add")
    if not (isinstance(alpha, (int, float)) and alpha == 1.0):
        out = alpha * out
    if y is not None:
        out = out + (1.0 if beta is None else beta) * y.own
    ghost = out.new_zeros((rlay.n_parts, rlay.n_ghost_pad))
    return PVector(out, ghost, rlay, A.backend)


def spmtv(
    A: PSparseMatrix, x: PVector, alpha=1.0, beta=None, y: Optional[PVector] = None
) -> PVector:
    """``alpha * A^T @ x [+ beta * y]``: x partitioned by ``A.row_prange``,
    the result (and y) by ``A.col_prange``.  The products are the frozen
    transposes (``device_transpose``): the own-own one (DIA on K1 or
    compressed rows on K5) and, with ghost columns, the own-ghost one (K5),
    whose rows are the ghost columns and are added to their owners (the
    assemble exchange: without it a restriction would drop every
    contribution across parts)."""
    clay = A.col_layout()
    ooT, ohT = A.device_transpose()
    out = ooT.spmv(x.own)
    if ohT is not None and clay.assemble_plan.n_rounds:
        out = clay.assemble_plan.apply(ohT.spmv(x.own), out, "add")
    if not (isinstance(alpha, (int, float)) and alpha == 1.0):
        out = alpha * out
    if y is not None:
        out = out + (1.0 if beta is None else beta) * y.own
    return PVector(out, out.new_zeros((clay.n_parts, clay.n_ghost_pad)), clay, A.backend)


def device_df64(A: PSparseMatrix):
    """The (hi, lo) pair of device matrices of the df64 SpMV, split from
    A's float64 blocks on their device and kept on A
    (``freeze_block_pair``).  A must be float64, as the reference
    requires."""
    if A._device_df is None:
        if A.dtype != torch.float64:
            raise TypeError(
                f"device_df64 expects float64 blocks (build with dtype=np.float64), got {A.dtype}"
            )
        dev = A.device()
        ooh, ool = freeze_block_pair(dev.oo)
        ohh, ohl = freeze_block_pair(dev.oh) if dev.oh is not None else (None, None)
        A._device_df = (DeviceSpMat(ooh, ohh), DeviceSpMat(ool, ohl))
    return A._device_df


def spmv_df64(A: PSparseMatrix, x_pair) -> Tuple[PVector, PVector]:
    """A @ x with matrix and vector in df64; x_pair is (hi, lo) PVectors
    on ``A.col_prange`` (or re-homed from the row range, as ``spmv``).  One
    exchange per word, the own-own product through kernel K7, the
    own-ghost product as the compensated compressed-row product, joined by
    ``df.add``.  Matches the float64 SpMV to about 1e-13 of
    ``sum |A||x|``."""
    xh, xl = x_pair
    clay, xgh = _col_ghosts(A, xh)
    _, xgl = _col_ghosts(A, xl)
    rlay = A.row_layout()
    devh, devl = device_df64(A)
    y = block_spmv_df(devh.oo, devl.oo, (xh.own, xl.own))
    if _has_exchange(clay):
        gh = clay.consistent_plan.apply(xh.own, xgh, "set")
        gl = clay.consistent_plan.apply(xl.own, xgl, "set")
        y = df.add(y, block_spmv_df(devh.oh, devl.oh, (gh, gl)))
    zg = y[0].new_zeros((rlay.n_parts, rlay.n_ghost_pad))
    return PVector(y[0], zg, rlay, A.backend), PVector(y[1], zg, rlay, A.backend)
