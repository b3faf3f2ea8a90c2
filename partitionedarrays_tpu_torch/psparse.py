"""PSparseMatrix: a row-partitioned sparse matrix, its COO constructor,
its state changes, its SpMVs and the distributed sparse products.

Counterpart of ``partitionedarrays_tpu/psparse.py``: ``as_prange`` :50,
``_sorted_ghosts`` :54, ``DeviceSpMat`` and ``PSparseMatrix`` :63-360 with
``device_transpose``, its blockwise ``copy``, ``astype`` and arithmetic and
its block accessors (``own_own_values`` ...),
``_build_part_blocks`` and ``psparse`` :366-577, ``psparse_from_blocks`` :782,
``psparse_from_global``, ``centralize``, ``to_global_scipy`` and
``gather_global_scipy`` :885-977, ``replicate_psparse`` :980,
``_part_triplets`` :992, ``_hstack_local`` :1020, ``assemble_matrix``
:1349-1431 and ``consistent_matrix`` :1445-1552, ``spmv`` and ``spmtv``
:1568-1750, ``dense_diag`` :1757, ``sparse_diag_matrix`` :1779, ``spmm``
:1827, ``spmtm`` :1994, ``rap`` :2080, ``transpose_psparse`` :2102,
``identity_minus`` :2119, ``repartition_matrix`` :2146,
``repartition_system`` :2616, ``split_format``, ``split_matrix``,
``split_matrix_blocks`` and ``renumber_matrix`` :2638-2671, and the df64
SpMV ``device_df64``/``spmv_df64`` :2711-2783.

A matrix has frozen device blocks, the own-own block ``oo`` and the
own-ghost block ``oh`` (``ops/blocks.py``: DIA on kernel K1 or compressed
rows on K5), plus the ghost-own ``ho`` and ghost-ghost ``hh`` blocks of a
subassembled matrix (``assembled=False``), and host mirrors
``blocks[p]["oo"|"oh"|"ho"|"hh"]``: scipy CSR when it was assembled from
triplets (frozen on first use), a lazy scipy DIA ``oo`` for the
closed-form stencil matrices (``ops/stencil.py``), whose device blocks are
built directly; a matrix adopted from device arrays (``convert.py``) gets
its host blocks from its frozen blocks on first use (``host_blocks``).
The device blocks may hold another dtype than the host mirrors
(``device_dtype``): a float32 AMG hierarchy keeps the reference's host
products, whose prolongators are float64 (the nullspace is), and runs its
cycle in float32 as the reference does on its TPU, which has no float64.

COO assembly runs on any number of parts of the serial backend, in the
three input states (disassembled, assembled, subassembled) and with local
ids; ghost columns are discovered from the triplets and ordered by owner,
then global id, after the partition's existing ghosts.  The sparse
products are the reference's distributed algorithms, part by part on the
host: the same scipy products on the same operands in the same order, so
the host blocks agree with the reference's number for number.

The reuse tier (the reference's :453-780, :1048-1444 and :1791-2101,
``psystem`` :2673-2710): ``psparse(reuse=True)`` returns a cache that
refills the same triplets' new values (``psparse_refill`` on the host,
``DeviceRefill`` on the device); ``assemble_matrix``,
``consistent_matrix``, ``spmm``, ``spmtm`` and ``rap`` with
``reuse=True`` return a plan that their ``_into`` forms refill at fixed
sparsity, through frozen value routes (``_MatRoutes``) and fill positions,
never re-running ghost discovery or classification.  A refilled matrix
drops its frozen blocks (``invalidate_device``) and restacks the new
values into their structure on next use.

On a multi-process backend (``backends.MeshBackend``) a matrix's device
blocks hold the process's own parts (``[P_local, ...]``), frozen from its
parts' host blocks.  ``psparse_local`` builds a per-process matrix from
each process's own triplets: the other processes' parts hold empty
placeholder blocks, and the host setup products route their part-to-part
messages through ``parallel/host_exchange.py``
(``exchange_part_messages``), their refill routes across processes included
(``_MatRoutes.finalize_multiprocess``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from .backends import SerialBackend
from .config import numpy_dtype, torch_dtype
from .ops import df64 as df
from .ops.blocks import (
    DeviceBlock,
    block_spmv_df,
    freeze_block,
    freeze_block_pair,
    refreeze_block,
)
from .ops.dia import host_dia
from .ops.sparse_host import compresscoo, precompute_nzindex
from .parallel.host_exchange import allgather_part_arrays, exchange_part_messages
from .parallel.exchange_plan import VectorLayout, layout_of
from .parallel.partition import (INT, PRange, find_owner, map_local_to_global,
                                 matching_own_indices, renumber_partition)
from .pvector import PVector, Task, pvector_from_own, repartition

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

    def nbytes(self) -> int:
        """The device bytes of the blocks (``DeviceBlock.nbytes``)."""
        return sum(b.nbytes() for b in (self.oo, self.oh, self.ho, self.hh) if b is not None)

    def astype(self, dtype) -> "DeviceSpMat":
        """A copy with every block's values cast to ``dtype`` (structure
        shared)."""
        return DeviceSpMat(*(b.astype(dtype) if b is not None else None
                             for b in (self.oo, self.oh, self.ho, self.hh)))


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
        # a stencil matrix's own-own DIA values on the host, (offsets,
        # [P, n_off, n_own_pad]), where ops/stencil.py built them there
        self._oo_dia_host = None
        # the dropped frozen blocks and transposes of invalidate_device: the
        # structure the next freeze restacks the new values into
        self._frozen_structure = (None, None)
        self.values_version = 0  # counts the refills (invalidate_device)

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

    def _local_blocks(self, name: str, transpose: bool = False) -> list:
        """The host blocks ``name`` of the parts in this process (their
        transposes, as CSR, with ``transpose``)."""
        blocks = host_blocks(self)
        out = [blocks[p][name] for p in self.backend.local_parts()]
        return [b.T.tocsr() for b in out] if transpose else out

    def _freeze(self, parts: list, n_rows: int, n_cols: int, device) -> DeviceBlock:
        """Freeze the local parts' host blocks; on several processes the
        DIA-or-compressed-rows choice and the DIA offsets are agreed by all
        (``_agreed_dia_offsets``), so that every process takes the same
        kernels and smoother tier, and so is K5's plan
        (``_agreed_ell_groups``)."""
        return freeze_block(parts, n_rows, n_cols, device=device, dtype=self.dtype,
                            **_freeze_agreements(self.backend))

    def device(self) -> DeviceSpMat:
        """The frozen blocks; a matrix built from host blocks freezes them
        on first call (``freeze_block``: DIA when banded, else compressed
        rows), and after ``invalidate_device`` restacks the new values into
        the structure of the blocks it dropped (``refreeze_block``)."""
        if self._device is None:
            old = self._frozen_structure[0]
            rlay, clay = self.row_layout(), self.col_layout()
            ngc = max(clay.n_ghost_pad, 1)
            ngr = max(rlay.n_ghost_pad, 1)
            shapes = {"oo": (rlay.n_own_pad, clay.n_own_pad), "oh": (rlay.n_own_pad, ngc),
                      "ho": (ngr, clay.n_own_pad), "hh": (ngr, ngc)}
            names = _BLOCK_NAMES if not self.assembled else ("oo", "oh")
            frozen = {}
            for name in names:
                parts = self._local_blocks(name)
                if old is not None:
                    frozen[name] = refreeze_block(getattr(old, name), parts)
                else:
                    frozen[name] = self._freeze(parts, *shapes[name], self._target)
            self._device = DeviceSpMat(**frozen)
            self._frozen_structure = (None, self._frozen_structure[1])  # free the old values
        return self._device

    def device_transpose(self) -> Tuple[DeviceBlock, Optional[DeviceBlock]]:
        """The frozen transposes ``(oo^T, oh^T)`` of the own blocks (the
        products of ``spmtv``; ``oh^T`` is None without ghost columns),
        built once from the host blocks (restacked into the dropped
        structure after ``invalidate_device``)."""
        if self._device_T is None:
            if not self.assembled:
                raise ValueError("the transpose SpMV needs an assembled matrix")
            rlay, clay = self.row_layout(), self.col_layout()
            old = self._frozen_structure[1]

            def freeze(name, n_rows, k):
                parts = self._local_blocks(name, transpose=True)
                if old is not None:
                    return refreeze_block(old[k], parts)
                return self._freeze(parts, n_rows, rlay.n_own_pad, self.torch_device)

            ohT = freeze("oh", clay.n_ghost_pad, 1) if clay.n_ghost_pad else None
            self._device_T = (freeze("oo", clay.n_own_pad, 0), ohT)
            self._frozen_structure = (self._frozen_structure[0], None)
        return self._device_T

    def invalidate_device(self) -> None:
        """After new values at fixed sparsity (a refill): drop the frozen
        blocks, their transposes and the df64 pair.  The next ``device()``
        and ``device_transpose()`` restack the host values into the
        structure dropped here (offsets, compressed rows, K5's plans),
        never re-planning it."""
        dev, devT = self._frozen_structure
        self._frozen_structure = (self._device if self._device is not None else dev,
                                  self._device_T if self._device_T is not None else devT)
        self._device = self._device_T = self._device_df = self._oo_dia_host = None
        self.values_version += 1

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

    # the reference's accessors (psparse.py:197-208): each part's host
    # block, None for a ghost row block of an assembled matrix
    def own_own_values(self) -> List[sp.spmatrix]:
        return [b["oo"] for b in host_blocks(self)]

    def own_ghost_values(self) -> List[sp.spmatrix]:
        return [b["oh"] for b in host_blocks(self)]

    def ghost_own_values(self) -> List[Optional[sp.spmatrix]]:
        return [b.get("ho") for b in host_blocks(self)]

    def ghost_ghost_values(self) -> List[Optional[sp.spmatrix]]:
        return [b.get("hh") for b in host_blocks(self)]

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
    access; a matrix adopted from device arrays gets them from its frozen
    blocks on first access, ``_blocks_from_device``)."""
    if A.blocks is None:
        A.blocks = _blocks_from_device(A)
    return A.blocks


def _host_block(db: DeviceBlock, p: int, n_rows: int, n_cols: int):
    """Part p of a frozen block as a scipy matrix of ``n_rows`` x
    ``n_cols``: a DIA block as scipy DIA, a compressed-row block as CSR."""
    if db.kind == "dia":
        return host_dia(db.offsets, db.vals[p].cpu().numpy(), n_rows, n_cols)
    rows, cols = db.rows[p].cpu().numpy(), db.cols[p].cpu().numpy()
    vals = db.vals[p].cpu().numpy()
    live = (cols >= 0) & (rows >= 0)[None, :]
    r = np.broadcast_to(rows[None, :], cols.shape)[live]
    return sp.csr_matrix((vals[live], (r, cols[live])), shape=(n_rows, n_cols))


def _blocks_from_device(A: PSparseMatrix) -> List[dict]:
    """Host blocks of a matrix that has only frozen blocks, each part's
    own and ghost rows and columns."""
    dev = A.device()
    local = {p: k for k, p in enumerate(A.backend.local_parts())}
    out = []
    for p, (li_r, li_c) in enumerate(zip(A.row_prange.parts, A.col_prange.parts)):
        dims = {"oo": (li_r.n_own, li_c.n_own), "oh": (li_r.n_own, li_c.n_ghost),
                "ho": (li_r.n_ghost, li_c.n_own), "hh": (li_r.n_ghost, li_c.n_ghost)}
        b = {}
        for name in _BLOCK_NAMES:
            db = getattr(dev, name)
            if db is not None and p in local:
                b[name] = _host_block(db, local[p], *dims[name])
            elif db is not None or name == "oh":
                b[name] = sp.csr_matrix(dims[name], dtype=numpy_dtype(A.dtype))
        out.append(b)
    return out


# -- construction ------------------------------------------------------------

def as_prange(x) -> PRange:
    """``x`` as a PRange (a list of parts is wrapped)."""
    return x if isinstance(x, PRange) else PRange(list(x))


def _build_part_blocks(li_row, li_col, I, J, V, subassembled: bool, dtype):
    """One part's triplets (global ids) -> its split blocks ``{"oo", "oh"}``
    (and ``"ho"``, ``"hh"`` when ``subassembled``), with the row and column
    parts extended by the ghosts the triplets touch (new ghosts by owner,
    then global id, after the existing ones).  ``compresscoo`` sums
    duplicates in triplet order and sorts the columns.  Negative ids mark
    entries to skip.  Returns (blocks, row part, column part, the
    classification of the triplets that ``_dst_maps`` reads)."""
    I = np.asarray(I, dtype=INT)
    J = np.asarray(J, dtype=INT)
    V = np.asarray(V, dtype=dtype)
    n_in = I.shape[0]
    keep = (I >= 0) & (J >= 0)
    kept = None
    if not keep.all():
        kept = np.flatnonzero(keep)
        I, J, V = I[kept], J[kept], V[kept]
    iro = li_row.global_to_own(I)
    row_is_own = iro >= 0
    li_row2 = li_row
    irg = np.full(I.shape, -1, dtype=INT)
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
    info = (n_in, kept, iro, irg, jco, jcg, row_is_own, col_is_own)
    return blocks, li_row2, li_col2, info


def _shuffle_to_owners(rows_pr: PRange, I_parts, J_parts, V_parts, dtype):
    """The disassembled triplets moved to their row owners: for each
    destination part, the triplets of every source part in source-part
    order (a stable argsort by owner within each source), so that
    ``compresscoo`` sums the duplicates in the reference's order.  Each
    destination also gets the source part and source position of its
    triplets (the reuse cache's origins)."""
    P = rows_pr.n_parts
    owners = find_owner(rows_pr.parts, I_parts)
    by_src = []
    for p in range(P):
        o = owners[p]
        order = np.argsort(o, kind="stable")
        bounds = np.searchsorted(o[order], np.arange(P + 1))
        by_src.append((np.asarray(I_parts[p], dtype=INT)[order],
                       np.asarray(J_parts[p], dtype=INT)[order],
                       np.asarray(V_parts[p], dtype=dtype)[order], order, bounds))
    tri, origins = [], []
    for d in range(P):
        segs = [(sI[b[d]:b[d + 1]], sJ[b[d]:b[d + 1]], sV[b[d]:b[d + 1]],
                 np.full(b[d + 1] - b[d], q, dtype=INT), so[b[d]:b[d + 1]])
                for q, (sI, sJ, sV, so, b) in enumerate(by_src) if b[d + 1] > b[d]]
        if segs:
            cat = [np.concatenate([s[k] for s in segs]) for k in range(5)]
        else:
            cat = [np.zeros(0, INT), np.zeros(0, INT), np.zeros(0, dtype),
                   np.zeros(0, INT), np.zeros(0, INT)]
        tri.append(tuple(cat[:3]))
        origins.append(tuple(cat[3:]))
    return tri, origins


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
):
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
    host dtype).  ``reuse=True`` returns ``(A, cache)``: the cache routes
    new values of the same triplets into A (``psparse_refill``,
    ``device_refill_plan``)."""
    if indices not in ("global", "local"):
        raise ValueError(f"indices must be 'global' or 'local', got {indices!r}")
    if backend.is_multiprocess:
        if indices != "global" or not (assembled or assemble):
            raise ValueError("psparse on several processes: global ids into an assembled "
                             "matrix (psparse_local)")
        return psparse_local(I_parts, J_parts, V_parts, rows, cols, backend, dtype=dtype,
                             reuse=reuse, device=device, device_dtype=device_dtype)
    rows_pr = as_prange(rows)
    cols_pr = as_prange(cols)
    P = rows_pr.n_parts
    dtype = numpy_dtype(np.asarray(V_parts[0]).dtype if dtype is None else dtype)
    if indices == "local":
        I_parts = [map_local_to_global(I_parts[p], rows_pr.parts[p]) for p in range(P)]
        J_parts = [map_local_to_global(J_parts[p], cols_pr.parts[p]) for p in range(P)]
    if assembled or not assemble:
        tri = [(I_parts[p], J_parts[p], np.asarray(V_parts[p], dtype=dtype)) for p in range(P)]
        origins = [(np.full(len(tri[p][0]), p, dtype=INT), np.arange(len(tri[p][0]), dtype=INT))
                   for p in range(P)]
    else:
        tri, origins = _shuffle_to_owners(rows_pr, I_parts, J_parts, V_parts, dtype)
    subassembled = not (assembled or assemble)
    built = [
        _build_part_blocks(rows_pr.parts[p], cols_pr.parts[p], *tri[p], subassembled, dtype)
        for p in range(P)
    ]
    A = PSparseMatrix(
        None, PRange([b[1] for b in built]) if subassembled else rows_pr,
        PRange([b[2] for b in built]), backend, blocks=[b[0] for b in built],
        device=device, device_dtype=None if device_dtype is None else torch_dtype(device_dtype),
        assembled=not subassembled,
    )
    if not reuse:
        return A
    n_orig = [len(np.asarray(I_parts[q])) for q in range(P)]
    return A, _build_reuse_cache(A.blocks, origins, [b[3] for b in built], n_orig)


def _build_reuse_cache(blocks, origins, infos, n_orig):
    """Per original part q: for each of its triplets the destination part,
    block id (``_BLOCK_NAMES`` order) and position in that block's data,
    -1 for a dropped triplet."""
    P = len(blocks)
    offsets = np.zeros(P + 1, dtype=np.int64)
    np.cumsum(n_orig, out=offsets[1:])
    dp = np.full(offsets[-1], -1, dtype=np.int64)
    db = np.full(offsets[-1], -1, dtype=np.int64)
    dx = np.full(offsets[-1], -1, dtype=np.int64)
    for p in range(P):
        src_p, src_i = origins[p]
        dst_block, dst_pos = _dst_maps(blocks[p], infos[p])
        flat = offsets[src_p] + src_i
        dp[flat] = np.where(dst_block >= 0, p, -1)
        db[flat] = dst_block
        dx[flat] = dst_pos
    cut = lambda a: [a[offsets[q]:offsets[q + 1]] for q in range(P)]
    return cut(dp), cut(db), cut(dx)


def psparse_refill(A: PSparseMatrix, V_parts, cache) -> None:
    """New values of the triplets of ``psparse(..., reuse=True)``, summed
    into A's host blocks in place (duplicates in the order of the build:
    source part, then triplet); A's frozen blocks are dropped and restack
    the new values on next use (``invalidate_device``).  A per-process
    build's cache sends each process's new values along the build's
    messages (COLLECTIVE)."""
    if isinstance(cache, _LocalCooCache):
        return cache.refill(A, V_parts)
    dest_part, dest_block, dest_pos = cache
    for b in host_blocks(A):
        for name in _BLOCK_NAMES:
            if b.get(name) is not None:
                b[name].data[:] = 0
    for q, V in enumerate(V_parts):
        V = np.asarray(V)
        dp, db, dx = dest_part[q], dest_block[q], dest_pos[q]
        ok = dx >= 0
        key = dp[ok] * 4 + db[ok]
        for k in np.unique(key):
            m = key == k
            np.add.at(A.blocks[int(k) // 4][_BLOCK_NAMES[int(k) % 4]].data, dx[ok][m], V[ok][m])
    A.invalidate_device()


class DeviceRefill:
    """The refill of the frozen device blocks on the device: from the
    stacked new triplet values ``V[P, n_orig_pad]`` (``stack_values``) a
    new ``DeviceSpMat`` of A's structure, for ``spmv(A, x, dev=...)``.

    Built once from A and its ``psparse(reuse=True)`` cache: each triplet's
    destination part and flat slot in the frozen values, the cache's data
    position composed with the freeze layout (DIA ``vals[P, n_off, R]``:
    slot ``d * R + row``; compressed rows ``vals[P, K, Nr]``: slot ``lane *
    Nr + r``, r the row's place among the rows with nonzeros).  The sum is
    plain torch and deterministic: the triplets of one slot are ranked in
    the host refill's order, and rank k of every slot is added by one
    ``index_add_`` whose indices are unique, so each slot is summed in the
    order ``psparse_refill`` sums it, in the host dtype, and then cast to
    the blocks' device dtype: the result equals the host refill and
    refreeze bit for bit."""

    def __init__(self, A: PSparseMatrix, cache):
        dev = A.device()
        blocks = host_blocks(A)
        dest_part, dest_block, dest_pos = cache
        P = len(blocks)
        self._dev = {name: getattr(dev, name) for name in _BLOCK_NAMES}
        self.n_orig_pad = max([1] + [dp.shape[0] for dp in dest_part])
        self.dtype = torch_dtype(_host_dtype(A))
        self.device = A.torch_device
        self.ranks = {}
        for bi, name in enumerate(_BLOCK_NAMES):
            db = self._dev[name]
            if db is None:
                continue
            slot_of_pos = [_freeze_slots(db, blocks[p][name]) for p in range(P)]
            flat_n = int(np.prod(db.vals.shape[1:]))
            src, out = [], []
            for q in range(P):
                sel = np.flatnonzero((dest_block[q] == bi) & (dest_pos[q] >= 0))
                dps = dest_part[q][sel]
                slot = np.empty(sel.size, dtype=np.int64)
                for p in np.unique(dps):
                    m = dps == p
                    slot[m] = slot_of_pos[int(p)][dest_pos[q][sel[m]]]
                src.append(q * self.n_orig_pad + sel)
                out.append(dps * flat_n + slot)
            src, out = np.concatenate(src), np.concatenate(out)
            order = np.argsort(out, kind="stable")  # keeps (q, t) order in a slot
            so = out[order]
            first = np.r_[True, so[1:] != so[:-1]]
            start = np.maximum.accumulate(np.where(first, np.arange(so.size), 0))
            rank = np.arange(so.size) - start
            self.ranks[name] = [
                (torch.from_numpy(src[order][rank == r]).to(self.device),
                 torch.from_numpy(so[rank == r]).to(self.device))
                for r in range(int(rank.max()) + 1 if rank.size else 0)
            ]

    def stack_values(self, V_parts) -> torch.Tensor:
        """Per-part triplet values -> ``[P, n_orig_pad]`` on A's device, in
        the host dtype."""
        out = np.zeros((len(V_parts), self.n_orig_pad), dtype=numpy_dtype(self.dtype))
        for q, v in enumerate(V_parts):
            v = np.asarray(v)
            out[q, : v.size] = v
        return torch.from_numpy(out).to(self.device)

    def __call__(self, V_stacked: torch.Tensor) -> DeviceSpMat:
        flat_v = V_stacked.reshape(-1)
        new = {}
        for name in _BLOCK_NAMES:
            db = self._dev[name]
            if db is None:
                new[name] = None
                continue
            vals = flat_v.new_zeros(db.vals.numel())
            for src, out in self.ranks[name]:
                vals.index_add_(0, out, flat_v[src])
            vals = vals.reshape(db.vals.shape).to(db.vals.dtype)
            new[name] = DeviceBlock(db.kind, db.offsets, db.n_rows, db.n_cols_pad, vals,
                                    rows=db.rows, cols=db.cols, plan=db.plan)
        return DeviceSpMat(new["oo"], new["oh"], new["ho"], new["hh"])


def _freeze_slots(db: DeviceBlock, blk) -> np.ndarray:
    """Flat slot in ``db.vals[p]`` of each data position of the part's
    canonical CSR block ``blk``."""
    csr = _canon_csr(blk)
    nnz_row = np.diff(csr.indptr)
    rows = np.repeat(np.arange(csr.shape[0], dtype=np.int64), nnz_row)
    if db.kind == "dia":
        offs = np.asarray(db.offsets, dtype=np.int64)
        d = np.searchsorted(offs, csr.indices.astype(np.int64) - rows)
        return d * db.vals.shape[-1] + rows
    Nr = db.vals.shape[-1]
    live = np.flatnonzero(nnz_row)
    r_of_row = np.full(csr.shape[0], -1, dtype=np.int64)
    r_of_row[live] = np.arange(live.size)
    lane = np.arange(csr.nnz) - np.repeat(csr.indptr[:-1].astype(np.int64), nnz_row)
    return lane * Nr + r_of_row[rows]


def device_refill_plan(A: PSparseMatrix, cache) -> DeviceRefill:
    """The device refill of A's frozen blocks (``DeviceRefill``)."""
    return DeviceRefill(A, cache)


def psparse_from_global(G: sp.spmatrix, rows, cols, backend: SerialBackend,
                        device="cuda") -> PSparseMatrix:
    """A global host matrix split into an assembled matrix on ``rows`` and
    ``cols``."""
    rows_pr = as_prange(rows)
    G = G.tocsr()
    I_parts, J_parts, V_parts = [], [], []
    for li in rows_pr.parts:
        coo = G[li.own_to_global].tocoo()
        I_parts.append(li.own_to_global[coo.row])
        J_parts.append(coo.col.astype(INT))
        V_parts.append(coo.data)
    return psparse(I_parts, J_parts, V_parts, rows_pr, cols, backend, assembled=True,
                   device=device)


def psparse_from_blocks(blocks: List[dict], rows, cols, backend: SerialBackend,
                        assembled: bool = True, device="cuda",
                        device_dtype=None) -> PSparseMatrix:
    """A matrix from per-part host blocks (``"oo"``, ``"oh"`` and, when not
    ``assembled``, ``"ho"``, ``"hh"``) in the local numbering of ``rows``
    and ``cols``, frozen on ``device`` at first use."""
    return PSparseMatrix(None, as_prange(rows), as_prange(cols), backend, blocks=list(blocks),
                         device=device,
                         device_dtype=None if device_dtype is None else torch_dtype(device_dtype),
                         assembled=assembled)


# -- per-process matrices (the multi-process backend) -----------------------

def _require_full_blocks(A: PSparseMatrix, op: str) -> None:
    """A per-process matrix (``psparse_local``) holds real host blocks only
    for its process's parts, and empty placeholders elsewhere: a host setup
    operation without a per-process form would sum the placeholders and
    return a partial result, so it raises instead."""
    if A.backend.is_multiprocess:
        raise ValueError(
            f"{op}: unsupported on a per-process PSparseMatrix: the other "
            "processes' parts hold empty placeholder blocks; use replicate_psparse(A) "
            "first if the matrix is small enough to hold on every process")


def _data_parts(A: PSparseMatrix) -> List[int]:
    """The parts whose host blocks are real in this process."""
    return list(A.backend.local_parts())


def _sync_ghosted_partition(backend, P, base_parts, built: dict):
    """The full per-part list of ghosted parts: the data parts give their
    built ones, the others are rebuilt from all-gathered ghost ids and
    owners on the same base part (the same on every process)."""
    if len(built) == P:
        return [built[p] for p in range(P)]
    gids = allgather_part_arrays(backend, P, {p: li.ghost_to_global for p, li in built.items()},
                                 INT)
    gown = allgather_part_arrays(backend, P, {p: li.ghost_to_owner for p, li in built.items()},
                                 INT)
    return [built[p] if p in built else base_parts[p].replace_ghost(gids[p], gown[p])
            for p in range(P)]


def _placeholder_blocks(li_r, li_c, dtype, subassembled: bool = False) -> dict:
    """Empty blocks of a part that another process holds."""
    b = {"oo": sp.csr_matrix((li_r.n_own, li_c.n_own), dtype=dtype),
         "oh": sp.csr_matrix((li_r.n_own, li_c.n_ghost), dtype=dtype)}
    if subassembled:
        b["ho"] = sp.csr_matrix((li_r.n_ghost, li_c.n_own), dtype=dtype)
        b["hh"] = sp.csr_matrix((li_r.n_ghost, li_c.n_ghost), dtype=dtype)
    return b


def _agree_max_i32(backend, arr) -> np.ndarray:
    """Elementwise max of a small int array across processes (the array
    itself in one process)."""
    arr = np.asarray(arr, dtype=np.int64)
    if not backend.is_multiprocess:
        return arr
    return np.max(backend.allgather_object(arr), axis=0)


def _agreed_dia_offsets(backend):
    """The agreement of ``freeze_block`` on several processes: DIA on the
    union of every process's offsets when every process's block is banded,
    the union is at most ``MAX_DIAGS`` wide and within the storage rule of
    the widest row anywhere; else compressed rows everywhere.  A process
    whose blocks are empty agrees with any band."""
    from .ops.dia import MAX_DIAGS

    def agree(offsets, kmax):
        mine = (None if offsets is None else [int(o) for o in offsets], int(kmax))
        views = backend.allgather_object(mine)
        kmax_all = max(k for _, k in views)
        if any(o is None for o, _ in views):
            return None, kmax_all
        union = np.array(sorted({o for offs, _ in views for o in offs}), dtype=np.int64)
        if union.size > MAX_DIAGS:
            return None, kmax_all
        return union, kmax_all

    return agree


def _agreed_ell_groups(backend):
    """The agreement of K5's plan on several processes: the row groups of
    the whole block (every part padded to the most groups of any part, as
    the serial backend's stacked block is) and the lanes summed over them,
    from each process's (groups a part, lanes summed)."""

    def agree(groups_per_part: int, total: int):
        views = backend.allgather_object((int(groups_per_part), int(total)))
        return backend.n_parts * max(g for g, _ in views), sum(t for _, t in views)

    return agree


def _freeze_agreements(backend) -> dict:
    """``freeze_block``'s agreements on a multi-process backend (none on
    one process)."""
    if not backend.is_multiprocess:
        return {}
    return {"agree": _agreed_dia_offsets(backend), "agree_lanes": _agreed_ell_groups(backend)}


class _LocalCooCache:
    """The frozen plan of a per-process COO build (``psparse_local(...,
    reuse=True)``): for each local source part and destination part, the
    positions of the source's triplets in the message of the build; for
    each message a local part received, the block and position of each of
    its triplets.  A refill sends the new values along the same messages
    and sums them in the build's order."""

    def __init__(self, send_idx: dict, recv_maps: dict, dtype):
        self.send_idx = send_idx
        self.recv_maps = recv_maps
        self.dtype = np.dtype(dtype)

    def refill(self, A: PSparseMatrix, V_parts) -> None:
        msgs = {k: (np.asarray(V_parts[k[0]], dtype=self.dtype)[idx],)
                for k, idx in self.send_idx.items()}
        got = exchange_part_messages(A.backend, A.row_prange.n_parts, msgs, (self.dtype,))
        for p in A.backend.local_parts():
            for name in _BLOCK_NAMES:
                if A.blocks[p].get(name) is not None:
                    A.blocks[p][name].data[:] = 0
        for key in sorted(self.recv_maps, key=lambda k: (k[1], k[0])):
            db, dx = self.recv_maps[key]
            vals = got[key][0]
            for bi in np.unique(db[dx >= 0]):
                m = (db == bi) & (dx >= 0)
                np.add.at(A.blocks[key[1]][_BLOCK_NAMES[int(bi)]].data, dx[m], vals[m])
        A.invalidate_device()


def psparse_local(I_parts, J_parts, V_parts, rows, cols, backend, dtype=None,
                  reuse: bool = False, device="cuda", device_dtype=None):
    """The per-process disassembled COO constructor: a process gives the
    triplets of its own parts only (the others may be None).  The triplets
    are moved to their row owners, and only those whose owner lives in
    another process travel (``exchange_part_messages``: edge-colored
    rounds padded per round, so the wire bytes are O(surface)); each owner
    sums its triplets in source-part order, as ``psparse`` does.  The
    column ghosts (O(surface)) are then all-gathered, so that every process
    holds the same partitions and exchange plans, and the other processes'
    parts keep empty placeholder blocks.  The result is assembled; its
    blocks are frozen here, the DIA choice
    agreed by all processes.  The shuffle's wire cost is left in
    ``backend._last_local_build_stats``.  ``reuse=True`` returns ``(A,
    cache)`` for ``psparse_refill``."""
    rows_pr, cols_pr = as_prange(rows), as_prange(cols)
    P = rows_pr.n_parts
    local = backend.local_parts()
    if any(I_parts[p] is None or J_parts[p] is None or V_parts[p] is None for p in local):
        raise ValueError("psparse_local: a local part's triplets are missing")
    dtype = numpy_dtype(np.asarray(V_parts[local[0]]).dtype if dtype is None else dtype)
    msgs, send_idx = {}, {}
    for p in local:
        I = np.asarray(I_parts[p], dtype=INT)
        o = find_owner(rows_pr.parts, [I])[0]
        order = np.argsort(o, kind="stable")
        bounds = np.searchsorted(o[order], np.arange(P + 1))
        J = np.asarray(J_parts[p], dtype=INT)[order]
        V = np.asarray(V_parts[p], dtype=dtype)[order]
        I = I[order]
        for d in range(P):
            lo, hi = bounds[d], bounds[d + 1]
            if hi > lo:
                msgs[(p, d)] = (I[lo:hi], J[lo:hi], V[lo:hi])
                send_idx[(p, d)] = order[lo:hi]
    stats: dict = {}
    got = exchange_part_messages(backend, P, msgs, (INT, INT, dtype), stats=stats)
    backend._last_local_build_stats = stats
    built, recv_maps = {}, {}
    for d in local:
        keys = sorted(k for k in got if k[1] == d)
        chunks = [got[k] for k in keys]
        tri = [np.concatenate([c[f] for c in chunks]) if chunks else
               np.zeros(0, INT if f < 2 else dtype) for f in range(3)]
        built[d] = _build_part_blocks(rows_pr.parts[d], cols_pr.parts[d], *tri, False, dtype)
        if reuse:
            db, dx = _dst_maps(built[d][0], built[d][3])
            cuts = np.cumsum([len(c[0]) for c in chunks])[:-1]
            for k, b_, x_ in zip(keys, np.split(db, cuts), np.split(dx, cuts)):
                recv_maps[k] = (b_, x_)
    gids = allgather_part_arrays(backend, P, {p: b[2].ghost_to_global for p, b in built.items()},
                                 INT, stats=stats)
    gown = allgather_part_arrays(backend, P, {p: b[2].ghost_to_owner for p, b in built.items()},
                                 INT, stats=stats)
    col_parts, blocks = [], []
    for p in range(P):
        if p in built:
            col_parts.append(built[p][2])
            blocks.append(built[p][0])
        else:
            li_c = cols_pr.parts[p].replace_ghost(gids[p], gown[p])
            col_parts.append(li_c)
            blocks.append(_placeholder_blocks(rows_pr.parts[p], li_c, dtype))
    nnz = int(backend.allreduce(torch.tensor(sum(blocks[p][k].nnz for p in local
                                                 for k in ("oo", "oh")))))
    A = PSparseMatrix(None, rows_pr, PRange(col_parts), backend, nnz=nnz, blocks=blocks,
                      device=device,
                      device_dtype=None if device_dtype is None else torch_dtype(device_dtype))
    A.device()
    return (A, _LocalCooCache(send_idx, recv_maps, dtype)) if reuse else A


def replicate_psparse(A: PSparseMatrix, max_rows: Optional[int] = 1_000_000) -> PSparseMatrix:
    """The matrix with every part's blocks on this process: on the serial
    backend every matrix already is, so ``A`` itself (``max_rows``, the
    reference's cap on a per-process gather, has nothing to cap)."""
    return A


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
    """All parts' blocks summed into one global CSR on the host (on several
    processes: ``gather_global_scipy``)."""
    _require_full_blocks(A, "to_global_scipy")
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
    """The global CSR of A on the host of every process (``to_global_scipy``;
    on several processes each process's parts' triplets are all-gathered,
    COLLECTIVE)."""
    if max_rows is not None and A.shape[0] > max_rows:
        raise ValueError(f"gather_global_scipy: {A.shape[0]} rows exceeds max_rows={max_rows}")
    if not A.backend.is_multiprocess:
        return to_global_scipy(A)
    blocks = host_blocks(A)
    mine = [_part_triplets(blocks[p], A.row_prange.parts[p], A.col_prange.parts[p],
                           _BLOCK_NAMES) for p in _data_parts(A)]
    tri = [t for chunk in A.backend.allgather_object(mine) for t in chunk]
    G = sp.coo_matrix((np.concatenate([t[2] for t in tri]),
                       (np.concatenate([t[0] for t in tri]), np.concatenate([t[1] for t in tri]))),
                      shape=A.shape, dtype=_host_dtype(A))
    G.sum_duplicates()
    G = G.tocsr()
    G.sort_indices()
    return G


# -- the routing tier of the reuse forms ----------------------------------------
# A value's source is tagged ``(part * 4 + block) << 40 | position``, its
# position in the source block's canonical CSR data; a refill scatters the
# sources' current values through the frozen (source, destination) pairs.

_TAG_SHIFT = 40
_TAG_MASK = np.int64((1 << _TAG_SHIFT) - 1)


def _canon_csr(blk) -> sp.csr_matrix:
    """The canonical (sorted-indices) CSR of a host block: a CSR block is
    sorted in place (the matrix owns it and stays canonical), another
    format converts."""
    m = blk.tocsr()
    if not m.has_sorted_indices:
        m.sort_indices()
    return m


def _canon_data(blk) -> np.ndarray:
    return _canon_csr(blk).data


def _canonicalize_blocks(A: PSparseMatrix) -> None:
    """Every host block of A as canonical CSR, in place: tags and refills
    address ``.data`` directly."""
    for b in host_blocks(A):
        for name in _BLOCK_NAMES:
            v = b.get(name)
            if v is None:
                continue
            if not sp.issparse(v) or v.format != "csr":
                b[name] = _canon_csr(v)
            elif not v.has_sorted_indices:
                v.sort_indices()


def _tag_base(p: int, bi: int) -> np.int64:
    return np.int64((p * 4 + bi) << _TAG_SHIFT)


def _part_triplets_tagged(b: dict, li_r, li_c, p: int, names=("oo", "oh")):
    """``_part_triplets`` of the canonical blocks, with each triplet's
    source tag."""
    maps = {
        "oo": (li_r.own_to_global, li_c.own_to_global),
        "oh": (li_r.own_to_global, li_c.ghost_to_global),
        "ho": (li_r.ghost_to_global, li_c.own_to_global),
        "hh": (li_r.ghost_to_global, li_c.ghost_to_global),
    }
    Is, Js, Vs, Ts = [], [], [], []
    for name in names:
        blk = b.get(name)
        if blk is None or blk.nnz == 0:
            continue
        m = _canon_csr(blk)
        coo = m.tocoo()
        Is.append(maps[name][0][coo.row])
        Js.append(maps[name][1][coo.col])
        Vs.append(coo.data)
        Ts.append(_tag_base(p, _BLOCK_NAMES.index(name)) | np.arange(m.nnz, dtype=np.int64))
    if not Is:
        z = np.zeros(0, INT)
        return z, z, np.zeros(0, b["oo"].dtype), np.zeros(0, np.int64)
    return tuple(np.concatenate(a) for a in (Is, Js, Vs, Ts))


def _dst_maps(blocks: dict, info):
    """(destination block id, destination data position) of every input
    triplet of a ``_build_part_blocks`` call, -1 for a dropped one."""
    n_in, kept, iro, irg, jco, jcg, rown, coln = info
    n = rown.shape[0]
    dst_block = np.full(n, -1, dtype=np.int64)
    dst_pos = np.full(n, -1, dtype=np.int64)
    sels = {
        "oo": (rown & coln, iro, jco),
        "oh": (rown & ~coln, iro, jcg),
        "ho": (~rown & coln, irg, jco),
        "hh": (~rown & ~coln, irg, jcg),
    }
    for bi, name in enumerate(_BLOCK_NAMES):
        blk = blocks.get(name)
        if blk is None:
            continue
        sel, ri, ci = sels[name]
        if not sel.any():
            continue
        rsel, csel = ri[sel], ci[sel]
        pos = None
        # the common case: the selected triplets are the block's canonical
        # storage order (one equality check instead of the binary search)
        if rsel.size == blk.nnz:
            blk_rows = np.repeat(np.arange(blk.shape[0], dtype=rsel.dtype), np.diff(blk.indptr))
            if np.array_equal(blk_rows, rsel) and np.array_equal(blk.indices, csel):
                pos = np.arange(blk.nnz, dtype=np.int64)
        if pos is None:
            pos = precompute_nzindex(blk, rsel, csel)
        idx = np.flatnonzero(sel)
        dst_block[idx] = bi
        dst_pos[idx] = pos
    if kept is None:
        return dst_block, dst_pos
    full_block = np.full(n_in, -1, dtype=np.int64)
    full_pos = np.full(n_in, -1, dtype=np.int64)
    full_block[kept] = dst_block
    full_pos[kept] = dst_pos
    return full_block, full_pos


class _MatRoutes:
    """The frozen value routing between two matrices of fixed sparsity:
    ``refill`` zeroes the destination's data and adds every source value at
    its recorded position, in the order of the build."""

    def __init__(self):
        self._acc: dict = {}
        self.routes: list = []
        self.multiprocess = False
        self.send_plan: dict = {}  # (local source, remote destination) -> (blocks, positions)
        self.recv_scatter: dict = {}  # (remote source, local destination) -> (blocks, positions)

    def add(self, dst_p: int, tags, dst_block, dst_pos) -> None:
        ok = (dst_pos >= 0) & (dst_block >= 0)
        tags, dst_block, dst_pos = tags[ok], dst_block[ok], dst_pos[ok]
        if not tags.size:
            return
        key = (tags >> _TAG_SHIFT) * 4 + dst_block
        spos = tags & _TAG_MASK
        order = np.argsort(key, kind="stable")
        ks = key[order]
        cuts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
        for i, st in enumerate(cuts):
            en = cuts[i + 1] if i + 1 < cuts.size else ks.size
            sk = int(ks[st])
            src_p, src_bi, dbi = sk // 16, (sk // 4) % 4, sk % 4
            sel = order[st:en]
            self._acc.setdefault((dst_p, dbi, src_p, src_bi), []).append((spos[sel], dst_pos[sel]))

    def finalize(self) -> "_MatRoutes":
        for k, segs in self._acc.items():
            self.routes.append(k + (np.concatenate([a for a, _ in segs]),
                                    np.concatenate([d for _, d in segs])))
        self._acc = {}
        return self

    def finalize_multiprocess(self, backend, P: int, dtype) -> "_MatRoutes":
        """The refill across processes, set up once: the routes whose source
        part lives in another process become a request sent there (the
        source blocks and positions, in a fixed order) and a local scatter
        of the values that the request will bring; the source process keeps
        the request as its send plan.  COLLECTIVE."""
        self.multiprocess = True
        self.dtype = np.dtype(dtype)
        local = set(backend.local_parts())
        kept, remote = [], {}
        for r in self.routes:
            if r[2] in local:
                kept.append(r)
            else:
                remote.setdefault((r[0], r[2]), []).append(r)
        self.routes = kept
        reqs = {}
        for (dst_p, src_p), rs in sorted(remote.items()):
            rs = sorted(rs, key=lambda r: (r[1], r[3]))
            sbi = np.concatenate([np.full(r[4].size, r[3], dtype=np.int64) for r in rs])
            spos = np.concatenate([r[4] for r in rs]).astype(np.int64)
            dbi = np.concatenate([np.full(r[5].size, r[1], dtype=np.int64) for r in rs])
            dpos = np.concatenate([r[5] for r in rs]).astype(np.int64)
            reqs[(dst_p, src_p)] = (sbi, spos)
            self.recv_scatter[(src_p, dst_p)] = (dbi, dpos)
        got = exchange_part_messages(backend, P, reqs, (np.int64, np.int64))
        for (dst_p, src_p), (sbi, spos) in got.items():
            self.send_plan[(src_p, dst_p)] = (sbi, spos)
        return self

    def refill(self, src: PSparseMatrix, out: PSparseMatrix, data_of=None) -> None:
        """``data_of(part, block name) -> values`` replaces the source
        matrix's canonical block data (the ``spmtm`` refill routes its
        recomputed local products)."""
        if data_of is None:
            _canonicalize_blocks(src)
            data_of = lambda p, name: src.blocks[p][name].data
        for b in out.blocks:
            for name in _BLOCK_NAMES:
                if b.get(name) is not None:
                    b[name].data[:] = 0
        for dst_p, dbi, src_p, sbi, spos, dpos in self.routes:
            np.add.at(out.blocks[dst_p][_BLOCK_NAMES[dbi]].data, dpos,
                      data_of(src_p, _BLOCK_NAMES[sbi])[spos])
        if self.multiprocess:
            msgs = {}
            for (src_p, dst_p), (sbi, spos) in sorted(self.send_plan.items()):
                vals = np.empty(spos.size, dtype=self.dtype)
                for bi in np.unique(sbi):
                    m = sbi == bi
                    vals[m] = data_of(src_p, _BLOCK_NAMES[int(bi)])[spos[m]]
                msgs[(src_p, dst_p)] = (vals,)
            got = exchange_part_messages(out.backend, out.row_prange.n_parts, msgs, (self.dtype,))
            for key, (vals,) in sorted(got.items()):
                dbi, dpos = self.recv_scatter[key]
                for bi in np.unique(dbi):
                    m = dbi == bi
                    np.add.at(out.blocks[key[1]][_BLOCK_NAMES[int(bi)]].data, dpos[m], vals[m])
        out.invalidate_device()


def _hstack_with_tags(b: dict, p: int, names=("oo", "oh"), want_tags=True):
    """The part's rows as ``[block0 | block1 | ...]`` canonical CSR (a copy:
    the refills overwrite its data), each block's fill positions in it
    (``loc.data[fill[bi]] = block.data``) and, optionally, every entry's
    source tag.  With canonical blocks each row's entries of block k are
    contiguous and precede block k+1's, so the positions follow from the
    row pointers."""
    mats = [(name, _canon_csr(b[name])) for name in names if b.get(name) is not None]
    nrows = mats[0][1].shape[0]
    if len(mats) == 1:
        name, m = mats[0]
        bi = _BLOCK_NAMES.index(name)
        tags = _tag_base(p, bi) | np.arange(m.nnz, dtype=np.int64) if want_tags else None
        return m.copy(), tags, {bi: np.arange(m.nnz, dtype=np.int64)}
    loc = sp.hstack([m for _, m in mats], format="csr")
    indptr = loc.indptr.astype(np.int64)
    tags = np.empty(loc.nnz, dtype=np.int64) if want_tags else None
    fill = {}
    acc = np.zeros(nrows, dtype=np.int64)
    for name, m in mats:
        cnt = np.diff(m.indptr).astype(np.int64)
        within = np.arange(m.nnz, dtype=np.int64) - np.repeat(m.indptr[:-1].astype(np.int64), cnt)
        out_pos = np.repeat(indptr[:-1] + acc, cnt) + within
        bi = _BLOCK_NAMES.index(name)
        if want_tags:
            tags[out_pos] = _tag_base(p, bi) | np.arange(m.nnz, dtype=np.int64)
        fill[bi] = out_pos
        acc += cnt
    return loc, tags, fill


def _csr_row_slice_positions(M: sp.csr_matrix, rows: np.ndarray) -> np.ndarray:
    """Positions in ``M.data`` of the entries of ``M[rows]``, in its order."""
    rows = np.asarray(rows)
    cnt = (M.indptr[rows + 1] - M.indptr[rows]).astype(np.int64)
    starts = np.repeat(M.indptr[rows].astype(np.int64), cnt)
    csum = np.cumsum(cnt) - cnt
    return starts + np.arange(int(cnt.sum()), dtype=np.int64) - np.repeat(csum, cnt)


# -- state changes -------------------------------------------------------------

def assemble_matrix(A: PSparseMatrix, reuse: bool = False) -> Task:
    """Subassembled -> assembled: each part sends the triplets of its ghost
    rows (``ho``, ``hh``) to their owners, which merge them after their own
    ``oo``/``oh`` triplets (source parts in order).  An assembled matrix is
    returned as it is.  ``reuse=True``: the task yields ``(out, cache)``
    for ``assemble_matrix_into`` (the cache is None for an assembled A)."""
    if A.assembled:
        return Task((A, None)) if reuse else Task(A)
    _require_full_blocks(A, "assemble_matrix")
    dtype = _host_dtype(A)
    if reuse:
        _canonicalize_blocks(A)
    row_parts, col_parts = A.row_prange.parts, A.col_prange.parts
    triplets = _part_triplets_tagged if reuse else (lambda b, r, c, p, n: _part_triplets(b, r, c, n))
    msgs, own_tri = {}, []
    for p, (b, li_r, li_c) in enumerate(zip(host_blocks(A), row_parts, col_parts)):
        own_tri.append(triplets(b, li_r, li_c, p, ("oo", "oh")))
        ghost = triplets(b, li_r, li_c, p, ("ho", "hh"))
        if ghost[0].size:
            owners = li_r.ghost_to_owner[li_r.global_to_ghost(ghost[0])]
            order = np.argsort(owners, kind="stable")
            cuts = np.flatnonzero(np.diff(owners[order])) + 1
            for grp in np.split(order, cuts):
                msgs[(p, int(owners[grp[0]]))] = tuple(a[grp] for a in ghost)
    routes = _MatRoutes() if reuse else None
    blocks, new_cols = [], []
    for p in range(A.row_prange.n_parts):
        chunks = [own_tri[p]] + [msgs[k] for k in sorted(msgs) if k[1] == p]
        b2, _, li_c2, info = _build_part_blocks(
            row_parts[p].remove_ghost(), col_parts[p],
            *(np.concatenate([c[k] for c in chunks]) for k in range(3)), False, dtype,
        )
        blocks.append(b2)
        new_cols.append(li_c2)
        if reuse:
            routes.add(p, np.concatenate([c[3] for c in chunks]), *_dst_maps(b2, info))
    out = PSparseMatrix(
        None, PRange([li.remove_ghost() for li in row_parts]), PRange(new_cols), A.backend,
        blocks=blocks, device=A.torch_device, device_dtype=A.dtype,
    )
    return Task((out, routes.finalize())) if reuse else Task(out)


def assemble_matrix_into(out: PSparseMatrix, A: PSparseMatrix, cache) -> None:
    """``out`` refilled from new values of the subassembled A (same
    sparsity) through the frozen routes of ``assemble_matrix(A,
    reuse=True)``: a value scatter, no ghost discovery."""
    if cache is None:
        if out is not A:
            raise ValueError("assemble_matrix_into without a cache: A was assembled, out must be A")
        return
    cache.refill(A, out)


def consistent_matrix(A: PSparseMatrix, rows_co, reuse: bool = False) -> Task:
    """Assembled -> subassembled with the ghost rows of ``rows_co`` (a row
    partition with the wanted ghosts): each owner replies with the
    triplets of the rows other parts ghost, and each part classifies its
    own triplets and the fetched rows (by source part) into the four
    blocks, adding any new ghost column.  ``reuse=True``: the task yields
    ``(out, cache)`` for ``consistent_matrix_into``."""
    if not A.assembled:
        raise ValueError("consistent_matrix needs an assembled matrix")
    rows_co = as_prange(rows_co)
    P = rows_co.n_parts
    dtype = _host_dtype(A)
    if reuse:
        _canonicalize_blocks(A)
    col_parts = A.col_prange.parts
    blocks_in = host_blocks(A)
    data = _data_parts(A)
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
        if o not in data:
            continue
        if reuse:
            loc, loc_tags, _ = _hstack_with_tags(blocks_in[o], o)
        else:
            loc = _hstack_local(blocks_in[o])
        li_r, li_c = A.row_prange.parts[o], col_parts[o]
        col_g = np.concatenate([li_c.own_to_global, li_c.ghost_to_global])
        for p, gids in reqs:
            pos = li_r.global_to_own(gids)
            if not (pos >= 0).all():
                raise ValueError("consistent_matrix: a wanted row is not owned by its owner")
            sub = loc[pos].tocoo()
            msgs[(o, p)] = (gids[sub.row], col_g[sub.col], sub.data.astype(dtype, copy=False))
            if reuse:
                msgs[(o, p)] += (loc_tags[_csr_row_slice_positions(loc, pos)],)
    msgs = exchange_part_messages(A.backend, P, msgs,
                                  (INT, INT, dtype) + ((np.int64,) if reuse else ()))
    routes = _MatRoutes() if reuse else None
    blocks, new_cols = {}, {}
    for p in data:
        li_r, li_c = A.row_prange.parts[p], col_parts[p]
        own = (_part_triplets_tagged(blocks_in[p], li_r, li_c, p) if reuse
               else _part_triplets(blocks_in[p], li_r, li_c))
        chunks = [own] + [msgs[k] for k in sorted(msgs) if k[1] == p]
        b2, _, li_c2, info = _build_part_blocks(
            rows_co.parts[p], li_c,
            *(np.concatenate([c[k] for c in chunks]) for k in range(3)), True, dtype,
        )
        blocks[p] = b2
        new_cols[p] = li_c2
        if reuse:
            routes.add(p, np.concatenate([c[3] for c in chunks]), *_dst_maps(b2, info))
    cols_all = _sync_ghosted_partition(A.backend, P, col_parts, new_cols)
    out = PSparseMatrix(
        None, PRange(list(rows_co.parts)), PRange(cols_all), A.backend,
        blocks=[blocks[p] if p in blocks else
                _placeholder_blocks(rows_co.parts[p], cols_all[p], dtype, True) for p in range(P)],
        device=A.torch_device, device_dtype=A.dtype, assembled=False,
    )
    if reuse:
        routes.finalize()
        if A.backend.is_multiprocess:
            routes.finalize_multiprocess(A.backend, P, dtype)
    return Task((out, routes)) if reuse else Task(out)


def consistent_matrix_into(out: PSparseMatrix, A: PSparseMatrix, cache) -> None:
    """``out`` refreshed from new values of the assembled A (same
    sparsity) through the frozen routes of ``consistent_matrix(A, rows_co,
    reuse=True)``."""
    cache.refill(A, out)


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
    I_parts = [li.own_to_global for li in pr.parts]
    V_parts = v.own_values()  # None for the parts of another process
    return psparse(I_parts, I_parts, V_parts, pr, pr, v.backend, assembled=True,
                   device=v.own.device)


def _check_assembled(*mats) -> None:
    if not all(M.assembled for M in mats):
        raise ValueError("the sparse products need assembled matrices")


class _RefillOutsidePattern(ValueError):
    """A refilled product has a real entry outside the sparsity of its
    build (``_refilled_product``); ``AMGPreconditioner.update`` answers it
    with a new setup on the same aggregates."""


def _refilled_product(L: sp.csr_matrix, R: sp.csr_matrix, indptr: np.ndarray,
                      indices: np.ndarray, outside: Optional[list] = None) -> np.ndarray:
    """The values of the recomputed local product ``L @ R`` on the pattern
    of its build (``indptr``, ``indices``).

    scipy's product drops the entries whose sum is exactly zero, so the
    build's pattern (the reference's, which the AMG hierarchies match entry
    for entry) lacks an entry whose terms cancelled then.  New values may
    leave a rounding residue there: an entry within k eps of its row's
    largest (k the most terms a sum has, eps that of the operands' lower
    precision) stands for the same zero and is not kept.  A larger entry
    there raises ``_RefillOutsidePattern``: new values made real a product
    the build saw cancel, as in an elasticity hierarchy built at constant
    coefficients and refilled with variable ones.  With a list
    ``outside`` the entry is counted there instead and left out, so that
    a caller on several processes finishes the refill's collective steps
    before it acts on the fault.  An entry of the pattern that now cancels
    is stored as zero."""
    C = L @ R
    C.sum_duplicates()
    C.sort_indices()
    if np.array_equal(C.indptr, indptr) and np.array_equal(C.indices, indices):
        return C.data
    frozen = sp.csr_matrix((np.zeros(indices.size, C.dtype), indices, indptr), shape=C.shape)
    coo = C.tocoo()
    pos = precompute_nzindex(frozen, coo.row, coo.col)
    out = np.zeros(indices.size, dtype=C.dtype)
    out[pos[pos >= 0]] = coo.data[pos >= 0]
    extra = np.flatnonzero(pos < 0)
    if extra.size:
        eps = max(np.finfo(L.dtype).eps, np.finfo(R.dtype).eps)
        k = max(int(np.diff(L.indptr).max(initial=0)), 1)
        row_max = np.zeros(C.shape[0])
        np.maximum.at(row_max, coo.row, np.abs(coo.data))
        real = int(np.count_nonzero(np.abs(coo.data[extra]) > k * eps * row_max[coo.row[extra]]))
        if real and outside is None:
            raise _RefillOutsidePattern(
                "a refilled product has an entry outside the sparsity of its build: its terms "
                "cancelled exactly at the build; AMGPreconditioner.update sets up anew there")
        if real:
            outside.append(real)
    return out


class _SpmmCache:
    """The frozen plan of C = A @ B at fixed sparsity of both operands:
    the consistent fetch of B refreshes through its routes, the local
    ``[A | ghost]`` and ``[[B], [B ghost]]`` operands through their fill
    positions, the scipy product is recomputed and its canonical values
    land in C's blocks at their recorded positions."""

    def __init__(self, Bc, bc_cache):
        self.Bc = Bc
        self.bc_cache = bc_cache
        self.parts: dict = {}

    def refill(self, C: PSparseMatrix, A: PSparseMatrix, B: PSparseMatrix,
               refresh_b: bool = True, outside: Optional[list] = None) -> None:
        _canonicalize_blocks(A)
        if refresh_b:
            consistent_matrix_into(self.Bc, B, self.bc_cache)
        for p, (A_loc, a_fill, B_loc, b_fill, pattern, dst) in self.parts.items():
            for bi, idx in a_fill.items():
                A_loc.data[idx] = A.blocks[p][_BLOCK_NAMES[bi]].data
            for bi, idx in b_fill.items():
                B_loc.data[idx] = _canon_data(self.Bc.blocks[p][_BLOCK_NAMES[bi]])
            data = _refilled_product(A_loc, B_loc, *pattern, outside=outside)
            for name, cpos, dpos in dst:
                d = C.blocks[p][name].data
                d[:] = 0
                d[dpos] = data[cpos]
        C.invalidate_device()


def spmm(A: PSparseMatrix, B: PSparseMatrix, reuse: bool = False):
    """C = A @ B, part by part: ``consistent_matrix(B)`` fetches the rows
    of B at A's ghost columns, then each part multiplies its ``[oo|oh]``
    rows of A by its ``[[oo, oh], [ho, hh]]`` rows of the fetched B (A's
    local columns and B's local rows align by construction), and its
    product is re-split by ``compresscoo``.  C's host dtype is the result
    type of the operands', its device dtype A's.  ``reuse=True`` returns
    ``(C, cache)`` for ``spmm_into``."""
    _check_assembled(A, B)
    for lb, lc in zip(B.row_prange.parts, A.col_prange.parts):
        if not matching_own_indices(lb, lc):
            raise ValueError("spmm: A's column owners must match B's row owners")
    rows_co = PRange([
        lb.replace_ghost(lc.ghost_to_global, lc.ghost_to_owner)
        for lb, lc in zip(B.row_prange.parts, A.col_prange.parts)
    ])
    if reuse:
        _canonicalize_blocks(A)
        Bc, bc_cache = consistent_matrix(B, rows_co, reuse=True).wait()
        cache = _SpmmCache(Bc, bc_cache)
    else:
        Bc = consistent_matrix(B, rows_co).wait()
    dtype = np.result_type(_host_dtype(A), _host_dtype(B))
    blocks, new_cols = {}, {}
    for p in _data_parts(A):
        ba, bb = host_blocks(A)[p], Bc.blocks[p]
        li_ra, li_rb, li_cb = A.row_prange.parts[p], Bc.row_prange.parts[p], Bc.col_prange.parts[p]
        if reuse:
            A_loc, _, a_fill = _hstack_with_tags(ba, p, want_tags=False)
            B_loc, _, b_fill = _hstack_with_tags(bb, p, ("oo", "oh"), want_tags=False)
            if li_rb.n_ghost:
                bot, _, bot_fill = _hstack_with_tags(bb, p, ("ho", "hh"), want_tags=False)
                b_fill.update({bi: idx + B_loc.nnz for bi, idx in bot_fill.items()})
                B_loc = sp.vstack([B_loc, bot], format="csr")
        else:
            A_loc = _hstack_local(ba)
            B_loc = _hstack_local(bb, ("oo", "oh"))
            if li_rb.n_ghost:
                B_loc = sp.vstack([B_loc, _hstack_local(bb, ("ho", "hh"))], format="csr")
        C = A_loc @ B_loc
        C.sum_duplicates()
        C.sort_indices()
        coo = C.tocoo()
        col_g = np.concatenate([li_cb.own_to_global, li_cb.ghost_to_global])
        b2, _, li_c2, info = _build_part_blocks(
            li_ra.remove_ghost(), li_cb.remove_ghost(), li_ra.own_to_global[coo.row],
            col_g[coo.col], coo.data.astype(dtype, copy=False), False, dtype,
        )
        blocks[p] = b2
        new_cols[p] = li_c2
        if reuse:
            dst_block, dst_pos = _dst_maps(b2, info)
            dst = []
            for bi, name in enumerate(_BLOCK_NAMES[:2]):
                sel = np.flatnonzero((dst_block == bi) & (dst_pos >= 0))
                if sel.size:
                    dst.append((name, sel, dst_pos[sel]))
            cache.parts[p] = (A_loc, a_fill, B_loc, b_fill, (C.indptr.copy(), C.indices.copy()),
                              dst)
    P = A.row_prange.n_parts
    rows = [li.remove_ghost() for li in A.row_prange.parts]
    cols = _sync_ghosted_partition(A.backend, P, [li.remove_ghost() for li in Bc.col_prange.parts],
                                   new_cols)
    out = PSparseMatrix(
        None, PRange(rows), PRange(cols), A.backend,
        blocks=[blocks[p] if p in blocks else _placeholder_blocks(rows[p], cols[p], dtype)
                for p in range(P)],
        device=A.torch_device, device_dtype=A.dtype,
    )
    return (out, cache) if reuse else out


def spmm_into(C: PSparseMatrix, A: PSparseMatrix, B: PSparseMatrix, cache: _SpmmCache,
              refresh_b: bool = True) -> None:
    """C = A @ B in place, for new values of A and B at the sparsity of
    ``spmm(A, B, reuse=True)``.  ``refresh_b=False`` skips the refresh of
    B's fetched rows: only for a B whose values have not changed since the
    build (the AMG's tentative prolongator)."""
    cache.refill(C, A, B, refresh_b=refresh_b)


class _SpmtmCache:
    """The frozen plan of C = A^T @ B at fixed sparsity: the local operands
    refresh through their fill positions, the transpose through a fixed
    permutation of its data, and the canonical local products refill C
    through the psparse reuse cache (the owner shuffle is frozen)."""

    def __init__(self):
        self.parts: dict = {}
        self.pcache = None

    def refill(self, C: PSparseMatrix, A: PSparseMatrix, B: PSparseMatrix,
               outside: Optional[list] = None) -> None:
        _canonicalize_blocks(A)
        _canonicalize_blocks(B)
        V_parts = [None] * C.row_prange.n_parts
        for p, (A_loc, a_fill, AT, tpos, B_loc, b_fill, pattern) in sorted(self.parts.items()):
            for bi, idx in a_fill.items():
                A_loc.data[idx] = A.blocks[p][_BLOCK_NAMES[bi]].data
            for bi, idx in b_fill.items():
                B_loc.data[idx] = B.blocks[p][_BLOCK_NAMES[bi]].data
            AT.data[tpos] = A_loc.data
            V_parts[p] = _refilled_product(AT, B_loc, *pattern, outside=outside)
        psparse_refill(C, V_parts, self.pcache)


def spmtm(A: PSparseMatrix, B: PSparseMatrix, reuse: bool = False):
    """C = A^T @ B: each part's ``[oo|oh]_A^T @ [oo|oh]_B`` (rows on A's
    local columns, ghosts included), whose triplets the disassembled
    constructor moves to their owners.  Dtypes as ``spmm``.  ``reuse=True``
    returns ``(C, cache)`` for ``spmtm_into``.

    Each part's product is sorted before the move, as in the reference's
    Galerkin product (its reuse form): the order in which ``compresscoo``
    sums the parts' contributions to one entry fixes its rounding.  The
    reference's plain ``spmtm`` moves its products unsorted and may differ
    from this one by an ulp where three or more parts meet."""
    _check_assembled(A, B)
    if A.row_prange.n_global != B.row_prange.n_global:
        raise ValueError("spmtm: A and B must share the row partition")
    dtype = np.result_type(_host_dtype(A), _host_dtype(B))
    cache = _SpmtmCache() if reuse else None
    if reuse:
        _canonicalize_blocks(A)
        _canonicalize_blocks(B)
    P = A.row_prange.n_parts
    I_parts, J_parts, V_parts = [None] * P, [None] * P, [None] * P
    for p in _data_parts(A):
        ba, bb = host_blocks(A)[p], host_blocks(B)[p]
        li_ca, li_cb = A.col_prange.parts[p], B.col_prange.parts[p]
        if reuse:
            A_loc, _, a_fill = _hstack_with_tags(ba, p, want_tags=False)
            B_loc, _, b_fill = _hstack_with_tags(bb, p, want_tags=False)
        else:
            A_loc, B_loc = _hstack_local(ba), _hstack_local(bb)
        AT = A_loc.T.tocsr()
        AT.sort_indices()
        C = AT @ B_loc
        C.sum_duplicates()
        C.sort_indices()
        if reuse:
            acoo = A_loc.tocoo()
            tpos = precompute_nzindex(AT, acoo.col, acoo.row)
            cache.parts[p] = (A_loc, a_fill, AT, tpos, B_loc, b_fill,
                              (C.indptr.copy(), C.indices.copy()))
        C = C.tocoo()
        I_parts[p] = np.concatenate([li_ca.own_to_global, li_ca.ghost_to_global])[C.row]
        J_parts[p] = np.concatenate([li_cb.own_to_global, li_cb.ghost_to_global])[C.col]
        V_parts[p] = C.data.astype(dtype, copy=False)
    out = psparse(
        I_parts, J_parts, V_parts, PRange([li.remove_ghost() for li in A.col_prange.parts]),
        PRange([li.remove_ghost() for li in B.col_prange.parts]), A.backend, dtype=dtype,
        reuse=reuse, device=A.torch_device, device_dtype=A.dtype,
    )
    if not reuse:
        return out
    C, cache.pcache = out
    return C, cache


def spmtm_into(C: PSparseMatrix, A: PSparseMatrix, B: PSparseMatrix, cache: _SpmtmCache) -> None:
    """C = A^T @ B in place, for new values of A and B at the sparsity of
    ``spmtm(A, B, reuse=True)``."""
    cache.refill(C, A, B)


def rap(R: PSparseMatrix, A: PSparseMatrix, Pm: PSparseMatrix, reuse: bool = False):
    """The triple product R @ A @ P as two ``spmm``; ``reuse=True`` returns
    ``(Ac, cache)`` for ``rap_into``."""
    if not reuse:
        return spmm(R, spmm(A, Pm))
    AP, c1 = spmm(A, Pm, reuse=True)
    Ac, c2 = spmm(R, AP, reuse=True)
    return Ac, (AP, c1, c2)


def rap_into(Ac: PSparseMatrix, R: PSparseMatrix, A: PSparseMatrix, Pm: PSparseMatrix,
             cache) -> None:
    """Ac = R @ A @ P in place at the sparsity of ``rap(..., reuse=True)``."""
    AP, c1, c2 = cache
    spmm_into(AP, A, Pm, c1)
    spmm_into(Ac, R, AP, c2)


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


def repartition_matrix(A: PSparseMatrix, new_rows, new_cols,
                       backend: Optional[SerialBackend] = None) -> PSparseMatrix:
    """A on the partitions ``new_rows`` and ``new_cols`` of the same ids:
    each part's triplets (in global ids) moved to their new row owners by
    the disassembled COO constructor, which sums them there in part order
    and finds the new ghost columns."""
    names = ("oo", "oh") if A.assembled else _BLOCK_NAMES
    tri = [_part_triplets(b, li_r, li_c, names)
           for b, li_r, li_c in zip(host_blocks(A), A.row_prange.parts, A.col_prange.parts)]
    return psparse([t[0] for t in tri], [t[1] for t in tri], [t[2] for t in tri],
                   as_prange(new_rows), as_prange(new_cols), backend or A.backend,
                   dtype=_host_dtype(A), device=A.torch_device, device_dtype=A.dtype)


def repartition_system(A: PSparseMatrix, b: Optional[PVector] = None, new_rows=None,
                       new_cols=None, backend: Optional[SerialBackend] = None):
    """A (and the right-hand side ``b``, on the same new row partition)
    repartitioned: ``A2`` or ``(A2, b2)``.  The columns follow the rows
    unless ``new_cols`` says otherwise."""
    new_rows = as_prange(new_rows if new_rows is not None else A.row_prange)
    new_cols = as_prange(new_cols if new_cols is not None else new_rows)
    A2 = repartition_matrix(A, new_rows, new_cols, backend)
    if b is None:
        return A2
    return A2, repartition(b, A2.row_prange, backend or A.backend)


def split_format(A: PSparseMatrix) -> PSparseMatrix:
    """The split form of A: its storage always is."""
    return A


split_matrix = split_format


def split_matrix_blocks(A: PSparseMatrix):
    """Per-part host blocks (own-own, own-ghost, ghost-own, ghost-ghost);
    the last two are None for an assembled matrix."""
    blocks = host_blocks(A)
    return tuple([b.get(k) for b in blocks] for k in _BLOCK_NAMES)


def renumber_matrix(A: PSparseMatrix) -> PSparseMatrix:
    """A on the renumbered partitions (``renumber_partition``: each part's
    own ids consecutive).  Every part keeps its own and ghost order, so
    the host and frozen blocks are A's own: no data moves."""
    return PSparseMatrix(
        A.device(), PRange(renumber_partition(A.row_prange.parts)),
        PRange(renumber_partition(A.col_prange.parts)), A.backend, nnz=A.nnz(),
        blocks=A.blocks, device=A.torch_device, device_dtype=A.dtype, assembled=A.assembled,
    )


def psystem(I_parts, J_parts, V_parts, Ib_parts, Vb_parts, rows, cols, backend: SerialBackend,
            reuse: bool = False, device="cuda"):
    """The matrix (disassembled triplets, assembled by ``psparse``) and its
    rhs (``pvector`` contributions on A's rows) together: ``(A, b)``, or
    ``(A, b, cache)`` with ``reuse=True`` for ``psystem_refill``."""
    from .pvector import pvector

    if reuse:
        A, mcache = psparse(I_parts, J_parts, V_parts, rows, cols, backend, reuse=True,
                            device=device)
        b, vcache = pvector(Ib_parts, Vb_parts, A.row_prange, backend, reuse=True, device=device)
        return A, b, (mcache, vcache)
    A = psparse(I_parts, J_parts, V_parts, rows, cols, backend, device=device)
    return A, pvector(Ib_parts, Vb_parts, A.row_prange, backend, device=device)


def psystem_refill(A: PSparseMatrix, V_parts, Vb_parts, cache) -> PVector:
    """New matrix and rhs values at the structure of ``psystem(...,
    reuse=True)``: A is refilled in place (``psparse_refill``), the rhs is
    returned (``pvector_refill``)."""
    from .pvector import pvector_refill

    mcache, vcache = cache
    psparse_refill(A, V_parts, mcache)
    return pvector_refill(Vb_parts, vcache)


# -- SpMV ----------------------------------------------------------------------

def _col_ghosts(A: PSparseMatrix, x: PVector):
    """x's column layout and ghost values: a vector on another layout with
    the same own parts (the row range of a square matrix, or the range of
    another matrix built on the same partition) is re-homed to the column
    layout with zero ghosts, which the exchange fills (keeping its own
    layout would drop every own-ghost term of A)."""
    clay = A.col_layout()
    if x.layout is not clay:
        if x.own.shape[1] != clay.n_own_pad:
            raise ValueError("spmv: x's own parts do not match A's columns")
        return clay, x.own.new_zeros((x.own.shape[0], clay.n_ghost_pad))
    return x.layout, x.ghost


def _has_exchange(clay: VectorLayout) -> bool:
    return clay.n_ghost_pad > 0 and clay.consistent_plan.n_rounds > 0


def spmv(
    A: PSparseMatrix, x: PVector, alpha=1.0, beta=None, y: Optional[PVector] = None, dev=None
) -> PVector:
    """``alpha * A @ x [+ beta * y]`` (the reference's 5-argument form;
    ``beta`` defaults to 1 when ``y`` is given).  x is partitioned by
    ``A.col_prange``, or by another layout of the same own parts (re-homed,
    see ``_col_ghosts``); y by ``A.row_prange``.

    With ghost columns, ``g = consistent(x)`` (one exchange) and
    ``A x = A_oo x + A_oh g``: the own-own product is kernel K1 and the
    own-ghost product, kernel K5, accumulates into K1's output.  A
    subassembled matrix also forms its ghost rows ``A_ho x + A_hh g`` and
    adds them to their owners (one assemble exchange).  ``dev``: device
    blocks of A's structure to use instead of A's own (a ``DeviceRefill``
    result)."""
    clay, xg = _col_ghosts(A, x)
    rlay = A.row_layout()
    dev = A.device() if dev is None else dev
    bk = A.backend
    out = dev.oo.spmv(x.own)
    g = clay.consistent_plan.apply(x.own, xg, "set", bk) if _has_exchange(clay) else xg
    if _has_exchange(clay):
        out = dev.oh.spmv_add(g, out)
    if not A.assembled and rlay.n_ghost_pad:
        yg = dev.ho.spmv(x.own)
        if clay.n_ghost_pad:
            yg = dev.hh.spmv_add(g, yg)
        out = rlay.assemble_plan.apply(yg[:, : rlay.n_ghost_pad], out, "add", bk)
    if not (isinstance(alpha, (int, float)) and alpha == 1.0):
        out = alpha * out
    if y is not None:
        out = out + (1.0 if beta is None else beta) * y.own
    ghost = out.new_zeros((out.shape[0], rlay.n_ghost_pad))
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
        out = clay.assemble_plan.apply(ohT.spmv(x.own), out, "add", A.backend)
    if not (isinstance(alpha, (int, float)) and alpha == 1.0):
        out = alpha * out
    if y is not None:
        out = out + (1.0 if beta is None else beta) * y.own
    return PVector(out, out.new_zeros((out.shape[0], clay.n_ghost_pad)), clay, A.backend)


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
        gh = clay.consistent_plan.apply(xh.own, xgh, "set", A.backend)
        gl = clay.consistent_plan.apply(xl.own, xgl, "set", A.backend)
        y = df.add(y, block_spmv_df(devh.oh, devl.oh, (gh, gl)))
    zg = y[0].new_zeros((y[0].shape[0], rlay.n_ghost_pad))
    return PVector(y[0], zg, rlay, A.backend), PVector(y[1], zg, rlay, A.backend)
