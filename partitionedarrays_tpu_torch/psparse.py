"""PSparseMatrix: a row-partitioned sparse matrix, its COO constructor,
its SpMVs and the host sparse products.

Counterpart of ``partitionedarrays_tpu/psparse.py``: ``_sorted_ghosts``
:54, ``DeviceSpMat`` and ``PSparseMatrix`` :63-252 with
``device_transpose``, its blockwise ``copy``, ``astype`` and arithmetic
:284-360, ``_build_part_blocks`` and ``psparse`` :366-579,
``to_global_scipy`` and ``gather_global_scipy`` :885-977, ``spmv`` and
``spmtv`` :1568-1750,
``dense_diag`` :1757, ``spmm`` :1827 and ``spmtm`` :1994, and the df64
SpMV ``device_df64``/``spmv_df64`` :2711-2783.

A matrix has frozen device blocks, the own-own block ``oo`` and the
own-ghost block ``oh`` (``ops/blocks.py``: DIA on kernel K1 or compressed
rows on K5), and host mirrors ``blocks[p]["oo"|"oh"]``: scipy CSR when it
was assembled from triplets (frozen on first use), a lazy scipy DIA
``oo`` for the closed-form stencil matrices (``ops/stencil.py``), whose
device blocks are built directly.
The device blocks may hold another dtype than the host mirrors
(``device_dtype``): a float32 AMG hierarchy keeps the reference's host
products, whose prolongators are float64 (the nullspace is), and runs
its cycle in float32 as the reference does on its TPU, which has no
float64.

COO assembly and the sparse products are ported for one part: the triplets
of a one-part matrix are all own rows, and its columns have no ghosts.
More parts, ghost columns in the triplets, and the reuse tier raise
``NotImplementedError`` (ROADMAP Queue 1 item 10).  The products are the
reference's scipy products on the same operands in the same order, without
its reuse caches.
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
from .parallel.partition import INT, PRange
from .pvector import PVector, pvector_from_own

_MULTI_PART = "ROADMAP Queue 1 item 10 (multi-part COO, ghost columns)"


def _sorted_ghosts(gids: np.ndarray, owners: np.ndarray):
    """Ghost ids ordered by owner, then global id."""
    order = np.lexsort((gids, owners))
    return gids[order], owners[order]


class DeviceSpMat:
    """Frozen device blocks: own-own ``oo`` and own-ghost ``oh`` (None for
    a matrix without ghost columns)."""

    def __init__(self, oo: DeviceBlock, oh: Optional[DeviceBlock] = None):
        self.oo = oo
        self.oh = oh


class PSparseMatrix:
    """An assembled matrix: rows partitioned by ``row_prange``, columns by
    ``col_prange``.  Built from frozen device blocks (``device_blocks``) or
    from host blocks (``blocks``, frozen on ``device`` at first use, with
    values of ``device_dtype``, by default the host blocks' dtype)."""

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
        if nnz is None:
            nnz = sum(m.nnz for b in blocks for m in b.values())
        self._nnz = int(nnz)
        self._device_T = None  # the frozen transpose of oo, built once
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

    def device(self) -> DeviceSpMat:
        """The frozen blocks; a matrix built from host blocks freezes them
        on first call (``freeze_block``: DIA when banded, else compressed
        rows)."""
        if self._device is None:
            rlay, clay = self.row_layout(), self.col_layout()
            oo = freeze_block([b["oo"] for b in self.blocks], rlay.n_own_pad, clay.n_own_pad,
                              device=self._target, dtype=self.dtype)
            oh = freeze_block([b["oh"] for b in self.blocks], rlay.n_own_pad,
                              max(clay.n_ghost_pad, 1), device=self._target, dtype=self.dtype)
            self._device = DeviceSpMat(oo, oh)
        return self._device

    def device_transpose(self) -> DeviceBlock:
        """The frozen transpose of the own-own block (the product of
        ``spmtv``), built once from the host blocks."""
        if self._device_T is None:
            if self.col_layout().n_ghost_pad:
                raise NotImplementedError(f"the transpose of a ghosted matrix: {_MULTI_PART}")
            rlay, clay = self.row_layout(), self.col_layout()
            self._device_T = freeze_block(
                [b["oo"].T.tocsr() for b in host_blocks(self)], clay.n_own_pad,
                rlay.n_own_pad, device=self.torch_device, dtype=self.dtype,
            )
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
        blocks = [{k: f(b[k]) for k in ("oo", "oh")} for b in host_blocks(self)]
        return PSparseMatrix(
            None, self.row_prange, self.col_prange, self.backend, blocks=blocks,
            device=self.torch_device, device_dtype=dtype or self.dtype,
        )

    def _zip_blocks(self, other: "PSparseMatrix", f) -> "PSparseMatrix":
        if other.shape != self.shape:
            raise ValueError("matrix shapes/partitions do not match")
        blocks = [
            {k: f(ba[k], bb[k]) for k in ("oo", "oh")}
            for ba, bb in zip(host_blocks(self), host_blocks(other))
        ]
        return PSparseMatrix(
            None, self.row_prange, self.col_prange, self.backend, blocks=blocks,
            device=self.torch_device, device_dtype=torch.promote_types(self.dtype, other.dtype),
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


def _build_part_blocks(li_row, li_col, I, J, V, dtype):
    """One part's own-row triplets (global ids) -> its split blocks
    ``{"oo", "oh"}`` (``compresscoo``: duplicates summed, columns sorted).
    Negative ids mark entries to skip.  A column owned by another part
    would be a ghost column, which is not ported."""
    I = np.asarray(I, dtype=INT)
    J = np.asarray(J, dtype=INT)
    V = np.asarray(V, dtype=dtype)
    iro = li_row.global_to_own(I)
    if not ((iro >= 0) | (I < 0)).all():
        raise ValueError("psparse: a triplet row is not owned by its part")
    jco = li_col.global_to_own(J)
    if ((jco < 0) & (J >= 0)).any():
        raise NotImplementedError(f"psparse: triplets with ghost columns: {_MULTI_PART}")
    return {
        "oo": compresscoo(iro, jco, V, li_row.n_own, li_col.n_own),
        "oh": sp.csr_matrix((li_row.n_own, 0), dtype=dtype),
    }


def psparse(
    I_parts: Sequence[np.ndarray],
    J_parts: Sequence[np.ndarray],
    V_parts: Sequence[np.ndarray],
    rows,
    cols,
    backend: SerialBackend,
    assembled: bool = False,
    dtype=None,
    device="cuda",
) -> PSparseMatrix:
    """The COO constructor: per-part triplets (I, J, V) in global ids,
    duplicates summed, into an assembled matrix on ``rows`` and ``cols``
    (a PRange or a list of parts).  ``assembled=False`` (the disassembled
    state) lets a part contribute to rows it does not own; on one part
    every row is its own, so both states assemble alike.  The blocks are
    frozen on ``device`` at first use."""
    rows_pr = _as_prange(rows)
    cols_pr = _as_prange(cols)
    if rows_pr.n_parts != 1 or cols_pr.n_parts != 1:
        raise NotImplementedError(f"psparse on {rows_pr.n_parts} parts: {_MULTI_PART}")
    dtype = numpy_dtype(dtype or np.asarray(V_parts[0]).dtype)
    li_r, li_c = rows_pr.parts[0], cols_pr.parts[0]
    if li_r.n_ghost or li_c.n_ghost:
        raise NotImplementedError(f"psparse on a ghosted partition: {_MULTI_PART}")
    blocks = _build_part_blocks(li_r, li_c, I_parts[0], J_parts[0], V_parts[0], dtype)
    return PSparseMatrix(
        None, rows_pr, PRange([li_c]), backend, blocks=[blocks], device=device
    )


def to_global_scipy(A: PSparseMatrix) -> sp.csr_matrix:
    """All parts' blocks summed into one global CSR on the host."""
    m, n = A.shape
    Is, Js, Vs = [], [], []
    for b, li_r, li_c in zip(host_blocks(A), A.row_prange.parts, A.col_prange.parts):
        for name, cmap in (("oo", li_c.own_to_global), ("oh", li_c.ghost_to_global)):
            if b[name].nnz == 0:
                continue
            coo = b[name].tocoo()
            Is.append(li_r.own_to_global[coo.row])
            Js.append(cmap[coo.col])
            Vs.append(coo.data)
    if not Is:
        return sp.csr_matrix((m, n), dtype=numpy_dtype(A.dtype))
    G = sp.coo_matrix((np.concatenate(Vs), (np.concatenate(Is), np.concatenate(Js))), shape=(m, n))
    G.sum_duplicates()
    G = G.tocsr()
    G.sort_indices()
    return G


def gather_global_scipy(A: PSparseMatrix, max_rows: Optional[int] = None) -> sp.csr_matrix:
    """The global CSR of A on the host (``to_global_scipy``; a
    per-process matrix and its triplet gather are not ported)."""
    if max_rows is not None and A.shape[0] > max_rows:
        raise ValueError(f"gather_global_scipy: {A.shape[0]} rows exceeds max_rows={max_rows}")
    return to_global_scipy(A)


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


def _one_part_csr(A: PSparseMatrix, what: str) -> sp.csr_matrix:
    """The own-own block of a one-part matrix without ghost columns."""
    b = host_blocks(A)
    if len(b) != 1 or b[0]["oh"].shape[1]:
        raise NotImplementedError(f"{what} across parts or with ghost columns: {_MULTI_PART}")
    return b[0]["oo"]


def spmm(A: PSparseMatrix, B: PSparseMatrix) -> PSparseMatrix:
    """C = A @ B on the host: scipy's product of the own-own blocks (the
    reference's local product at one part), re-split by ``compresscoo``.
    C's host dtype is the result type of the operands', its device dtype
    A's."""
    a = _one_part_csr(A, "spmm")
    b = _one_part_csr(B, "spmm")
    dtype = np.result_type(a.dtype, b.dtype)
    C = (a @ b).tocoo()
    li_r, li_c = A.row_prange.parts[0].remove_ghost(), B.col_prange.parts[0].remove_ghost()
    blocks = _build_part_blocks(
        li_r, li_c, li_r.own_to_global[C.row], li_c.own_to_global[C.col],
        C.data.astype(dtype, copy=False), dtype,
    )
    return PSparseMatrix(
        None, PRange([li_r]), PRange([li_c]), A.backend, blocks=[blocks],
        device=A.torch_device, device_dtype=A.dtype,
    )


def spmtm(A: PSparseMatrix, B: PSparseMatrix) -> PSparseMatrix:
    """C = A^T @ B on the host: scipy's product of the sorted transpose of
    A's own-own block with B's, re-split by ``compresscoo``.  Dtypes as
    ``spmm``."""
    a = _one_part_csr(A, "spmtm")
    b = _one_part_csr(B, "spmtm")
    if A.shape[0] != B.shape[0]:
        raise ValueError("spmtm: A and B must share the row partition")
    dtype = np.result_type(a.dtype, b.dtype)
    AT = a.T.tocsr()
    AT.sort_indices()
    C = (AT @ b).tocoo()
    li_r, li_c = A.col_prange.parts[0].remove_ghost(), B.col_prange.parts[0].remove_ghost()
    blocks = _build_part_blocks(
        li_r, li_c, li_r.own_to_global[C.row], li_c.own_to_global[C.col],
        C.data.astype(dtype, copy=False), dtype,
    )
    return PSparseMatrix(
        None, PRange([li_r]), PRange([li_c]), A.backend, blocks=[blocks],
        device=A.torch_device, device_dtype=A.dtype,
    )


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
    own-ghost product, kernel K5, accumulates into K1's output.  The
    reference's ``dev`` substitute is not ported."""
    clay, xg = _col_ghosts(A, x)
    rlay = A.row_layout()
    dev = A.device()
    out = dev.oo.spmv(x.own)
    if _has_exchange(clay):
        g = clay.consistent_plan.apply(x.own, xg, "set")
        out = dev.oh.spmv_add(g, out)
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
    the result (and y) by ``A.col_prange``.  The product is the frozen
    transpose of the own-own block (``device_transpose``: DIA on K1 or
    compressed rows on K5); a matrix with ghost columns would assemble
    their contributions back to the owners, which is not ported."""
    clay = A.col_layout()
    out = A.device_transpose().spmv(x.own)
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
