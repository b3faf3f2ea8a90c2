"""Per-block device storage of a partitioned matrix.

Counterpart of ``partitionedarrays_tpu/ops/blocks.py`` (``DeviceBlock``
:22-130, ``make_dia_block`` :152-173, ``freeze_block`` :176-250).  A block
freezes into one of two kinds:

- "dia": a banded block, values ``[P, n_off, R]`` on static ``offsets``; the
  SpMV is kernel K1.  The reference's segment-major ``vflat`` copy existed
  only to avoid TPU sublane padding and does not carry over.
- "ell": any other block, as a compressed-row ELL that keeps only the rows
  with nonzeros (``stack_rows``); the SpMV is kernel K5, whose launch plan
  (``ops/ell_rows.py``) is computed once at the freeze and kept with the
  block.  The reference
  stores a padded ``[P, R, K]`` ELL plus the TPU slot format; neither is
  mirrored (``ops/ghost_spmv.py``).

A df64 (two-float) block is a pair of float32 blocks of one structure
(``freeze_block_pair``, ``block_spmv_df``, the reference's :275-335).

After a refill at fixed sparsity ``refreeze_block`` restacks only the
values into a frozen block's structure: the counterpart of the
reference's fixed-sparsity fast path (``blocks.py:209-240``,
``ell.py:69-88 stack_ell_values``).  The reference's TPU slot format
(``refill_slot_vals``) is not mirrored.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import scipy.sparse as sp
import torch
from torch.autograd import forward_ad

from . import df64 as df
from .dia import MAX_DIAGS, dia_viable, stack_dia
from .dia_spmv import dia_spmv, dia_spmv_df
from .ell_rows import EllPlan, plan_of
from .ghost_spmv import ghost_spmv


class DeviceBlock:
    """kind "dia": ``vals[P, n_off, R]`` on static ``offsets``; kind "ell":
    ``rows[P, Nr]``, ``cols[P, K, Nr]``, ``vals[P, K, Nr]`` of the rows with
    nonzeros and K5's ``plan``.  The block has ``n_rows`` (padded) rows and
    ``n_cols_pad`` columns."""

    def __init__(
        self, kind: str, offsets, n_rows: int, n_cols_pad: int, vals: torch.Tensor,
        rows: torch.Tensor = None, cols: torch.Tensor = None, plan: EllPlan = None,
    ):
        if kind not in ("dia", "ell"):
            raise ValueError(f"unknown block kind {kind!r}")
        self.kind = kind
        self.offsets = offsets
        self.n_rows = int(n_rows)
        self.n_cols_pad = int(n_cols_pad)
        self.vals = vals
        self.rows = rows
        self.cols = cols
        self.plan = plan

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        """Per-part SpMV: x [P, n_cols_pad] -> [P, n_rows] (K1 or K5).
        Inside a forward-AD level (``torch.autograd.forward_ad``) the
        product is a linear map whose tangent is the same kernel launched
        on x's tangent (``_BlockSpmv``); outside one the kernel is called
        directly."""
        if forward_ad._current_level < 0:
            return self._spmv(x)
        return _BlockSpmv.apply(self, x)

    def spmv_add(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """``y + block @ x``.  An "ell" block accumulates into y in place
        (K5): each row gets one sum added, so the rounding is that of adding
        the two products.  Inside a forward-AD level its tangent is ``y' +
        block @ x'`` (``_BlockSpmvAdd``)."""
        if forward_ad._current_level < 0:
            return self._spmv_add(x, y)
        return _BlockSpmvAdd.apply(self, x, y)

    def _spmv(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "dia":
            return dia_spmv(self.offsets, self.vals, x.contiguous())
        y = x.new_zeros((x.shape[0], self.n_rows))
        return ghost_spmv(self.rows, self.cols, self.vals, x.contiguous(), y, self.plan)

    def _spmv_add(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if self.kind == "dia":
            return y + self._spmv(x)
        return ghost_spmv(self.rows, self.cols, self.vals, x.contiguous(), y, self.plan)


class _BlockSpmv(torch.autograd.Function):
    """K1 or K5 as a function of x alone (the values are constants of a
    residual that closes over the matrix): the product is linear in x, so
    its forward derivative is the same kernel on the tangent."""

    @staticmethod
    def forward(block: DeviceBlock, x: torch.Tensor) -> torch.Tensor:
        return block._spmv(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.block = inputs[0]

    @staticmethod
    def jvp(ctx, _block_t, x_t):
        return ctx.block._spmv(x_t)


class _BlockSpmvAdd(torch.autograd.Function):
    """``y + block @ x``, with y updated in place for a compressed-row
    block (marked dirty, and its tangent updated in place likewise)."""

    @staticmethod
    def forward(block: DeviceBlock, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return _written(block._spmv_add(x, y), y)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.block = inputs[0]
        if output is inputs[2]:
            ctx.mark_dirty(inputs[2])

    @staticmethod
    def jvp(ctx, _block_t, x_t, y_t):
        if x_t is None:
            return y_t
        if y_t is None:
            return ctx.block._spmv(x_t)
        return _written(ctx.block._spmv_add(x_t, y_t), y_t)


def _written(out: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """K5 writes y in place through its pointer, unseen by autograd, whose
    forward mode checks that an in-place Function modified its input and
    that input's tangent: bump y's version where the output is y."""
    if out is y:
        torch.autograd.graph.increment_version(y)
    return out


def make_dia_block(offsets, n_cols_pad: int, vals: torch.Tensor) -> DeviceBlock:
    """DIA block from device values ``[P, n_off, R]``."""
    offsets = tuple(int(o) for o in offsets)
    return DeviceBlock("dia", offsets, vals.shape[2], int(n_cols_pad), vals.contiguous())


def _row_slots(b: sp.csr_matrix):
    """The compressed-row slots of a CSR block's entries in storage order:
    (live rows, compressed row of each entry, lane of each entry)."""
    live = np.flatnonzero(np.diff(b.indptr))
    counts = np.diff(b.indptr)[live]
    i = np.repeat(np.arange(live.size), counts)  # compressed row of each entry
    k = np.arange(b.nnz) - np.repeat(b.indptr[live], counts)  # lane in its row
    return live, i, k


def stack_rows(blocks: Sequence[sp.spmatrix], n_cols: int):
    """Per-part CSR blocks -> the compressed-row ELL host arrays ``rows[P,
    Nr]``, ``cols[P, K, Nr]``, ``vals[P, K, Nr]`` with Nr (a multiple of 8)
    and K common to all parts.  Lanes keep each row's CSR order; padding
    lanes hold column -1 and value 0, padding rows hold row -1."""
    csrs = [b.tocsr() for b in blocks]
    Nr, K = _ell_shape(csrs)
    dtype = csrs[0].dtype if csrs else np.float32
    P = len(csrs)
    rows = np.full((P, Nr), -1, dtype=np.int32)
    cols = np.full((P, K, Nr), -1, dtype=np.int32)
    vals = np.zeros((P, K, Nr), dtype=dtype)
    for p, b in enumerate(csrs):
        if b.nnz == 0:
            continue
        if b.indices.max() >= n_cols:
            raise ValueError(f"part {p}: a column index >= {n_cols}")
        live, i, k = _row_slots(b)
        rows[p, : live.size] = live
        cols[p, k, i] = b.indices
        vals[p, k, i] = b.data
    return rows, cols, vals


def _ell_shape(csrs) -> Tuple[int, int]:
    """(Nr, K) of the compressed-row layout of per-part CSR blocks."""
    Nr = max((int(np.count_nonzero(np.diff(b.indptr))) for b in csrs), default=0)
    K = max((int(np.diff(b.indptr).max()) if b.nnz else 0 for b in csrs), default=0)
    return ((Nr + 7) // 8) * 8, K


def freeze_block(
    blocks: Sequence[sp.spmatrix],
    n_rows_pad: int,
    n_cols_pad: int,
    device="cuda",
    prefer_dia: bool = True,
    dtype=None,
    agree=None,
) -> DeviceBlock:
    """Per-part host blocks -> one DeviceBlock on ``device``: DIA when
    every part block is banded with a small common diagonal set and the
    dense-diagonal storage does not exceed the ELL footprint (the
    reference's rule), else the compressed-row ELL.  The common diagonal
    set is capped at ``MAX_DIAGS`` (128, the reference's cap and the most
    K1 takes).  ``dtype``: the values' torch dtype on the device (default:
    the host blocks' own).  ``agree``: on several processes, maps this
    process's (offsets or None, widest row) to the ones all processes
    use (``psparse._agreed_dia_offsets``)."""
    csrs = [b.tocsr() for b in blocks]
    for b in csrs:
        b.sort_indices()
    if prefer_dia:
        offsets = dia_viable(csrs, max_diags=MAX_DIAGS)
        kmax = max((int(np.diff(b.indptr).max()) if b.nnz else 0 for b in csrs), default=0)
        if agree is not None:
            offsets, kmax = agree(offsets, kmax)
        if offsets is not None and offsets.size:
            # DIA stores n_off*R values; ELL stores K*R values + K*R int32
            if offsets.size <= max(2 * kmax, 4):
                vals = stack_dia(csrs, n_rows_pad, offsets)
                return make_dia_block(
                    tuple(int(o) for o in offsets), n_cols_pad,
                    torch.from_numpy(vals).to(device, dtype),
                )
    rows, cols, vals = stack_rows(csrs, n_cols_pad)
    return DeviceBlock(
        "ell", None, n_rows_pad, n_cols_pad, torch.from_numpy(vals).to(device, dtype),
        rows=torch.from_numpy(rows).to(device), cols=torch.from_numpy(cols).to(device),
        plan=plan_of(cols, torch.device(device)),
    )


def refreeze_block(block: DeviceBlock, blocks: Sequence[sp.spmatrix]) -> DeviceBlock:
    """The values of per-part host blocks restacked into the structure of
    ``block``, frozen from blocks of the same sparsity: a DIA block keeps
    its offsets, a compressed-row block its ``rows``, ``cols`` and K5's
    ``plan``, and the values keep its device and dtype.  The result equals
    ``freeze_block`` of the same host blocks bit for bit; a block whose
    structure no longer fits raises."""
    csrs = [b.tocsr() for b in blocks]
    for b in csrs:
        b.sort_indices()
    dev, dt = block.vals.device, block.vals.dtype
    if block.kind == "dia":
        offsets = np.asarray(block.offsets, dtype=np.int64)
        for b in csrs:
            coo = b.tocoo()
            off = coo.col.astype(np.int64) - coo.row.astype(np.int64)
            if not np.isin(off, offsets).all():
                raise ValueError("refreeze_block: an entry outside the block's diagonals")
        vals = stack_dia(csrs, block.n_rows, offsets)
        return make_dia_block(block.offsets, block.n_cols_pad, torch.from_numpy(vals).to(dev, dt))
    P, K, Nr = block.vals.shape
    if _ell_shape(csrs) != (Nr, K) or len(csrs) != P:
        raise ValueError("refreeze_block: the compressed-row structure changed")
    vals = np.zeros((P, K, Nr), dtype=csrs[0].dtype if csrs else np.float32)
    for p, b in enumerate(csrs):
        if b.nnz:
            _, i, k = _row_slots(b)
            vals[p, k, i] = b.data
    return DeviceBlock("ell", None, block.n_rows, block.n_cols_pad,
                       torch.from_numpy(vals).to(dev, dt), rows=block.rows, cols=block.cols,
                       plan=block.plan)


def freeze_block_pair(block: DeviceBlock) -> Tuple[DeviceBlock, DeviceBlock]:
    """A float64 device block -> the (hi, lo) pair of float32 blocks of the
    same kind and structure (an "ell" pair shares its rows and columns).

    The reference freezes the pair from float64 host blocks, because its
    TPU has no float64 (``blocks.py:275-313``); the card has, so the split
    runs on the device on the block's own values, bit for bit as the
    reference's host split."""
    if block.vals.dtype != torch.float64:
        raise TypeError(f"freeze_block_pair: a float64 block, got {block.vals.dtype}")
    hi, lo = df.from_f64(block.vals)
    return tuple(
        DeviceBlock(block.kind, block.offsets, block.n_rows, block.n_cols_pad,
                    v.contiguous(), rows=block.rows, cols=block.cols, plan=block.plan)
        for v in (hi, lo)
    )


def block_spmv_df(bh: DeviceBlock, bl: DeviceBlock, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """``block @ x`` in df64 on a ``freeze_block_pair``: x a pair of
    [P, n_cols_pad], returns a pair of [P, n_rows].  A "dia" pair runs
    kernel K7; an "ell" pair the compensated compressed-row product of
    ``ops/df64.py`` in plain torch (the reference computes it in XLA, not
    in a TPU kernel)."""
    if bh.kind == "dia":
        return dia_spmv_df(bh.offsets, bh.vals, bl.vals, (x[0].contiguous(), x[1].contiguous()))
    return df.ell_spmv_df(bh.rows, bh.cols, bh.vals, bl.vals, x, bh.n_rows)
