"""PSparseMatrix: a row-partitioned sparse matrix, and its SpMV.

Counterpart of ``partitionedarrays_tpu/psparse.py`` (``_sorted_ghosts``
:54, ``DeviceSpMat`` and ``PSparseMatrix`` :63-252, ``spmv`` :1568-1677),
reduced to what the HPCG slices need: an assembled matrix whose device
blocks are already frozen (built in closed form by ``ops/stencil.py``):
the own-own block ``oo`` and the own-ghost block ``oh``.  COO assembly, the
host block mirrors and the reuse tier come with the generic slice.  The
df64 (two-float) SpMV is ``device_df64`` and ``spmv_df64`` (:2711-2783).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .backends import SerialBackend
from .ops import df64 as df
from .ops.blocks import DeviceBlock, block_spmv_df, freeze_block_pair
from .parallel.exchange_plan import VectorLayout, layout_of
from .parallel.partition import PRange
from .pvector import PVector


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
    ``col_prange``."""

    def __init__(
        self,
        device_blocks: DeviceSpMat,
        row_prange: PRange,
        col_prange: PRange,
        backend: SerialBackend,
        nnz: int,
    ):
        self._device = device_blocks
        self.row_prange = row_prange
        self.col_prange = col_prange
        self.backend = backend
        self._nnz = int(nnz)
        self._device_df = None  # the (hi, lo) pair of device_df64, built once

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.row_prange.n_global, self.col_prange.n_global)

    @property
    def dtype(self) -> torch.dtype:
        return self._device.oo.vals.dtype

    def nnz(self) -> int:
        return self._nnz

    def row_layout(self) -> VectorLayout:
        return layout_of(self.row_prange)

    def col_layout(self) -> VectorLayout:
        return layout_of(self.col_prange)

    def device(self) -> DeviceSpMat:
        return self._device

    def __repr__(self):
        return (
            f"PSparseMatrix({self.shape[0]}x{self.shape[1]}, P="
            f"{self.row_prange.n_parts}, nnz={self.nnz()})"
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
    reference's ``dev`` substitute comes with the generic slice."""
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
