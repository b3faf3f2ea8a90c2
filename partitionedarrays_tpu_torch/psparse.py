"""PSparseMatrix: a row-partitioned sparse matrix, and its SpMV.

Counterpart of ``partitionedarrays_tpu/psparse.py`` (``_sorted_ghosts``
:54, ``DeviceSpMat`` and ``PSparseMatrix`` :63-252, ``spmv`` :1568-1677),
reduced to what the HPCG slices need: an assembled matrix whose device
blocks are already frozen (built in closed form by ``ops/stencil.py``):
the own-own block ``oo`` and the own-ghost block ``oh``.  COO assembly, the
host block mirrors and the reuse tier come with the generic slice.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .backends import SerialBackend
from .ops.blocks import DeviceBlock
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


def spmv(A: PSparseMatrix, x: PVector) -> PVector:
    """A @ x.  x is partitioned by ``A.col_prange``, or by the row range of
    a square matrix with matching own parts: then it is re-homed to the
    column layout with zero ghosts, which the exchange fills (keeping the
    row layout would drop every own-ghost term).

    With ghost columns, ``g = consistent(x)`` (one exchange) and
    ``y = A_oo x + A_oh g``: the own-own product is kernel K1 and the
    own-ghost product, kernel K5, accumulates into K1's output.  The
    reference's 5-argument form and ``dev`` substitute come with the
    generic slice."""
    clay = x.layout
    rlay = A.row_layout()
    xg = x.ghost
    if clay is not A.col_layout() and clay is rlay:
        clay = A.col_layout()
        xg = x.own.new_zeros((clay.n_parts, clay.n_ghost_pad))
    dev = A.device()
    out = dev.oo.spmv(x.own)
    if clay.n_ghost_pad > 0 and clay.consistent_plan.n_rounds > 0:
        g = clay.consistent_plan.apply(x.own, xg, "set")
        out = dev.oh.spmv_add(g, out)
    ghost = out.new_zeros((rlay.n_parts, rlay.n_ghost_pad))
    return PVector(out, ghost, rlay, A.backend)
