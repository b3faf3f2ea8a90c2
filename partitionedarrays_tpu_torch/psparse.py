"""PSparseMatrix: a row-partitioned sparse matrix, and its SpMV.

Counterpart of ``partitionedarrays_tpu/psparse.py`` (``DeviceSpMat`` and
``PSparseMatrix`` :63-252, ``spmv`` :1568-1677), reduced to what the
one-part HPCG slice needs: an assembled matrix whose device blocks are
already frozen (built in closed form by ``ops/stencil.py``) and whose ghost
plan has zero rounds.  COO assembly, the host block mirrors and the reuse
tier come with the generic slice.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .backends import GHOSTED_PARTS, SerialBackend
from .ops.blocks import DeviceBlock
from .parallel.exchange_plan import VectorLayout, layout_of
from .parallel.partition import PRange
from .pvector import PVector


class DeviceSpMat:
    """Frozen device blocks.  Only the own-own block ``oo`` exists so far:
    the own-ghost block comes with the ghosted slice."""

    def __init__(self, oo: DeviceBlock):
        self.oo = oo


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
    """A @ x.  x is partitioned by ``A.col_prange`` (or by the row range of
    a square matrix with matching own parts).  The own-own product is
    kernel K1; the ghost exchange and the own-ghost product come with the
    ghosted slice, and the reference's 5-argument form and ``dev``
    substitute with the generic one."""
    clay = x.layout
    rlay = A.row_layout()
    if clay is not A.col_layout() and clay is rlay:
        clay = A.col_layout()
    if clay.n_ghost_pad > 0 and clay.consistent_plan.n_rounds > 0:
        raise NotImplementedError(GHOSTED_PARTS)
    out = A.device().oo.spmv(x.own)
    ghost = out.new_zeros((rlay.n_parts, rlay.n_ghost_pad))
    return PVector(out, ghost, rlay, A.backend)
