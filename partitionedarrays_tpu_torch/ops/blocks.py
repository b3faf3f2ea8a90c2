"""Per-block device storage of a partitioned matrix.

Counterpart of ``partitionedarrays_tpu/ops/blocks.py`` (``DeviceBlock``
:22-130, ``make_dia_block`` :152-173), DIA kind only.  The values are kept
in the logical layout ``[P, n_off, R]``, which is also what the CUDA kernel
streams: the reference's segment-major ``vflat`` copy existed only to avoid
TPU sublane padding and does not carry over.  ELL and slot blocks come
with the ghosted and generic slices.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .dia_spmv import dia_spmv


class DeviceBlock:
    """kind "dia": ``vals[P, n_off, R]`` on static ``offsets``; the block
    has ``n_cols_pad`` columns."""

    def __init__(self, kind: str, offsets: Tuple[int, ...], n_cols_pad: int, vals: torch.Tensor):
        if kind != "dia":
            raise NotImplementedError(f"{kind} blocks: ROADMAP slice B/C")
        self.kind = kind
        self.offsets = offsets
        self.n_cols_pad = n_cols_pad
        self.vals = vals

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        """Per-part SpMV: x [P, n_cols_pad] -> [P, R] (kernel K1)."""
        return dia_spmv(self.offsets, self.vals, x.contiguous())


def make_dia_block(offsets, n_cols_pad: int, vals: torch.Tensor) -> DeviceBlock:
    """DIA block from device values ``[P, n_off, R]``."""
    offsets = tuple(int(o) for o in offsets)
    return DeviceBlock("dia", offsets, int(n_cols_pad), vals.contiguous())
