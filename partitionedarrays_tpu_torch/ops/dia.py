"""DIA (diagonal) sparse format: the device layout of banded blocks.

Counterpart of ``partitionedarrays_tpu/ops/dia.py``.  After C-order box
partitioning every stencil own block is banded in local indices: its
nonzeros sit on a few constant diagonals (27 for HPCG).  The values are
stored densely per diagonal, ``vals[P, n_off, R]`` with
``vals[p, d, i] = A_p[i, i + offsets[d]]`` (zero outside), and the SpMV is

    y[p, i] = sum_d vals[p, d, i] * x[p, i + offsets[d]]

with x read as zero outside ``[0, n_cols)``.  ``dia_spmv_plain`` below is the
plain PyTorch version of that product; the hand-written kernel K1 and its
wrapper live in ``ops/dia_spmv.py``.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import scipy.sparse as sp
import torch

# the most diagonals a DIA block may carry (as the reference's dia_viable)
MAX_DIAGS = 48


def csr_diagonals(A: sp.spmatrix) -> np.ndarray:
    """Distinct diagonal offsets (j - i) present in A."""
    coo = A.tocoo()
    if coo.nnz == 0:
        return np.zeros(0, dtype=np.int64)
    return np.unique(coo.col.astype(np.int64) - coo.row.astype(np.int64))


def stack_dia(
    blocks: Sequence[sp.spmatrix], n_rows_pad: int, offsets: np.ndarray
) -> np.ndarray:
    """Per-part blocks -> vals[P, n_off, n_rows_pad] with
    vals[p, d, i] = A_p[i, i + offsets[d]] (0 outside)."""
    P = len(blocks)
    n_off = offsets.shape[0]
    dtype = blocks[0].dtype if P else np.float32
    out = np.zeros((P, max(n_off, 1), n_rows_pad), dtype=dtype)
    for p, b in enumerate(blocks):
        coo = b.tocoo()
        if coo.nnz == 0:
            continue
        off = coo.col.astype(np.int64) - coo.row.astype(np.int64)
        d = np.searchsorted(offsets, off)  # offsets is sorted by contract
        out[p, d, coo.row] = coo.data
    return out


def dia_spmv_plain(
    offsets: Tuple[int, ...], vals: torch.Tensor, x: torch.Tensor
) -> torch.Tensor:
    """y[p, i] = sum_d vals[p, d, i] * x[p, i + offsets[d]], x zero outside
    ``[0, n_cols)``.  vals: [P, n_off, R]; x: [P, n_cols]; returns [P, R].
    Each term is a shifted slice of a zero-padded copy of x, summed in
    the order of the offsets (as the reference's ``dia_spmv``)."""
    P, _, R = vals.shape
    n_cols = x.shape[-1]
    if not offsets:
        return vals.new_zeros((P, R))
    lo = min(min(offsets), 0)
    hi = max(max(offsets) + R, n_cols)
    xpad = x.new_zeros((P, hi - lo))
    xpad[:, -lo : -lo + n_cols] = x
    y = vals.new_zeros((P, R))
    for d, off in enumerate(offsets):
        y = y + vals[:, d] * xpad[:, off - lo : off - lo + R]
    return y
