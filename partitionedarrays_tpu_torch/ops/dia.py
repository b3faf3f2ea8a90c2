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

# the most diagonals a DIA block may carry (the reference's freeze_block
# cap): banded operators up to interleaved Q1 elasticity (99 diagonals in 3-D)
# stay DIA, as in the reference
MAX_DIAGS = 128


def csr_diagonals(A: sp.spmatrix) -> np.ndarray:
    """Distinct diagonal offsets (j - i) present in A."""
    coo = A.tocoo()
    if coo.nnz == 0:
        return np.zeros(0, dtype=np.int64)
    return np.unique(coo.col.astype(np.int64) - coo.row.astype(np.int64))


def dia_viable(blocks: Sequence[sp.spmatrix], max_diags: int = MAX_DIAGS):
    """The union of the blocks' diagonal offsets when it has at most
    ``max_diags`` entries, else None (as the reference's ``dia_viable``)."""
    offs = set()
    for b in blocks:
        offs.update(csr_diagonals(b.tocsr()).tolist())
        if len(offs) > max_diags:
            return None
    return np.array(sorted(offs), dtype=np.int64)


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


def host_dia(offsets, row_vals: np.ndarray, n_rows: int, n_cols: int) -> sp.dia_matrix:
    """The scipy DIA matrix of row-indexed diagonals ``row_vals[n_off, >=
    n_rows]`` (``row_vals[d, i] = A[i, i + offsets[d]]``).  scipy indexes a
    diagonal by column (``data[d, j] = A[j - offsets[d], j]``), so each is
    shifted by its offset; entries outside the matrix are dropped.  (The
    reference's stencil mirror, ``ops/stencil.py:60-82`` and ``:395-408``.)"""
    data = np.zeros((max(len(offsets), 1), n_cols), dtype=row_vals.dtype)
    for k, o in enumerate(offsets):
        diag = row_vals[k, :n_rows]
        if o >= 0:
            w = min(n_rows, n_cols - o)
            if w > 0:
                data[k, o : o + w] = diag[:w]
        else:
            w = min(n_rows + o, n_cols)
            if w > 0:
                data[k, :w] = diag[-o : -o + w]
    return sp.dia_matrix((data, np.array(offsets)), shape=(n_rows, n_cols))


def dia_spmv_plain(
    offsets: Tuple[int, ...], vals: torch.Tensor, x: torch.Tensor
) -> torch.Tensor:
    """y[p, i] = sum_d vals[p, d, i] * x[p, i + offsets[d]], x zero outside
    ``[0, n_cols)``.  vals: [P, n_off, R]; x: [P, n_cols]; returns [P, R]
    in x's dtype.  Each term is a shifted slice of a zero-padded copy of x,
    summed in the order of the offsets (as the reference's ``dia_spmv``);
    values narrower than x are widened to its dtype first (the reference
    promotes them)."""
    P, _, R = vals.shape
    n_cols = x.shape[-1]
    if not offsets:
        return x.new_zeros((P, R))
    lo = min(min(offsets), 0)
    hi = max(max(offsets) + R, n_cols)
    xpad = x.new_zeros((P, hi - lo))
    xpad[:, -lo : -lo + n_cols] = x
    y = x.new_zeros((P, R))
    for d, off in enumerate(offsets):
        y = y + vals[:, d].to(x.dtype) * xpad[:, off - lo : off - lo + R]
    return y


def dia_spmv(offsets: Tuple[int, ...], vals: torch.Tensor, x: torch.Tensor,
             n_cols_pad: int) -> torch.Tensor:
    """The reference's per-part ``dia_spmv`` (``ops/dia.py:69``), its
    signature kept: y[i] = sum_d vals[d, i] * x[i + offsets[d]] for one
    part, vals ``[n_off, R]``, x ``[n_cols_pad]``, x zero outside, returns
    ``[R]``.  It runs ``dia_spmv_plain`` on the part as a stack of one, on
    x's device; the stacked kernel K1 is ``ops/dia_spmv.py::dia_spmv``."""
    return dia_spmv_plain(tuple(offsets), vals.unsqueeze(0), x[:n_cols_pad].unsqueeze(0))[0]
