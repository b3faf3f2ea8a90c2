"""Padded ELL blocks: the layout of the sorted-by-color Gauss-Seidel tier.

A copy of ``partitionedarrays_tpu/ops/ell.py`` (``csr_to_ell`` :32,
``stack_ell`` :48, ``stack_ell_values`` :69, ``ell_spmv`` :90,
``ell_spmv_masked_diag`` :103): the host functions verbatim in numpy, the
products in torch.  A block is ``cols[R, K]`` / ``vals[R, K]`` with K the
longest row; padding lanes hold the out-of-bounds column ``OOB`` (gathered
as 0) and value 0.  The products also take stacked parts: ``cols[P, R, K]``
with ``x[P, n]``.

In the port these are the plain versions of the sorted tier's products
(``solvers/smoothers.py::SortedColorGS``), whose sweeps on the card run
each color's rows as compressed-row operands of kernel K5
(``ops/ghost_spmv.py``); the reference computes this tier in XLA, with no
TPU kernel.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp
import torch

# the reference's exchange_plan.OOB
OOB = np.int32(np.iinfo(np.int32).max - 255)


def csr_to_ell(A: sp.csr_matrix, n_rows_pad: int, k: Optional[int] = None):
    """One CSR block -> (cols[int32 n_rows_pad, K], vals[n_rows_pad, K])."""
    A = A.tocsr()
    nnz_row = np.diff(A.indptr)
    kmax = int(nnz_row.max()) if nnz_row.size else 0
    K = kmax if k is None else k
    cols = np.full((n_rows_pad, max(K, 1)), OOB, dtype=np.int32)
    vals = np.zeros((n_rows_pad, max(K, 1)), dtype=A.dtype)
    if A.nnz:
        r = np.repeat(np.arange(A.shape[0]), nnz_row)
        c = (np.arange(A.nnz) - np.repeat(A.indptr[:-1], nnz_row)).astype(np.int64)
        cols[r, c] = A.indices
        vals[r, c] = A.data
    return cols, vals


def stack_ell(blocks: Sequence[sp.spmatrix], n_rows_pad: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-part CSR blocks -> stacked ELL arrays [P, n_rows_pad, K] with a
    common (padded) K across parts."""
    csrs = [b.tocsr() for b in blocks]
    kmax = 0
    for b in csrs:
        nnz_row = np.diff(b.indptr)
        if nnz_row.size:
            kmax = max(kmax, int(nnz_row.max()))
    K = max(kmax, 1)
    cols = np.empty((len(csrs), n_rows_pad, K), dtype=np.int32)
    vals = np.empty((len(csrs), n_rows_pad, K), dtype=csrs[0].dtype if csrs else np.float32)
    for p, b in enumerate(csrs):
        c, v = csr_to_ell(b, n_rows_pad, K)
        cols[p] = c
        vals[p] = v
    return cols, vals


def stack_ell_values(blocks: Sequence[sp.spmatrix], n_rows_pad: int, K: int) -> np.ndarray:
    """Values-only restack at fixed sparsity (the refill path: the column
    table is unchanged, so only the value planes are rebuilt)."""
    csrs = [b.tocsr() for b in blocks]
    vals = np.zeros((len(csrs), n_rows_pad, max(K, 1)),
                    dtype=csrs[0].dtype if csrs else np.float32)
    for p, b in enumerate(csrs):
        if b.nnz:
            nnz_row = np.diff(b.indptr)
            r = np.repeat(np.arange(b.shape[0]), nnz_row)
            c = (np.arange(b.nnz) - np.repeat(b.indptr[:-1], nnz_row)).astype(np.int64)
            vals[p, r, c] = b.data
    return vals


def _gather(cols: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x[..., cols]`` with 0 where a column is out of bounds: cols
    ``[..., R, K]``, x ``[..., n]`` on the same leading dims."""
    n = x.shape[-1]
    live = (cols >= 0) & (cols < n)
    idx = torch.where(live, cols, torch.zeros_like(cols)).to(torch.int64)
    flat = idx.reshape(idx.shape[:-2] + (-1,))
    g = torch.gather(x, -1, flat).reshape(idx.shape)
    return torch.where(live, g, torch.zeros_like(g))


def ell_spmv(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y[r] = sum_k vals[r, k] * x[cols[r, k]], padding lanes (OOB columns,
    zero values) adding 0.  cols/vals ``[R, K]`` with x ``[n]``, or stacked
    ``[P, R, K]`` with ``[P, n]``."""
    if x.shape[-1] == 0 or cols.shape[-1] == 0:
        # an empty block (e.g. no ghost columns): its contribution is zero
        return vals.new_zeros(cols.shape[:-1])
    return torch.sum(vals * _gather(cols, x), dim=-1)


def ell_spmv_masked_diag(cols: torch.Tensor, vals: torch.Tensor, diag_idx: torch.Tensor,
                         x: torch.Tensor) -> torch.Tensor:
    """The SpMV without the diagonal lane ``diag_idx[r]`` of each row (the
    Jacobi-style sweeps)."""
    K = cols.shape[-1]
    if x.shape[-1] == 0 or K == 0:
        return vals.new_zeros(cols.shape[:-1])
    lane = torch.arange(K, device=cols.device)
    off = torch.where(lane == diag_idx.unsqueeze(-1), torch.zeros_like(vals), vals)
    return torch.sum(off * _gather(cols, x), dim=-1)
