"""Host-side (setup-time) sparse helpers over scipy CSR matrices.

Copied from ``partitionedarrays_tpu/ops/sparse_host.py``: ``compresscoo``
:26, ``nziterator`` and ``indextype`` :48-60, ``precompute_nzindex``
:73-110, ``sparse_matrix`` :113-123, ``sparse_matrix_refill`` :125-134, the
host products ``spmv``/``spmtv`` :137-144 (exported as ``spmv_local`` and
``spmtv_local``), ``sub_sparse_matrix`` :147-154 and ``split_locally``
:157-178.  Unlike the reference,
``precompute_nzindex`` does not sort its argument in place: it takes a CSR
with sorted indices and raises otherwise, so positions it returns always
address the caller's own data order.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sp


def compresscoo(I, J, V, m: int, n: int) -> sp.csr_matrix:
    """COO triplets -> CSR with duplicates summed and column indices sorted.
    Entries with a negative row or column index are dropped."""
    I = np.asarray(I)
    J = np.asarray(J)
    V = np.asarray(V)
    keep = (I >= 0) & (J >= 0)
    if not keep.all():
        I, J, V = I[keep], J[keep], V[keep]
    A = sp.coo_matrix((V, (I, J)), shape=(m, n)).tocsr()
    A.sum_duplicates()
    A.sort_indices()
    return A


def precompute_nzindex(A: sp.csr_matrix, I, J) -> np.ndarray:
    """For each triplet (I[k], J[k]) its position in ``A.data`` (-1 for a
    negative id or an entry A does not store).  A must be CSR with sorted
    indices (``compresscoo``'s output is); it is left untouched."""
    if not (sp.issparse(A) and A.format == "csr" and A.has_sorted_indices):
        raise ValueError("precompute_nzindex needs a CSR matrix with sorted indices")
    I = np.asarray(I)
    J = np.asarray(J)
    K = np.full(I.shape[0], -1, dtype=np.int64)
    valid = (I >= 0) & (J >= 0)
    # sorted unique CSR entries are sorted by the key row*(n+1)+col: one
    # searchsorted answers every query
    n1 = np.int64(A.shape[1] + 1)
    entry_keys = (
        np.repeat(np.arange(A.shape[0], dtype=np.int64), np.diff(A.indptr)) * n1
        + A.indices.astype(np.int64)
    )
    query_keys = I[valid].astype(np.int64) * n1 + J[valid].astype(np.int64)
    pos = np.searchsorted(entry_keys, query_keys)
    if entry_keys.size:
        safe = np.minimum(pos, entry_keys.size - 1)
        found = (pos < entry_keys.size) & (entry_keys[safe] == query_keys)
    else:
        found = np.zeros(pos.shape, dtype=bool)
    K[valid] = np.where(found, pos, -1)
    return K


def sparse_matrix(I, J, V, m: int, n: int, reuse: bool = False):
    """CSR from COO; with ``reuse=True`` also the refill positions of the
    triplets (``precompute_nzindex``)."""
    A = compresscoo(I, J, V, m, n)
    if reuse:
        return A, precompute_nzindex(A, I, J)
    return A


def sparse_matrix_refill(A: sp.csr_matrix, V, K, reset: bool = True) -> None:
    """A's values refilled in place from triplet values V at the positions
    K (duplicates summed in triplet order)."""
    if reset:
        A.data[:] = 0
    valid = K >= 0
    np.add.at(A.data, K[valid], np.asarray(V)[valid])


def nziterator(A: sp.spmatrix):
    """(i, j, v) over the stored entries, in COO order (reference
    ``nziterator``, src/sparse_utils.jl:24-125)."""
    coo = A.tocoo()
    for i, j, v in zip(coo.row, coo.col, coo.data):
        yield int(i), int(j), v


def indextype(A: sp.spmatrix):
    """The dtype of A's column indices as CSR (reference ``indextype``)."""
    return A.tocsr().indices.dtype


def spmv(A: sp.spmatrix, x: np.ndarray) -> np.ndarray:
    """y = A x on the host (reference ``spmv!``, src/sparse_utils.jl:609)."""
    return A @ x


def spmtv(A: sp.spmatrix, x: np.ndarray) -> np.ndarray:
    """y = A^T x on the host (reference ``spmtv!``, src/sparse_utils.jl:633-647)."""
    return A.T @ x


def sub_sparse_matrix(A: sp.csr_matrix, rows: np.ndarray, cols: np.ndarray) -> sp.csr_matrix:
    """The block A[rows, cols] as CSR (the reference's lazy
    ``SubSparseMatrix``, src/sparse_utils.jl:127-211, materialized: it
    serves setup only)."""
    return A[np.asarray(rows)][:, np.asarray(cols)].tocsr()


def split_locally(A: sp.spmatrix, own_rows: np.ndarray, ghost_rows: np.ndarray,
                  own_cols: np.ndarray, ghost_cols: np.ndarray
                  ) -> Tuple[sp.csr_matrix, sp.csr_matrix, sp.csr_matrix, sp.csr_matrix]:
    """A local matrix split into its own-own, own-ghost, ghost-own and
    ghost-ghost blocks, numbered in the own and ghost orders (reference
    ``split_format_locally``, src/p_sparse_matrix.jl:823-935)."""
    A = A.tocsr()
    return (sub_sparse_matrix(A, own_rows, own_cols), sub_sparse_matrix(A, own_rows, ghost_cols),
            sub_sparse_matrix(A, ghost_rows, own_cols),
            sub_sparse_matrix(A, ghost_rows, ghost_cols))
