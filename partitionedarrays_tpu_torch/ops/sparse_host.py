"""Host-side (setup-time) sparse helpers over scipy CSR matrices.

Copied from ``partitionedarrays_tpu/ops/sparse_host.py`` (``compresscoo``
:26); the rest of that module comes with the generic slice.
"""
from __future__ import annotations

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
