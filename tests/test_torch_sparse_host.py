"""The host sparse helpers of the port's ``ops/sparse_host.py`` against the
JAX package's (``partitionedarrays_tpu/ops/sparse_host.py``): the entry
iterator, the index type, the host products exported as ``spmv_local`` and
``spmtv_local``, the sub-block and the split into own and ghost blocks,
entry for entry on the same random matrices.
"""
import numpy as np
import pytest
import scipy.sparse as sp

import partitionedarrays_tpu as jpt
from partitionedarrays_tpu.ops import sparse_host as jsh

import partitionedarrays_tpu_torch as pt
from partitionedarrays_tpu_torch.ops import sparse_host as sh


def _matrix(seed, dtype=np.float64, index=np.int32):
    A = sp.random(30, 24, density=0.2, random_state=seed, format="csr", dtype=dtype)
    A.indices = A.indices.astype(index)
    A.indptr = A.indptr.astype(index)
    return A


@pytest.mark.parametrize("seed", [0, 1])
def test_nziterator_and_indextype_match_jax(seed):
    A = _matrix(seed)
    assert list(sh.nziterator(A)) == list(jsh.nziterator(A))
    assert sh.indextype(A) == jsh.indextype(A) == np.int32
    assert sh.indextype(_matrix(seed, index=np.int64)) == np.int64


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_host_products_match_jax(dtype):
    A = _matrix(2, dtype)
    rng = np.random.default_rng(3)
    x, y = rng.standard_normal(24).astype(dtype), rng.standard_normal(30).astype(dtype)
    np.testing.assert_array_equal(pt.spmv_local(A, x), jpt.spmv_local(A, x))
    np.testing.assert_array_equal(pt.spmtv_local(A, y), jpt.spmtv_local(A, y))
    np.testing.assert_allclose(pt.spmv_local(A, x), A.toarray() @ x, rtol=1e-5)


def test_sub_sparse_matrix_and_split_locally_match_jax():
    A = _matrix(4)
    rng = np.random.default_rng(5)
    rows, cols = rng.permutation(30), rng.permutation(24)
    own_r, ghost_r, own_c, ghost_c = rows[:20], rows[20:], cols[:16], cols[16:]
    got = sh.sub_sparse_matrix(A, own_r, ghost_c)
    want = jsh.sub_sparse_matrix(A, own_r, ghost_c)
    assert got.format == "csr" and (got != want).nnz == 0
    for g, w, (r, c) in zip(sh.split_locally(A, own_r, ghost_r, own_c, ghost_c),
                            jsh.split_locally(A, own_r, ghost_r, own_c, ghost_c),
                            [(own_r, own_c), (own_r, ghost_c), (ghost_r, own_c),
                             (ghost_r, ghost_c)]):
        assert g.shape == w.shape == (r.size, c.size) and (g != w).nnz == 0
        np.testing.assert_array_equal(g.toarray(), A.toarray()[np.ix_(r, c)])
