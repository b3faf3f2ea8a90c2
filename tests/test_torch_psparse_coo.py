"""COO assembly of the PyTorch port against the JAX reference, on one part:
``psparse`` with duplicate summation, the host blocks, the device freeze
(the 99-diagonal elasticity block is DIA in both packages: the repaired
DIA cap), ``spmv`` and ``spmtv``, ``spmm`` and ``spmtm``, ``dense_diag``
and ``to_global_scipy``.

Triplets come from both galleries (bit-equal, ``test_torch_gallery.py``);
vectors are made with numpy from a seed.  The reference runs as JAX on the
CPU with Pallas off; the port on the CPU, where K1 and K5 run their plain
versions.  Host blocks and products are the same scipy operations on the
same data, so they must be equal bit for bit; the SpMVs agree to rtol
1e-13 (float64) and 1e-6 (float32) of the largest reference entry (the
summation order differs).
"""
import importlib

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from partitionedarrays_tpu import config as jax_config
from partitionedarrays_tpu.backends import SerialBackend as JaxSerialBackend
from partitionedarrays_tpu.models import gallery as jax_gallery
from partitionedarrays_tpu.parallel.p_range import PRange as JaxPRange

from partitionedarrays_tpu_torch.backends import SerialBackend
from partitionedarrays_tpu_torch.models import gallery
from partitionedarrays_tpu_torch.ops.dia import MAX_DIAGS
from partitionedarrays_tpu_torch.psparse import (
    dense_diag, psparse, spmm, spmtm, spmtv, spmv, to_global_scipy,
)
from partitionedarrays_tpu_torch.pvector import pvector_from_own

jax_psparse = importlib.import_module("partitionedarrays_tpu.psparse")
jax_pvector = importlib.import_module("partitionedarrays_tpu.pvector")

torch.set_num_threads(1)

RTOL = {np.float32: 1e-6, np.float64: 1e-13}
# (generator, nodes, expected own-block kind, expected number of diagonals)
CASES = {
    "elasticity3d": ("linear_elasticity_fem", (6, 6, 6), "dia", 99),
    "elasticity2d": ("linear_elasticity_fem", (7, 6), "dia", 21),
    "laplacian_fem2d": ("laplacian_fem", (9, 7), "dia", 9),
}


# numpy's BLAS on one thread in this module: its idle threads spin, and
# beside the suite's other workers its small dense factorizations (tile
# inverses, QR, LU) then run up to ~30x slower
@pytest.fixture(scope="module", autouse=True)
def reference_without_pallas():
    saved = jax_config.use_pallas
    jax_config.use_pallas = False
    with threadpool_limits(limits=1):
        yield
    jax_config.use_pallas = saved


def build(case, dtype):
    """(port A, reference A) from the same triplets."""
    name, nodes, _, _ = CASES[case]
    parts = (1,) * len(nodes)
    I, J, V, rows, cols = getattr(gallery, name)(nodes, parts, dtype=dtype)
    A = psparse(I, J, V, rows, cols, SerialBackend(1), device="cpu")
    Ir, Jr, Vr, rows_r, cols_r = getattr(jax_gallery, name)(nodes, parts, dtype=dtype)
    A_ref = jax_psparse.psparse(Ir, Jr, Vr, JaxPRange(rows_r), JaxPRange(cols_r), JaxSerialBackend(1))
    return A, A_ref


def _same_csr(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.array_equal(a.indptr, b.indptr) and np.array_equal(a.indices, b.indices)
    assert np.array_equal(a.data, b.data)


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", list(CASES))
def test_host_blocks_and_freeze_match(case, dtype):
    A, A_ref = build(case, dtype)
    _, _, kind, n_diags = CASES[case]
    for name in ("oo", "oh"):
        _same_csr(A.blocks[0][name].tocsr(), A_ref.blocks[0][name].tocsr())
    assert A.nnz() == A_ref.nnz()
    assert A.shape == A_ref.shape
    oo, oo_ref = A.device().oo, A_ref.device().oo
    assert oo.kind == oo_ref.kind == kind
    assert len(oo.offsets) == len(oo_ref.offsets) == n_diags
    assert tuple(oo.offsets) == tuple(oo_ref.offsets)
    np.testing.assert_array_equal(oo.vals.numpy(), np.asarray(oo_ref.vals))
    _same_csr(to_global_scipy(A), jax_psparse.to_global_scipy(A_ref))
    d, d_ref = dense_diag(A), jax_psparse.dense_diag(A_ref)
    np.testing.assert_array_equal(d.own.numpy(), np.asarray(d_ref.own))


def test_dia_cap_is_the_reference_s():
    """The 99-diagonal 3-D elasticity block (the fault's case) freezes to DIA
    as in the reference, whose ``freeze_block`` caps DIA at 128 diagonals."""
    import inspect

    from partitionedarrays_tpu.ops.blocks import freeze_block as jax_freeze_block

    assert MAX_DIAGS == inspect.signature(jax_freeze_block).parameters["max_diags"].default == 128
    A, A_ref = build("elasticity3d", np.float64)
    assert A.device().oo.kind == A_ref.device().oo.kind == "dia"
    assert 48 < len(A.device().oo.offsets) <= MAX_DIAGS


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", list(CASES))
def test_spmv_and_spmtv_match(case, dtype):
    A, A_ref = build(case, dtype)
    rng = np.random.default_rng(7)
    n = A.shape[0]
    own = [rng.standard_normal(n).astype(dtype)]
    y_own = [rng.standard_normal(n).astype(dtype)]
    x = pvector_from_own(own, A.col_prange, A.backend, device="cpu")
    y = pvector_from_own(y_own, A.row_prange, A.backend, device="cpu")
    x_ref = jax_pvector.pvector_from_own(own, A_ref.col_prange, A_ref.backend)
    y_ref = jax_pvector.pvector_from_own(y_own, A_ref.row_prange, A_ref.backend)
    rtol = RTOL[dtype]
    _close(spmv(A, x).own[0, :n], np.asarray(jax_psparse.spmv(A_ref, x_ref).own)[0, :n], rtol)
    _close(
        spmv(A, x, alpha=-1.0, beta=1.0, y=y).own[0, :n],
        np.asarray(jax_psparse.spmv(A_ref, x_ref, alpha=-1.0, beta=1.0, y=y_ref).own)[0, :n],
        rtol,
    )
    xr = pvector_from_own(own, A.row_prange, A.backend, device="cpu")
    xr_ref = jax_pvector.pvector_from_own(own, A_ref.row_prange, A_ref.backend)
    _close(spmtv(A, xr).own[0, :n], np.asarray(jax_psparse.spmtv(A_ref, xr_ref).own)[0, :n], rtol)
    G = to_global_scipy(A).astype(np.float64)
    _close(spmtv(A, xr).own[0, :n], G.T @ own[0].astype(np.float64), rtol)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_spmm_and_spmtm_equal_scipy_and_the_reference(dtype):
    A, A_ref = build("elasticity3d", dtype)
    B, B_ref = build("elasticity3d", dtype)
    G = to_global_scipy(A)
    C = spmm(A, B)
    C_ref = jax_psparse.spmm(A_ref, B_ref)
    _same_csr(C.blocks[0]["oo"], C_ref.blocks[0]["oo"].tocsr())
    want = (G @ G).tocsr()
    want.sort_indices()
    np.testing.assert_array_equal(to_global_scipy(C).toarray(), want.toarray())
    T = spmtm(A, B)
    T_ref = jax_psparse.spmtm(A_ref, B_ref)
    _same_csr(T.blocks[0]["oo"], T_ref.blocks[0]["oo"].tocsr())
    np.testing.assert_array_equal(to_global_scipy(T).toarray(), (G.T.tocsr() @ G).toarray())
    assert C.shape == T.shape == A.shape


def test_more_parts_and_ghost_columns_assemble():
    """What raised before multi-part COO: two parts of a 3-D elasticity
    operator, and one part whose triplets reach a column it does not own
    (a ghost column), equal to the reference's."""
    I, J, V, rows, cols = gallery.linear_elasticity_fem((4, 4, 4), (2, 1, 1))
    A = psparse(I, J, V, rows, cols, SerialBackend(2), device="cpu")
    I, J, V, rows, cols = jax_gallery.linear_elasticity_fem((4, 4, 4), (2, 1, 1))
    A_ref = jax_psparse.psparse(I, J, V, JaxPRange(rows), JaxPRange(cols), JaxSerialBackend(2))
    for p in range(2):
        for k in ("oo", "oh"):
            _same_csr(A.blocks[p][k], A_ref.blocks[p][k])
    _same_csr(to_global_scipy(A), jax_psparse.to_global_scipy(A_ref))
    from partitionedarrays_tpu_torch.parallel.partition import LocalIndices, variable_partition

    # column 5 lies outside the part's own columns 0..3: a ghost column
    owner = lambda q: np.where(np.asarray(q) < 4, 0, 1)
    cols = [LocalIndices(6, 0, 1, np.arange(4), global_to_owner=owner)]
    A = psparse([np.array([0, 1])], [np.array([1, 5])], [np.ones(2)], variable_partition([4]),
                cols, SerialBackend(1), device="cpu")
    li = A.col_prange.parts[0]
    assert li.ghost_to_global.tolist() == [5] and li.ghost_to_owner.tolist() == [1]
    assert A.blocks[0]["oo"].toarray()[0].tolist() == [0, 1, 0, 0]
    assert A.blocks[0]["oh"].toarray().tolist() == [[0], [1], [0], [0]]


def test_colored_plan_of_the_99_offsets_matches():
    """The colored Gauss-Seidel state of the 99-diagonal block at 16^3 nodes
    (K3's operands): the reference's m = 27, Lq, Kp and tap schedule, and
    the same de-interleaved values and inverse diagonal."""
    from partitionedarrays_tpu.solvers.smoothers import GaussSeidel as JaxGaussSeidel

    from partitionedarrays_tpu_torch.solvers.smoothers import GaussSeidel

    nodes = (16, 16, 16)
    I, J, V, rows, cols = gallery.linear_elasticity_fem(nodes, (1, 1, 1))
    A = psparse(I, J, V, rows, cols, SerialBackend(1), device="cpu")
    Ir, Jr, Vr, rows_r, cols_r = jax_gallery.linear_elasticity_fem(nodes, (1, 1, 1))
    A_ref = jax_psparse.psparse(Ir, Jr, Vr, JaxPRange(rows_r), JaxPRange(cols_r), JaxSerialBackend(1))
    col, col_ref = GaussSeidel(A).colored, JaxGaussSeidel(A_ref).colored
    assert len(col.offsets) == 99 and col.m == col_ref.m == 27
    assert (col.Lq, col.Kp) == (col_ref.Lq, col_ref.Kp)
    assert tuple(map(tuple, col.schedule)) == tuple(map(tuple, col_ref.schedule))
    np.testing.assert_array_equal(col.vals_d.numpy(), np.asarray(col_ref.vals_d))
    np.testing.assert_array_equal(col.invd_d.numpy(), np.asarray(col_ref.invd_d))
