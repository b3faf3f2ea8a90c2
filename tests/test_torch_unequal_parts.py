"""Stencil operators on part boxes of unequal shape, and the AMG-CG on them
and on their repartition, of the PyTorch port against the JAX reference on
the CPU (Pallas off; the reference's float32 with JAX's x64 mode off, its
TPU semantics).

- ``stencil_psparse`` through ``plaplacian_fdm`` on grids that the parts
  do not divide ((9,10,11) and 17^3 on (2,2,2), (9,10) on (2,3)), and on
  one that they do (the equal-box branch): the DIA offsets (the union of
  the parts' offsets), the device values ``[P, n_off, n_own_pad]`` with
  each part's zero diagonals and zero padding rows, the host copy
  ``_oo_dia_host``, nnz, the partitions and every host block bit for bit,
  and the global matrix equal to the triplet build's; the SpMV on the
  plain kernel versions to 1e-12 (float64) / 1e-5 (float32) of the
  largest entry.
- The AMG-CG of ``chip_smoke.py`` phase 4j at 17^3 on (2,2,2) parts
  (``AMGParams(coarse_size=200)``, ones in the first 10 own entries of
  part 0, rtol 1e-8): on the unequal boxes (the box aggregation declines,
  as the reference's does) and after ``repartition_system`` onto eight
  contiguous blocks of ids; the hierarchy bit for bit, the same iteration
  count, and the residual history to rtol 1e-8 (float64) or to 1e-3 while
  the relres is above 1e-5 (float32), the tolerances of
  ``tests/test_torch_amg_parts_{f64,f32}.py``; the two solutions, in
  global order, agree to 1e-7 (float64) / 1e-4 (float32) of the largest
  entry (both solves stop at rtol 1e-8).
"""
import importlib

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import torch_amg_cases
import torch_amg_parts_cases as cases
from partitionedarrays_tpu import config as jax_config
from partitionedarrays_tpu.backends import SerialBackend as JaxSerialBackend
from partitionedarrays_tpu.models import gallery as jax_gallery
from partitionedarrays_tpu.parallel import p_range as jp
from partitionedarrays_tpu.solvers import amg as jax_amg

from partitionedarrays_tpu_torch import psparse as ps
from partitionedarrays_tpu_torch import pvector as pv
from partitionedarrays_tpu_torch.backends import SerialBackend
from partitionedarrays_tpu_torch.models import gallery
from partitionedarrays_tpu_torch.parallel import partition as tp
from partitionedarrays_tpu_torch.solvers import amg

jax_psparse = importlib.import_module("partitionedarrays_tpu.psparse")
jax_pvector = importlib.import_module("partitionedarrays_tpu.pvector")

torch.set_num_threads(1)

DTYPES = pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
SPMV_RTOL = {np.float64: 1e-12, np.float32: 1e-5}
GRIDS = {
    "9x10x11": ((9, 10, 11), (2, 2, 2)),
    "17^3": ((17, 17, 17), (2, 2, 2)),
    "9x10": ((9, 10), (2, 3)),
    "equal_8^3": ((8, 8, 8), (2, 2, 2)),
}
AMG_NODES, AMG_PARTS = (17, 17, 17), (2, 2, 2)
SOLUTION_RTOL = {np.float64: 1e-7, np.float32: 1e-4}


@pytest.fixture(scope="module", autouse=True)
def reference_without_pallas():
    saved = jax_config.use_pallas
    jax_config.use_pallas = False
    with threadpool_limits(limits=1):
        yield
    jax_config.use_pallas = saved


def _mode(dtype):
    """The reference's context: x64 off for float32 (its TPU semantics)."""
    return torch_amg_cases.reference_mode(dtype)


def _pair(nodes, parts, dtype):
    P = int(np.prod(parts))
    A = gallery.plaplacian_fdm(nodes, parts, SerialBackend(P), dtype=dtype, device="cpu")
    A_ref = jax_gallery.plaplacian_fdm(nodes, parts, JaxSerialBackend(P), dtype=dtype)
    return A, A_ref


@DTYPES
@pytest.mark.parametrize("grid", list(GRIDS))
def test_plaplacian_fdm_matches_jax(grid, dtype):
    nodes, parts = GRIDS[grid]
    with _mode(dtype):
        A, A_ref = _pair(nodes, parts, dtype)
        oo, oo_ref = A.device().oo, A_ref.device().oo
        equal = grid.startswith("equal")
        assert (len({li.n_own for li in A.row_prange.parts}) == 1) == equal
        assert oo.kind == oo_ref.kind == "dia" and oo.offsets == tuple(oo_ref.offsets)
        np.testing.assert_array_equal(oo.vals.numpy(), np.asarray(oo_ref.vals))
        assert A.nnz() == A_ref.nnz()
        if equal:
            assert A._oo_dia_host is None and A_ref._oo_dia_host is None
        else:
            assert A._oo_dia_host[0] == A_ref._oo_dia_host[0] == oo.offsets
            np.testing.assert_array_equal(A._oo_dia_host[1], A_ref._oo_dia_host[1])
            assert A._oo_dia_host[1].shape == tuple(oo.vals.shape)
        cases.same_matrix(A, A_ref)
        I, J, V, rows, cols = gallery.laplacian_fdm(nodes, parts, dtype=dtype)
        B = ps.psparse(I, J, V, rows, cols, A.backend, assembled=True, device="cpu")
        G = ps.to_global_scipy(A)
        assert (G != ps.to_global_scipy(B)).nnz == 0 and G.nnz == A.nnz()
        x = pv.pones(A.col_prange, A.backend, dtype=A.dtype, device="cpu")
        x_ref = jax_pvector.pones(A_ref.col_prange, A_ref.backend, dtype=dtype)
        y = pv.collect(ps.spmv(A, x))
        y_ref = jax_pvector.collect(jax_psparse.spmv(A_ref, x_ref))
        np.testing.assert_allclose(y, y_ref, rtol=0, atol=SPMV_RTOL[dtype] * np.abs(y_ref).max())


def _slabs(mod, n):
    """Eight contiguous blocks of ``range(n)``: x-slabs of the grid that do
    not align with its planes."""
    return mod.PRange(mod.variable_partition([len(mod.local_range(p, 8, n)) for p in range(8)]))


def _solve_pair(dtype, repartitioned):
    """((A, M, b), (A_ref, M_ref, b_ref)) of phase 4j's AMG-CG at 17^3,
    on the unequal boxes or repartitioned onto slabs."""
    A, A_ref = _pair(AMG_NODES, AMG_PARTS, dtype)
    own = [np.zeros(li.n_own, dtype=dtype) for li in A.row_prange.parts]
    own[0][:10] = 1.0
    b = pv.pvector_from_own(own, A.row_prange, A.backend, device="cpu")
    b_ref = jax_pvector.pvector_from_own(own, A_ref.row_prange, A_ref.backend)
    if repartitioned:
        A, b = ps.repartition_system(A, b, _slabs(tp, A.shape[0]))
        A_ref, b_ref = jax_psparse.repartition_system(A_ref, b_ref, _slabs(jp, A.shape[0]))
        cases.same_matrix(A, A_ref)
        np.testing.assert_array_equal(b.own.numpy(), np.asarray(b_ref.own))
    assert amg.box_aggregate_psparse(A) is None and jax_amg.box_aggregate_psparse(A_ref) is None
    M = amg.AMGPreconditioner(A, amg.AMGParams(coarse_size=200))
    M_ref = jax_amg.AMGPreconditioner(A_ref, jax_amg.AMGParams(coarse_size=200))
    return (A, M, b), (A_ref, M_ref, b_ref)


@DTYPES
def test_amg_cg_on_unequal_parts_and_repartitioned_matches_jax(dtype):
    """Both paths of phase 4j at 17^3: the hierarchies, iteration counts
    and histories against the reference's, and the two solutions against
    each other."""
    xs = {}
    with _mode(dtype):
        for repartitioned in (False, True):
            port, ref = _solve_pair(dtype, repartitioned)
            cases.check_hierarchy(port[1], ref[1])
            M = port[1]
            assert M.levels[0].smoother.colored is not None
            assert M.levels[0].A.device().oo.offsets == (
                (-289, -17, -1, 0, 1, 17, 289) if repartitioned else
                (-81, -72, -64, -9, -8, -1, 0, 1, 8, 9, 64, 72, 81))
            (x, h), (x_ref, h_ref) = cases.histories(port, ref)
            assert len(h) == len(h_ref) and h[-1] <= cases.RTOL_CG * h[0]
            if dtype == np.float64:
                np.testing.assert_allclose(h, h_ref, rtol=1e-8)
            else:
                rtol, floor = cases.F32_HISTORY
                keep = h_ref / h_ref[0] > floor
                np.testing.assert_allclose(h[keep], h_ref[keep], rtol=rtol)
            assert cases.true_relres(port[0], x, port[2]) <= (2e-8 if dtype == np.float64 else 1e-5)
            xs[repartitioned] = x  # in global order
    np.testing.assert_allclose(xs[True], xs[False], rtol=0,
                               atol=SOLUTION_RTOL[dtype] * np.abs(xs[False]).max())
