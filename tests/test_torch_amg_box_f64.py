"""Box-stencil SA-AMG of the PyTorch port against the JAX reference, float64
(cases in ``tests/torch_amg_box_cases.py``), and the host mirrors of the
closed-form stencil matrices.

- ``box_aggregate_psparse`` on an exact (9^3) and a ragged ((10, 11, 12))
  box: aggregates, coarse counts and shapes bit-equal to the reference's.
- The hierarchy of the ragged box under the default ``AMGParams`` (but
  ``coarse_size``): every level bit for bit, omega to 1e-12, the same
  frozen offsets, smoother tiers, colors and box shapes.
- The structured and flat transfers against the reference's and against
  the materialized P (``P^T r``, ``P e``), to 1e-12 of the largest entry;
  one V-cycle and one W-cycle, and the cycle's structured branch that is
  not flat (a level forced onto the tile tier), to 1e-10; the PCG
  residual histories to rtol 1e-10 with the same iteration count.
- ``PSparseMatrix.astype``, ``copy`` and the arithmetic against the
  reference's; ``cg_df64`` preconditioned by an AMG built from the float32
  copy of a float64 ``laplacian_fdm``: iterations within one of the
  reference's, the true float64 residual below 1e-9.
- ``stencil_psparse``'s host mirrors: ``to_global_scipy`` and
  ``dense_diag`` equal to the reference's, on one part and on (2,2,2)
  parts, and to ``build_hpcg_problem(structured=False)`` (its blocks and
  ghosts equal to the reference's triplet pipeline's) on both; the
  AMG hierarchy of the one-part HPCG operator equal to the reference's.
"""
import importlib

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import torch_amg_box_cases as cases
import torch_amg_cases
from partitionedarrays_tpu import config as jax_config
from partitionedarrays_tpu.backends import SerialBackend as JaxSerialBackend
from partitionedarrays_tpu.models.hpcg.problem import build_hpcg_problem as jax_build_hpcg
from partitionedarrays_tpu.solvers import amg as jax_amg
from partitionedarrays_tpu.solvers import krylov as jax_krylov

from partitionedarrays_tpu_torch.backends import SerialBackend
from partitionedarrays_tpu_torch.models.hpcg.problem import build_hpcg_problem
from partitionedarrays_tpu_torch.ops import df64 as df
from partitionedarrays_tpu_torch.psparse import dense_diag, host_blocks, spmv, to_global_scipy
from partitionedarrays_tpu_torch.pvector import PVector, collect_df64, pvector_df64
from partitionedarrays_tpu_torch.solvers import amg, krylov

jax_psparse = importlib.import_module("partitionedarrays_tpu.psparse")
jax_pvector = importlib.import_module("partitionedarrays_tpu.pvector")

torch.set_num_threads(1)

DTYPE = np.float64


# numpy's BLAS on one thread in this module: its idle threads spin, and
# beside the suite's other workers its small dense factorizations then run
# up to ~30x slower
@pytest.fixture(scope="module", autouse=True)
def reference_mode():
    saved = jax_config.use_pallas
    jax_config.use_pallas = False
    with threadpool_limits(limits=1):
        yield
    jax_config.use_pallas = saved


@pytest.fixture(scope="module")
def built():
    return cases.build(DTYPE)


@pytest.mark.parametrize("nodes", [cases.EXACT, cases.RAGGED])
def test_box_aggregation_matches_jax(nodes):
    A, A_ref = cases.operators(nodes, DTYPE)
    aggs, coarse, shapes = amg.box_aggregate_psparse(A)
    aggs_ref, coarse_ref, shapes_ref = jax_amg.box_aggregate_psparse(A_ref)
    assert shapes == shapes_ref == (nodes, tuple(-(-n // 3) for n in nodes))
    np.testing.assert_array_equal(aggs[0], aggs_ref[0])
    assert coarse.n_global == coarse_ref.n_global == int(np.prod(shapes[1]))
    # not a box stencil: an elasticity operator keeps the generic aggregation
    from partitionedarrays_tpu_torch.models.gallery import linear_elasticity_fem
    from partitionedarrays_tpu_torch.psparse import psparse

    I, J, V, rows, cols = linear_elasticity_fem((4, 4, 4), (1, 1, 1))
    assert amg.box_aggregate_psparse(psparse(I, J, V, rows, cols, SerialBackend(1), device="cpu")) is None


def test_hierarchy_matches_jax(built):
    (A, M, b), (A_ref, M_ref, b_ref) = built
    cases.check_hierarchy(M, M_ref)
    assert [lev.A.shape[0] for lev in M.levels] == [1320, 64, 8]
    assert torch_amg_cases.tiers(M) == ["colored", "colored", None]
    assert [lev.smoother.n_colors for lev in M.levels[:2]] == [5, 9]
    assert [len(lev.A.device().oo.offsets) for lev in M.levels] == [7, 27, 15]
    # a box level never applies P as a matrix: it is not frozen
    assert all(lev.P._device is None for lev in M.levels[:-1])


def test_transfers_match_jax_and_P(built):
    cases.check_transfers(*built, DTYPE)


def test_vcycle_matches_jax(built):
    (A, M, b), (A_ref, M_ref, b_ref) = built
    n = A.shape[0]
    cases.close(cases.own(M(b), n), cases.own(M_ref(b_ref), n), cases.CYCLE_ATOL[DTYPE])


def test_wcycle_matches_jax(built):
    """The W-cycle on the same hierarchy (the reference reuses its
    compiled level programs): its second visit of level 1 goes through
    ``_cycle``, the first through the flat cycle."""
    (A, M, b), (A_ref, M_ref, b_ref) = built
    n = A.shape[0]
    z, z_ref = M._cycle(0, b, True), M_ref._cycle(0, b_ref, True)
    cases.close(cases.own(z, n), cases.own(z_ref, n), cases.CYCLE_ATOL[DTYPE])
    assert np.abs(cases.own(z, n) - cases.own(M(b), n)).max() > 0


def test_cg_history_matches_jax(built):
    port, ref = built
    (x, h), (x_ref, h_ref) = torch_amg_cases.histories(port, ref)
    assert len(h) == len(h_ref) and 5 <= len(h) - 1 <= 15
    np.testing.assert_allclose(h, h_ref, rtol=1e-10)
    A, M, b = port
    _, info = krylov.cg(A, b, M=M, rtol=torch_amg_cases.RTOL_CG, maxiter=torch_amg_cases.MAXITER)
    assert info.iterations == len(h_ref) - 1


def test_structured_branch_that_is_not_flat_matches_jax():
    """Level 0 on the tile tier (level 1 stays flat): the cycle restricts
    and prolongates level 0 by ``_restrict_struct``/``_prolong_struct``."""
    port, ref = cases.build(DTYPE, coarse_size=100, max_levels=2)
    (A, M, b), (A_ref, M_ref, b_ref) = port, ref
    cases.force_tile_tier(M, M_ref, 0)
    n = A.shape[0]
    cases.close(cases.own(M(b), n), cases.own(M_ref(b_ref), n), cases.CYCLE_ATOL[DTYPE])


def test_astype_copy_and_arithmetic_match_jax():
    A, A_ref = cases.operators((5, 6, 7), DTYPE)
    A32 = A.astype(np.float32)
    assert A32.dtype == torch.float32 and A32.torch_device == A.torch_device
    assert A32.device().oo.vals.dtype == torch.float32 and A32.blocks[0]["oo"].dtype == np.float32
    assert A.dtype == torch.float64  # the source is untouched
    pairs = [
        (A32, A_ref.astype(np.float32)),
        (A.copy(), A_ref.copy()),
        (2.0 * A - A / 4.0 + (-A), 2.0 * A_ref - A_ref / 4.0 + (-A_ref)),
        (A * 3.0 + A, A_ref * 3.0 + A_ref),
    ]
    for got, want in pairs:
        cases.same_csr(to_global_scipy(got), jax_psparse.to_global_scipy(want))
        np.testing.assert_array_equal(cases.own(dense_diag(got), A.shape[0]),
                                      cases.own(jax_psparse.dense_diag(want), A.shape[0]))


def test_cg_df64_with_a_float32_amg_matches_jax():
    """``cg_df64`` on a float64 ``laplacian_fdm`` preconditioned by the AMG
    of its float32 copy (the reference's bench.py:491-544 at 12^3)."""
    A, A_ref = cases.operators((12, 12, 12), np.float64)
    G = to_global_scipy(A)
    xg = np.random.default_rng(7).standard_normal(A.shape[0])
    bg = G @ xg
    b = pvector_df64([bg], A.row_prange, A.backend, device="cpu")
    b_ref = jax_pvector.pvector_df64([bg], A_ref.row_prange, A_ref.backend)
    M = amg.AMGPreconditioner(A.astype(np.float32), amg.AMGParams(coarse_size=20))
    assert [lev.A.dtype for lev in M.levels] == [torch.float32] * len(M.levels)
    assert M.levels[0].struct is not None
    M_ref = jax_amg.AMGPreconditioner(A_ref.astype(np.float32), jax_amg.AMGParams(coarse_size=20))
    x, info = krylov.cg_df64(A, b, M=M, rtol=1e-10, maxiter=200)
    _, info_ref = jax_krylov.cg_df64(A_ref, b_ref, M=M_ref, rtol=1e-10, maxiter=200)
    assert abs(info.iterations - int(info_ref.iterations)) <= 1 and info.iterations < 40
    x64 = df.to_f64(x[0].own, x[1].own)
    xv = PVector(x64, x64.new_zeros((1, A.row_layout().n_ghost_pad)), A.row_layout(), A.backend)
    b64 = df.to_f64(b[0].own, b[1].own)
    relres = torch.linalg.vector_norm(b64 - spmv(A, xv).own) / torch.linalg.vector_norm(b64)
    assert relres <= 1e-9, relres
    np.testing.assert_allclose(collect_df64(x), xg, rtol=0, atol=1e-7 * np.abs(xg).max())


@pytest.mark.parametrize("local,parts", [((6, 5, 4), (1, 1, 1)), ((3, 4, 3), (2, 2, 2))])
def test_stencil_host_mirror_matches_jax(local, parts):
    P = int(np.prod(parts))
    A, _ = build_hpcg_problem(local, parts, SerialBackend(P), device="cpu")
    A_ref, _ = jax_build_hpcg(local, parts, JaxSerialBackend(P))
    blk = host_blocks(A)[0]
    assert dict.__contains__(blk, "oh") and not dict.__contains__(blk, "oo")
    # every view holds both blocks; only values/items make the mirror
    assert "oo" in blk and len(blk) == 2 and list(blk) == list(blk.keys()) == ["oh", "oo"]
    assert not dict.__contains__(blk, "oo")
    assert sum(m.count_nonzero() for b in host_blocks(A) for m in b.values()) == A.nnz()
    assert [k for k, _ in blk.items()] == ["oh", "oo"] and dict.__contains__(blk, "oo")
    G = to_global_scipy(A)
    cases.same_csr(G, jax_psparse.to_global_scipy(A_ref))
    np.testing.assert_array_equal(dense_diag(A).own.numpy(), np.asarray(jax_psparse.dense_diag(A_ref).own))
    # the mirror holds the values of the frozen device block
    oo = A.device().oo
    xs = np.random.default_rng(5).standard_normal((P, oo.n_cols_pad))
    got = oo.spmv(torch.from_numpy(xs)).numpy()
    for p in range(P):
        dia = host_blocks(A)[p]["oo"]
        want = dia @ xs[p, : dia.shape[1]]
        cases.close(got[p, : dia.shape[0]], want, 1e-15)
    # the generic triplet pipeline gives the same matrix, on any number of parts
    A_coo, b_coo = build_hpcg_problem(local, parts, SerialBackend(P), structured=False, device="cpu")
    cases.same_csr(to_global_scipy(A_coo), G)
    A_coo_ref, _ = jax_build_hpcg(local, parts, JaxSerialBackend(P), structured=False)
    for p in range(P):
        for k in ("oo", "oh"):
            cases.same_csr(host_blocks(A_coo)[p][k], A_coo_ref.blocks[p][k])
        np.testing.assert_array_equal(A_coo.col_prange.parts[p].ghost_to_global,
                                      A_coo_ref.col_prange[p].ghost_to_global)
    _, b = build_hpcg_problem(local, parts, SerialBackend(P), device="cpu")
    np.testing.assert_array_equal(b_coo.own.numpy(), b.own.numpy())


def test_amg_on_the_hpcg_operator_matches_jax():
    """AMG on the one-part 27-point operator: level 0 is the closed-form
    matrix (its lazy DIA mirror), aggregated in boxes."""
    A, _ = build_hpcg_problem((8, 8, 8), (1, 1, 1), SerialBackend(1), device="cpu")
    A_ref, _ = jax_build_hpcg((8, 8, 8), (1, 1, 1), JaxSerialBackend(1))
    M = amg.AMGPreconditioner(A, amg.AMGParams(coarse_size=10))
    M_ref = jax_amg.AMGPreconditioner(A_ref, jax_amg.AMGParams(coarse_size=10))
    cases.check_hierarchy(M, M_ref)
    assert [lev.A.shape[0] for lev in M.levels] == [512, 27, 1]
    assert M.levels[0].struct.fine == (8, 8, 8)
