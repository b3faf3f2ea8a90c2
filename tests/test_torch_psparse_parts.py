"""The partitioned sparse matrix of the PyTorch port across parts, against
the JAX reference: COO assembly in its three input states and from local
ids, the state changes, the SpMVs and the distributed products, on (2,2)
and (2,2,2) parts of the gallery's operators (8-12 nodes per direction).

Triplets come from both galleries (bit-equal, ``test_torch_gallery.py``);
vectors are made with numpy from a seed.  The reference runs as JAX on the
CPU with Pallas off; the port on the CPU, where K1 and K5 run their plain
versions.

- Host setup (the ghost ids and owners of every part's rows and columns,
  the host blocks, the state changes and the products) is the same
  numpy/scipy work in the same order in both packages, so it is held equal
  bit for bit, in float64 and in float32.  The one exception is the
  reference's plain ``spmtm``: it moves its local products unsorted, so
  where three or more parts add to one entry its sum may round otherwise
  by an ulp; the port follows the order of the reference's Galerkin
  product (its reuse form), which it equals bit for bit, and is held to
  the plain form within 4 ulps of the largest entry.
- The SpMVs are device work (the order of the sums differs), held to 1e-12
  (float64) and 1e-6 (float32) of the largest reference entry.
- The global matrices and products also agree with scipy on the
  centralized operands.
"""
import importlib

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from threadpoolctl import threadpool_limits

from partitionedarrays_tpu import config as jax_config
from partitionedarrays_tpu.backends import SerialBackend as JaxSerialBackend
from partitionedarrays_tpu.models import gallery as jax_gallery
from partitionedarrays_tpu.parallel.p_range import PRange as JaxPRange
from partitionedarrays_tpu.parallel.p_range import variable_partition as jax_variable_partition
from partitionedarrays_tpu.solvers import interfaces as jax_if

from partitionedarrays_tpu_torch import psparse as ps
from partitionedarrays_tpu_torch.backends import SerialBackend
from partitionedarrays_tpu_torch.models import gallery
from partitionedarrays_tpu_torch.parallel.partition import PRange, variable_partition
from partitionedarrays_tpu_torch.pvector import collect, pvector_from_own
from partitionedarrays_tpu_torch.solvers import interfaces as port_if

jax_psparse = importlib.import_module("partitionedarrays_tpu.psparse")
jax_pvector = importlib.import_module("partitionedarrays_tpu.pvector")

torch.set_num_threads(1)

# (generator, nodes per direction, parts per direction)
CASES = {
    "fdm3d": ("laplacian_fdm", (8, 9, 10), (2, 2, 2)),
    "fem2d": ("laplacian_fem", (10, 12), (2, 2)),
    "elasticity2d": ("linear_elasticity_fem", (9, 8), (2, 2)),
    "elasticity3d": ("linear_elasticity_fem", (8, 8, 8), (2, 2, 2)),
}
STATES = ("disassembled", "assembled", "subassembled", "local")
DTYPES = (np.float64, np.float32)
# SpMV agreement relative to the largest reference entry
ATOL = {np.float64: 1e-12, np.float32: 1e-6}


@pytest.fixture(scope="module", autouse=True)
def reference_without_pallas():
    saved = jax_config.use_pallas
    jax_config.use_pallas = False
    with threadpool_limits(limits=1):
        yield
    jax_config.use_pallas = saved


def same_csr(a, b):
    a, b = a.tocsr(), b.tocsr()
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.data, b.data)


def same_parts(port_pr, ref_pr):
    """Every part's own ids, ghost ids and ghost owners, in order."""
    assert port_pr.n_parts == ref_pr.n_parts
    for li, li_ref in zip(port_pr.parts, ref_pr.partition()):
        np.testing.assert_array_equal(li.own_to_global, li_ref.own_to_global)
        np.testing.assert_array_equal(li.ghost_to_global, li_ref.ghost_to_global)
        np.testing.assert_array_equal(li.ghost_to_owner, li_ref.ghost_to_owner)


def same_matrix(A, A_ref):
    """Partitions, state and every host block bit for bit."""
    assert A.assembled == A_ref.assembled and A.shape == A_ref.shape
    same_parts(A.row_prange, A_ref.row_prange)
    same_parts(A.col_prange, A_ref.col_prange)
    for b, b_ref in zip(ps.host_blocks(A), A_ref.blocks):
        assert sorted(b) == sorted(k for k, v in b_ref.items() if v is not None)
        for k in b:
            same_csr(b[k], b_ref[k])


def close(got, want, dtype):
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL[dtype] * np.abs(want).max())


def _local_ids(gids, li):
    own, ghost = li.global_to_own(gids), li.global_to_ghost(gids)
    return np.where(own >= 0, own, np.where(ghost >= 0, ghost + li.n_own, -1))


def build(case, dtype, state="disassembled"):
    """(A, A_ref, G): the port's and the reference's matrix in ``state``
    from the same triplets, and the global scipy matrix the triplets sum
    to."""
    gen, nodes, parts = CASES[case]
    P = int(np.prod(parts))
    I, J, V, rows, cols = getattr(gallery, gen)(nodes, parts, dtype=dtype)
    I_r, J_r, V_r, rows_r, cols_r = getattr(jax_gallery, gen)(nodes, parts, dtype=dtype)
    n = rows[0].n_global
    G = sp.coo_matrix((np.concatenate(V), (np.concatenate(I), np.concatenate(J))),
                      shape=(n, n)).tocsr()
    kw = {}
    if state == "assembled":
        # every part's own rows of the assembled matrix, as triplets
        A0 = ps.psparse(I, J, V, rows, cols, SerialBackend(P), device="cpu")
        tri = [ps._part_triplets(b, li_r, li_c)
               for b, li_r, li_c in zip(A0.blocks, A0.row_prange.parts, A0.col_prange.parts)]
        I = I_r = [t[0] for t in tri]
        J = J_r = [t[1] for t in tri]
        V = V_r = [t[2] for t in tri]
        kw = dict(assembled=True)
    elif state == "subassembled":
        kw = dict(assemble=False)
    elif state == "local":
        # local ids on the subassembled partitions, which hold every ghost
        S = ps.psparse(I, J, V, rows, cols, SerialBackend(P), device="cpu", assemble=False)
        rows, cols = S.row_prange, S.col_prange
        S_ref = jax_psparse.psparse(I_r, J_r, V_r, JaxPRange(rows_r), JaxPRange(cols_r),
                                    JaxSerialBackend(P), assemble=False)
        rows_r, cols_r = S_ref.row_prange.partition(), S_ref.col_prange.partition()
        I = I_r = [_local_ids(i, li) for i, li in zip(I, rows.parts)]
        J = J_r = [_local_ids(j, li) for j, li in zip(J, cols.parts)]
        kw = dict(indices="local")
    A = ps.psparse(I, J, V, rows, cols, SerialBackend(P), device="cpu", **kw)
    A_ref = jax_psparse.psparse(I_r, J_r, V_r, JaxPRange(list(rows_r)), JaxPRange(list(cols_r)),
                                JaxSerialBackend(P), **kw)
    return A, A_ref, G


def vectors(pr, pr_ref, dtype, seed=0):
    own = [np.random.default_rng(seed + p).standard_normal(li.n_own).astype(dtype)
           for p, li in enumerate(pr.parts)]
    x = pvector_from_own(own, pr, SerialBackend(pr.n_parts), device="cpu")
    x_ref = jax_pvector.pvector_from_own(own, pr_ref, JaxSerialBackend(pr.n_parts))
    xg = np.zeros(pr.n_global, dtype=dtype)
    for li, o in zip(pr.parts, own):
        xg[li.own_to_global] = o
    return x, x_ref, xg


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("state", STATES)
@pytest.mark.parametrize("case", list(CASES))
def test_assembly_matches_jax(case, state, dtype):
    """Ghost ids and owners per part, the host blocks bit for bit, and the
    global matrix, in every input state."""
    A, A_ref, G = build(case, dtype, state)
    same_matrix(A, A_ref)
    Gp = ps.to_global_scipy(A)
    same_csr(Gp, jax_psparse.to_global_scipy(A_ref))
    if dtype == np.float64:
        assert abs(Gp - G).max() <= 1e-12 * abs(G).max()
    same_csr(ps.centralize(A), jax_psparse.centralize(A_ref))
    if state in ("disassembled", "subassembled") or CASES[case][0] == "laplacian_fdm":
        assert any(li.n_ghost for li in A.col_prange.parts)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("state", ("disassembled", "subassembled"))
@pytest.mark.parametrize("case", list(CASES))
def test_spmv_and_spmtv_match_jax(case, state, dtype):
    """``spmv`` on assembled and subassembled matrices (the ghost rows
    assembled on the fly), ``spmtv`` with its ghost columns assembled back
    to their owners, and ``assemble_matrix`` of the subassembled one."""
    A, A_ref, G = build(case, dtype, state)
    x, x_ref, xg = vectors(A.col_prange, A_ref.col_prange, dtype)
    y = ps.spmv(A, x)
    close(y.own.numpy(), np.asarray(jax_psparse.spmv(A_ref, x_ref).own), dtype)
    close(collect(y), G @ xg, dtype)
    if state == "subassembled":
        A, A_ref = ps.assemble_matrix(A).wait(), jax_psparse.assemble_matrix(A_ref).wait()
        same_matrix(A, A_ref)
    x, x_ref, xg = vectors(A.row_prange, A_ref.row_prange, dtype, seed=7)
    y = ps.spmtv(A, x, alpha=0.5, beta=2.0, y=x)
    y_ref = jax_psparse.spmtv(A_ref, x_ref, alpha=0.5, beta=2.0, y=x_ref)
    close(y.own.numpy(), np.asarray(y_ref.own), dtype)
    close(collect(y), 0.5 * (G.T @ xg) + 2.0 * xg, dtype)
    ooT, ohT = A.device_transpose()
    assert ohT is not None and ohT.kind == "ell"


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("case", list(CASES))
def test_matrix_consistent_matches_jax(case, dtype):
    """``consistent_matrix`` (the reference's test_matrix_consistent): the
    rows each part ghosts fetched from their owners, as the ``ho``/``hh``
    blocks, equal to the reference's and to the global matrix's rows."""
    A, A_ref, G = build(case, dtype)
    B = ps.consistent_matrix(A, A.col_prange).wait()
    B_ref = jax_psparse.consistent_matrix(A_ref, A_ref.col_prange).wait()
    same_matrix(B, B_ref)
    assert not B.assembled
    for b, li_r, li_c in zip(B.blocks, B.row_prange.parts, B.col_prange.parts):
        cols = np.concatenate([li_c.own_to_global, li_c.ghost_to_global])
        gh = sp.hstack([b["ho"], b["hh"]]).tocsr()
        assert abs(gh - G[li_r.ghost_to_global][:, cols]).max() <= 1e-6 * abs(G).max()
    same_matrix(ps.assemble_matrix(B).wait(), jax_psparse.assemble_matrix(B_ref).wait())


def _aggregate_pairs(A, A_ref, dtype):
    """A rectangular prolongator on both sides: every pair of consecutive
    own rows of a part to one coarse column of that part."""
    counts = [(li.n_own + 1) // 2 for li in A.row_prange.parts]
    coarse = PRange(variable_partition(counts))
    coarse_ref = JaxPRange(jax_variable_partition(counts))
    I = [li.own_to_global for li in A.row_prange.parts]
    J = [lc.own_to_global[np.arange(li.n_own) // 2] for li, lc in zip(A.row_prange.parts, coarse.parts)]
    V = [np.full(li.n_own, 0.5, dtype=dtype) for li in A.row_prange.parts]
    P = len(I)
    fine = PRange([li.remove_ghost() for li in A.row_prange.parts])
    Pm = ps.psparse(I, J, V, fine, coarse, SerialBackend(P), assembled=True, device="cpu")
    Pm_ref = jax_psparse.psparse(I, J, V, JaxPRange([li.remove_ghost() for li in A_ref.row_prange.partition()]),
                                 coarse_ref, JaxSerialBackend(P), assembled=True)
    return Pm, Pm_ref


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("case", list(CASES))
def test_products_match_jax(case, dtype):
    """``spmm``, ``spmtm``, ``rap`` with a rectangular prolongator,
    ``transpose_psparse``, ``identity_minus``, ``dense_diag`` and
    ``sparse_diag_matrix`` across parts (the reference's
    test_spmm_spmtm_rap): equal to the reference's and to scipy's product
    of the centralized operands."""
    A, A_ref, G = build(case, dtype)
    tol = (1e-12 if dtype == np.float64 else 1e-5)
    C = ps.spmm(A, A)
    same_matrix(C, jax_psparse.spmm(A_ref, A_ref))
    assert abs(ps.to_global_scipy(C) - G @ G).max() <= tol * abs(G @ G).max()
    T = ps.spmtm(A, A)
    same_matrix(T, jax_psparse.spmtm(A_ref, A_ref, reuse=True)[0])
    T_plain = jax_psparse.to_global_scipy(jax_psparse.spmtm(A_ref, A_ref))
    eps = np.finfo(dtype).eps
    assert abs(ps.to_global_scipy(T) - T_plain).max() <= 4 * eps * abs(T_plain).max()
    Pm, Pm_ref = _aggregate_pairs(A, A_ref, dtype)
    R, R_ref = ps.transpose_psparse(Pm), jax_psparse.transpose_psparse(Pm_ref)
    same_matrix(R, R_ref)
    Ac = ps.rap(R, A, Pm)
    same_matrix(Ac, jax_psparse.rap(R_ref, A_ref, Pm_ref))
    Gp = ps.to_global_scipy(Pm)
    want = (Gp.T @ G @ Gp).toarray()
    np.testing.assert_allclose(ps.to_global_scipy(Ac).toarray(), want, rtol=0,
                               atol=tol * np.abs(want).max())
    same_matrix(ps.spmtm(Pm, ps.spmm(A, Pm)), jax_psparse.spmtm(
        Pm_ref, jax_psparse.spmm(A_ref, Pm_ref, reuse=True)[0], reuse=True)[0])
    same_matrix(ps.identity_minus(A), jax_psparse.identity_minus(A_ref))
    d = ps.dense_diag(A)
    np.testing.assert_array_equal(d.own.numpy(), np.asarray(jax_psparse.dense_diag(A_ref).own))
    D = ps.sparse_diag_matrix(d)
    D_ref = jax_psparse.sparse_diag_matrix(jax_psparse.dense_diag(A_ref))
    same_matrix(D, D_ref)
    np.testing.assert_allclose(ps.to_global_scipy(D).diagonal(), G.diagonal(), rtol=tol)


@pytest.mark.parametrize("case", ["fem2d", "elasticity3d"])
def test_psparse_from_global_and_lu_solver(case):
    """``psparse_from_global`` splits the centralized matrix back into the
    same blocks; ``lu_solver`` (scipy's LU of ``centralize``) solves across
    parts as the reference's."""
    A, A_ref, G = build(case, np.float64)
    rows = PRange([li.remove_ghost() for li in A.row_prange.parts])
    cols = PRange([li.remove_ghost() for li in A.col_prange.parts])
    B = ps.psparse_from_global(ps.centralize(A), rows, cols, A.backend, device="cpu")
    for b, b_ref in zip(B.blocks, A.blocks):
        for k in ("oo", "oh"):
            same_csr(b[k], b_ref[k])
    b, b_ref, bg = vectors(A.row_prange, A_ref.row_prange, np.float64, seed=3)
    x = port_if.solve(port_if.lu_solver(), port_if.LinearProblem(A, b))
    x_ref = jax_if.solve(jax_if.lu_solver(), jax_if.LinearProblem(A_ref, b_ref))
    np.testing.assert_array_equal(x.own.numpy(), np.asarray(x_ref.own))
    assert np.linalg.norm(G @ collect(x) - bg) <= 1e-10 * np.linalg.norm(bg)


def test_filtered_negative_ids():
    """Entries with a negative row or column id are dropped, on four parts
    of a 1-D range (the reference's test_filtered_negative_ids)."""
    n = 10
    rows = PRange(variable_partition([3, 2, 3, 2]))
    Is = [np.array(v) for v in ([0, 1, 0, 1, 1], [2, 2, 3, 5, -1], [4, 4, 5, 6], [8, 8, 7, 9, 5, -2])]
    Js = [np.array(v) for v in ([1, 5, 0, 1, 0], [2, 8, 3, 1, -1], [6, 5, 5, 6], [8, 2, 7, 9, 4, 0])]
    Vs = [np.arange(len(i), dtype=np.float64) + 1 for i in Is]
    A = ps.psparse(Is, Js, Vs, rows, rows, SerialBackend(4), device="cpu")
    keep = [(i >= 0) & (j >= 0) for i, j in zip(Is, Js)]
    E = sp.coo_matrix((np.concatenate([v[k] for v, k in zip(Vs, keep)]),
                       (np.concatenate([i[k] for i, k in zip(Is, keep)]),
                        np.concatenate([j[k] for j, k in zip(Js, keep)]))), shape=(n, n)).tocsr()
    assert abs(ps.centralize(A) - E).max() == 0


def test_reuse_raises_with_its_item():
    """The reuse forms build their caches; the cross-process refill of
    per-process matrices sets up its exchange (in one process every route
    stays local, and the refill is the serial one)."""
    from partitionedarrays_tpu_torch.pvector import pvector

    I, J, V, rows, cols = gallery.laplacian_fem((6, 6), (2, 2))
    A, cache = ps.psparse(I, J, V, rows, cols, SerialBackend(4), reuse=True, device="cpu")
    assert len(cache) == 3 and A.assembled
    v, vcache = pvector(I, V, rows, SerialBackend(4), reuse=True, device="cpu")
    assert vcache.layout is v.layout
    routes = ps.consistent_matrix(A, A.row_prange, reuse=True).wait()[1]
    n_routes = len(routes.routes)
    assert routes.finalize_multiprocess(SerialBackend(4), 4, np.float64) is routes
    assert routes.multiprocess and len(routes.routes) == n_routes
    assert routes.send_plan == {} and routes.recv_scatter == {}