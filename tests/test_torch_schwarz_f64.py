"""Additive Schwarz and the native setup library of the PyTorch port against
the JAX reference's, float64 (cases in ``tests/torch_schwarz_cases.py``).

- ``ops/native.py``: ``ilu0`` on 2-D and 3-D FDM and FEM Laplacians, a
  block lacking structural diagonal entries and a block with zero pivots,
  bit-equal to the reference's (the same C++ source and flags) and to the
  Python version in both packages; ``vanek_aggregate_native`` and
  ``greedy_coloring_native`` equal to their Python versions and to the
  reference's; ``coo_to_csr_native`` equal to the reference's and to
  scipy's to 1e-15 of the largest entry (the duplicates sum in another
  order).
- The level schedules, W, B and one-direction packs of the ILU(0) factors
  equal the reference's (packs bit for bit); the plain K6 in one-direction
  mode on them is the exact triangular solve: scipy's
  ``spsolve_triangular`` to 1e-10 of the largest entry, on parts with
  W >= 3.
- ``AdditiveSchwarz`` in each mode (dense, ilu0, auto, custom), ``apply``
  with ``iterations=2`` and ``refresh_values``, against the reference to
  1e-12 of the largest entry, and the refreshed operands against a fresh
  build bit for bit; the raises of a user solver without
  ``refresh_values`` and of a tier change.
- CG with each tier: the reference's iteration count exactly.
- SA-AMG with Schwarz level smoothers: the hierarchy (host operators bit for
  bit, the tiers), a V-cycle to 1e-12, the CG counts exactly and the
  residual histories to rtol 1e-8 while above 1e-8 of the first, then
  ``update`` with 3 V against the reference's update and a fresh setup
  (1e-12).
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.sparse.linalg import spsolve_triangular
from threadpoolctl import threadpool_limits

import torch_schwarz_cases as cases
from partitionedarrays_tpu import config as jax_config
from partitionedarrays_tpu.ops import native as jax_native
from partitionedarrays_tpu.solvers import amg as jax_amg
from partitionedarrays_tpu.solvers import smoothers as jax_smoothers

from partitionedarrays_tpu_torch.models import gallery
from partitionedarrays_tpu_torch.ops import native
from partitionedarrays_tpu_torch.solvers import amg
from partitionedarrays_tpu_torch.solvers.amg import AMGParams, AMGPreconditioner
from partitionedarrays_tpu_torch.solvers.smoothers import AdditiveSchwarz

torch.set_num_threads(1)

DTYPE = np.float64
RTOL = cases.RTOL[DTYPE]


# numpy's BLAS on one thread in this module: its idle threads spin, and
# beside the suite's other workers its small dense factorizations (tile
# inverses, LU) then run up to ~30x slower
@pytest.fixture(scope="module", autouse=True)
def reference_mode():
    saved = jax_config.use_pallas
    jax_config.use_pallas = False
    with cases.reference_mode(DTYPE), threadpool_limits(limits=1):
        yield
    jax_config.use_pallas = saved


def _one_part(name, nodes):
    I, J, V, rows, cols = getattr(gallery, name)(nodes, (1,) * len(nodes))
    n = int(np.prod(nodes))
    return sp.coo_matrix((V[0], (I[0], J[0])), shape=(n, n)).tocsr()


def _no_diagonal():
    """The 2-D FDM Laplacian without the diagonal entries of every third
    row (ilu0 inserts them as explicit zeros)."""
    A = _one_part("laplacian_fdm", (12, 12)).tocoo()
    keep = ~((A.row == A.col) & (A.row % 3 == 0))
    return sp.csr_matrix((A.data[keep], (A.row[keep], A.col[keep])), shape=A.shape)


def _zero_pivots():
    """Blocks [[1, 1], [1, 1]] coupled to a chain: the second pivot of
    each block is exactly zero (ilu0 perturbs it)."""
    n = 64
    rows, cols, vals = [], [], []
    for k in range(0, n, 2):
        for i in (k, k + 1):
            for j in (k, k + 1):
                rows.append(i)
                cols.append(j)
                vals.append(1.0)
        if k + 2 < n:
            rows += [k + 1, k + 2]
            cols += [k + 2, k + 1]
            vals += [-0.5, -0.5]
    return sp.csr_matrix((vals, (rows, cols)), shape=(n, n))


ILU_CASES = {
    "fdm2d": lambda: _one_part("laplacian_fdm", (12, 12)),
    "fdm3d": lambda: _one_part("laplacian_fdm", (6, 6, 6)),
    "fem2d": lambda: _one_part("laplacian_fem", (12, 12)),
    "fem3d": lambda: _one_part("laplacian_fem", (6, 6, 6)),
    "no_diagonal": _no_diagonal,
    "zero_pivots": _zero_pivots,
}


def _same_csr(a, b):
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.data, b.data)


@pytest.mark.parametrize("name", list(ILU_CASES))
def test_ilu0_bit_equal_to_jax_and_python(name):
    A = ILU_CASES[name]()
    L, U = native.ilu0(A)
    A_ref = A
    if name == "no_diagonal":
        # the reference's insertion adds a matrix of explicit zeros, which
        # scipy's sum drops: it raises here, and factors the same block
        # once its diagonal zeros are explicit
        with pytest.raises(ValueError, match="missing diagonal"):
            jax_native.ilu0(A)
        A_ref = native._with_diagonal(A)
        assert A_ref.nnz == A.nnz + 48
    L_ref, U_ref = jax_native.ilu0(A_ref)
    _same_csr(L, L_ref)
    _same_csr(U, U_ref)
    # the Python versions of both packages on the same canonical matrix
    Ad = native._with_diagonal(A)
    for python_ilu0 in (native._ilu0_python, jax_native._ilu0_python):
        data = Ad.data.astype(np.float64)
        python_ilu0(Ad.indptr.astype(np.int64), Ad.indices.astype(np.int64), data, A.shape[0])
        L2, U2 = native._factors(Ad.indptr, Ad.indices, data, A.shape[0], A.shape)
        _same_csr(L, L2)
        _same_csr(U, U2)
    # L unit lower on A's lower pattern, U upper on its upper pattern
    assert (sp.triu(L, 1).nnz, sp.tril(U, -1).nnz) == (0, 0)
    np.testing.assert_array_equal(L.diagonal(), 1.0)
    assert np.abs(U.diagonal()).min() > 0
    if name == "zero_pivots":
        assert np.abs(U.diagonal()).min() < 1e-11


@pytest.mark.parametrize("name, block_size, epsilon", [
    ("laplacian_fdm", 1, 0.0), ("laplacian_fem", 1, 0.08), ("elasticity", 3, 0.0),
    ("elasticity", 3, 0.02),
])
def test_native_aggregate_and_coloring(name, block_size, epsilon):
    if name == "elasticity":
        I, J, V, _, _ = gallery.linear_elasticity_fem((5, 5, 5), (1, 1, 1))
        n = 3 * 125
        A = sp.coo_matrix((V[0], (I[0], J[0])), shape=(n, n)).tocsr()
    else:
        A = _one_part(name, (7, 7, 7))
    G = amg.strength_graph(A, block_size)
    agg = amg.aggregate(G, epsilon)
    np.testing.assert_array_equal(agg, amg.aggregate_plain(G, epsilon))
    np.testing.assert_array_equal(agg, jax_amg.aggregate(G, epsilon))
    colors = native.greedy_coloring_native(A)
    np.testing.assert_array_equal(colors, native._greedy_coloring_python(A))
    np.testing.assert_array_equal(colors, jax_smoothers.greedy_coloring(A))


def test_coo_to_csr_native():
    I, J, V, _, _ = gallery.laplacian_fem((9, 9, 9), (1, 1, 1))
    n = 729
    I, J, V = I[0].copy(), J[0].copy(), V[0]
    I[::17] = -1  # dropped
    C = native.coo_to_csr_native(I, J, V, n, n)
    _same_csr(C, jax_native.coo_to_csr_native(I, J, V, n, n))
    keep = I >= 0
    S = sp.csr_matrix((V[keep], (I[keep], J[keep])), shape=(n, n))
    S.sort_indices()
    np.testing.assert_array_equal(C.indptr, S.indptr)
    np.testing.assert_array_equal(C.indices, S.indices)
    np.testing.assert_allclose(C.data, S.data, rtol=0, atol=1e-15 * np.abs(S.data).max())


@pytest.mark.parametrize("case", [cases.FEM_TRI, ("laplacian_fdm", (12, 12, 12), (1, 1, 1)),
                                  ("laplacian_fdm", (16, 16, 16), (2, 2, 1))])
def test_topo_schedules_and_packs_match_jax(case):
    A, A_ref = cases.pair(case, DTYPE)
    S, S_ref = cases.schwarz_pair(A, A_ref, mode="ilu0")
    for tg, tg_ref, d in ((S.sgsL, S_ref.sgsL, "f"), (S.sgsU, S_ref.sgsU, "b")):
        assert tg.topo and tg.directions == (d,) == tg_ref.directions
        assert tg.schedules == tg_ref.schedules
        assert (tg.W, tg.B, tg.n_real_tiles) == (tg_ref.W, tg_ref.B, tg_ref.n_real_tiles)
        assert tuple(tg.pack.shape) == (len(A.blocks), 1, tg.n_real_tiles, 128, 128)
        dpack = np.asarray(tg_ref.arrs[6])  # [P, W, B * 128, 128]: one direction
        pack = tg.pack.numpy()
        for k, waves in enumerate(tg.schedules):
            for w, wave in enumerate(waves):
                for j, t in enumerate(wave):
                    np.testing.assert_array_equal(pack[k, 0, t],
                                                  dpack[k, w, j * 128:(j + 1) * 128])
        with pytest.raises(ValueError, match="not packed"):
            tg.sweeps(None, torch.zeros(len(A.blocks), tg.Rp, dtype=torch.float64),
                      ("b" if d == "f" else "f",))
    if case == cases.FEM_TRI:
        assert min(S.sgsL.W, S.sgsU.W) >= 3


def test_k6_triangular_solves_match_scipy():
    """The reference's guard: on parts with W >= 3, the forward solve with
    L and the backward solve with U (plain K6, one direction each) are
    scipy's ``spsolve_triangular``."""
    A, _ = cases.pair(cases.FEM_TRI, DTYPE)
    S = AdditiveSchwarz(A, mode="ilu0")
    assert S.sgsL.W >= 3 and S.sgsU.W >= 3
    rng = np.random.default_rng(0)
    r = [rng.standard_normal(li.n_own) for li in A.row_prange.parts]
    bo = torch.zeros(len(r), A.row_layout().n_own_pad, dtype=torch.float64)
    for p, v in enumerate(r):
        bo[p, : v.size] = torch.from_numpy(v)
    y = S.sgsL.sweeps(None, bo, ("f",))
    z = S.sgsU.sweeps(None, y, ("b",))
    for p, (blk, li) in enumerate(zip(A.blocks, A.row_prange.parts)):
        L, U = native.ilu0(blk["oo"])
        ye = spsolve_triangular(L.tocsr(), r[p], lower=True)
        xe = spsolve_triangular(U.tocsr(), ye, lower=False)
        k = li.n_own
        assert np.abs(y[p, :k].numpy() - ye).max() < 1e-10 * max(np.abs(ye).max(), 1.0)
        assert np.abs(z[p, :k].numpy() - xe).max() < 1e-10 * max(np.abs(xe).max(), 1.0)


@pytest.mark.parametrize("mode", ["dense", "ilu0", "auto", "custom"])
def test_schwarz_modes_match_jax(mode):
    A, A_ref = cases.pair(cases.FEM_TRI, DTYPE)
    kw = dict(iterations=2)
    if mode == "custom":
        from partitionedarrays_tpu.solvers.smoothers import JacobiCorrection as JaxJacobi

        from partitionedarrays_tpu_torch.solvers.smoothers import JacobiCorrection

        S = AdditiveSchwarz(A, local_solver=JacobiCorrection(A), **kw)
        S_ref = jax_smoothers.AdditiveSchwarz(A_ref, local_solver=JaxJacobi(A_ref), **kw)
    else:
        S, S_ref = cases.schwarz_pair(A, A_ref, mode=mode, **kw)
    assert S.mode == S_ref.mode == {"auto": "dense"}.get(mode, mode)
    r, r_ref = cases.vectors(A, A_ref, DTYPE, 11)
    x, x_ref = cases.vectors(A, A_ref, DTYPE, 12)
    cases.assert_close(cases.own(S(r), A), cases.own(S_ref(r_ref), A), RTOL)
    cases.assert_close(cases.own(S.apply(x, r), A), cases.own(S_ref.apply(x_ref, r_ref), A),
                       RTOL)
    # new values at the same sparsity: the reference's refresh, and a fresh build
    A3, A3_ref = cases.scaled(cases.FEM_TRI, DTYPE, 3.0)
    if mode == "custom":
        with pytest.raises(ValueError, match="own refresh_values"):
            S.refresh_values(A3)
        return
    S.refresh_values(A3)
    S_ref.refresh_values(A3_ref)
    cases.assert_close(cases.own(S.apply(x, r), A), cases.own(S_ref.apply(x_ref, r_ref), A),
                       RTOL)
    fresh = AdditiveSchwarz(A3, mode=mode, iterations=2)
    for got, want in zip(cases.smoother_operands(S), cases.smoother_operands(fresh)):
        assert torch.equal(got, want)
    # a matrix that selects the other tier
    S_auto = AdditiveSchwarz(A, mode="auto")
    S_auto._DENSE_MAX = 100
    with pytest.raises(ValueError, match="different Schwarz tier"):
        S_auto.refresh_values(A3)


@pytest.mark.parametrize("mode", ["dense", "ilu0"])
def test_cg_with_schwarz_matches_jax_iterations(mode):
    A, A_ref = cases.pair(cases.FDM_CG, DTYPE, assembled=True)
    b, b_ref = cases.rhs(A, A_ref, DTYPE)
    S, S_ref = cases.schwarz_pair(A, A_ref, mode=mode)
    (x, its), (x_ref, its_ref) = cases.cg_iterations(A, A_ref, S, S_ref, b, b_ref, 1e-10)
    assert its == its_ref > 0
    cases.assert_close(cases.own(x, A), cases.own(x_ref, A), 1e-9)


@pytest.mark.parametrize("name", list(cases.AMG_CASES))
def test_amg_schwarz_matches_jax(name):
    A, A_ref, M, M_ref = cases.amg_pair(name, DTYPE)
    cases.check_hierarchy(M, M_ref)
    tiers = cases.level_tiers(M)
    # the ilu0 tier above 1,024 rows a part, dense below (both in fdm2d_ilu0)
    assert tiers == ["ilu0" if name == "fdm2d_ilu0" else "dense"] + ["dense"] * (len(tiers) - 1)
    r, r_ref = cases.vectors(A, A_ref, DTYPE, 21)
    cases.assert_close(cases.own(M(r), A), cases.own(M_ref(r_ref), A), RTOL)
    b, b_ref = cases.rhs(A, A_ref, DTYPE)
    (its, h), (its_ref, h_ref) = cases.pcg_iterations(A, A_ref, M, M_ref, b, b_ref, 1e-10)
    assert its == its_ref > 0
    live = h_ref > 1e-8 * h_ref[0]  # above the rounding floor
    np.testing.assert_allclose(h[live], h_ref[live], rtol=1e-8, atol=0)
    # update with 3 V: the reference's update, and a fresh setup
    A3, A3_ref = cases.scaled(cases.AMG_CASES[name][0], DTYPE, 3.0)
    M.update(A3)
    M_ref.update(A3_ref)
    got = cases.own(M(r), A)
    cases.assert_close(got, cases.own(M_ref(r_ref), A), RTOL)
    fresh = AMGPreconditioner(A3, AMGParams(smoother="schwarz", **cases.AMG_CASES[name][1]))
    cases.assert_close(got, cases.own(fresh(r), A), RTOL)
    for lev, lev_f in zip(M.levels[:-1], fresh.levels[:-1]):
        for t, t_f in zip(cases.smoother_operands(lev.smoother),
                          cases.smoother_operands(lev_f.smoother)):
            torch.testing.assert_close(t, t_f, rtol=RTOL, atol=0)
