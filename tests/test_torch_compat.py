"""The reference's names of ``compat.py`` and the small constructors of the
PyTorch port against the JAX reference's on the CPU (Pallas off): the
backend, index-type, accessor, renumber, split-storage, block-array and
constructor aliases, ``laplace_matrix`` in both forms; the smoothers'
``gauss_seidel``, ``identity_solver`` and ``greedy_coloring``, the gallery's
``near_nullspace_linear_elasticity``, and ``ops/df64.py``'s raw
error-free transformations and ``dot_spmd``.  Host arrays are held equal
bit for bit (the same host work); device results to rtol 1e-13."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from partitionedarrays_tpu import config as jax_config
from partitionedarrays_tpu.backends import SerialBackend as JaxSerialBackend
from partitionedarrays_tpu.parallel import p_range as jp

from partitionedarrays_tpu_torch import compat
from partitionedarrays_tpu_torch.backends import SerialBackend
from partitionedarrays_tpu_torch.block_arrays import BMatrix, BVector
from partitionedarrays_tpu_torch.models import gallery
from partitionedarrays_tpu_torch.ops import df64 as tdf
from partitionedarrays_tpu_torch.parallel.partition import LocalIndices, PRange, uniform_partition
from partitionedarrays_tpu_torch.psparse import psparse, spmv, to_global_scipy
from partitionedarrays_tpu_torch.pvector import collect, pvector_from_own
from partitionedarrays_tpu_torch.solvers import smoothers
from partitionedarrays_tpu_torch.solvers.gs_dia import ColoredDIAGS

jcompat = importlib.import_module("partitionedarrays_tpu.compat")
jsmoothers = importlib.import_module("partitionedarrays_tpu.solvers.smoothers")
jgallery = importlib.import_module("partitionedarrays_tpu.models.gallery")
jdf = importlib.import_module("partitionedarrays_tpu.ops.df64")
jpsparse = importlib.import_module("partitionedarrays_tpu.psparse")
jpvector = importlib.import_module("partitionedarrays_tpu.pvector")

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def reference_without_pallas():
    saved = jax_config.use_pallas
    jax_config.use_pallas = False
    yield
    jax_config.use_pallas = saved


def _li_arrays(li):
    return (li.n_global, li.part, li.n_parts, li.own_to_global.tolist(),
            li.ghost_to_global.tolist(), li.ghost_to_owner.tolist(),
            None if li.perm is None else np.asarray(li.perm).tolist())


def test_backend_names():
    """DebugArray and with_debug are the serial backend; the MPI names are
    the mesh backend over the process group, as the reference's are its
    mesh backend (one process here: every part local)."""
    from partitionedarrays_tpu_torch.backends import MeshBackend

    assert compat.DebugArray is SerialBackend
    assert compat.with_debug(lambda b: b.n_parts, 3) == 3 == jcompat.with_serial(
        lambda b: b.n_parts, 3)
    assert compat.MPIArray is MeshBackend and jcompat.MPIArray.__name__ == "MeshBackend"
    for b in (compat.MPIArray(2), compat.with_mpi(lambda b: b, 2), compat.distribute_with_mpi(2)):
        assert isinstance(b, MeshBackend) and b.n_parts == 2 and b.local_parts() == [0, 1]
        assert not b.is_multiprocess
    assert compat.distribute_with_mpi().n_parts == 1


def test_index_types_match_jax():
    g2o = lambda q: np.asarray(q) // 5  # noqa: E731
    built = []
    for m, LI in ((compat, LocalIndices), (jcompat, jp.LocalIndices)):
        own = m.OwnIndices(20, 1, [5, 6, 7, 8, 9])
        ghost = m.GhostIndices(20, [4, 10], [0, 2])
        li = m.OwnAndGhostIndices(own, ghost, global_to_owner=g2o, n_parts=4)
        pli = m.PermutedLocalIndices(li, [6, 0, 1, 2, 3, 4, 5])
        assert m.AbstractLocalIndices is LI and isinstance(li, LI)
        built.append((_li_arrays(li), _li_arrays(pli), m.global_to_owner(li, [3, 12]).tolist(),
                      _li_arrays(m.OwnAndGhostIndices(own, ghost))))
    assert built[0] == built[1]
    with pytest.raises(ValueError):
        compat.global_to_owner(LocalIndices(4, 0, 1, [0, 1, 2, 3]), [1])


def _fem(port: bool):
    if port:
        I, J, V, rows, cols = gallery.laplacian_fem((6, 6), (2, 2))
        return psparse(I, J, V, rows, cols, SerialBackend(4), device="cpu")
    I, J, V, rows, cols = jgallery.laplacian_fem((6, 6), (2, 2))
    return jpsparse.psparse(I, J, V, jp.PRange(rows), jp.PRange(cols), JaxSerialBackend(4))


def _vec(port: bool, A):
    vals = [li.own_to_global * 0.25 - 1.0 for li in A.col_prange.partition()]
    if port:
        return pvector_from_own(vals, A.col_prange, A.backend, dtype=np.float64, device="cpu")
    return jpvector.pvector_from_own(vals, A.col_prange, A.backend, dtype=np.float64)


def test_accessors_match_jax():
    A, B = _fem(True), _fem(False)
    x, y = _vec(True, A), _vec(False, B)
    for name in ("own_own_values", "own_ghost_values", "ghost_own_values",
                 "ghost_ghost_values"):
        for a, b in zip(getattr(compat, name)(A), getattr(jcompat, name)(B)):
            assert (a is None) == (b is None)
            if a is not None:
                assert (sp.csr_matrix(a) != sp.csr_matrix(b)).nnz == 0
    for a, b in zip(compat.local_values(x), jcompat.local_values(y)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(compat.own_values(x).numpy(), np.asarray(jcompat.own_values(y)))
    np.testing.assert_array_equal(compat.ghost_values(x).numpy(),
                                  np.asarray(jcompat.ghost_values(y)))


def test_renumber_and_split_names_match_jax():
    A, B = _fem(True), _fem(False)
    x, y = _vec(True, A), _vec(False, B)
    RA, RB = compat.renumber(A), jcompat.renumber(B)
    assert (to_global_scipy(RA) != jpsparse.to_global_scipy(RB)).nnz == 0
    np.testing.assert_array_equal(collect(compat.renumber(x)),
                                  jpvector.collect(jcompat.renumber(y)))
    pr = PRange(uniform_partition((2, 2), (6, 6), ghost=(1, 1)))
    jpr = jp.PRange(jp.uniform_partition((2, 2), (6, 6), ghost=(1, 1)))
    for a, b in zip(compat.renumber(pr).parts, jcompat.renumber(jpr).partition()):
        assert _li_arrays(a) == _li_arrays(b)
    for a, b in zip(compat.renumber(pr.parts), jcompat.renumber(jpr.partition())):
        assert _li_arrays(a) == _li_arrays(b)
    assert compat.psparse_from_split_blocks is not None
    np.testing.assert_array_equal(collect(compat.SplitVector(x)), collect(x))
    np.testing.assert_array_equal(collect(compat.OwnAndGhostVectors(x)), collect(x))
    S = compat.SplitMatrix(A)
    want = jpvector.collect(jpsparse.spmv(B, y))
    np.testing.assert_allclose(collect(spmv(S, x)), want, rtol=1e-13,
                               atol=1e-13 * np.abs(want).max())
    g, jg = compat.assembly_graph(A.col_prange), jcompat.assembly_graph(B.col_prange)
    assert (g.neighbors_snd, g.neighbors_rcv) == (jg.neighbors_snd, jg.neighbors_rcv)
    g2 = compat.assembly_graph(A.col_prange.parts)
    assert g2.neighbors_snd == jg.neighbors_snd


def test_old_constructors_and_barray():
    I, J, V, rows, cols = gallery.laplacian_fdm((5, 4), (2, 1))
    A = compat.old_psparse(I, J, V, rows, cols, SerialBackend(2), assembled=True, device="cpu")
    b = compat.old_pvector([li.own_to_global for li in rows], [np.ones(li.n_own) for li in rows],
                           rows, SerialBackend(2), device="cpu")
    assert A.shape == (20, 20) and collect(b).tolist() == [1.0] * 20
    assert isinstance(compat.BArray([b, b]), BVector)
    M = compat.BArray([[A, None], [None, A]])
    assert isinstance(M, BMatrix) and M.shape == (40, 40)


@pytest.mark.parametrize("parts", [None, (2, 2, 1)])
def test_laplace_matrix_matches_jax(parts):
    if parts is None:
        got, want = compat.laplace_matrix((4, 3, 5)), jcompat.laplace_matrix((4, 3, 5))
    else:
        got = to_global_scipy(compat.laplace_matrix((4, 3, 5), parts, SerialBackend(4),
                                                    device="cpu"))
        want = jpsparse.to_global_scipy(jcompat.laplace_matrix((4, 3, 5), parts,
                                                               JaxSerialBackend(4)))
    assert got.shape == want.shape and abs(got - want).max() == 0
    assert got.diagonal().max() == 6.0  # 2 D, unscaled
    with pytest.raises(ValueError, match="backend"):
        compat.laplace_matrix((4, 4), (2, 2))


def test_gauss_seidel_identity_and_coloring_match_jax():
    """``gauss_seidel`` is the GaussSeidel smoother (its sweep against the
    reference's), ``identity_solver`` returns r, ``greedy_coloring`` equals
    the reference's colors bit for bit."""
    A, B = _fem(True), _fem(False)
    for blk, jblk in zip(A.own_own_values(), B.own_own_values()):
        np.testing.assert_array_equal(smoothers.greedy_coloring(sp.csr_matrix(blk)),
                                      jsmoothers.greedy_coloring(sp.csr_matrix(jblk)))
    gs = smoothers.gauss_seidel(A, iterations=2, sweep="forward")
    jgs = jsmoothers.gauss_seidel(B, iterations=2, sweep="forward")
    assert isinstance(gs, smoothers.GaussSeidel) and (gs.iterations, gs.sweep) == (2, "forward")
    r, jr = _vec(True, A), _vec(False, B)
    got = gs(spmv(A, r))
    want = jgs(jpsparse.spmv(B, jr))
    np.testing.assert_allclose(collect(got), jpvector.collect(want), rtol=1e-13,
                               atol=1e-13 * np.abs(jpvector.collect(want)).max())
    assert smoothers.identity_solver()(r) is r
    assert isinstance(gs.colored, ColoredDIAGS) or gs.colored is None


def test_near_nullspace_matches_jax():
    coords, _ = gallery.node_coordinates_unit_cube((3, 4, 3), (1, 2, 1))
    jcoords, _ = jgallery.node_coordinates_unit_cube((3, 4, 3), (1, 2, 1))
    got = gallery.near_nullspace_linear_elasticity(coords)
    want = jgallery.near_nullspace_linear_elasticity(jcoords, None)
    assert gallery.near_nullspace_linear_elasticity is gallery.nullspace_linear_elasticity
    for a, b in zip(got, want):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)


def test_df64_raw_helpers_match_jax():
    """The raw error-free transformations, bit for bit on float32 words."""
    rng = np.random.default_rng(64)
    a = (rng.standard_normal(4096) * 10.0 ** rng.integers(-6, 6, 4096)).astype(np.float32)
    b = (rng.standard_normal(4096) * 10.0 ** rng.integers(-6, 6, 4096)).astype(np.float32)
    for name in ("two_sum_raw", "quick_two_sum_raw", "two_prod_raw"):
        x, y = (np.maximum(np.abs(a), np.abs(b)) * np.sign(a), b) if name.startswith(
            "quick") else (a, b)
        got = getattr(tdf, name)(torch.from_numpy(x), torch.from_numpy(y))
        want = jax.jit(getattr(jdf, name))(jnp.asarray(x), jnp.asarray(y))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_dot_spmd_matches_jax():
    """The df64 dot of part-stacked pairs: the reference's per-part dots
    folded over its SPMD axis (vmapped here), the port's over dim 0."""
    rng = np.random.default_rng(65)
    v = rng.standard_normal((4, 300))
    w = rng.standard_normal((4, 300))
    pv, pw = tdf.from_f64(torch.from_numpy(v)), tdf.from_f64(torch.from_numpy(w))
    jv, jw = jdf.from_f64(v), jdf.from_f64(w)
    got = tdf.dot_spmd(pv, pw, "parts")
    want = jax.vmap(lambda a, b, c, d: jdf.dot_spmd((a, b), (c, d), "parts"),
                    axis_name="parts")(jnp.asarray(jv[0]), jnp.asarray(jv[1]),
                                       jnp.asarray(jw[0]), jnp.asarray(jw[1]))
    for g, wv in zip(got, want):
        assert np.all(np.asarray(wv) == np.asarray(wv)[0])  # every part holds the fold
        assert g.item() == float(np.asarray(wv)[0])
    exact = float(np.sum(v * w))
    assert abs(float(tdf.to_f64(*got)) - exact) < 1e-12 * np.abs(v * w).sum()
