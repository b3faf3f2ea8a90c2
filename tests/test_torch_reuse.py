"""The fixed-sparsity reuse tier of the port against the JAX package: the
ten cases of ``tests/test_reuse.py`` (the ``_into`` forms of assemble,
consistent, spmm, spmtm and rap, the AMG update, the coarse solve after
it, ``pvector`` and ``psystem`` reuse), plus ``psparse_refill`` bit for bit
against the reference's, ``DeviceRefill`` and the values-only refreeze on
the CPU, and the two reference faults the port does not copy.

Each case builds with ``reuse=True``, refills new values of the same
sparsity through the cache, and holds the result against a fresh build of
the new values and against the reference's refill of the same values, on
the serial backend (the port on the CPU, the reference with Pallas off).
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
from partitionedarrays_tpu.solvers import amg as jax_amg

from partitionedarrays_tpu_torch import psparse as ps
from partitionedarrays_tpu_torch.backends import SerialBackend
from partitionedarrays_tpu_torch.models import gallery
from partitionedarrays_tpu_torch.ops import sparse_host
from partitionedarrays_tpu_torch.ops.blocks import freeze_block
from partitionedarrays_tpu_torch.parallel.partition import PRange, uniform_partition
from partitionedarrays_tpu_torch.pvector import collect, pvector, pvector_refill
from partitionedarrays_tpu_torch.solvers import amg

jax_ps = importlib.import_module("partitionedarrays_tpu.psparse")
jax_pv = importlib.import_module("partitionedarrays_tpu.pvector")

jax_config.use_pallas = False


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield


def _fem(scale=1.0, assemble=True, reuse=False):
    """The (8, 8) Q1 Laplacian on (2, 2) parts in both packages, from the
    same disassembled triplets (scaled)."""
    I, J, V, rows, cols = gallery.laplacian_fem((8, 8), (2, 2))
    V = [scale * v for v in V]
    A = ps.psparse(I, J, V, rows, cols, SerialBackend(4), assemble=assemble, reuse=reuse,
                   device="cpu")
    Ir, Jr, Vr, rr, cr = jax_gallery.laplacian_fem((8, 8), (2, 2))
    Ar = jax_ps.psparse(Ir, Jr, [scale * v for v in Vr], JaxPRange(rr), JaxPRange(cr),
                        JaxSerialBackend(4), assembled=False, assemble=assemble, reuse=reuse)
    return A, Ar


def _scaled(A, f):
    """A port matrix of A's sparsity with ``f`` of every block's values."""
    blocks = [{k: _with_data(v, f) for k, v in b.items()} for b in ps.host_blocks(A)]
    return ps.PSparseMatrix(None, A.row_prange, A.col_prange, A.backend, blocks=blocks,
                            device="cpu", assembled=A.assembled)


def _scaled_ref(A, f):
    blocks = [{k: (None if v is None else _with_data(v, f)) for k, v in b.items()}
              for b in A.blocks]
    return jax_ps.PSparseMatrix(blocks, A.row_prange, A.col_prange, A.backend, A.assembled)


def _with_data(m, f):
    m2 = m.copy()
    m2.data = f(m2.data)
    return m2


def _canon(m):
    m = m.tocsr().copy()
    m.sort_indices()
    return m


def _same_blocks(A, A_ref):
    """Every host block of both matrices bit for bit (canonical CSR)."""
    for b, b_ref in zip(ps.host_blocks(A), A_ref.blocks):
        for k in ("oo", "oh", "ho", "hh"):
            if b.get(k) is None:
                assert b_ref.get(k) is None or b_ref[k].nnz == 0
                continue
            x, y = _canon(b[k]), _canon(b_ref[k])
            assert x.shape == y.shape and x.dtype == y.dtype
            np.testing.assert_array_equal(x.indptr, y.indptr)
            np.testing.assert_array_equal(x.indices, y.indices)
            np.testing.assert_array_equal(x.data, y.data)


def _same_global(A, B, tol=0.0):
    G1, G2 = ps.to_global_scipy(A), ps.to_global_scipy(B)
    d = abs(G1 - G2)
    assert (d.max() if d.nnz else 0.0) <= tol * max(abs(G1).max(), 1.0)


# -- the five products ---------------------------------------------------------

def test_assemble_matrix_reuse():
    (A_sub, A_sub_ref) = _fem(assemble=False)
    out, cache = ps.assemble_matrix(A_sub, reuse=True).wait()
    out_ref, cache_ref = jax_ps.assemble_matrix(A_sub_ref, reuse=True).wait()
    _same_blocks(out, out_ref)
    _same_global(ps.assemble_matrix(A_sub).wait(), out)
    f = lambda d: 3.0 * d + 1.0
    A2, A2_ref = _scaled(A_sub, f), _scaled_ref(A_sub_ref, f)
    ps.assemble_matrix_into(out, A2, cache)
    jax_ps.assemble_matrix_into(out_ref, A2_ref, cache_ref)
    _same_blocks(out, out_ref)
    _same_global(ps.assemble_matrix(A2).wait(), out)


def test_consistent_matrix_reuse():
    A, A_ref = _fem()
    co, co_ref = [], []
    for p, (li, li_ref) in enumerate(zip(A.row_prange.parts, A_ref.row_prange.partition())):
        q = (p + 1) % 4
        gid = A.row_prange.parts[q].own_to_global[:1]
        co.append(li.remove_ghost().union_ghost(gid, np.array([q])))
        co_ref.append(li_ref.remove_ghost().union_ghost(gid, np.array([q])))
    out, cache = ps.consistent_matrix(A, PRange(co), reuse=True).wait()
    out_ref, cache_ref = jax_ps.consistent_matrix(A_ref, JaxPRange(co_ref), reuse=True).wait()
    _same_blocks(out, out_ref)
    _same_global(ps.consistent_matrix(A, PRange(co)).wait(), out)
    f = lambda d: d * -0.5 + 2.0
    A2, A2_ref = _scaled(A, f), _scaled_ref(A_ref, f)
    ps.consistent_matrix_into(out, A2, cache)
    jax_ps.consistent_matrix_into(out_ref, A2_ref, cache_ref)
    _same_blocks(out, out_ref)
    _same_global(ps.consistent_matrix(A2, PRange(co)).wait(), out)


@pytest.mark.parametrize("kind", ["spmm", "spmtm"])
def test_product_reuse(kind):
    """spmm and spmtm: the refilled product equals the reference's refill
    bit for bit, the plain product of the new values (bit for bit for
    spmm; spmtm's owner shuffle sums duplicates, which scipy's build sums
    in its own order, so to an ulp) and scipy's global product to 1e-12."""
    (A, A_ref), (B, B_ref) = _fem(), _fem(scale=0.5 if kind == "spmm" else 2.0)
    op, op_into = getattr(ps, kind), getattr(ps, kind + "_into")
    op_ref, op_into_ref = getattr(jax_ps, kind), getattr(jax_ps, kind + "_into")
    C, cache = op(A, B, reuse=True)
    C_ref, cache_ref = op_ref(A_ref, B_ref, reuse=True)
    _same_blocks(C, C_ref)
    _same_blocks(op(A, B), C_ref)
    fa, fb = (lambda d: 2.0 * d - 0.25), (lambda d: -d)
    A2, B2 = _scaled(A, fa), _scaled(B, fb)
    op_into(C, A2, B2, cache)
    op_into_ref(C_ref, _scaled_ref(A_ref, fa), _scaled_ref(B_ref, fb), cache_ref)
    _same_blocks(C, C_ref)
    if kind == "spmm":
        _same_blocks(op(A2, B2), C_ref)
    else:
        _same_global(op(A2, B2), C, 1e-15)
    GA, GB = ps.to_global_scipy(A2), ps.to_global_scipy(B2)
    G = (GA @ GB) if kind == "spmm" else (GA.T @ GB)
    d = abs(G - ps.to_global_scipy(C))
    assert d.max() < 1e-12 * abs(G).max()


def test_rap_reuse():
    A, A_ref = _fem()
    aggs, coarse = amg.aggregate_psparse(A)
    P = amg.constant_prolongator(A, aggs, coarse)
    R = ps.transpose_psparse(P)
    aggs_ref, coarse_ref = jax_amg.aggregate_psparse(A_ref)
    P_ref = jax_amg.constant_prolongator(A_ref, aggs_ref, coarse_ref)
    R_ref = jax_ps.transpose_psparse(P_ref)
    Ac, cache = ps.rap(R, A, P, reuse=True)
    Ac_ref, cache_ref = jax_ps.rap(R_ref, A_ref, P_ref, reuse=True)
    _same_blocks(Ac, Ac_ref)
    f = lambda d: 5.0 * d
    A2 = _scaled(A, f)
    ps.rap_into(Ac, R, A2, P, cache)
    jax_ps.rap_into(Ac_ref, R_ref, _scaled_ref(A_ref, f), P_ref, cache_ref)
    _same_blocks(Ac, Ac_ref)
    _same_blocks(ps.rap(R, A2, P), Ac_ref)


# -- the COO refill, on the host and on the device -------------------------------

@pytest.mark.parametrize("state", ["disassembled", "assembled_fdm", "subassembled"])
def test_psparse_refill_matches_jax(state):
    """psparse_refill's host blocks equal the reference's bit for bit
    (float64), and a fresh build of the new values to an ulp, in every
    input state."""
    if state == "assembled_fdm":
        gen, kw = "laplacian_fdm", dict(assembled=True)
    else:
        gen, kw = "linear_elasticity_fem", dict(assemble=state == "disassembled")
    args = ((4, 4, 4), (2, 2, 1)) if gen == "linear_elasticity_fem" else ((6, 6, 6), (2, 2, 2))
    I, J, V, rows, cols = getattr(gallery, gen)(*args)
    Ir, Jr, Vr, rr, cr = getattr(jax_gallery, gen)(*args)
    P = len(rows)
    A, cache = ps.psparse(I, J, V, rows, cols, SerialBackend(P), reuse=True, device="cpu", **kw)
    A_ref, cache_ref = jax_ps.psparse(Ir, Jr, Vr, JaxPRange(rr), JaxPRange(cr),
                                      JaxSerialBackend(P), reuse=True,
                                      **(kw if "assembled" in kw else dict(assembled=False, **kw)))
    rng = np.random.default_rng(4)
    V2 = [rng.standard_normal(v.size) for v in V]
    ps.psparse_refill(A, V2, cache)
    jax_ps.psparse_refill(A_ref, V2, cache_ref)
    _same_blocks(A, A_ref)
    # a fresh build sums the duplicates in scipy's order: equal to an ulp
    fresh = ps.psparse(I, J, V2, rows, cols, SerialBackend(P), device="cpu", **kw)
    _same_global(fresh, A, 1e-15)


@pytest.mark.parametrize("case", ["dia", "ell"])
def test_device_refill_equals_refill_and_refreeze(case):
    """DeviceRefill on the CPU: the same values as the host refill and the
    values-only refreeze, bit for bit, on DIA blocks (the 7-point FDM on
    (2,2,2) parts: oo DIA, oh compressed rows) and on compressed rows with
    duplicates summed (disassembled 3-D elasticity on parts of unequal
    size, whose bands differ); the refreeze keeps the
    structure and equals a fresh freeze."""
    if case == "dia":
        I, J, V, rows, cols = gallery.laplacian_fdm((6, 6, 6), (2, 2, 2))
        A, cache = ps.psparse(I, J, V, rows, cols, SerialBackend(8), assembled=True, reuse=True,
                              device="cpu")
    else:
        I, J, V, rows, cols = gallery.linear_elasticity_fem((7, 7, 7), (2, 2, 2))
        A, cache = ps.psparse(I, J, V, rows, cols, SerialBackend(8), reuse=True, device="cpu")
    dev0 = A.device()
    kinds = (dev0.oo.kind, dev0.oh.kind)
    assert kinds == (("dia", "ell") if case == "dia" else ("ell", "ell"))
    plan = ps.device_refill_plan(A, cache)
    if case == "ell":
        assert max(len(r) for r in plan.ranks["oo"]) > 0 and len(plan.ranks["oo"]) > 1
    rng = np.random.default_rng(1)
    V2 = [rng.standard_normal(v.size) for v in V]
    dev = plan(plan.stack_values(V2))
    x = ps.pvector_from_own([rng.standard_normal(li.n_own) for li in A.col_prange.parts],
                            A.col_prange, A.backend, device="cpu")
    y_dev = ps.spmv(A, x, dev=dev).own
    ps.psparse_refill(A, V2, cache)
    got = A.device()
    for name in ("oo", "oh"):
        old, new, d = getattr(dev0, name), getattr(got, name), getattr(dev, name)
        assert torch.equal(new.vals, d.vals)
        assert new.kind == old.kind and new.offsets == old.offsets
        if new.kind == "ell":
            assert new.rows is old.rows and new.cols is old.cols and new.plan is old.plan
        fresh = freeze_block([b[name] for b in A.blocks], new.n_rows, new.n_cols_pad,
                             device="cpu")
        assert torch.equal(fresh.vals, new.vals)
    assert torch.equal(y_dev, ps.spmv(A, x).own)


def test_invalidate_drops_transposes_and_df64():
    I, J, V, rows, cols = gallery.laplacian_fem((6, 6), (2, 2))
    A, cache = ps.psparse(I, J, V, rows, cols, SerialBackend(4), reuse=True, device="cpu")
    ooT, ohT = A.device_transpose()
    df = ps.device_df64(A)
    version = A.values_version
    ps.psparse_refill(A, [2.0 * v for v in V], cache)
    assert A.values_version == version + 1
    ooT2, ohT2 = A.device_transpose()
    assert torch.equal(ooT2.vals, 2.0 * ooT.vals) and torch.equal(ohT2.vals, 2.0 * ohT.vals)
    assert ps.device_df64(A) is not df


# -- the AMG update and the coarse solve -------------------------------------------

def test_amg_update_equals_fresh_setup():
    """update at fixed sparsity equals a fresh _GalerkinCache at the frozen
    omegas to 1e-12 and never aggregates again (the generic path: 2-D FEM
    with epsilon 0.01); the CG on the new operator converges."""
    I, J, V, rows, cols = gallery.laplacian_fem((8, 8), (2, 2))
    A = ps.psparse(I, J, V, rows, cols, SerialBackend(4), device="cpu")
    M = amg.AMGPreconditioner(A, amg.AMGParams(coarse_size=10, epsilon=0.01))
    assert M.levels[0].struct is None
    aggs_before = [a[0] for a in M._aggs]
    A2 = ps.psparse(I, J, [3.0 * v for v in V], rows, cols, SerialBackend(4), device="cpu")
    M.update(A2)
    assert all(a0 is a[0] for a0, a in zip(aggs_before, M._aggs))
    current = A2
    for gk in M._galerkin:
        fresh = amg._GalerkinCache(current, gk.P0, gk.omega)
        _same_global(fresh.P, gk.P, 1e-12)
        _same_global(fresh.Ac, gk.Ac, 1e-12)
        current = fresh.Ac
    from partitionedarrays_tpu_torch.solvers.krylov import cg

    rng = np.random.default_rng(3)
    x_exact = ps.pvector_from_own([rng.standard_normal(li.n_own) for li in A2.row_prange.parts],
                                  A2.row_prange, A2.backend, device="cpu")
    x, info = cg(A2, ps.spmv(A2, x_exact), M=M, rtol=1e-10, maxiter=100)
    assert np.linalg.norm(collect(x) - collect(x_exact)) < 1e-5
    assert int(info.iterations) <= 30


def test_amg_update_identical_values_is_identity():
    """update with the same values reproduces the hierarchy (to 1e-12: the
    refill sums a coarse entry's contributions in triplet order, the build
    in scipy's)."""
    I, J, V, rows, cols = gallery.laplacian_fem((8, 8), (2, 2))
    A = ps.psparse(I, J, V, rows, cols, SerialBackend(4), device="cpu")
    M = amg.AMGPreconditioner(A, amg.AMGParams(coarse_size=10, epsilon=0.01))
    before = [ps.to_global_scipy(lev.A).copy() for lev in M.levels]
    M.update(A)
    for G0, lev in zip(before, M.levels):
        assert abs(G0 - ps.to_global_scipy(lev.A)).max() <= 1e-12 * abs(G0).max()


def test_coarse_solve_not_stale_after_update():
    """update recomputes the coarse factors: 4 A gives a quarter of the
    coarse correction, as in the reference."""
    I, J, V, rows, cols = gallery.laplacian_fdm((12, 12), (2, 2))
    A = ps.psparse(I, J, V, rows, cols, SerialBackend(4), assembled=True, device="cpu")
    M = amg.AMGPreconditioner(A, amg.AMGParams(coarse_size=40))
    coarse = M.levels[-1].A
    rc = ps.pvector_from_own([np.eye(1, li.n_own)[0] if p == 0 else np.zeros(li.n_own)
                              for p, li in enumerate(coarse.row_prange.parts)],
                             coarse.row_prange, coarse.backend, device="cpu")
    z1 = M._coarse_solve(rc).own.numpy()
    A2 = ps.psparse(I, J, [4.0 * v for v in V], rows, cols, SerialBackend(4), assembled=True,
                    device="cpu")
    M.update(A2)
    z2 = M._coarse_solve(rc).own.numpy()
    np.testing.assert_allclose(z2, z1 / 4.0, rtol=1e-10, atol=1e-14)


# -- pvector and psystem -------------------------------------------------------------

def test_pvector_reuse():
    rng = np.random.default_rng(0)
    n = 40
    pr = PRange(uniform_partition((4,), (n,)))
    I, V = [], []
    for li in pr.parts:
        ids = np.concatenate([li.own_to_global, [(li.own_to_global[-1] + 1) % n]])
        I.append(ids)
        V.append(rng.standard_normal(ids.size))
    v, cache = pvector(I, V, pr, SerialBackend(4), reuse=True, device="cpu")
    ref = np.zeros(n)
    for ids, vals in zip(I, V):
        np.add.at(ref, ids, vals)
    np.testing.assert_allclose(collect(v), ref, rtol=1e-12)
    V2 = [2.5 * v_ - 1.0 for v_ in V]
    v2 = pvector_refill(V2, cache)
    ref2 = np.zeros(n)
    for ids, vals in zip(I, V2):
        np.add.at(ref2, ids, vals)
    np.testing.assert_allclose(collect(v2), ref2, rtol=1e-12)
    np.testing.assert_array_equal(collect(v2), collect(pvector(I, V2, pr, SerialBackend(4),
                                                                device="cpu")))


def test_psystem_reuse():
    I, J, V, rows, cols = gallery.laplacian_fem((8, 8), (2, 2))
    Ir, Jr, Vr, rr, cr = jax_gallery.laplacian_fem((8, 8), (2, 2))
    rng = np.random.default_rng(1)
    Ib = [li.own_to_global for li in PRange(rows).parts]
    Vb = [rng.standard_normal(i.size) for i in Ib]
    A, b, cache = ps.psystem(I, J, V, Ib, Vb, rows, cols, SerialBackend(4), reuse=True,
                             device="cpu")
    A_ref, b_ref, cache_ref = jax_ps.psystem(Ir, Jr, Vr, Ib, Vb, JaxPRange(rr), JaxPRange(cr),
                                             JaxSerialBackend(4), reuse=True)
    G0 = ps.to_global_scipy(A).copy()
    V2, Vb2 = [-0.5 * v for v in V], [3.0 * v for v in Vb]
    b2 = ps.psystem_refill(A, V2, Vb2, cache)
    b2_ref = jax_ps.psystem_refill(A_ref, V2, Vb2, cache_ref)
    _same_blocks(A, A_ref)
    assert abs(ps.to_global_scipy(A) - (-0.5) * G0).max() < 1e-12
    np.testing.assert_array_equal(collect(b2), np.asarray(jax_pv.collect(b2_ref)))


# -- the two reference faults the port does not copy ------------------------------------

def test_precompute_nzindex_leaves_the_matrix_alone():
    """The reference sorts its argument in place; the port takes a sorted
    CSR and raises otherwise, leaving an unsorted matrix as it was."""
    A = sp.csr_matrix((np.array([1.0, 2.0, 3.0]), np.array([2, 0, 1]), np.array([0, 2, 3])),
                      shape=(2, 3))
    assert not A.has_sorted_indices
    before = (A.indices.copy(), A.data.copy())
    with pytest.raises(ValueError, match="sorted"):
        sparse_host.precompute_nzindex(A, [0, 1], [0, 1])
    np.testing.assert_array_equal(A.indices, before[0])
    np.testing.assert_array_equal(A.data, before[1])
    B, K = sparse_host.sparse_matrix([0, 0, 1, 0], [2, 0, 1, 2], [1.0, 2.0, 3.0, 4.0], 2, 3,
                                     reuse=True)
    np.testing.assert_array_equal(K, [1, 0, 2, 1])
    sparse_host.sparse_matrix_refill(B, np.array([1.0, 1.0, 1.0, 1.0]), K)
    np.testing.assert_array_equal(B.toarray(), [[1.0, 0.0, 2.0], [0.0, 1.0, 0.0]])


def test_pvector_refill_keeps_its_dtype():
    """The reference rounds wider values into the vector's dtype silently;
    the port raises, and keeps the dtype for values that fit."""
    pr = PRange(uniform_partition((2,), (8,)))
    I = [li.own_to_global for li in pr.parts]
    v, cache = pvector(I, [np.ones(i.size, np.float32) for i in I], pr, SerialBackend(2),
                       reuse=True, device="cpu")
    assert v.own.dtype == torch.float32
    with pytest.raises(TypeError, match="float64"):
        pvector_refill([np.full(i.size, 0.1) for i in I], cache)
    v2 = pvector_refill([np.full(i.size, 2, np.float32) for i in I], cache)
    assert v2.own.dtype == torch.float32 and (collect(v2) == 2).all()
