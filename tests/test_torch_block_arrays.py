"""Block arrays of the PyTorch port against the JAX reference on the CPU
(Pallas off): ``BRange``, ``BVector`` (its arithmetic, ``similar``,
``fill`` and accessors), every ``b_*`` reduction and product, ``BMatrix``
(shape, accessors, blockwise algebra with zero blocks) and ``b_cg``, on the
coupled two-field system of ``chip_smoke.py`` phase 4k at 8^3 and 12^3 on
(2,2,2) parts: [[A, C], [C, S]], A the 7-point Laplacian, S = A + 0.5 I,
C = 0.1 I.

The same numpy inputs go to both packages.  Reductions, products and
moved values are held to rtol 1e-6 in float32 and 1e-13 in float64 (the
order of a sum may differ); ``b_cg`` to the reference's iterations exactly
and its solution to 1e-5 (float32) and 1e-12 (float64), relative.
"""
import contextlib
import importlib

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from partitionedarrays_tpu import config as jax_config
from partitionedarrays_tpu.backends import SerialBackend as JaxSerialBackend

from partitionedarrays_tpu_torch import block_arrays as tb
from partitionedarrays_tpu_torch import psparse as tps
from partitionedarrays_tpu_torch import pvector as tpv
from partitionedarrays_tpu_torch.backends import SerialBackend
from partitionedarrays_tpu_torch.ops import stencil as tstencil

jb = importlib.import_module("partitionedarrays_tpu.block_arrays")
jps = importlib.import_module("partitionedarrays_tpu.psparse")
jpv = importlib.import_module("partitionedarrays_tpu.pvector")
jstencil = importlib.import_module("partitionedarrays_tpu.ops.stencil")

torch.set_num_threads(1)

PARTS = (2, 2, 2)
RTOL = {np.float32: 1e-6, np.float64: 1e-13}
CG_RTOL = {np.float32: 1e-5, np.float64: 1e-12}


@pytest.fixture(scope="module", autouse=True)
def reference_without_pallas():
    saved = jax_config.use_pallas
    jax_config.use_pallas = False
    yield
    jax_config.use_pallas = saved


def _stencil(n, shift):
    alpha = float((n + 1) ** 3)
    out = [((0, 0, 0), 6 * alpha + shift)]
    for d in range(3):
        for step in (-1, 1):
            out.append((tuple(step if k == d else 0 for k in range(3)), -alpha))
    return out


def _system(port: bool, n: int, dtype):
    """The coupled system's BMatrix in one package, and its backend."""
    if port:
        backend = SerialBackend(8)
        kw = {"device": "cpu"}
        A = tstencil.stencil_psparse(PARTS, (n,) * 3, _stencil(n, 0.0), backend, dtype=dtype, **kw)
        S = tstencil.stencil_psparse(PARTS, (n,) * 3, _stencil(n, 0.5), backend, dtype=dtype, **kw)
        C = tps.sparse_diag_matrix(tpv.pfill(0.1, A.row_prange, backend, dtype, **kw))
        return tb.BMatrix([[A, C], [C, S]]), backend
    backend = JaxSerialBackend(8)
    A = jstencil.stencil_psparse(PARTS, (n,) * 3, _stencil(n, 0.0), backend, dtype=dtype)
    S = jstencil.stencil_psparse(PARTS, (n,) * 3, _stencil(n, 0.5), backend, dtype=dtype)
    C = jps.sparse_diag_matrix(jpv.pfill(0.1, A.row_prange, backend, dtype))
    return jb.BMatrix([[A, C], [C, S]]), backend


def _bvector(port: bool, M, backend, values: np.ndarray, dtype):
    """The BVector of global ``values`` (both fields, one after the other)
    on M's row blocks."""
    blocks = []
    for k, A in enumerate(M.blocks[k][k] for k in range(2)):
        pr = A.row_prange
        N = A.shape[0]
        own = [values[k * N + li.own_to_global].astype(dtype) for li in pr.partition()]
        if port:
            blocks.append(tpv.pvector_from_own(own, pr, backend, device="cpu"))
        else:
            blocks.append(jpv.pvector_from_own(own, pr, backend))
    return (tb if port else jb).BVector(blocks)


def _global(M) -> sp.csr_matrix:
    to = tps.to_global_scipy if isinstance(M, tb.BMatrix) else jps.to_global_scipy
    return sp.bmat([[None if B is None else to(B).astype(np.float64) for B in row]
                    for row in M.blocks]).tocsr()


@pytest.fixture(scope="module", params=[np.float32, np.float64], ids=["f32", "f64"])
def pair(request):
    """Both packages' systems at 8^3, two random BVectors of each, and the
    dtype."""
    dtype = request.param
    tM, tback = _system(True, 8, dtype)
    jM, jback = _system(False, 8, dtype)
    rng = np.random.default_rng(14)
    N2 = 2 * 8 ** 3
    u, v = rng.standard_normal(N2), rng.uniform(-1.0, 1.0, N2)
    tu, tv = (_bvector(True, tM, tback, a, dtype) for a in (u, v))
    ju, jv = (_bvector(False, jM, jback, a, dtype) for a in (u, v))
    return dtype, (tM, tu, tv), (jM, ju, jv)


def _close(got, want, dtype):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    scale = max(np.abs(want).max(), 1e-300) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=RTOL[dtype], atol=RTOL[dtype] * scale)


def _bcollect(x):
    return tb.b_collect(x) if isinstance(x, tb.BVector) else jb.b_collect(x)


def test_brange_and_bvector_structure(pair):
    _, (tM, tu, _), (jM, ju, _) = pair
    for t, j in ((tu.axes_brange(), ju.axes_brange()), (tM.row_brange(), jM.row_brange()),
                 (tM.col_brange(), jM.col_brange())):
        assert (t.n_global, t.n_blocks, t.blocklasts(), len(t)) == (
            j.n_global, j.n_blocks, j.blocklasts(), len(j))
        assert repr(t) == repr(j)
    assert (tu.n_blocks, tu.blocksize, tu.blocklength, tu.n_global, len(tu)) == (
        ju.n_blocks, ju.blocksize, ju.blocklength, ju.n_global, len(ju))
    assert repr(tu) == repr(ju)
    assert tu.block(1) is tu[1] is tu.blocks[1]


@pytest.mark.parametrize("name", ["b_dot", "b_norm", "b_sum", "b_maximum", "b_minimum",
                                  "b_euclidean"])
def test_reductions_match_jax(pair, name):
    dtype, (_, tu, tv), (_, ju, jv) = pair
    args = {"b_dot": 2, "b_euclidean": 2}.get(name, 1)
    got = getattr(tb, name)(*(tu, tv)[:args])
    want = getattr(jb, name)(*(ju, jv)[:args])
    _close(float(got), float(want), dtype)


@pytest.mark.parametrize("name", ["b_any", "b_all"])
def test_predicates_match_jax(pair, name):
    _, (_, tu, tv), (_, ju, jv) = pair
    for pred in (lambda v: v > 0, lambda v: v > -2.0, lambda v: v != 0):
        for t, j in ((tu, ju), (tv, jv), (tu * 0.0, ju * 0.0)):
            assert getattr(tb, name)(t, pred) == getattr(jb, name)(j, pred)


@pytest.mark.parametrize("op", ["add", "sub", "mul", "div", "neg", "scalar_add",
                                "scalar_sub", "axpy", "copy"])
def test_bvector_arithmetic_matches_jax(pair, op):
    dtype, (_, tu, tv), (_, ju, jv) = pair
    f = {
        "add": lambda u, v, m: u + v, "sub": lambda u, v, m: u - v,
        "mul": lambda u, v, m: 2.5 * u, "div": lambda u, v, m: u / 4.0,
        "neg": lambda u, v, m: -u, "scalar_add": lambda u, v, m: u + 1.5,
        "scalar_sub": lambda u, v, m: u - 1.5,
        "axpy": lambda u, v, m: m.b_axpy(-0.75, u, v), "copy": lambda u, v, m: u.copy(),
    }[op]
    t, j = f(tu, tv, tb), f(ju, jv, jb)
    _close(_bcollect(t), _bcollect(j), dtype)
    for tb_, jb_ in zip(t.blocks, j.blocks):  # padding lanes stay zero in both
        np.testing.assert_array_equal(tb_.own.numpy() == 0, np.asarray(jb_.own) == 0)


def test_scalar_minus_bvector(pair):
    """``s - u``: the reference's ``BVector.__rsub__`` computes ``s - b`` for
    each block, which its PVector does not define (TypeError,
    ``partitionedarrays_tpu/block_arrays.py:130``); the port's PVector has
    ``__rsub__``, so it gives the reference's ``-(u - s)``."""
    dtype, (_, tu, _), (_, ju, _) = pair
    with pytest.raises(TypeError):
        1.5 - ju
    _close(_bcollect(1.5 - tu), _bcollect(-(ju - 1.5)), dtype)


def test_similar_fill_and_accessors_match_jax(pair):
    dtype, (_, tu, _), (_, ju, _) = pair
    for t, j in ((tu.similar(), ju.similar()), (tu.fill(3.0), ju.fill(3.0))):
        _close(_bcollect(t), _bcollect(j), dtype)
        assert t.blocks[0].own.device == tu.blocks[0].own.device
    for name in ("own_values", "ghost_values", "local_values"):
        for tp_, jp_ in zip(getattr(tu, name)(), getattr(ju, name)()):
            for a, b in zip(tp_, jp_):
                _close(a, b, dtype)


def test_consistent_and_assemble_match_jax(pair):
    """Ghost values from their owners (``b_consistent``), and ghost values
    added to their owners (``b_assemble``), on the blocks' column layouts."""
    dtype, (tM, tu, _), (jM, ju, _) = pair

    def ghosted(x, M, port):
        P = tpv.PVector if port else jpv.PVector
        blocks = []
        for k, xb in enumerate(x.blocks):
            lay = M.blocks[k][k].col_layout()
            g = np.arange(lay.n_parts * lay.n_ghost_pad, dtype=dtype).reshape(
                lay.n_parts, lay.n_ghost_pad) * 1e-3
            g = g * (np.arange(lay.n_ghost_pad)[None, :] < np.asarray(lay.n_ghost)[:, None])
            ghost = torch.from_numpy(g) if port else jax.numpy.asarray(g)
            blocks.append(P(xb.own, ghost, lay, xb.backend))
        return (tb if port else jb).BVector(blocks)

    tx, jx = ghosted(tu, tM, True), ghosted(ju, jM, False)
    for fname in ("b_consistent", "b_assemble"):
        t, j = getattr(tb, fname)(tx).wait(), getattr(jb, fname)(jx).wait()
        for tb_, jb_ in zip(t.blocks, j.blocks):
            _close(tb_.own.numpy(), np.asarray(jb_.own), dtype)
            _close(tb_.ghost.numpy(), np.asarray(jb_.ghost), dtype)


def test_bmatrix_structure_and_accessors_match_jax(pair):
    _, (tM, _, _), (jM, _, _) = pair
    assert (tM.shape, tM.shape_blocks, tM.blocksize, tM.nnz()) == (
        jM.shape, jM.shape_blocks, jM.blocksize, jM.nnz())
    assert repr(tM) == repr(jM)
    assert tM.block(0, 1) is tM[0, 1]
    for name in ("own_own_values", "own_ghost_values", "ghost_own_values",
                 "ghost_ghost_values"):
        for trow, jrow in zip(getattr(tM, name)(), getattr(jM, name)()):
            for t, j in zip(trow, jrow):
                for tp_, jp_ in zip(t, j):
                    assert (tp_ is None) == (jp_ is None)
                    if tp_ is not None:
                        assert tp_.shape == jp_.shape
                        assert (sp.csr_matrix(tp_) != sp.csr_matrix(jp_)).nnz == 0


@pytest.mark.parametrize("op", ["mul", "scaled", "sum", "difference", "negated", "copy",
                                "zero_blocks"])
def test_block_products_match_jax(pair, op):
    """``b_mul`` of the system, of its blockwise algebra (2 M, M + M', M -
    M', -M / 2, a copy) and of a matrix with zero blocks, where the sum
    and the difference fill a zero block from the other operand."""
    dtype, (tM, tu, _), (jM, ju, _) = pair

    def make(M, m):
        diag = m.BMatrix([[M.blocks[0][0], None], [None, M.blocks[1][1]]])
        return {
            "mul": M, "scaled": 2.0 * M, "sum": M + diag, "difference": M - diag,
            "negated": -M / 2.0, "copy": M.copy(), "zero_blocks": diag,
        }[op]

    t, j = tb.b_mul(make(tM, tb), tu), jb.b_mul(make(jM, jb), ju)
    _close(_bcollect(t), _bcollect(j), dtype)
    G = _global(make(tM, tb))
    want = G @ _bcollect(tu).astype(np.float64)
    _close(_bcollect(t), want, dtype)


@pytest.mark.parametrize("n", [8, 12])
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_b_cg_matches_jax(n, dtype):
    """``b_cg`` to rtol 1e-8 from b = G x* (float64 on the host, rounded):
    the reference's iterations exactly, its solution to ``CG_RTOL``; the
    true residual of the float64 product below 1e-6 (float32) and 1e-8."""
    out = {}
    for port in (True, False):
        M, backend = _system(port, n, dtype)
        G = _global(M)
        xs = np.random.default_rng(14).standard_normal(G.shape[0])
        b = _bvector(port, M, backend, G @ xs, dtype)
        mod = tb if port else jb
        mode = jax.enable_x64(False) if (dtype == np.float32 and not port) else contextlib.nullcontext()
        with mode:
            x, iters, relres = mod.b_cg(M, b, rtol=1e-8, maxiter=1000)
        out[port] = (_bcollect(x).astype(np.float64), iters, relres, G,
                     _bcollect(b).astype(np.float64))
    (tx, titers, trel, G, bh), (jx, jiters, jrel, _, _) = out[True], out[False]
    assert titers == jiters and titers > 10
    assert trel <= 1e-8 and jrel <= 1e-8
    np.testing.assert_allclose(tx, jx, rtol=0, atol=CG_RTOL[dtype] * np.abs(jx).max())
    true = np.linalg.norm(bh - G @ tx) / np.linalg.norm(bh)
    assert true < (1e-6 if dtype == np.float32 else 1e-8), true


def test_b_cg_from_a_guess_and_zero_rhs():
    """From a nonzero guess ``b_cg`` starts at r = b - M x0; a zero right
    side returns at once, as the reference's does."""
    tM, backend = _system(True, 8, np.float64)
    jM, jbackend = _system(False, 8, np.float64)
    rng = np.random.default_rng(15)
    G = _global(tM)
    bh, x0 = G @ rng.standard_normal(G.shape[0]), rng.standard_normal(G.shape[0])
    got = tb.b_cg(tM, _bvector(True, tM, backend, bh, np.float64),
                  x0=_bvector(True, tM, backend, x0, np.float64), rtol=1e-10)
    want = jb.b_cg(jM, _bvector(False, jM, jbackend, bh, np.float64),
                   x0=_bvector(False, jM, jbackend, x0, np.float64), rtol=1e-10)
    assert got[1] == want[1]
    np.testing.assert_allclose(_bcollect(got[0]), _bcollect(want[0]), rtol=0,
                               atol=1e-12 * np.abs(_bcollect(want[0])).max())
    zero = _bvector(True, tM, backend, np.zeros(G.shape[0]), np.float64)
    x, iters, relres = tb.b_cg(tM, zero)
    assert (iters, relres) == (0, 0.0) and not tb.b_any(x)
