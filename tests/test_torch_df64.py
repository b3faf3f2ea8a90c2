"""The df64 (two-float) layer of the PyTorch port against the JAX reference
and against float64: the split, the error-free transformations, the pair
arithmetic and reductions, the plain K7 (``dia_spmv_df_plain``), the
df64 SpMV across parts (``spmv_df64``) and the df64 PVector helpers.

Inputs are made with numpy from seeds; the reference runs as JAX on the
CPU (Pallas off, x64 on, as its own ``tests/test_df64.py``).  Tolerances:

- ``from_f64``: bit for bit;
- elementwise pair operations: against float64 to 5e-14 of the operand
  scale (add, sub) or the result (mul, div, sqrt), as the reference's own
  test; against the reference to 1e-14 (its unpinned low-order terms may
  contract in XLA, which moves lo by an ulp);
- dots: 1e-12 relative to float64 (and to the reference);
- SpMVs: 1e-13 of ``sum_j |A_ij| |x_j|`` per row against float64, as
  ``tests/test_df64.py:68-92``; 1e-12 across parts as ``:115-141``.  The
  port's plain K7 orders each tap as the TPU kernel body does and the
  reference's XLA ``dia_spmv_df`` adds a full pair product per tap: they
  agree to ~2^-48 of that scale, not bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from partitionedarrays_tpu import config as jax_config
from partitionedarrays_tpu.backends import SerialBackend as JaxSerialBackend
from partitionedarrays_tpu.models.hpcg.problem import STENCIL_27PT as JAX_STENCIL_27PT
from partitionedarrays_tpu.ops import df64 as jdf
from partitionedarrays_tpu.ops.stencil import stencil_psparse as jax_stencil_psparse
from partitionedarrays_tpu.psparse import spmv_df64 as jax_spmv_df64
from partitionedarrays_tpu.psparse import to_global_scipy
from partitionedarrays_tpu.pvector import PVector as JaxPVector

from partitionedarrays_tpu_torch.backends import SerialBackend
from partitionedarrays_tpu_torch.models.hpcg.problem import STENCIL_27PT
from partitionedarrays_tpu_torch.ops import df64 as df
from partitionedarrays_tpu_torch.ops.blocks import freeze_block_pair
from partitionedarrays_tpu_torch.ops.dia import stack_dia
from partitionedarrays_tpu_torch.ops.dia_spmv import dia_spmv_df
from partitionedarrays_tpu_torch.ops.stencil import stencil_psparse
from partitionedarrays_tpu_torch.parallel.partition import PRange, uniform_partition
from partitionedarrays_tpu_torch.psparse import device_df64, spmv_df64
from partitionedarrays_tpu_torch.pvector import (
    PVector,
    axpy_df64,
    collect_df64,
    pdot_df64,
    pnorm_df64,
    pvector_df64,
    pvector_split_df64,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def reference_without_pallas():
    saved = jax_config.use_pallas
    jax_config.use_pallas = False
    yield
    jax_config.use_pallas = saved


def _rand(n, seed, scale=1.0):
    return np.random.default_rng(seed).standard_normal(n) * scale


def _t(pair):
    return tuple(torch.from_numpy(np.asarray(v)) for v in pair)


def _j(pair):
    return tuple(jnp.asarray(v) for v in pair)


def _f64(pair):
    return df.to_f64(*pair).numpy()


def test_from_f64_split_is_bitwise_the_reference():
    v = np.concatenate([
        _rand(4000, 1, scale=1e3), _rand(1000, 2, scale=1e-20),
        [0.0, -0.0, 1.0, np.pi, -np.e, 2.0**-126, 3.4e38, 1.0 + 2.0**-40],
    ])
    hi, lo = df.from_f64(torch.from_numpy(v))
    rhi, rlo = jdf.from_f64(v)
    assert hi.dtype == lo.dtype == torch.float32
    np.testing.assert_array_equal(hi.numpy().view(np.uint32), rhi.view(np.uint32))
    np.testing.assert_array_equal(lo.numpy().view(np.uint32), rlo.view(np.uint32))
    np.testing.assert_array_equal(df.to_f64(hi, lo).numpy(), jdf.to_f64(rhi, rlo))


def test_two_sum_two_prod_are_error_free():
    a = _rand(2000, 3).astype(np.float32)
    b = (_rand(2000, 4) * 1e-3).astype(np.float32)
    s, e = df.two_sum(torch.from_numpy(a), torch.from_numpy(b))
    exact = a.astype(np.float64) + b.astype(np.float64)
    np.testing.assert_array_equal(s.double().numpy() + e.double().numpy(), exact)
    p, pe = df.two_prod(torch.from_numpy(a), torch.from_numpy(b))
    exact = a.astype(np.float64) * b.astype(np.float64)
    np.testing.assert_array_equal(p.double().numpy() + pe.double().numpy(), exact)
    for got, ref in ((df.two_sum, jdf.two_sum), (df.two_prod, jdf.two_prod)):
        mine = got(torch.from_numpy(a), torch.from_numpy(b))
        theirs = ref(jnp.asarray(a), jnp.asarray(b))
        np.testing.assert_array_equal(_f64(mine), jdf.to_f64(*theirs))


@pytest.mark.parametrize("op", ["add", "sub", "mul", "div"])
def test_pair_ops_match_f64_and_jax(op):
    a64 = _rand(1000, 5)
    b64 = _rand(1000, 6) + 2.0  # divisors away from 0
    a, b = jdf.from_f64(a64), jdf.from_f64(b64)
    got = _f64(getattr(df, op)(_t(a), _t(b)))
    ref = jdf.to_f64(*getattr(jdf, op)(_j(a), _j(b)))
    exp = {"add": a64 + b64, "sub": a64 - b64, "mul": a64 * b64, "div": a64 / b64}[op]
    if op in ("add", "sub"):
        scale = np.abs(a64) + np.abs(b64)
    else:
        scale = np.abs(exp)
    assert (np.abs(got - exp) / scale).max() < 5e-14
    assert (np.abs(got - ref) / scale).max() < 1e-14


def test_sqrt_neg_scale_match_f64_and_jax():
    a64 = np.abs(_rand(1000, 7)) + 1e-3
    a = jdf.from_f64(a64)
    got = _f64(df.sqrt(_t(a)))
    ref = jdf.to_f64(*jdf.sqrt(_j(a)))
    exp = np.sqrt(a64)
    assert (np.abs(got - exp) / exp).max() < 5e-14
    assert (np.abs(got - ref) / exp).max() < 1e-14
    np.testing.assert_array_equal(_f64(df.neg(_t(a))), -jdf.to_f64(*a))
    s = jdf.from_f64(np.array(np.pi))
    got = _f64(df.scale(_t(a), _t(s)))
    assert (np.abs(got - a64 * np.pi) / (a64 * np.pi)).max() < 5e-14


@pytest.mark.parametrize("n", [1, 7, 1000, 1 << 16])
def test_dot_matches_f64_and_jax(n):
    a64, b64 = _rand(n, 8), _rand(n, 9)
    a, b = jdf.from_f64(a64), jdf.from_f64(b64)
    got = df.to_f64(*df.dot(_t(a), _t(b))).item()
    ref = float(jdf.to_f64(*jdf.dot(_j(a), _j(b))))
    exp = float(a64 @ b64)
    scale = float(np.abs(a64) @ np.abs(b64))
    assert abs(got - exp) <= 1e-12 * scale
    assert abs(got - ref) <= 1e-12 * scale


def test_dot_parts_folds_the_per_part_pairs():
    """The dot over parts equals the reference's per-part dot followed by
    a df64 fold of the partial pairs (its ``dot_spmd``)."""
    P, n = 5, 3001
    a64, b64 = _rand(P * n, 10).reshape(P, n), _rand(P * n, 11).reshape(P, n)
    a, b = jdf.from_f64(a64), jdf.from_f64(b64)
    got = df.to_f64(*df.dot_parts(_t(a), _t(b))).item()
    parts = [jdf.dot((jnp.asarray(a[0][p]), jnp.asarray(a[1][p])),
                     (jnp.asarray(b[0][p]), jnp.asarray(b[1][p]))) for p in range(P)]
    ref = jdf.tree_sum((jnp.stack([h for h, _ in parts]), jnp.stack([l for _, l in parts])))
    exp = float(np.sum(a64 * b64))
    assert abs(got - float(jdf.to_f64(*ref))) <= 1e-13 * abs(exp)
    assert abs(got - exp) <= 1e-12 * abs(exp)


def _dia_case(n=4096, P=2, seed=12):
    rng = np.random.default_rng(seed)
    offsets = (-64, -1, 0, 1, 64)
    mats = [sp.dia_matrix((rng.standard_normal((len(offsets), n)), offsets), shape=(n, n)).tocsr()
            for _ in range(P)]
    x64 = rng.standard_normal((P, n))
    vals = stack_dia(mats, n, np.array(offsets))  # [P, n_off, n] float64
    return offsets, mats, vals, x64


def test_dia_spmv_df_plain_matches_f64_and_jax():
    offsets, mats, vals, x64 = _dia_case()
    vh, vl = jdf.from_f64(vals)
    x = jdf.from_f64(x64)
    got = _f64(df.dia_spmv_df_plain(offsets, *_t((vh, vl)), _t(x)))
    for p, A in enumerate(mats):
        scale = np.abs(A) @ np.abs(x64[p]) + 1e-30
        assert (np.abs(got[p] - A @ x64[p]) / scale).max() < 1e-13
        ref = jdf.to_f64(*jdf.dia_spmv_df(
            offsets, jnp.asarray(vh[p]), jnp.asarray(vl[p]), _j((x[0][p], x[1][p])), x64.shape[1]
        ))
        assert (np.abs(got[p] - ref) / scale).max() < 1e-13
        # float32 is ~6 orders of magnitude off on the same rows
        y32 = A.astype(np.float32) @ x64[p].astype(np.float32)
        assert (np.abs(y32 - A @ x64[p]) / scale).max() > 1e-8


def test_dia_spmv_df_wrapper_runs_the_plain_version_on_cpu_tensors():
    offsets, _, vals, x64 = _dia_case(n=512, P=3, seed=13)
    v = df.from_f64(torch.from_numpy(vals))
    x = df.from_f64(torch.from_numpy(x64))
    before = dia_spmv_df.launches
    got = dia_spmv_df(offsets, *v, x)
    assert dia_spmv_df.launches == before  # no kernel on the CPU
    want = df.dia_spmv_df_plain(offsets, *v, x)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(TypeError):
        dia_spmv_df(offsets, v[0].double(), v[1].double(), x)
    with pytest.raises(ValueError):
        dia_spmv_df(offsets, v[0], v[1][:, :, :-1], x)


def test_freeze_block_pair_and_device_df64_need_float64():
    be = SerialBackend(1)
    A32 = stencil_psparse((1, 1, 1), (4, 4, 4), STENCIL_27PT, be, dtype=np.float32, device="cpu")
    with pytest.raises(TypeError):
        device_df64(A32)
    with pytest.raises(TypeError):
        freeze_block_pair(A32.device().oo)
    A = stencil_psparse((1, 1, 1), (4, 4, 4), STENCIL_27PT, be, dtype=np.float64, device="cpu")
    pair = device_df64(A)
    assert device_df64(A) is pair  # built once
    hi, lo = pair[0].oo.vals, pair[1].oo.vals
    np.testing.assert_array_equal(df.to_f64(hi, lo).numpy(), A.device().oo.vals.numpy())


def test_spmv_df64_matches_f64_and_jax_across_parts():
    """(2,2,2) parts of 8^3: exchange per word, K7 on the own-own block and
    the compressed-row product on the own-ghost block."""
    parts, gshape = (2, 2, 2), (16, 16, 16)
    A_ref = jax_stencil_psparse(parts, gshape, JAX_STENCIL_27PT, JaxSerialBackend(8),
                                dtype=np.float64, host_only=True)
    A = stencil_psparse(parts, gshape, STENCIL_27PT, SerialBackend(8), dtype=np.float64,
                        device="cpu")
    assert A.device().oh.kind == "ell"
    G = to_global_scipy(A_ref)
    xg = np.random.default_rng(14).standard_normal(A.shape[1])
    clay = A.col_layout()
    xo = np.zeros((8, clay.n_own_pad))
    for p, part in enumerate(A.col_prange.parts):
        xo[p, : part.n_own] = xg[part.own_to_global]
    xh, xl = jdf.from_f64(xo)
    zg = np.zeros((8, clay.n_ghost_pad), np.float32)
    yh, yl = spmv_df64(A, (PVector(torch.from_numpy(xh), torch.from_numpy(zg), clay, A.backend),
                           PVector(torch.from_numpy(xl), torch.from_numpy(zg), clay, A.backend)))
    got = df.to_f64(yh.own, yl.own).numpy()
    rclay = A_ref.col_layout()
    rh, rl = jax_spmv_df64(A_ref, (JaxPVector(xh, zg, rclay, A_ref.backend),
                                   JaxPVector(xl, zg, rclay, A_ref.backend)))
    ref = jdf.to_f64(np.asarray(rh.own), np.asarray(rl.own))
    exp = G @ xg
    scale = np.abs(G) @ np.abs(xg) + 1e-30
    for p, part in enumerate(A.row_prange.parts):
        rows = part.own_to_global
        assert (np.abs(got[p, : part.n_own] - exp[rows]) / scale[rows]).max() < 1e-12
        assert (np.abs(got[p, : part.n_own] - ref[p, : part.n_own]) / scale[rows]).max() < 1e-12
    # the row layout is re-homed to the column layout, ghosts refilled
    rlay = A.row_layout()
    zr = torch.zeros((8, rlay.n_ghost_pad))
    yh2, yl2 = spmv_df64(A, (PVector(torch.from_numpy(xh), zr, rlay, A.backend),
                             PVector(torch.from_numpy(xl), zr, rlay, A.backend)))
    assert torch.equal(yh2.own, yh.own) and torch.equal(yl2.own, yl.own)


def test_df64_pvector_ops_match_f64():
    parts, gshape = (2, 2, 1), (10, 9, 7)
    pr = PRange(uniform_partition(parts, gshape))
    be = SerialBackend(4)
    rng = np.random.default_rng(15)
    xs = [rng.standard_normal(part.n_own) for part in pr.parts]
    ys = [rng.standard_normal(part.n_own) for part in pr.parts]
    x = pvector_df64(xs, pr, be, device="cpu")
    y = pvector_df64(ys, pr, be, device="cpu")
    xg, yg = collect_df64(x), collect_df64(y)
    for part, xv in zip(pr.parts, xs):
        # the split keeps 48 of float64's 53 bits; the gather is exact
        assert (np.abs(xg[part.own_to_global] - xv) <= 2.0**-48 * np.abs(xv)).all()
    h, l = pdot_df64(x, y)
    assert abs((float(h) + float(l)) - xg @ yg) < 1e-11 * abs(xg @ yg)
    nh, nl = pnorm_df64(x)
    assert abs((float(nh) + float(nl)) - np.linalg.norm(xg)) < 1e-11 * np.linalg.norm(xg)
    for alpha in (np.pi, df.from_f64(torch.tensor(np.pi, dtype=torch.float64))):
        zg = collect_df64(axpy_df64(alpha, x, y))
        assert np.abs(zg - (yg + np.pi * xg)).max() < 1e-12 * np.abs(yg + np.pi * xg).max()
    zg = collect_df64(axpy_df64(torch.tensor(0.5), x, y))
    assert np.abs(zg - (yg + 0.5 * xg)).max() < 1e-12 * np.abs(yg).max()
    # splitting a float64 PVector is the same exact split
    v = x[0]
    own64 = df.to_f64(x[0].own, x[1].own)
    sh, sl = pvector_split_df64(PVector(own64, v.ghost.double(), v.layout, be))
    assert torch.equal(sh.own, x[0].own) and torch.equal(sl.own, x[1].own)
