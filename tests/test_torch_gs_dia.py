"""Colored DIA Gauss-Seidel (K3 sweeps, K4 core SpMV) of the PyTorch port
against the JAX reference.

The same inputs, made with numpy from a seed, go through
``partitionedarrays_tpu.solvers.gs_dia.ColoredDIAGS`` (JAX on the CPU,
Pallas off) and through the port's ``ColoredDIAGS`` (the plain PyTorch
versions on the CPU).  Tolerances: float64 rtol 1e-10, since only the
summation order may differ; float32 rtol 1e-4 for single outputs.  Entries
can cancel to near zero, so the absolute tolerance is rtol times the
largest reference entry.  Sweeps are compared iterate against iterate:
a sweep whose colors ran out of order would still reduce the residual.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partitionedarrays_tpu import config as jax_config
from partitionedarrays_tpu.backends import SerialBackend as JaxSerialBackend
from partitionedarrays_tpu.models.hpcg.problem import build_hpcg_problem as jax_build
from partitionedarrays_tpu.solvers.gs_dia import ColoredDIAGS as JaxColoredDIAGS
from partitionedarrays_tpu.solvers.smoothers import GaussSeidel as JaxGaussSeidel

from partitionedarrays_tpu_torch.backends import SerialBackend
from partitionedarrays_tpu_torch.models.hpcg.problem import build_hpcg_problem
from partitionedarrays_tpu_torch.solvers.gs_dia import ColoredDIAGS
from partitionedarrays_tpu_torch.solvers.smoothers import GaussSeidel

torch.set_num_threads(1)

RTOL = {np.float32: 1e-4, np.float64: 1e-10}


@pytest.fixture(scope="module", autouse=True)
def reference_without_pallas():
    saved = jax_config.use_pallas
    jax_config.use_pallas = False
    yield
    jax_config.use_pallas = saved


def _close(got, ref, dtype):
    ref = np.asarray(ref)
    rtol = RTOL[dtype]
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


@pytest.fixture(scope="module", params=[np.float32, np.float64], ids=["f32", "f64"])
def state(request):
    """The reference's colored GS state at 16^3 and the port's copy of it."""
    dtype = request.param
    A, _ = jax_build((16, 16, 16), (1, 1, 1), JaxSerialBackend(1), dtype=dtype)
    ref = JaxGaussSeidel(A).colored
    assert not ref.flat_vals  # [P, m, n_off, Lq] layout
    vals_d = np.asarray(ref.vals_d)
    invd_d = np.asarray(ref.invd_d)
    col = ColoredDIAGS.from_arrays(
        ref.offsets, ref.R, torch.from_numpy(vals_d.copy()), torch.from_numpy(invd_d.copy())
    )
    return dtype, ref, col, vals_d, invd_d


def _plan_of(cls, offsets, R):
    obj = cls.__new__(cls)
    obj._plan(offsets, R)
    return obj


@pytest.mark.parametrize("n", [8, 16, 32])
def test_plan_matches_jax(n):
    A, _ = build_hpcg_problem((n, n, n), (1, 1, 1), SerialBackend(1))
    oo = A.device().oo
    R = oo.vals.shape[-1]
    mine = _plan_of(ColoredDIAGS, oo.offsets, R)
    ref = _plan_of(JaxColoredDIAGS, oo.offsets, R)
    assert (mine.m, mine.Lq, mine.Kp) == (ref.m, ref.Lq, ref.Kp)
    assert tuple(mine.schedule) == tuple(ref.schedule)


def test_build_matches_jax(state):
    """The port's on-device de-interleave of A's values equals the
    reference's exactly (a permutation and 1/d)."""
    dtype, ref, _, vals_d, invd_d = state
    A, _ = build_hpcg_problem((16, 16, 16), (1, 1, 1), SerialBackend(1), dtype=dtype)
    col = GaussSeidel(A).colored
    np.testing.assert_array_equal(col.vals_d.numpy(), vals_d)
    np.testing.assert_array_equal(col.invd_d.numpy(), invd_d)


def test_deinterleave_roundtrip_is_exact(state):
    dtype, ref, col, _, _ = state
    rng = np.random.default_rng(10)
    x = rng.standard_normal((1, col.R)).astype(dtype)
    xd = col.deinterleave(torch.from_numpy(x))
    np.testing.assert_array_equal(xd[0].numpy(), np.asarray(ref.deinterleave(jnp.asarray(x[0]))))
    np.testing.assert_array_equal(col.interleave_core(xd).numpy(), x)


@pytest.mark.parametrize("start", ["zero", "random"])
def test_sweeps_core_matches_jax(state, start):
    dtype, ref, col, vals_d, invd_d = state
    rng = np.random.default_rng(11)
    bd = rng.standard_normal((1, col.m, col.Lq)).astype(dtype)
    x0 = None if start == "zero" else rng.standard_normal((1, col.m, col.Lq)).astype(dtype)
    fwd = tuple(range(col.m))
    for order in (fwd, fwd + fwd[::-1]):
        run = jax.jit(
            lambda x, b, v, i, order=order: ref.sweeps_core(x, b, v, i, order)
        )
        want = run(
            None if x0 is None else jnp.asarray(x0[0]), jnp.asarray(bd[0]),
            jnp.asarray(vals_d[0]), jnp.asarray(invd_d[0]),
        )
        got = col.sweeps_core(
            None if x0 is None else torch.from_numpy(x0), torch.from_numpy(bd),
            col.vals_d, col.invd_d, order,
        )
        _close(got[0].numpy(), want, dtype)


def test_ax_core_matches_jax(state):
    dtype, ref, col, vals_d, _ = state
    rng = np.random.default_rng(12)
    x = rng.standard_normal((1, col.m, col.Lq)).astype(dtype)
    want = jax.jit(ref.ax_core)(jnp.asarray(x[0]), jnp.asarray(vals_d[0]))
    got = col.ax_core(torch.from_numpy(x), col.vals_d)
    _close(got[0].numpy(), want, dtype)


def test_sweep_order_matters(state):
    """The check above can tell colors run in order from colors run
    at once: a Jacobi-like update of all colors from the old x differs."""
    dtype, _, col, _, _ = state
    rng = np.random.default_rng(13)
    bd = torch.from_numpy(rng.standard_normal((1, col.m, col.Lq)).astype(dtype))
    x0 = col.zeros_core(1, bd.dtype, "cpu")
    seq = col.sweeps_core(x0, bd, col.vals_d, col.invd_d, tuple(range(col.m)))
    jacobi = x0 + (bd - col.ax_core(x0, col.vals_d)) * col.invd_d
    assert (seq - jacobi).abs().max() > 1e-2 * seq.abs().max()
