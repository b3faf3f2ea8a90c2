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
    A, _ = build_hpcg_problem((n, n, n), (1, 1, 1), SerialBackend(1), device="cpu")
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
    A, _ = build_hpcg_problem((16, 16, 16), (1, 1, 1), SerialBackend(1), dtype=dtype, device="cpu")
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


# -- K3's host-side planning (ops/dia_rows.py, TapTable.steps_on) ---------


@pytest.mark.parametrize("sweep", ["forward", "backward", "symmetric"])
@pytest.mark.parametrize("iterations", [1, 2])
def test_step_array_equals_order_seq(sweep, iterations):
    """The int32 step array K3 reads is the smoother's color sequence,
    built once per order and device."""
    A, _ = build_hpcg_problem((8, 8, 8), (1, 1, 1), SerialBackend(1), device="cpu")
    gs = GaussSeidel(A, iterations=iterations, sweep=sweep)
    order = gs._order_seq()
    steps = gs.colored.taps.steps_on(order, torch.device("cpu"))
    assert steps.dtype == torch.int32
    assert steps.tolist() == list(order)
    assert len(order) == iterations * gs.colored.m * (2 if sweep == "symmetric" else 1)
    assert gs.colored.taps.steps_on(list(order), "cpu") is steps
    with pytest.raises(ValueError):
        gs.colored.taps.steps_on((0, gs.colored.m), "cpu")


# (P, m, n_off, Lq, itemsize) of the levels the paths run, and the lanes
# the rule of ops/dia_rows.py gives them: one lane where rows are many
# (the HPCG fine level), up to 16 where rows are few and taps many
PLAN_CASES = [
    ((1, 9, 27, 245760, 4), 1),  # 128^3 fine, float32
    ((1, 9, 27, 245760, 8), 1),  # 128^3 fine, float64
    ((1, 11, 27, 24576, 4), 4),  # 64^3
    ((1, 11, 27, 24576, 8), 2),
    ((1, 9, 27, 4096, 4), 16),  # 32^3
    ((1, 9, 27, 1024, 8), 16),  # 16^3
    ((8, 11, 27, 24576, 4), 1),  # (2,2,2) x 64^3
    ((1, 27, 99, 7168, 4), 16),  # 40^3 elasticity fine
    ((1, 27, 99, 7168, 8), 8),
    ((1, 10, 2, 1024, 4), 2),  # lanes never exceed the taps
]


@pytest.mark.parametrize("shape, lanes", PLAN_CASES, ids=[str(c[0]) for c in PLAN_CASES])
def test_sweep_plan_per_level(shape, lanes):
    from partitionedarrays_tpu_torch.ops.dia_rows import (
        TARGET_THREADS, THREADS, row_lanes, sweep_plan, vec_of,
    )

    P, m, n_off, Lq, itemsize = shape
    plan = sweep_plan(*shape)
    assert plan.lanes == lanes
    groups = Lq // vec_of(itemsize)
    # one pass over a step, and the smallest lane count that reaches the
    # target unless the taps or the sector width stop it first
    assert plan.width * THREADS >= groups * plan.lanes > (plan.width - 1) * THREADS
    assert plan.lanes == 16 or 2 * plan.lanes > n_off or P * groups * plan.lanes >= TARGET_THREADS
    assert plan.lanes == 1 or P * groups * plan.lanes // 2 < TARGET_THREADS
    assert row_lanes(P * groups, n_off, TARGET_THREADS) == plan.lanes


@pytest.mark.parametrize("sweep", ["forward", "symmetric"])
def test_zero_guess_entry_matches_plain_on_zero_core(state, sweep):
    """``gs_sweeps(..., xcore=None)`` (and ``sweeps_core(None, ...)``) is
    the plain sweep from a zero core, bit for bit on the CPU."""
    from partitionedarrays_tpu_torch.ops.gs_dia_kernels import gs_sweeps, gs_sweeps_plain

    dtype, _, col, _, _ = state
    rng = np.random.default_rng(14)
    bd = torch.from_numpy(rng.standard_normal((1, col.m, col.Lq)).astype(dtype))
    fwd = tuple(range(col.m))
    order = fwd if sweep == "forward" else fwd + fwd[::-1]
    want = gs_sweeps_plain(col.vals_d, bd, col.invd_d, torch.zeros_like(bd), col.taps, order)
    got = gs_sweeps(col.vals_d, bd, col.invd_d, None, col.taps, order)
    assert torch.equal(got, want)
    assert torch.equal(col.sweeps_core(None, bd, col.vals_d, col.invd_d, order), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_row_engine_refuses_what_its_16_byte_loads_cannot_read(dtype):
    """``check_rows``, the one operand policy of K2 and K3: rows, starts and
    part strides in whole 16-byte steps pass; anything else raises."""
    from partitionedarrays_tpu_torch.ops.dia_rows import check_rows, vec_of

    vec = vec_of(torch.empty((), dtype=dtype).element_size())
    vals = torch.zeros(2, 3, 5, 8 * vec, dtype=dtype)
    check_rows("k", 8 * vec, (vals, vals[:, 1]), vec)  # a color view: part stride 15 rows
    buf = torch.zeros(vals.numel() + 1, dtype=dtype)
    with pytest.raises(ValueError):
        check_rows("k", 8 * vec, (buf[1:].view(vals.shape),), vec)  # start off by 1 element
    with pytest.raises(ValueError):
        check_rows("k", 8 * vec + 1, (vals,), vec)  # rows not whole 16-byte steps
    with pytest.raises(ValueError):
        check_rows("k", 8 * vec, (buf[: 2 * (8 * vec + 1)].view(2, 8 * vec + 1)[:, 1:],), vec)


@pytest.mark.parametrize("values, dtype", [(torch.bfloat16, torch.float32),
                                           (torch.bfloat16, torch.float64),
                                           (torch.float32, torch.float64)])
def test_row_engine_refuses_narrow_values_its_loads_cannot_read(values, dtype):
    """Narrow values keep the rows per thread of their vectors (``vec``):
    a value load is ``vec`` narrow elements (8 or 4 bytes), so a view of
    the values passes where its start is a whole load and its rows and
    part stride whole ``vec``; one element off, it raises."""
    from partitionedarrays_tpu_torch.ops.dia_rows import check_rows, vec_of

    vec = vec_of(torch.empty((), dtype=dtype).element_size())
    vals = torch.zeros(2, 3, 5, 8 * vec, dtype=values)
    bd = torch.zeros(2, 3, 8 * vec, dtype=dtype)
    check_rows("k", 8 * vec, (vals, vals[:, 1], bd), vec)
    buf = torch.zeros(vals.numel() + 1, dtype=values)
    with pytest.raises(ValueError):
        check_rows("k", 8 * vec, (buf[1:].view(vals.shape), bd), vec)  # start off by 1
    with pytest.raises(ValueError):
        check_rows("k", 8 * vec + 1, (vals,), vec)  # rows not whole row groups
    with pytest.raises(ValueError):
        check_rows("k", 8 * vec, (buf[: 2 * (8 * vec + 1)].view(2, 8 * vec + 1)[:, 1:],), vec)
