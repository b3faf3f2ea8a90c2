"""The HPCG slice of the PyTorch port against the JAX reference: box
partition, partitioned vectors, problem build and the driver's report.  The
V-cycle and the CG histories are in ``test_torch_hpcg_cg_f32.py`` and
``test_torch_hpcg_cg_f64.py``.

The same inputs, made with numpy from a seed, go through the reference (JAX
on the CPU, Pallas off) and the port (CPU).  The operator, the rhs and the
vectors' storage are built in closed form by both and must agree exactly;
dots and norms agree to rtol 1e-10 in float64 and 1e-4 in float32 (only
the summation order differs).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partitionedarrays_tpu import config as jax_config
from partitionedarrays_tpu.backends import SerialBackend as JaxSerialBackend
from partitionedarrays_tpu.models.hpcg.driver import hpcg_benchmark as jax_hpcg_benchmark
from partitionedarrays_tpu.models.hpcg.problem import build_hpcg_problem as jax_build
from partitionedarrays_tpu.parallel.p_range import PRange as JaxPRange
from partitionedarrays_tpu.parallel.p_range import uniform_partition as jax_uniform_partition

from partitionedarrays_tpu_torch import pvector
from partitionedarrays_tpu_torch.backends import SerialBackend
from partitionedarrays_tpu_torch.config import torch_dtype
from partitionedarrays_tpu_torch.models.hpcg.driver import hpcg_benchmark
from partitionedarrays_tpu_torch.models.hpcg.problem import build_hpcg_problem
from partitionedarrays_tpu_torch.parallel.exchange_plan import ExchangePlan, layout_of
from partitionedarrays_tpu_torch.parallel.partition import PRange, uniform_partition

# the reference's module (its package exports a function of the same name)
jax_pvector = importlib.import_module("partitionedarrays_tpu.pvector")

torch.set_num_threads(1)

RTOL = {np.float32: 1e-4, np.float64: 1e-10}


@pytest.fixture(scope="module", autouse=True)
def reference_without_pallas():
    saved = jax_config.use_pallas
    jax_config.use_pallas = False
    yield
    jax_config.use_pallas = saved


@pytest.mark.parametrize("parts, grid", [((1, 1, 1), (8, 8, 8)), ((2, 3, 1), (5, 7, 4))])
def test_partition_matches_jax(parts, grid):
    """Box geometry, remainders included, as the reference's partition."""
    mine = uniform_partition(parts, grid)
    ref = jax_uniform_partition(parts, grid)
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a.own_to_global, b.own_to_global)
        assert a.n_own == b.n_own


@pytest.mark.parametrize("grid", [(8, 8, 8), (5, 7, 4)])
def test_layout_matches_jax_and_plans_have_no_rounds(grid):
    """Padded sizes as the reference's layout; with one part the exchange
    plans have zero rounds and ``apply`` hands back its destination."""
    lay = layout_of(PRange(uniform_partition((1, 1, 1), grid)))
    ref = jax_pvector.pvector_layout(JaxPRange(jax_uniform_partition((1, 1, 1), grid)))
    assert (lay.n_parts, lay.n_own_pad, lay.n_ghost_pad) == (
        ref.n_parts, ref.n_own_pad, ref.n_ghost_pad,
    )
    dst = torch.zeros(1, lay.n_ghost_pad)
    for plan in (lay.assemble_plan, lay.consistent_plan):
        assert plan.n_rounds == 0
        assert plan.apply(torch.ones(1, lay.n_own_pad), dst, "set") is dst
    with pytest.raises(NotImplementedError, match="ROADMAP slice B"):
        ExchangePlan(perms=[[(0, 1)]]).apply(dst, dst, "add")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pvector_core_matches_jax(dtype):
    """pzeros, pones, pvector_from_own, axpy (exact storage, padding at
    zero) and pdot, pnorm (to RTOL) on a box whose size is not a multiple
    of the padding."""
    grid = (5, 7, 4)
    pr = PRange(uniform_partition((1, 1, 1), grid))
    pr_ref = JaxPRange(jax_uniform_partition((1, 1, 1), grid))
    be, be_ref = SerialBackend(1), JaxSerialBackend(1)
    rng = np.random.default_rng(30)
    own = [rng.standard_normal(int(np.prod(grid))).astype(dtype) for _ in range(2)]
    x = pvector.pvector_from_own([own[0]], pr, be)
    y = pvector.pvector_from_own([own[1]], pr, be)
    x_ref = jax_pvector.pvector_from_own([own[0]], pr_ref, be_ref)
    y_ref = jax_pvector.pvector_from_own([own[1]], pr_ref, be_ref)
    pairs = [
        (pvector.pzeros(pr, be, dtype=dtype), jax_pvector.pzeros(pr_ref, be_ref, dtype=dtype)),
        (pvector.pones(pr, be, dtype=dtype), jax_pvector.pones(pr_ref, be_ref, dtype=dtype)),
        (x, x_ref),
        (pvector.axpy(0.5, x, y), jax_pvector.axpy(jnp.asarray(0.5, dtype), x_ref, y_ref)),
    ]
    for mine, ref in pairs:
        assert mine.own.dtype == torch_dtype(dtype)
        np.testing.assert_array_equal(mine.own.numpy(), np.asarray(ref.own))
        np.testing.assert_array_equal(mine.ghost.numpy(), np.asarray(ref.ghost))
    rtol = RTOL[dtype]
    np.testing.assert_allclose(
        pvector.pdot(x, y).item(), float(jax_pvector.pdot(x_ref, y_ref)), rtol=rtol
    )
    np.testing.assert_allclose(pvector.pnorm(x).item(), float(jax_pvector.pnorm(x_ref)), rtol=rtol)


@pytest.mark.parametrize("shape", [(8, 8, 8), (16, 16, 16), (4, 6, 2)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_problem_matches_jax(shape, dtype):
    """The closed-form operator and rhs equal the reference's exactly."""
    A_ref, b_ref = jax_build(shape, (1, 1, 1), JaxSerialBackend(1), dtype=dtype)
    A, b = build_hpcg_problem(shape, (1, 1, 1), SerialBackend(1), dtype=dtype)
    assert A.device().oo.offsets == A_ref.device().oo.offsets
    np.testing.assert_array_equal(A.device().oo.vals.numpy(), np.asarray(A_ref.device().oo.vals))
    np.testing.assert_array_equal(b.own.numpy(), np.asarray(b_ref.own))
    assert A.nnz() == A_ref.nnz()
    assert A.shape == A_ref.shape


@pytest.fixture(scope="module")
def jax_report_keys():
    """The reference report's keys (a 1-level, 1-iteration run: the keys do
    not depend on the configuration, and a larger one costs a long jit)."""
    return set(
        jax_hpcg_benchmark(
            None, local_shape=(8, 8, 8), parts_per_dir=(1, 1, 1), n_levels=1,
            iterations=1, ref_sets=1, timed_sets=1, dtype=np.float64,
        ).summary()
    )


@pytest.mark.parametrize("total_runtime, window", [(None, "measured_sets"), (0.05, "executed")])
def test_benchmark_report_matches_jax_keys(jax_report_keys, total_runtime, window):
    mine = hpcg_benchmark(
        None, local_shape=(8, 8, 8), parts_per_dir=(1, 1, 1), n_levels=2,
        iterations=10, ref_sets=1, timed_sets=1, dtype=np.float64,
        total_runtime=total_runtime,
    ).summary()
    assert set(mine) == jax_report_keys
    assert mine["validation_passed"] and mine["chain_consistent"]
    assert mine["final_relres"] < 1e-9
    assert (mine["nrow"], mine["levels"], mine["dtype"]) == (512, 2, "float64")
    assert mine["phase3_window"] == window and mine["sets"] >= 1
