"""The reference-name aliases of the port's HPCG package against the JAX
reference's (``partitionedarrays_tpu/models/hpcg/__init__.py``): the
sequential and the partitioned 27-point problem and the injection table
bit for bit, one V-cycle of ``pc_setup``/``pc_solve`` at 4^3 on 2 levels in
float64 within rtol 1e-10 (only the summation order differs; the reference
runs with Pallas off), the CG aliases and the debug driver."""
import numpy as np
import pytest
import torch

from partitionedarrays_tpu import config as jax_config
from partitionedarrays_tpu.backends import SerialBackend as JaxSerialBackend
from partitionedarrays_tpu.models import hpcg as jax_hpcg

from partitionedarrays_tpu_torch.backends import SerialBackend
from partitionedarrays_tpu_torch.models import hpcg

torch.set_num_threads(1)


@pytest.mark.parametrize("gshape", [(4, 4, 4), (3, 5, 6)])
@pytest.mark.parametrize("dtype", [None, np.float32])
def test_build_matrix_equals_jax(gshape, dtype):
    A, b = hpcg.build_matrix(gshape, dtype)
    R, rb = jax_hpcg.build_matrix(gshape, dtype)
    assert A.dtype == R.dtype and A.shape == R.shape
    for name in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(A, name), getattr(R, name))
    np.testing.assert_array_equal(b, rb)


@pytest.mark.parametrize("box", [(8, 8, 8), (4, 6, 2)])
def test_restrict_operator_equals_jax(box):
    got = hpcg.restrict_operator(*box)
    want = jax_hpcg.restrict_operator(*box)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_restrict_operator_refuses_an_odd_box():
    with pytest.raises(ValueError):
        hpcg.restrict_operator(4, 3, 4)


def test_hpcg_triplets_for_box_equals_jax():
    rows = np.arange(10, 40)
    for got, want in zip(hpcg.hpcg_triplets_for_box(rows, (4, 5, 6)),
                         jax_hpcg.hpcg_triplets_for_box(rows, (4, 5, 6))):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("parts", [(1, 1, 1), (2, 1, 2)])
def test_build_p_matrix_equals_jax(parts):
    P = int(np.prod(parts))
    A, b = hpcg.build_p_matrix(parts, (4, 4, 4), SerialBackend(P), device="cpu")
    R, rb = jax_hpcg.build_p_matrix(parts, (4, 4, 4), JaxSerialBackend(P))
    assert A.dtype == torch.float64 and A.nnz() == R.nnz()
    np.testing.assert_array_equal(A.device().oo.vals.numpy(), np.asarray(R.device().oo.vals))
    np.testing.assert_array_equal(b.own.numpy(), np.asarray(rb.own))


def test_pc_solve_of_pc_setup_matches_jax():
    saved = jax_config.use_pallas
    jax_config.use_pallas = False
    try:
        ref = jax_hpcg.pc_setup((4, 4, 4), (1, 1, 1), JaxSerialBackend(1), n_levels=2)
        want = np.asarray(jax_hpcg.pc_solve(ref, ref.b).own)
    finally:
        jax_config.use_pallas = saved
    mg = hpcg.pc_setup((4, 4, 4), (1, 1, 1), SerialBackend(1), n_levels=2, device="cpu")
    assert mg.A.dtype == torch.float64
    got = hpcg.pc_solve(mg, mg.b).own.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10 * np.abs(want).max())


def test_cg_aliases_are_the_preconditioned_cg():
    """Both packages map ``ref_cg`` and ``opt_cg`` to their HPCG CG, which
    ``test_torch_hpcg_cg_{f32,f64}.py`` hold against each other."""
    assert hpcg.ref_cg is hpcg.opt_cg is hpcg.hpcg_cg
    assert jax_hpcg.ref_cg is jax_hpcg.opt_cg is jax_hpcg.hpcg_cg
    mg = hpcg.pc_setup((8, 8, 8), (1, 1, 1), SerialBackend(1), n_levels=3, device="cpu")
    _, norms = hpcg.ref_cg(mg.A, mg.b, M=mg, iterations=10)
    assert norms[-1] / norms[0] < 1e-9


def test_hpcg_benchmark_debug_runs_on_the_serial_backend():
    r = hpcg.hpcg_benchmark_debug(
        n_parts=8, local_shape=(4, 4, 4), parts_per_dir=(2, 2, 2), n_levels=2, iterations=5,
        ref_sets=1, timed_sets=1, device="cpu",
    ).summary()
    assert r["parts_per_dir"] == [2, 2, 2] and r["validation_passed"]
