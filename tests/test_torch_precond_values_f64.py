"""Reduced-precision preconditioner values under float64 vectors: the
colored Gauss-Seidel state with bfloat16 and with float32 values and the
HPCG MG with ``precond_dtype`` of the PyTorch port against the JAX
reference (the cases and their tolerances: ``torch_precond_values_cases.py``;
test_torch_precond_values_f32.py runs them under float32 vectors), the
port's narrow-valued HPCG against its float64-valued runs, and the pairs
that have no kernel."""
import numpy as np
import pytest
import torch

import torch_precond_values_cases as cases
from partitionedarrays_tpu_torch.backends import SerialBackend
from partitionedarrays_tpu_torch.models.hpcg.cg import hpcg_cg_flat_g
from partitionedarrays_tpu_torch.models.hpcg.driver import hpcg_benchmark
from partitionedarrays_tpu_torch.models.hpcg.mg import HPCGMGPreconditioner

torch.set_num_threads(1)

DTYPE = np.float64


@pytest.fixture(scope="module", params=["bfloat16", "float32"])
def states(request):
    return cases.colored_states(DTYPE, request.param)


@pytest.fixture(scope="module")
def solved():
    return cases.hpcg_solve(DTYPE, "generic")


def test_values_bit_equal_to_jax(states):
    cases.check_values_bit_equal(states)


def test_invd_within_an_ulp_of_jax(states):
    cases.check_invd_within_an_ulp(states)


@pytest.mark.parametrize("order", ["forward", "symmetric"])
@pytest.mark.parametrize("start", ["zero", "random"])
def test_sweeps_core_matches_jax(states, start, order):
    cases.check_sweeps_core(states, start, order)


def test_ax_core_matches_jax(states):
    cases.check_ax_core(states)


def test_sweep_flat_matches_jax(states):
    cases.check_sweep_flat(states)


def test_rounding_is_visible(states):
    cases.check_rounding_is_visible(states)


def test_cg_generic_history_matches_jax(solved):
    cases.check_history_matches_jax(solved)


@pytest.mark.parametrize("route", ["flat", "generic"])
def test_bf16_history_equals_f64_values_history(solved, route):
    _, _, pmg, _ = solved
    full = HPCGMGPreconditioner((16, 16, 16), (1, 1, 1), SerialBackend(1), n_levels=3,
                                dtype=DTYPE, device="cpu")
    narrow = cases.port_history(pmg, route)
    np.testing.assert_array_equal(narrow, cases.port_history(full, route))
    assert narrow[-1] / narrow[0] < 1e-6


@pytest.mark.parametrize("precond, name", [("bfloat16", "bfloat16"), ("float32", "float32"),
                                           (np.float32, "float32"), (torch.bfloat16, "bfloat16")])
def test_hpcg_benchmark_reports_the_values_dtype(precond, name):
    r = hpcg_benchmark(None, local_shape=(8, 8, 8), parts_per_dir=(1, 1, 1), n_levels=3,
                       iterations=10, ref_sets=1, timed_sets=1, dtype=DTYPE,
                       precond_dtype=precond, device="cpu")
    s = r.summary()
    assert s["precond_values_dtype"] == name
    assert s["validation_passed"] and s["chain_consistent"]


def test_flat_g_with_float32_values_equals_float64_values():
    hist = []
    for precond in (None, "float32"):
        mg = HPCGMGPreconditioner((8, 8, 8), (2, 2, 2), SerialBackend(8), n_levels=3,
                                  dtype=DTYPE, precond_dtype=precond, device="cpu")
        hist.append(hpcg_cg_flat_g(mg, mg.b, iterations=10)[1].numpy())
    np.testing.assert_array_equal(hist[1], hist[0])


@pytest.mark.parametrize("dtype, precond", [(np.float32, "float64"), (np.float32, np.float64),
                                            (np.float32, torch.float64)])
def test_pairs_without_a_kernel_raise(dtype, precond):
    """float64 values under float32 vectors, named as a string, a numpy and
    a torch dtype, have no kernel: TypeError before any work (float16
    values have one under either vector dtype:
    ``test_torch_precond_values_f16.py``)."""
    with pytest.raises(TypeError):
        HPCGMGPreconditioner((8, 8, 8), (1, 1, 1), SerialBackend(1), n_levels=2, dtype=dtype,
                             precond_dtype=precond, device="cpu")
