"""Reduced-precision preconditioner values under float32 vectors: the
colored Gauss-Seidel state with bfloat16 values and the HPCG MG with
``precond_dtype`` of the PyTorch port against the JAX reference (the cases
and their tolerances: ``torch_precond_values_cases.py``;
test_torch_precond_values_f64.py runs them under float64 vectors), and the
port's bfloat16-valued HPCG on every CG route against its float32-valued
runs, equal on the CPU since HPCG's values are exact in bfloat16."""
import numpy as np
import pytest
import torch

import torch_precond_values_cases as cases
from partitionedarrays_tpu_torch.backends import SerialBackend
from partitionedarrays_tpu_torch.models.hpcg.cg import hpcg_cg_df64, hpcg_cg_flat_g
from partitionedarrays_tpu_torch.models.hpcg.driver import cg_route, df64_problem, hpcg_benchmark
from partitionedarrays_tpu_torch.models.hpcg.mg import HPCGMGPreconditioner
from partitionedarrays_tpu_torch.models.hpcg.problem import build_hpcg_problem
from partitionedarrays_tpu_torch.solvers.smoothers import GaussSeidel

torch.set_num_threads(1)

DTYPE = np.float32


@pytest.fixture(scope="module")
def states():
    return cases.colored_states(DTYPE, "bfloat16")


@pytest.fixture(scope="module")
def solved():
    return cases.hpcg_solve(DTYPE, "flat")


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


def test_cg_flat_history_matches_jax(solved):
    cases.check_history_matches_jax(solved)


@pytest.mark.parametrize("route", ["flat", "generic"])
def test_bf16_history_equals_f32_values_history(solved, route):
    """The reference's levels as bfloat16 and as float32 values: HPCG's 26
    and -1 are exact in bfloat16, so the two histories are equal."""
    _, _, pmg, _ = solved
    full = HPCGMGPreconditioner((16, 16, 16), (1, 1, 1), SerialBackend(1), n_levels=3,
                                dtype=DTYPE, device="cpu")
    narrow = cases.port_history(pmg, route)
    np.testing.assert_array_equal(narrow, cases.port_history(full, route))
    assert narrow[-1] / narrow[0] < 1e-6


def test_hpcg_benchmark_reports_bfloat16():
    r = hpcg_benchmark(None, local_shape=(16, 16, 16), parts_per_dir=(1, 1, 1), n_levels=3,
                       iterations=10, ref_sets=1, timed_sets=1, precond_dtype="bfloat16",
                       device="cpu")
    s = r.summary()
    assert s["precond_values_dtype"] == "bfloat16"
    assert s["validation_passed"] and s["chain_consistent"] and s["final_relres"] < 1e-6


@pytest.mark.parametrize("route", ["flat_g", "df64"])
def test_other_routes_equal_their_full_value_runs(route):
    """``flat_g`` on (2,2,2) parts of 8^3 and ``df64`` at 8^3 with the
    bfloat16-valued float32 MG: each set's history equals the run without
    ``precond_dtype``, and ``hpcg_benchmark`` reports the dtype."""
    parts = (2, 2, 2) if route == "flat_g" else (1, 1, 1)
    P = int(np.prod(parts))
    precision = "df64" if route == "df64" else None
    hist = {}
    for precond in (None, "bfloat16"):
        mg = HPCGMGPreconditioner((8, 8, 8), parts, SerialBackend(P), n_levels=3,
                                  dtype=DTYPE, precond_dtype=precond, device="cpu")
        assert cg_route(mg, precision) == route
        if route == "df64":
            A, b = df64_problem((8, 8, 8), parts, mg.backend, "cpu")
            hist[precond] = hpcg_cg_df64(A, b, M=mg, iterations=10)[1].numpy()
        else:
            hist[precond] = hpcg_cg_flat_g(mg, mg.b, iterations=10)[1].numpy()
        r = hpcg_benchmark(None, local_shape=(8, 8, 8), parts_per_dir=parts, n_levels=3,
                           iterations=10, ref_sets=1, timed_sets=1, mg=mg, precision=precision,
                           device="cpu").summary()
        assert r["precond_values_dtype"] == precond and r["validation_passed"]
    np.testing.assert_array_equal(hist["bfloat16"], hist[None])


def test_refresh_values_keeps_bfloat16():
    """The AMG ``update`` leg re-de-interleaves new values in the storage
    dtype: a bfloat16 smoother stays bfloat16, rounded from the new ones."""
    A, _ = build_hpcg_problem((8, 8, 8), (1, 1, 1), SerialBackend(1), dtype=DTYPE, device="cpu")
    gs = GaussSeidel(A, values_dtype=torch.bfloat16)
    B = A * (1.0 + 2.0 ** -12)  # 26 (1 + 2^-12) is not exact in bfloat16
    gs.refresh_values(B)
    assert gs.colored.vals_d.dtype == torch.bfloat16
    want = GaussSeidel(B, values_dtype=torch.bfloat16).colored
    assert torch.equal(gs.colored.vals_d, want.vals_d)
    assert torch.equal(gs.colored.invd_d, want.invd_d)
    assert gs.colored.invd_d.dtype == torch.float32
