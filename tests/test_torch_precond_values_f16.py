"""float16 preconditioner values under float32 and float64 vectors: the
colored Gauss-Seidel state with float16 values of the PyTorch port against
the JAX reference (Pallas off; the cases and their tolerances:
``torch_precond_values_cases.py``, random values, since HPCG's own are
exact in float16), and the port's float16-valued HPCG on every CG route
against its full-valued runs, equal on the CPU since HPCG's values are
exact in float16."""
import numpy as np
import pytest
import torch

import torch_precond_values_cases as cases
from partitionedarrays_tpu_torch import _build
from partitionedarrays_tpu_torch.backends import SerialBackend
from partitionedarrays_tpu_torch.models.hpcg.cg import hpcg_cg_df64, hpcg_cg_flat_g
from partitionedarrays_tpu_torch.models.hpcg.driver import cg_route, df64_problem, hpcg_benchmark
from partitionedarrays_tpu_torch.models.hpcg.mg import HPCGMGPreconditioner
from partitionedarrays_tpu_torch.models.hpcg.problem import build_hpcg_problem
from partitionedarrays_tpu_torch.solvers.gs_dia import round_values
from partitionedarrays_tpu_torch.solvers.smoothers import GaussSeidel

torch.set_num_threads(1)

DTYPES = {"f32": np.float32, "f64": np.float64}


@pytest.fixture(scope="module", params=list(DTYPES))
def states(request):
    return cases.colored_states(DTYPES[request.param], "float16")


def test_float16_pairs_have_kernels():
    for vectors in (torch.float32, torch.float64):
        assert (torch.float16, vectors) in _build.NARROW_PAIRS
        _build.check_pair("test", torch.float16, vectors)
        assert _build._suffix(torch.float16, vectors) in _build._SUFFIXES["pat_gs_sweeps"]


def test_round_values_rounds_float64_to_float16_once():
    """float64 values just above and below the midpoint of two float16
    neighbours round to nearest float16 as numpy and JAX round them, once;
    torch's own cast rounds through float32, which lands on the midpoint
    and then on the even neighbour, wrong in half of these cases."""
    rng = np.random.default_rng(16)
    lo = rng.uniform(0.5, 40.0, 4096).astype(np.float16)
    hi = np.nextafter(lo, np.float16(np.inf))
    mid = (lo.astype(np.float64) + hi.astype(np.float64)) / 2
    vals = np.concatenate([mid * (1 + 2.0 ** -40), mid * (1 - 2.0 ** -40),
                           rng.uniform(-40.0, 40.0, 4096)])
    want = vals.astype(np.float16).view(np.uint16)
    got = round_values(torch.from_numpy(vals), torch.float16)
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16), want)
    twice = torch.from_numpy(vals).to(torch.float16).view(torch.int16).numpy().view(np.uint16)
    assert (twice != want).sum() > 1000
    for dtype in (torch.float32, torch.bfloat16):  # torch's cast, as before
        assert torch.equal(round_values(torch.from_numpy(vals), dtype),
                           torch.from_numpy(vals).to(dtype))


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
    """float16 keeps 11 bits, 8 times bfloat16's 8: under float32 vectors its
    rounding moves the product and the sweep by 3.4e-4 and 4.1e-4 of their
    largest entry, over three times the float32 tolerance (1e-4)."""
    cases.check_rounding_is_visible(states, factor=3.0)


# the df64 route's MG is float32 whatever its dtype, so it runs once
ROUTES = [(d, r) for d in DTYPES for r in ("flat", "generic", "flat_g")] + [("f32", "df64")]


@pytest.mark.parametrize("dtype, route", ROUTES)
def test_history_equals_full_value_history(dtype, route):
    """The float16-valued MG on every CG route (one part of 8^3 for flat,
    generic and df64, (2,2,2) parts of 8^3 for flat_g): each history equals
    the run without ``precond_dtype``, and ``hpcg_benchmark`` reports the
    dtype."""
    parts = (2, 2, 2) if route == "flat_g" else (1, 1, 1)
    P = int(np.prod(parts))
    precision = "df64" if route == "df64" else None
    hist = {}
    for precond in (None, "float16"):
        mg = HPCGMGPreconditioner((8, 8, 8), parts, SerialBackend(P), n_levels=3,
                                  dtype=DTYPES[dtype], precond_dtype=precond, device="cpu")
        if route == "df64":
            A, b = df64_problem((8, 8, 8), parts, mg.backend, "cpu")
            hist[precond] = hpcg_cg_df64(A, b, M=mg, iterations=10)[1].numpy()
        elif route == "flat_g":
            hist[precond] = hpcg_cg_flat_g(mg, mg.b, iterations=10)[1].numpy()
        else:
            hist[precond] = cases.port_history(mg, route)
        r = hpcg_benchmark(None, local_shape=(8, 8, 8), parts_per_dir=parts, n_levels=3,
                           iterations=10, ref_sets=1, timed_sets=1, mg=mg, precision=precision,
                           device="cpu").summary()
        assert r["precond_values_dtype"] == precond and r["validation_passed"]
        if route in ("flat_g", "df64"):
            assert cg_route(mg, precision) == route
    np.testing.assert_array_equal(hist["float16"], hist[None])
    assert hist[None][-1] / hist[None][0] < 1e-3


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_refresh_values_keeps_float16(dtype):
    """A refresh re-de-interleaves new values in the storage dtype: a
    float16 smoother stays float16, rounded from the new values."""
    A, _ = build_hpcg_problem((8, 8, 8), (1, 1, 1), SerialBackend(1), dtype=DTYPES[dtype],
                              device="cpu")
    gs = GaussSeidel(A, values_dtype="float16")
    B = A * (1.0 + 2.0 ** -14)  # 26 (1 + 2^-14) is not exact in float16
    gs.refresh_values(B)
    assert gs.colored.vals_d.dtype == torch.float16
    want = GaussSeidel(B, values_dtype=torch.float16).colored
    assert torch.equal(gs.colored.vals_d, want.vals_d)
    assert torch.equal(gs.colored.invd_d, want.invd_d)
