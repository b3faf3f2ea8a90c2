"""The Krylov layer of the PyTorch port against the JAX reference: ``cg``
and ``pipelined_cg`` with no preconditioner, ``JacobiCorrection`` and
``GaussSeidel``; ``richardson_iteration`` and ``jacobi``; the 5-argument
``spmv`` that their residuals use.

Operators: the HPCG 27-point matrix on one part of 8^3 and on (2,2,2)
parts of 4^3 (ghost exchange), float64, built in closed form by both
packages (they agree exactly, ``test_torch_hpcg.py``); right-hand sides
made with numpy from seeds.  The reference runs as JAX on the CPU with
Pallas off.  Tolerances: iteration counts equal; solutions to 1e-9 of
their largest entry (the solves stop at rtol 1e-8 and only the summation
order of the dots differs); fixed-step iterations (Richardson, Jacobi) to
1e-12.  ``cg_df64`` is in ``test_torch_krylov_df64.py``.
"""
import importlib

import numpy as np
import pytest
import torch

from partitionedarrays_tpu import config as jax_config
from partitionedarrays_tpu.backends import SerialBackend as JaxSerialBackend
from partitionedarrays_tpu.models.hpcg.problem import build_hpcg_problem as jax_build
from partitionedarrays_tpu.psparse import spmv as jax_spmv
from partitionedarrays_tpu.solvers import krylov as jax_krylov
from partitionedarrays_tpu.solvers import smoothers as jax_smoothers

from partitionedarrays_tpu_torch.backends import SerialBackend
from partitionedarrays_tpu_torch.models.hpcg.problem import build_hpcg_problem
from partitionedarrays_tpu_torch.psparse import spmv
from partitionedarrays_tpu_torch.pvector import pvector_from_own
from partitionedarrays_tpu_torch.solvers import krylov
from partitionedarrays_tpu_torch.solvers.smoothers import GaussSeidel, JacobiCorrection, jacobi

jax_pvector = importlib.import_module("partitionedarrays_tpu.pvector")

torch.set_num_threads(1)

CONFIGS = {"one_part": ((8, 8, 8), (1, 1, 1)), "ghosted": ((4, 4, 4), (2, 2, 2))}


@pytest.fixture(scope="module", autouse=True)
def reference_without_pallas():
    saved = jax_config.use_pallas
    jax_config.use_pallas = False
    yield
    jax_config.use_pallas = saved


def problem(config, seed=40):
    """(port A, port b, reference A, reference b, own parts of b)."""
    local, parts = CONFIGS[config]
    P = int(np.prod(parts))
    A, _ = build_hpcg_problem(local, parts, SerialBackend(P), dtype=np.float64, device="cpu")
    A_ref, _ = jax_build(local, parts, JaxSerialBackend(P), dtype=np.float64)
    rng = np.random.default_rng(seed)
    own = [rng.standard_normal(part.n_own) for part in A.row_prange.parts]
    b = pvector_from_own(own, A.row_prange, A.backend, device="cpu")
    b_ref = jax_pvector.pvector_from_own(own, A_ref.row_prange, A_ref.backend)
    return A, b, A_ref, b_ref, own


PRECONDITIONERS = {
    "none": (lambda A: None, lambda A: None),
    "jacobi": (JacobiCorrection, jax_smoothers.JacobiCorrection),
    "gauss_seidel": (GaussSeidel, jax_smoothers.GaussSeidel),
}


def _assert_same_solution(x, x_ref, tol):
    got, want = x.own.numpy(), np.asarray(x_ref.own)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("pc", list(PRECONDITIONERS))
@pytest.mark.parametrize("solver", ["cg", "pipelined_cg"])
def test_cg_matches_jax(solver, pc, config):
    A, b, A_ref, b_ref, _ = problem(config)
    make, make_ref = PRECONDITIONERS[pc]
    x, info = getattr(krylov, solver)(A, b, M=make(A), rtol=1e-8)
    x_ref, info_ref = getattr(jax_krylov, solver)(A_ref, b_ref, M=make_ref(A_ref), rtol=1e-8)
    assert info.iterations == int(info_ref.iterations) > 0
    np.testing.assert_allclose(info.residual.item(), float(info_ref.residual), rtol=1e-6)
    assert x.layout is A.row_layout()
    _assert_same_solution(x, x_ref, 1e-9)
    r = b.own - spmv(A, x).own
    assert torch.linalg.vector_norm(r) <= 1e-8 * torch.linalg.vector_norm(b.own)


def test_cg_stops_at_maxiter_and_takes_x0():
    A, b, A_ref, b_ref, own = problem("ghosted")
    x, info = krylov.cg(A, b, rtol=1e-14, maxiter=3)
    x_ref, info_ref = jax_krylov.cg(A_ref, b_ref, rtol=1e-14, maxiter=3)
    assert info.iterations == int(info_ref.iterations) == 3
    _assert_same_solution(x, x_ref, 1e-12)
    # restart from there: the reference's count again
    x2, info2 = krylov.cg(A, b, x0=x, rtol=1e-8)
    x2_ref, info2_ref = jax_krylov.cg(A_ref, b_ref, x0=x_ref, rtol=1e-8)
    assert info2.iterations == int(info2_ref.iterations)
    _assert_same_solution(x2, x2_ref, 1e-9)
    # atol alone stops at the first iterate below it
    _, info3 = krylov.cg(A, b, rtol=0.0, atol=1e-3)
    _, info3_ref = jax_krylov.cg(A_ref, b_ref, rtol=0.0, atol=1e-3)
    assert info3.iterations == int(info3_ref.iterations)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_richardson_and_jacobi_match_jax(config):
    A, b, A_ref, b_ref, _ = problem(config)
    x0 = pvector_from_own(
        [np.full(p.n_own, 0.1) for p in A.row_prange.parts], A.row_prange, A.backend, device="cpu"
    )
    x0_ref = jax_pvector.pvector_from_own(
        [np.full(p.n_own, 0.1) for p in A.row_prange.parts], A_ref.row_prange, A_ref.backend
    )
    got = krylov.richardson_iteration(A, b, x0, omega=0.8, M=JacobiCorrection(A), iterations=5)
    want = jax_krylov.richardson_iteration(
        A_ref, b_ref, x0_ref, omega=0.8, M=jax_smoothers.JacobiCorrection(A_ref), iterations=5
    )
    _assert_same_solution(got, want, 1e-12)
    got = jacobi(A, b, x0, iterations=4, omega=0.7)
    want = jax_smoothers.jacobi(A_ref, b_ref, x0_ref, iterations=4, omega=0.7)
    _assert_same_solution(got, want, 1e-12)
    got = krylov.richardson_iteration(A, b, x0, omega=0.03, iterations=3)
    want = jax_krylov.richardson_iteration(A_ref, b_ref, x0_ref, omega=0.03, iterations=3)
    _assert_same_solution(got, want, 1e-12)


def test_jacobi_correction_is_the_inverse_diagonal():
    A, b, A_ref, b_ref, _ = problem("ghosted")
    got = JacobiCorrection(A)(b).own.numpy()
    want = np.asarray(jax_smoothers.JacobiCorrection(A_ref)(b_ref).own)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_five_argument_spmv_matches_jax(config):
    A, b, A_ref, b_ref, own = problem(config, seed=41)
    y = pvector_from_own([o[::-1].copy() for o in own], A.row_prange, A.backend, device="cpu")
    y_ref = jax_pvector.pvector_from_own([o[::-1].copy() for o in own], A_ref.row_prange,
                                         A_ref.backend)
    x = krylov._as_col_vector(A, b)
    x_ref = jax_krylov._as_col_vector(A_ref, b_ref)
    for kw, kw_ref in (
        (dict(alpha=-2.0, beta=0.5, y=y), dict(alpha=-2.0, beta=0.5, y=y_ref)),
        (dict(y=y), dict(y=y_ref)),
        (dict(alpha=3.0), dict(alpha=3.0)),
    ):
        got = spmv(A, x, **kw).own.numpy()
        want = np.asarray(jax_spmv(A_ref, x_ref, **kw_ref).own)
        np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13 * np.abs(want).max())
    # the residual of the solvers is b - A x exactly
    r = krylov._residual(A, b, krylov._as_row_vector(A, x)).own
    assert torch.equal(r, b.own - spmv(A, x).own)
