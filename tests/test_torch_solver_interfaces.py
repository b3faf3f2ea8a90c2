"""The solver protocol of the PyTorch port (``solvers/interfaces.py``)
against the JAX reference's, on the HPCG 27-point operator on (2,2,2)
parts of 4^3, float64, with a right-hand side made with numpy from a seed.
The reference runs as JAX on the CPU with Pallas off.  Tolerances: as
``test_torch_krylov.py`` (CG solutions to 1e-9 of their largest entry,
fixed-step smoother solves to 1e-12)."""
import importlib

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from partitionedarrays_tpu import config as jax_config
from partitionedarrays_tpu.backends import SerialBackend as JaxSerialBackend
from partitionedarrays_tpu.models.hpcg.problem import build_hpcg_problem as jax_build
from partitionedarrays_tpu.solvers import interfaces as jax_if

from partitionedarrays_tpu_torch.backends import SerialBackend
from partitionedarrays_tpu_torch.models.hpcg.problem import build_hpcg_problem
from partitionedarrays_tpu_torch.pvector import pvector_from_own
from partitionedarrays_tpu_torch.solvers import interfaces as port_if

jax_pvector = importlib.import_module("partitionedarrays_tpu.pvector")

torch.set_num_threads(1)


# numpy's BLAS on one thread in this module: its idle threads spin, and
# beside the suite's other workers its small dense factorizations (tile
# inverses, QR, LU) then run up to ~30x slower
@pytest.fixture(scope="module", autouse=True)
def reference_without_pallas():
    saved = jax_config.use_pallas
    jax_config.use_pallas = False
    with threadpool_limits(limits=1):
        yield
    jax_config.use_pallas = saved


@pytest.fixture(scope="module")
def problems():
    local, parts = (4, 4, 4), (2, 2, 2)
    A, _ = build_hpcg_problem(local, parts, SerialBackend(8), dtype=np.float64, device="cpu")
    A_ref, _ = jax_build(local, parts, JaxSerialBackend(8), dtype=np.float64)
    rng = np.random.default_rng(43)
    own = [rng.standard_normal(part.n_own) for part in A.row_prange.parts]
    b = pvector_from_own(own, A.row_prange, A.backend, device="cpu")
    b_ref = jax_pvector.pvector_from_own(own, A_ref.row_prange, A_ref.backend)
    return port_if.LinearProblem(A, b), jax_if.LinearProblem(A_ref, b_ref)


def _close(x, x_ref, tol):
    want = np.asarray(x_ref.own)
    np.testing.assert_allclose(x.own.numpy(), want, rtol=0, atol=tol * np.abs(want).max())


SOLVERS = {
    "cg": (dict(rtol=1e-8), 1e-9),
    "jacobi": (dict(iterations=5, omega=0.8), 1e-12),
    "gauss_seidel": (dict(iterations=3), 1e-12),
    "richardson": (dict(iterations=3, omega=0.03), 1e-12),
    "lu": (dict(), 1e-12),  # scipy's splu of the centralized matrix in both
}


@pytest.mark.parametrize("name", list(SOLVERS))
def test_solve_matches_jax(problems, name):
    prob, prob_ref = problems
    kw, tol = SOLVERS[name]
    solver = getattr(port_if, f"{name}_solver")(**kw)
    solver_ref = getattr(jax_if, f"{name}_solver")(**kw)
    x = port_if.solve(solver, prob)
    _close(x, jax_if.solve(solver_ref, prob_ref), tol)
    # smooth: a few more steps from x, as the reference
    _close(port_if.smooth(solver, x, prob),
           jax_if.smooth(solver_ref, jax_if.solve(solver_ref, prob_ref), prob_ref), 1e-9)
    solver.update(prob)
    solver.finalize()


def test_cg_solver_info_and_a_solver_as_preconditioner(problems):
    prob, prob_ref = problems
    inner = port_if.gauss_seidel_solver(iterations=1)
    outer = port_if.cg_solver(rtol=1e-8, M=port_if.preconditioner(inner, prob))
    inner_ref = jax_if.gauss_seidel_solver(iterations=1)
    outer_ref = jax_if.cg_solver(rtol=1e-8, M=jax_if.preconditioner(inner_ref, prob_ref))
    x = port_if.solve(outer, prob)
    x_ref = jax_if.solve(outer_ref, prob_ref)
    assert outer.last_info.iterations == int(outer_ref.last_info.iterations) > 0
    _close(x, x_ref, 1e-9)


def test_history_and_the_unported_solvers(problems):
    prob, prob_ref = problems
    solver = port_if.jacobi_solver(iterations=1, omega=0.8)

    def step(x):
        return port_if.smooth(solver, x, prob)

    x0 = port_if.solve(port_if.jacobi_solver(iterations=0), prob)
    xs = list(port_if.history(step, x0, maxiters=4))
    assert len(xs) == 4
    _close(xs[-1], port_if.solve(port_if.jacobi_solver(iterations=4, omega=0.8), prob), 1e-14)
    # additive_schwarz_solver: three Richardson steps of the dense tier
    # (64 rows a part), as the reference's
    _close(port_if.solve(port_if.additive_schwarz_solver(), prob),
           jax_if.solve(jax_if.additive_schwarz_solver(), prob_ref), 1e-12)
    with pytest.raises(NotImplementedError):
        port_if.LinearSolverBase().solve(prob)


def test_amg_solver_matches_jax():
    """``amg_solver``: two AMG V-cycles as Richardson steps on 2-D
    elasticity (6 x 6 nodes, block size 2, the rigid-body nullspace),
    float64, against the reference's to 1e-10."""
    from partitionedarrays_tpu.models import gallery as jax_gallery
    from partitionedarrays_tpu.parallel.p_range import PRange as JaxPRange
    from partitionedarrays_tpu.solvers.amg import AMGParams as JaxAMGParams

    from partitionedarrays_tpu_torch.models import gallery
    from partitionedarrays_tpu_torch.psparse import psparse
    from partitionedarrays_tpu_torch.solvers.amg import AMGParams

    jax_psparse = importlib.import_module("partitionedarrays_tpu.psparse")
    nodes, parts = (6, 6), (1, 1)
    own = [np.random.default_rng(44).standard_normal(72)]
    probs = []
    for gal, make_A, make_b, iface, Params in (
        (gallery, lambda *t: psparse(*t, SerialBackend(1), device="cpu"),
         lambda A: pvector_from_own(own, A.row_prange, A.backend, device="cpu"), port_if, AMGParams),
        (jax_gallery,
         lambda I, J, V, r, c: jax_psparse.psparse(I, J, V, JaxPRange(r), JaxPRange(c), JaxSerialBackend(1)),
         lambda A: jax_pvector.pvector_from_own(own, A.row_prange, A.backend), jax_if, JaxAMGParams),
    ):
        A = make_A(*gal.linear_elasticity_fem(nodes, parts))
        coords, _ = gal.node_coordinates_unit_cube(nodes, parts)
        ns = gal.nullspace_linear_elasticity(coords, A.row_prange)
        solver = iface.amg_solver(Params(coarse_size=10, block_size=2), ns, iterations=2)
        probs.append(iface.solve(solver, iface.LinearProblem(A, make_b(A))))
    _close(*probs, 1e-10)
