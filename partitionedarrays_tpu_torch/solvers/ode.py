"""Implicit one-stage ODE schemes.

Counterpart of ``partitionedarrays_tpu/solvers/ode.py`` (all of it):
``single_stage_solver`` and ``backward_euler``.  Each step solves
residual(t_{n+1}, x, (x - x_n) / dt) = 0 by ``newton_raphson``, with the
Jacobian weights (a_x, a_v) = (1, 1/dt) for backward Euler.
"""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

from ..pvector import PVector
from .interfaces import LinearSolverBase, NonlinearProblem, ODEProblem
from .nonlinear import newton_raphson


def single_stage_solver(
    problem: ODEProblem,
    dt: float,
    scheme: Tuple[float, float] = (1.0, None),
    solver: Optional[LinearSolverBase] = None,
    rtol: float = 1e-8,
    maxiters: int = 20,
) -> Iterator[Tuple[float, PVector]]:
    """Yields (t, x) after each implicit step; ``scheme`` is (a_x, a_v),
    a_v None meaning 1/dt."""
    a_x, a_v = scheme
    if a_v is None:
        a_v = 1.0 / dt
    t0, t1 = problem.interval
    x = problem.x0
    t = t0
    while t < t1 - 1e-12:
        t_next = min(t + dt, t1)
        x_old = x

        def residual(xn):
            return problem.residual(t_next, xn, _scale_diff(xn, x_old, 1.0 / dt))

        def jacobian(xn):
            return problem.jacobian(t_next, xn, _scale_diff(xn, x_old, 1.0 / dt), (a_x, a_v))

        x, _ = newton_raphson(NonlinearProblem(residual, jacobian, x), solver=solver, rtol=rtol,
                              maxiters=maxiters)
        t = t_next
        yield t, x


def backward_euler(
    problem: ODEProblem,
    dt: float,
    solver: Optional[LinearSolverBase] = None,
    **kw,
) -> Iterator[Tuple[float, PVector]]:
    """``single_stage_solver`` with the weights (1, 1/dt)."""
    return single_stage_solver(problem, dt, scheme=(1.0, 1.0 / dt), solver=solver, **kw)


def _scale_diff(a: PVector, b: PVector, s: float) -> PVector:
    return PVector((a.own - b.own) * s, (a.ghost - b.ghost) * s, a.layout, a.backend)
