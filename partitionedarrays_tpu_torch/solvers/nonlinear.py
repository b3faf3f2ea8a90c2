"""Newton-Raphson for nonlinear problems.

Counterpart of ``partitionedarrays_tpu/solvers/nonlinear.py``:
``NewtonInfo``, ``newton_raphson`` and ``_match_layout`` (:1-70), the
general tier whose Jacobians are re-assembled on the host through the
reuse caches (``psparse_refill``, ``psystem_refill``).  The reference's
``newton_krylov`` differentiates the residual through the kernels with
``jax.jvp``; the port would need forward derivatives of K1 and K5, and it
raises (ROADMAP Queue 1 step 11).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..pvector import PVector, axpy, pnorm
from .interfaces import LinearProblem, LinearSolverBase, NonlinearProblem, lu_solver


@dataclass
class NewtonInfo:
    iterations: int
    res_norm: float
    dx_norm: float
    converged: bool
    trace: list


def newton_raphson(
    problem: NonlinearProblem,
    solver: Optional[LinearSolverBase] = None,
    rtol: float = 1e-8,
    atol: float = 1e-12,
    dx_atol: float = 0.0,
    maxiters: int = 20,
    verbose: bool = False,
):
    """x -= J(x)^-1 r(x) until |r| <= max(rtol |r0|, atol) or |dx| <=
    ``dx_atol``, at most ``maxiters`` times; each step solves
    ``LinearProblem(J, r)`` with ``solver`` (default: the host LU).
    Returns (x, NewtonInfo)."""
    solver = solver or lu_solver()
    x = problem.x0
    r = problem.residual(x)
    r0 = float(pnorm(r))
    tol = max(rtol * r0, atol)
    trace = [(0, r0, np.nan)]
    if verbose:
        print(f"{'iter':>5} {'|r|':>12} {'|dx|':>12}")
        print(f"{0:5d} {r0:12.4e} {'':>12}")
    rn = r0
    dxn = np.inf
    it = 0
    for it in range(1, maxiters + 1):
        if rn <= tol or dxn <= dx_atol:
            break
        J = problem.jacobian(x)
        dx = solver.solve(LinearProblem(J, r))
        x = axpy(-1.0, _match_layout(dx, x), x)
        r = problem.residual(x)
        rn = float(pnorm(r))
        dxn = float(pnorm(dx))
        trace.append((it, rn, dxn))
        if verbose:
            print(f"{it:5d} {rn:12.4e} {dxn:12.4e}")
    converged = rn <= tol
    return x, NewtonInfo(it, rn, dxn, converged, trace)


def _match_layout(v: PVector, like: PVector) -> PVector:
    """v's own values on ``like``'s layout (ghosts zero)."""
    if v.layout is like.layout:
        return v
    return PVector(v.own, torch.zeros_like(like.ghost), like.layout, like.backend)


def newton_krylov(*args, **kwargs):
    raise NotImplementedError(
        "newton_krylov (a Jacobian-free Newton through forward derivatives of K1 and K5): "
        "ROADMAP Queue 1 step 11"
    )
