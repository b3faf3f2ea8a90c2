"""Newton-Raphson for nonlinear problems.

Counterpart of ``partitionedarrays_tpu/solvers/nonlinear.py``:
``NewtonInfo``, ``newton_raphson`` and ``_match_layout`` (:1-70), the
general tier whose Jacobians are re-assembled on the host through the
reuse caches (``psparse_refill``, ``psystem_refill``), and the matrix-free
``newton_krylov`` (:73-207).  Its exact Jacobian-vector product is
forward-mode AD over dual tensors (``torch.autograd.forward_ad``): K1 and
K5 enter the residual through ``ops/blocks.py``'s autograd Functions,
whose tangent is the same kernel launched on the tangent.  The reference
runs both loops on the device (``lax.while_loop``); here they run on the
host and read one norm per inner step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from ..pvector import PVector, axpy, pdot, pnorm
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


def _tangent_of(t: torch.Tensor) -> torch.Tensor:
    """The tangent of a dual tensor; zeros where the value does not depend
    on the input."""
    tan = fwAD.unpack_dual(t).tangent
    return torch.zeros_like(fwAD.unpack_dual(t).primal) if tan is None else tan


def newton_krylov(
    residual_fn,
    x0: PVector,
    M=None,
    rtol: float = 1e-8,
    atol: float = 0.0,
    maxiters: int = 20,
    inner_rtol: float = 1e-4,
    inner_maxiter: int = 100,
    jvp: str = "auto",
):
    """Matrix-free Newton: ``x -= J(x)^-1 r(x)`` until ``|r| <= max(rtol
    |r0|, atol)`` or ``maxiters`` steps, each inner solve a CG on the
    Jacobian-vector product to ``inner_rtol |r|`` or ``inner_maxiter``
    steps.  ``residual_fn``: PVector -> PVector, built from ``spmv`` and
    elementwise tensor ops.  ``jvp="auto"``: the exact product by forward
    AD; ``jvp="fd"``: ``(F(x + eps v) - F(x)) / eps`` with ``eps =
    sqrt(1e-7) (1 + |x|) / max(|v|, 1e-30)`` in the vectors' dtype.  ``M``:
    an optional preconditioner of the inner CG, PVector -> PVector (e.g. a
    ``GaussSeidel`` of a frozen matrix).  Returns ``(x, iterations, |r|)``,
    the last two 0-d tensors."""
    if jvp not in ("auto", "fd"):
        raise ValueError(f"jvp must be 'auto' or 'fd', got {jvp!r}")
    Mfn = M if M is not None else (lambda r: r)

    def rnorm(v: PVector) -> torch.Tensor:
        return torch.sqrt(pdot(v, v))

    def jvp_apply(x: PVector, r_x: PVector, v: PVector) -> PVector:
        if jvp == "fd":
            one = torch.tensor(1e-7, dtype=v.own.dtype, device=v.own.device)
            eps = torch.sqrt(one) * (1.0 + rnorm(x)) / torch.clamp(rnorm(v), min=1e-30)
            rp = residual_fn(PVector(x.own + eps * v.own, x.ghost + eps * v.ghost, x.layout,
                                     x.backend))
            return PVector((rp.own - r_x.own) / eps, (rp.ghost - r_x.ghost) / eps, r_x.layout,
                           r_x.backend)
        with fwAD.dual_level():
            xd = PVector(fwAD.make_dual(x.own, v.own), fwAD.make_dual(x.ghost, v.ghost),
                         x.layout, x.backend)
            r = residual_fn(xd)
            return PVector(_tangent_of(r.own), _tangent_of(r.ghost), r.layout, r.backend)

    def inner_cg(x: PVector, r_x: PVector) -> PVector:
        """Solve J dx = r_x from dx = 0 (the reference's inner loop)."""
        z = Mfn(r_x)
        p = z
        rz = pdot(r_x, z)
        dx = PVector(torch.zeros_like(r_x.own), torch.zeros_like(r_x.ghost), r_x.layout,
                     r_x.backend)
        rr = r_x
        tol_in = inner_rtol * rnorm(r_x)
        k = 0
        while k < inner_maxiter and bool(rnorm(rr) > tol_in):
            Jp = jvp_apply(x, r_x, p)
            alpha = rz / pdot(p, Jp)
            dx = axpy(alpha, p, dx)
            rr = axpy(-alpha, Jp, rr)
            z = Mfn(rr)
            rz_new = pdot(rr, z)
            beta = rz_new / rz
            p = PVector(z.own + beta * p.own, z.ghost + beta * p.ghost, p.layout, p.backend)
            rz = rz_new
            k += 1
        return dx

    x = x0
    r = residual_fn(x)
    rn = rnorm(r)
    tol = torch.clamp(rtol * rn, min=atol)
    k = 0
    while k < maxiters and bool(rn > tol):
        dx = inner_cg(x, r)
        x = axpy(-1.0, _match_layout(dx, x), x)
        r = residual_fn(x)
        rn = rnorm(r)
        k += 1
    return x, torch.tensor(k, dtype=torch.int32), rn
