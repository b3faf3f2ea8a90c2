"""The problem / solver protocol.

Counterpart of ``partitionedarrays_tpu/solvers/interfaces.py``, the part
that the ported solvers carry: ``LinearProblem``, ``LinearSolverBase``,
``CGSolver``, ``LUSolver`` (:89-110), ``SmootherSolver``, the constructors
``cg_solver``, ``lu_solver``, ``jacobi_solver``, ``gauss_seidel_solver``
and ``richardson_solver``, and ``solve``, ``preconditioner``, ``smooth``
and ``history``.  A solver has ``solve(problem)``, ``update(problem)``
(same sparsity, new values) and ``finalize()``.  ``amg_solver`` runs
``solvers/amg.py``'s preconditioner as a Richardson iteration, and
``additive_schwarz_solver`` (:173-176) ``smoothers.py::AdditiveSchwarz``.
``NonlinearProblem`` and ``ODEProblem`` (:37-57) are
the problems of ``solvers/nonlinear.py`` and ``solvers/ode.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, Optional

from ..psparse import PSparseMatrix
from ..pvector import PVector, pzeros


@dataclass
class LinearProblem:
    """A x = b."""

    A: PSparseMatrix
    b: PVector
    x0: Optional[PVector] = None
    nullspace: Optional[Any] = None
    attributes: Dict = field(default_factory=dict)


@dataclass
class NonlinearProblem:
    """residual(x) = 0, with its Jacobian matrix at x."""

    residual: Callable[[PVector], PVector]
    jacobian: Callable[[PVector], PSparseMatrix]
    x0: PVector
    attributes: Dict = field(default_factory=dict)


@dataclass
class ODEProblem:
    """residual(t, x, v) = 0 over ``interval``, v = dx/dt, with the Jacobian
    a_x dR/dx + a_v dR/dv for weights ``(a_x, a_v)``."""

    residual: Callable[[float, PVector, PVector], PVector]
    jacobian: Callable[[float, PVector, PVector, tuple], PSparseMatrix]
    x0: PVector
    interval: tuple
    attributes: Dict = field(default_factory=dict)


class LinearSolverBase:
    """The update / solve contract."""

    def solve(self, problem: LinearProblem) -> PVector:
        raise NotImplementedError

    def update(self, problem: LinearProblem) -> None:
        """Matrix values changed at fixed sparsity; refresh caches."""

    def finalize(self) -> None:
        """Release resources."""


class CGSolver(LinearSolverBase):
    def __init__(self, rtol=1e-8, atol=0.0, maxiter=1000, M=None):
        self.rtol, self.atol, self.maxiter, self.M = rtol, atol, maxiter, M
        self.last_info = None

    def solve(self, p: LinearProblem) -> PVector:
        from .krylov import cg

        x, info = cg(
            p.A, p.b, x0=p.x0, M=self.M, rtol=self.rtol, atol=self.atol,
            maxiter=self.maxiter,
        )
        self.last_info = info
        return x


class LUSolver(LinearSolverBase):
    """A sparse LU of the centralized matrix on the host (scipy's
    ``splu``): the reference's fallback for debugging and small systems.
    The solution returns to b's device.  The factors are redone for
    another matrix and for a matrix refilled in place since
    (``values_version``); the reference keys them on the matrix object
    alone, so a Newton step that refills its Jacobian in place would
    solve with the factors of the first one."""

    def __init__(self):
        self._splu = None
        self._A = None
        self._version = None

    def _factorize(self, A: PSparseMatrix) -> None:
        import scipy.sparse.linalg as spla

        from ..psparse import centralize

        self._splu = spla.splu(centralize(A).tocsc())
        self._A = A
        self._version = A.values_version

    def solve(self, p: LinearProblem) -> PVector:
        from ..pvector import collect, pvector_from_own

        if self._splu is None or self._A is not p.A or self._version != p.A.values_version:
            self._factorize(p.A)
        xg = self._splu.solve(collect(p.b))
        parts = [xg[li.own_to_global] for li in p.A.row_prange.parts]
        return pvector_from_own(parts, p.A.row_prange, p.b.backend, dtype=xg.dtype,
                                device=p.b.own.device)

    def update(self, p: LinearProblem) -> None:
        self._factorize(p.A)


class SmootherSolver(LinearSolverBase):
    """A preconditioner built from the matrix (``make_M(A)``), run as
    ``iterations`` Richardson steps."""

    def __init__(self, make_M, iterations=10, omega=1.0):
        self.make_M = make_M
        self.iterations = iterations
        self.omega = omega
        self._M = None
        self._A = None
        self._version = None

    def _get_M(self, A):
        """The preconditioner of A, rebuilt for another matrix or for one
        refilled in place since (``values_version``)."""
        if self._M is None or self._A is not A or self._version != A.values_version:
            self._M = self.make_M(A)
            self._A = A
            self._version = A.values_version
        return self._M

    def solve(self, p: LinearProblem) -> PVector:
        from .krylov import richardson_iteration

        M = self._get_M(p.A)
        x = p.x0 if p.x0 is not None else pzeros(
            p.A.row_prange, p.b.backend, dtype=p.b.own.dtype, device=p.b.own.device
        )
        return richardson_iteration(
            p.A, p.b, x, omega=self.omega, M=M, iterations=self.iterations
        )


def cg_solver(**kw) -> CGSolver:
    return CGSolver(**kw)


def jacobi_solver(iterations=10, omega=1.0) -> SmootherSolver:
    from .smoothers import JacobiCorrection

    return SmootherSolver(JacobiCorrection, iterations, omega)


def gauss_seidel_solver(iterations=10, sweep="symmetric") -> SmootherSolver:
    from .smoothers import GaussSeidel

    return SmootherSolver(lambda A: GaussSeidel(A, 1, sweep), iterations)


def richardson_solver(iterations=10, omega=1.0) -> SmootherSolver:
    return SmootherSolver(lambda A: (lambda r: r), iterations, omega)


def lu_solver() -> LUSolver:
    return LUSolver()


def additive_schwarz_solver(iterations=3, local_solver=None) -> SmootherSolver:
    from .smoothers import AdditiveSchwarz

    return SmootherSolver(lambda A: AdditiveSchwarz(A, local_solver), iterations)


def amg_solver(params=None, nullspace=None, iterations=1) -> SmootherSolver:
    from .amg import AMGPreconditioner

    return SmootherSolver(lambda A: AMGPreconditioner(A, params, nullspace), iterations)


def solve(solver: LinearSolverBase, problem: LinearProblem) -> PVector:
    return solver.solve(problem)


def preconditioner(solver: LinearSolverBase, problem: LinearProblem):
    """Any solver as a preconditioner callable r -> M(r)."""

    def M(r: PVector) -> PVector:
        return solver.solve(LinearProblem(problem.A, r))

    return M


def smooth(solver: LinearSolverBase, x: PVector, problem: LinearProblem) -> PVector:
    """Improve x in place of a full solve."""
    return solver.solve(LinearProblem(problem.A, problem.b, x0=x))


def history(
    step: Callable[[PVector], PVector], x0: PVector, maxiters: int = 100
) -> Iterator[PVector]:
    """The lazy history of iterates x_{k+1} = step(x_k)."""
    x = x0
    for _ in range(maxiters):
        x = step(x)
        yield x
