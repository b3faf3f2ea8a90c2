"""Krylov solvers on partitioned containers.

Counterpart of ``partitionedarrays_tpu/solvers/krylov.py`` (:1-437):
``cg``, ``cg_df64``, ``pipelined_cg`` and ``richardson_iteration``.  The
reference compiles each solve into one ``lax.while_loop`` and keeps a cache
of compiled runners (:78-114); neither carries over.  Here the loop is a
Python loop over device tensors: every scalar of the iteration stays on
the device, and the convergence test is read back once per iteration, so
the iteration counts are the reference's.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..ops import df64 as df
from ..psparse import PSparseMatrix, device_df64, spmv, spmv_df64
from ..pvector import PVector, axpy, pdot, pnorm, pvector_split_df64, pzeros


class CGInfo(NamedTuple):
    iterations: int
    residual: torch.Tensor  # the final |r|_2, a 0-d tensor


def _identity(r: PVector) -> PVector:
    return r


def _zeros_like(v: PVector) -> PVector:
    return PVector(torch.zeros_like(v.own), torch.zeros_like(v.ghost), v.layout, v.backend)


def _tolerance(rtol: float, atol: float, rnorm0: torch.Tensor) -> torch.Tensor:
    return torch.clamp(rtol * rnorm0, min=atol)


def _x0_on_rows(A: PSparseMatrix, b: PVector, x0: Optional[PVector]) -> PVector:
    if x0 is None:
        return pzeros(A.row_prange, b.backend, dtype=b.own.dtype, device=b.own.device)
    return _as_row_vector(A, x0)


def cg(
    A: PSparseMatrix,
    b: PVector,
    x0: Optional[PVector] = None,
    M: Optional[Callable[[PVector], PVector]] = None,
    rtol: float = 1e-8,
    atol: float = 0.0,
    maxiter: int = 1000,
):
    """Preconditioned conjugate gradient; ``M`` applies the preconditioner
    (z = M(r)).  Iterates while ``|r| > max(rtol |r0|, atol)`` and fewer
    than ``maxiter`` iterations ran.  Returns (x, CGInfo)."""
    x = _x0_on_rows(A, b, x0)
    Mfn = M if M is not None else _identity
    r = _residual(A, b, x)
    z = Mfn(r)
    p = z.copy()
    rz = pdot(r, z)
    rnorm = pnorm(r)
    tol = _tolerance(rtol, atol, rnorm)
    k = 0
    while k < maxiter and bool(rnorm > tol):
        Ap = _as_row_vector(A, spmv(A, _as_col_vector(A, p)))
        alpha = rz / pdot(p, Ap)
        x = axpy(alpha, p, x)
        r = axpy(-alpha, Ap, r)
        z = Mfn(r)
        rz_new = pdot(r, z)
        beta = rz_new / rz
        p = _combine(z, beta, p)
        rz = rz_new
        rnorm = pnorm(r)
        k += 1
    return x, CGInfo(k, rnorm)


def cg_df64(
    A: PSparseMatrix,
    b,
    x0=None,
    M: Optional[Callable[[PVector], PVector]] = None,
    rtol: float = 1e-8,
    atol: float = 0.0,
    maxiter: int = 1000,
):
    """Preconditioned CG in df64 (two-float) arithmetic: the operator SpMV
    (kernel K7 through ``spmv_df64``), the vector updates and every dot run
    compensated; ``M`` is an ordinary float32 callable (PVector ->
    PVector), e.g. a ``GaussSeidel`` built from a float32 copy of the
    operator.

    ``A`` must be float64 (``device_df64`` splits it).  ``b`` and ``x0``
    are (hi, lo) PVector pairs (``pvector_df64``) or PVectors, split
    exactly (a float32 one has lo = 0); ``x0=None`` starts from zero.
    Returns ((x_hi, x_lo) PVectors on the row layout, CGInfo) with the
    residual norm ``hi + lo`` of the df64 norm, in float32."""
    device_df64(A)
    bh, bl = pvector_split_df64(b) if isinstance(b, PVector) else b
    if x0 is None:
        x = (torch.zeros_like(bh.own), torch.zeros_like(bh.own))
    else:
        xh, xl = pvector_split_df64(x0) if isinstance(x0, PVector) else x0
        x = (xh.own, xl.own)
    backend = A.backend
    rlay, clay = A.row_layout(), A.col_layout()
    dot = df.dot_parts

    def a_apply(p):
        zgc = p[0].new_zeros((p[0].shape[0], clay.n_ghost_pad))
        yh, yl = spmv_df64(A, (PVector(p[0], zgc, clay, backend), PVector(p[1], zgc, clay, backend)))
        return yh.own, yl.own

    if M is None:
        def precond(r):
            return r  # the identity keeps both words (see hpcg_cg_df64)
    else:
        def precond(r):
            zg = r[0].new_zeros((r[0].shape[0], rlay.n_ghost_pad))
            zo = M(PVector(r[0], zg, rlay, backend)).own.to(r[0].dtype)
            return zo, torch.zeros_like(zo)

    r = df.sub((bh.own, bl.own), a_apply(x))
    z = precond(r)
    p = z
    rz = dot(r, z)
    rn_h, rn_l = df.sqrt(dot(r, r))
    rnorm = rn_h + rn_l
    tol = _tolerance(rtol, atol, rnorm)
    k = 0
    while k < maxiter and bool(rnorm > tol):
        Ap = a_apply(p)
        alpha = df.div(rz, dot(p, Ap))
        x = df.add(x, df.scale(p, alpha))
        r = df.sub(r, df.scale(Ap, alpha))
        z = precond(r)
        rz_new = dot(r, z)
        beta = df.div(rz_new, rz)
        p = df.add(z, df.scale(p, beta))
        rz = rz_new
        rn_h, rn_l = df.sqrt(dot(r, r))
        rnorm = rn_h + rn_l
        k += 1
    zg = x[0].new_zeros((x[0].shape[0], rlay.n_ghost_pad))
    return (PVector(x[0], zg, rlay, backend), PVector(x[1], zg, rlay, backend)), CGInfo(k, rnorm)


def pipelined_cg(
    A: PSparseMatrix,
    b: PVector,
    x0: Optional[PVector] = None,
    M: Optional[Callable[[PVector], PVector]] = None,
    rtol: float = 1e-8,
    atol: float = 0.0,
    maxiter: int = 1000,
):
    """Pipelined preconditioned CG (Ghysels and Vanroose, 2014): the same
    iterates as ``cg`` up to rounding, with the two reductions of an
    iteration independent of the preconditioner application and the SpMV
    that follow them.  Returns (x, CGInfo)."""
    x = _x0_on_rows(A, b, x0)
    Mfn = M if M is not None else _identity

    def Aop(v):
        return _as_row_vector(A, spmv(A, _as_col_vector(A, v)))

    r = _residual(A, b, x)
    u = Mfn(r)
    w = Aop(u)
    rnorm = pnorm(r)
    tol = _tolerance(rtol, atol, rnorm)
    z = q = p = s = _zeros_like(r)
    gamma_old = alpha_old = None  # read from the second iteration on
    k = 0
    while k < maxiter and bool(rnorm > tol):
        gamma = pdot(r, u)
        delta = pdot(w, u)
        m = Mfn(w)
        n = Aop(m)
        if k == 0:
            beta = torch.zeros_like(gamma)
            alpha = gamma / delta
        else:
            beta = gamma / gamma_old
            alpha = gamma / (delta - beta * gamma / alpha_old)
        z = _combine(n, beta, z)
        q = _combine(m, beta, q)
        p = _combine(u, beta, p)
        s = _combine(w, beta, s)
        x = axpy(alpha, p, x)
        r = axpy(-alpha, s, r)
        u = axpy(-alpha, q, u)
        w = axpy(-alpha, z, w)
        gamma_old, alpha_old = gamma, alpha
        rnorm = pnorm(r)
        k += 1
    return x, CGInfo(k, rnorm)


def _combine(z: PVector, beta, p: PVector) -> PVector:
    return PVector(z.own + beta * p.own, z.ghost + beta * p.ghost, p.layout, p.backend)


def _as_col_vector(A: PSparseMatrix, v: PVector) -> PVector:
    """A row-partitioned vector in the column layout (square matrices with
    matching own parts; the ghost slots are zero, refilled by ``spmv``'s
    exchange)."""
    clay = A.col_layout()
    if v.layout is clay:
        return v
    return PVector(v.own, v.own.new_zeros((v.own.shape[0], clay.n_ghost_pad)), clay, v.backend)


def _as_row_vector(A: PSparseMatrix, v: PVector) -> PVector:
    rlay = A.row_layout()
    if v.layout is rlay:
        return v
    return PVector(v.own, v.own.new_zeros((v.own.shape[0], rlay.n_ghost_pad)), rlay, v.backend)


def _residual(A: PSparseMatrix, b: PVector, x: PVector) -> PVector:
    """r = b - A x through the 5-argument SpMV (-1 * A x + 1 * b)."""
    r = spmv(A, _as_col_vector(A, x), alpha=-1.0, beta=1.0, y=_as_row_vector(A, b))
    return PVector(r.own, torch.zeros_like(r.ghost), b.layout, b.backend)


def richardson_iteration(
    A: PSparseMatrix,
    b: PVector,
    x: PVector,
    omega: float = 1.0,
    M: Optional[Callable[[PVector], PVector]] = None,
    iterations: int = 1,
) -> PVector:
    """``iterations`` times x <- x + omega * M(b - A x)."""
    Mfn = M if M is not None else _identity
    x = _as_row_vector(A, x)
    for _ in range(iterations):
        dx = Mfn(_residual(A, b, x))
        x = axpy(omega, _as_row_vector(A, dx), x)
    return x
