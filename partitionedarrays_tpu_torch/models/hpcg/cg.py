"""HPCG preconditioned CG: a fixed number of iterations, with the residual
history.

Counterpart of ``partitionedarrays_tpu/models/hpcg/cg.py`` (``hpcg_cg``
:22-60, ``hpcg_cg_flat_g`` :63-127, ``hpcg_cg_flat`` :130-186 and
``hpcg_cg_df64`` :189-286).  The loop runs eagerly; the residual norms
stay in a device tensor (``norms[k + 1] = ...``) and nothing is copied to
the host inside the loop, so the host only enqueues work.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ...ops import df64 as df
from ...psparse import PSparseMatrix, spmv, spmv_df64
from ...pvector import PVector, axpy, pdot
from ...solvers.krylov import _as_col_vector, _as_row_vector
from ...utils.profiling import span


def hpcg_cg(
    A: PSparseMatrix,
    b: PVector,
    M: Optional[Callable[[PVector], PVector]] = None,
    iterations: int = 50,
):
    """Run exactly ``iterations`` PCG iterations from x0 = 0 in standard
    order (the A-apply is ``spmv``, kernel K1).

    Returns (x, norms[iterations + 1]) with norms[k] = |r_k|_2."""
    Mfn = M if M is not None else (lambda r: r)
    x = PVector(torch.zeros_like(b.own), torch.zeros_like(b.ghost), b.layout, b.backend)
    r = b.copy()
    norms = b.own.new_zeros(iterations + 1)
    norms[0] = torch.sqrt(pdot(r, r))
    z = Mfn(r)
    p = _as_row_vector(A, z)
    rz = pdot(r, z)
    for k in range(iterations):
        Ap = _as_row_vector(A, spmv(A, _as_col_vector(A, p)))
        alpha = rz / pdot(p, Ap)
        x = axpy(alpha, p, x)
        r = axpy(-alpha, Ap, r)
        z = Mfn(r)
        rz_new = pdot(r, z)
        beta = rz_new / rz
        p = PVector(z.own + beta * p.own, z.ghost + beta * p.ghost, p.layout, p.backend)
        rz = rz_new
        norms[k + 1] = torch.sqrt(pdot(r, r))
    return x, norms


def _core_dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Dot product of two cores over all parts, as a 0-d device tensor."""
    return torch.vdot(u.reshape(-1), v.reshape(-1))


def hpcg_cg_flat_g(mg, b: PVector, iterations: int = 50):
    """PCG in the core layout for an operator with ghost columns (many
    parts).  Vectors, dots and axpys live in the finest level's core, as in
    ``hpcg_cg_flat``; the A-apply is the core SpMV (K4) plus the
    ghost-column contribution added into it (one exchange and K5, both on
    the core: ``GaussSeidel.ghost_couple_core``); the preconditioner is the
    ghosted V-cycle on the core residual (``_cycle_flat_gd``).  Standard
    order appears at the level transfers.  A profiled set records the span
    ``hpcg.cg``."""
    gs = mg.gss[-1]
    lay = b.layout

    def _dot(u, v):  # over every process's parts
        return b.backend.allreduce(_core_dot(u, v))

    def a_apply(p):
        return gs.ghost_couple_core(p, gs.flat_ax(p))

    def m_apply(r):
        return mg._cycle_flat_gd(mg.n_levels - 1, r.clone())  # r outlives the cycle

    with span("hpcg.cg"):
        bf = gs.make_bd(b)
        x = torch.zeros_like(bf)
        r = bf
        norms = bf.new_zeros(iterations + 1)
        norms[0] = torch.sqrt(_dot(r, r))
        z = m_apply(r)
        p = z
        rz = _dot(r, z)
        for k in range(iterations):
            Ap = a_apply(p)
            alpha = rz / _dot(p, Ap)
            x = x + alpha * p
            r = r - alpha * Ap
            z = m_apply(r)
            rz_new = _dot(r, z)
            beta = rz_new / rz
            p = z + beta * p
            rz = rz_new
            norms[k + 1] = torch.sqrt(_dot(r, r))
        x_own = gs.flat_interleave(x)
        xv = PVector(x_own, x_own.new_zeros((x_own.shape[0], lay.n_ghost_pad)), lay, b.backend)
        return xv, norms


def hpcg_cg_flat(mg, b: PVector, iterations: int = 50):
    """PCG with every vector in the de-interleaved core layout of the
    finest level's Gauss-Seidel (one part, no ghosts): the A-apply is the
    core SpMV (kernel K4), the preconditioner runs through ``apply_flat``,
    and dots and axpys run on the cores directly, since they do not depend
    on the order of the entries and the padding stays zero.  Standard
    order appears twice per solve: b in, x out.  A profiled set records
    the span ``hpcg.cg``."""
    gs = mg.gss[-1]
    lay = b.layout

    with span("hpcg.cg"):
        bf = gs.make_bd(b)
        x = torch.zeros_like(bf)
        r = bf
        norms = bf.new_zeros(iterations + 1)
        norms[0] = torch.sqrt(_core_dot(r, r))
        z = mg.apply_flat(r)
        p = z
        rz = _core_dot(r, z)
        for k in range(iterations):
            Ap = gs.flat_ax(p)
            alpha = rz / _core_dot(p, Ap)
            x = x + alpha * p
            r = r - alpha * Ap
            z = mg.apply_flat(r)
            rz_new = _core_dot(r, z)
            beta = rz_new / rz
            p = z + beta * p
            rz = rz_new
            norms[k + 1] = torch.sqrt(_core_dot(r, r))
        x_own = gs.flat_interleave(x)
        xv = PVector(x_own, x_own.new_zeros((x_own.shape[0], lay.n_ghost_pad)), lay, b.backend)
        return xv, norms


def hpcg_cg_df64(
    A: PSparseMatrix,
    b_pair,
    M: Optional[Callable[[PVector], PVector]] = None,
    iterations: int = 50,
):
    """Official-precision PCG (``cg.py:189-286``): the operator (kernel K7
    through ``spmv_df64``), the vectors, their updates and every dot in
    df64 two-float arithmetic; the preconditioner ``M`` stays float32.  A
    float64 ``A`` is frozen into its (hi, lo) pair on first use.

    ``b_pair``: (hi, lo) PVectors on ``A.row_prange``.  The loop stays on
    the device: alpha and beta are pairs of 0-d tensors and nothing is read
    back.  Returns ((x_hi, x_lo) own tensors, norms[iterations + 1]), the
    norms in float32 as the reference's (the square root of the hi word of
    the compensated dot)."""
    bh, bl = b_pair
    backend = bh.backend
    lay = bh.layout
    clay = A.col_layout()
    def dot(a, b):
        return df.dot_parts(a, b, backend)

    if M is None:
        # identity preconditioner: z = r exactly, both words.  Keeping only
        # hi here would quantize every search direction to float32, and x
        # would stall at float32 precision while the df64 residual
        # recurrence still converged (the reference's round-2 fault).
        def precond(r):
            return r
    else:
        # a float32 preconditioner is an approximate inverse: its output
        # has no lo word, and that moves only the convergence rate
        def precond(r):
            z = M(PVector(r[0], r[0].new_zeros((r[0].shape[0], lay.n_ghost_pad)), lay, backend))
            return z.own, torch.zeros_like(z.own)

    def a_apply(p):
        # the iterate lives on the row partition; re-home to the columns
        zgc = p[0].new_zeros((p[0].shape[0], clay.n_ghost_pad))
        yh, yl = spmv_df64(A, (PVector(p[0], zgc, clay, backend), PVector(p[1], zgc, clay, backend)))
        return yh.own, yl.own

    x = (torch.zeros_like(bh.own), torch.zeros_like(bh.own))
    r = (bh.own, bl.own)
    norms = bh.own.new_zeros(iterations + 1)
    norms[0] = torch.sqrt(dot(r, r)[0])
    z = precond(r)
    p = z
    rz = dot(r, z)
    for k in range(iterations):
        Ap = a_apply(p)
        alpha = df.div(rz, dot(p, Ap))
        x = df.add(x, df.scale(p, alpha))
        r = df.sub(r, df.scale(Ap, alpha))
        z = precond(r)
        rz_new = dot(r, z)
        beta = df.div(rz_new, rz)
        p = df.add(z, df.scale(p, beta))
        rz = rz_new
        norms[k + 1] = torch.sqrt(dot(r, r)[0])
    return x, norms
