"""HPCG preconditioned CG: a fixed number of iterations, with the residual
history.

Counterpart of ``partitionedarrays_tpu/models/hpcg/cg.py`` (``hpcg_cg``
:22-60 and ``hpcg_cg_flat`` :130-186).  The loop runs eagerly; the residual
norms stay in a device tensor (``norms[k + 1] = ...``) and nothing is copied
to the host inside the loop, so the host only enqueues work.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ...psparse import PSparseMatrix, spmv
from ...pvector import PVector, axpy, pdot


def _as_col_vector(A: PSparseMatrix, v: PVector) -> PVector:
    clay = A.col_layout()
    if v.layout is clay:
        return v
    return PVector(v.own, v.own.new_zeros((clay.n_parts, clay.n_ghost_pad)), clay, v.backend)


def _as_row_vector(A: PSparseMatrix, v: PVector) -> PVector:
    rlay = A.row_layout()
    if v.layout is rlay:
        return v
    return PVector(v.own, v.own.new_zeros((rlay.n_parts, rlay.n_ghost_pad)), rlay, v.backend)


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


def hpcg_cg_flat(mg, b: PVector, iterations: int = 50):
    """PCG with every vector in the de-interleaved core layout of the
    finest level's Gauss-Seidel (one part, no ghosts): the A-apply is the
    core SpMV (kernel K4), the preconditioner runs through ``apply_flat``,
    and dots and axpys run on the cores directly, since they do not depend
    on the order of the entries and the padding stays zero.  Standard
    order appears twice per solve: b in, x out."""
    gs = mg.gss[-1]
    lay = b.layout

    def dot(u, v):
        return torch.vdot(u.reshape(-1), v.reshape(-1))

    bf = gs.make_bd(b)
    x = torch.zeros_like(bf)
    r = bf
    norms = bf.new_zeros(iterations + 1)
    norms[0] = torch.sqrt(dot(r, r))
    z = mg.apply_flat(r)
    p = z
    rz = dot(r, z)
    for k in range(iterations):
        Ap = gs.flat_ax(p)
        alpha = rz / dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = mg.apply_flat(r)
        rz_new = dot(r, z)
        beta = rz_new / rz
        p = z + beta * p
        rz = rz_new
        norms[k + 1] = torch.sqrt(dot(r, r))
    x_own = gs.flat_interleave(x)
    xv = PVector(x_own, x_own.new_zeros((x_own.shape[0], lay.n_ghost_pad)), lay, b.backend)
    return xv, norms


def hpcg_cg_df64(*args, **kwargs):
    """The two-float (df64) CG is not ported yet; native float64 runs
    through ``hpcg_cg``/``hpcg_cg_flat`` with ``dtype=float64``."""
    raise NotImplementedError("df64 HPCG: ROADMAP Queue 1 item 9 (slice B)")
