"""Geometric multigrid preconditioner for HPCG.

Counterpart of ``partitionedarrays_tpu/models/hpcg/mg.py``: ``n_levels``
27-point operators, each at half the resolution of the next; restriction
by injection of the even-coordinate points; a V-cycle with symmetric
Gauss-Seidel before and after the coarse correction, and smoothing only on
the coarsest level.

The whole cycle stays in the de-interleaved core layout of the colored
Gauss-Seidel, the level transfers included: restriction and prolongation
map one level's core to the other's directly (``ops/mg_transfer.py``, two
hand-written kernels on the card), so standard order appears only where a
standard-order rhs enters (``_cycle``).  One recursion (``_vcycle``) serves
one part and many: with ghost columns the frozen ghost contribution of each
smoother application is folded into the core rhs
(``GaussSeidel.ghost_couple_core``, a no-op without them).  The reference's
selection matmul and dilated pad were TPU layout devices; ``_restrict`` and
``_prolong`` keep the same injection in standard order (a stride-2 slice of
the C-ordered box, the coarse values at the even points of a zero box), the
composition the tests hold the core transfers to.
``restrict_operator`` (reference ``mg.py:31-43``) is copied for callers
that want the injection as an index table.

``precond_dtype`` (reference ``mg.py:57-92``) stores every level's
smoother values narrower than the vectors (bfloat16 or float16; float32
under float64 vectors): the sweeps and level residuals read them and accumulate
in ``dtype``.  The reference also freezes narrow standard-order operators
(``devs_pc``) for its generic V-cycle branch, which no HPCG level takes
(every level here runs the flat cycle), so the port keeps none.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ...config import values_dtype
from ...ops.mg_transfer import prolong_add_core_, restrict_core
from ...psparse import PSparseMatrix
from ...pvector import PVector
from ...solvers.smoothers import GaussSeidel
from ...utils.profiling import span
from .problem import build_hpcg_problem


def restrict_operator(nx: int, ny: int, nz: int) -> np.ndarray:
    """Coarse own-local index -> fine own-local index of C-ordered boxes:
    the even-coordinate fine points (int32), as the reference's."""
    if nx % 2 or ny % 2 or nz % 2:
        raise ValueError(f"restrict_operator: box {(nx, ny, nz)} is not even")
    ix, iy, iz = np.meshgrid(
        np.arange(nx // 2), np.arange(ny // 2), np.arange(nz // 2), indexing="ij"
    )
    fine = ((2 * ix) * ny + (2 * iy)) * nz + (2 * iz)
    return fine.reshape(-1).astype(np.int32)


class HPCGMGPreconditioner:
    """V-cycle geometric MG over ``n_levels`` 27-point operators; list index
    0 is the coarsest level.  ``precond_dtype``: None, bfloat16, float16 or
    float32 (a torch or numpy dtype, or its name), the storage of the
    smoothers' values; a pair without a kernel (float32 values under float32 vectors
    are the plain case) raises TypeError.  A profiled cycle records the span
    ``mg.level`` (attribute ``level``, 0 the coarsest) around each level's
    visit, and each ghost coupling of a level's smoother the span ``ghost``
    with the same ``level``."""

    def __init__(
        self,
        local_shape: Sequence[int],
        parts_per_dir: Sequence[int],
        backend,
        n_levels: int = 4,
        dtype=np.float64,
        smoother_iters: int = 1,
        precond_dtype=None,
        device="cuda",
    ):
        nx, ny, nz = (int(v) for v in local_shape)
        if min(nx, ny, nz) % (2 ** (n_levels - 1)) != 0:
            raise ValueError("local shape must be divisible by 2^(levels-1)")
        shapes = [(nx >> l, ny >> l, nz >> l) for l in range(n_levels)][::-1]
        precond_dtype = values_dtype(precond_dtype)
        As, bs, gss = [], [], []
        for shape in shapes:
            A, b = build_hpcg_problem(shape, parts_per_dir, backend, dtype=dtype, device=device)
            As.append(A)
            bs.append(b)
            gss.append(GaussSeidel(A, iterations=smoother_iters, sweep="symmetric",
                                   values_dtype=precond_dtype))
        self._set_levels(As, bs, gss, shapes, backend)

    @classmethod
    def from_levels(
        cls,
        As: List[PSparseMatrix],
        bs: List[PVector],
        gss: List[GaussSeidel],
        level_shapes: List[Tuple[int, int, int]],
        backend,
    ) -> "HPCGMGPreconditioner":
        """Assemble from per-level operators, rhs and smoothers (coarsest
        first)."""
        self = cls.__new__(cls)
        self._set_levels(As, bs, gss, level_shapes, backend)
        return self

    def _set_levels(self, As, bs, gss, level_shapes, backend):
        self.n_levels = len(As)
        self.As = list(As)
        self.bs = list(bs)
        self.gss = list(gss)
        for l, gs in enumerate(self.gss):
            gs.level = l  # the ghost coupling's spans carry mg.level's index
        self.level_shapes = [tuple(int(v) for v in s) for s in level_shapes]
        self.backend = backend

    @property
    def A(self) -> PSparseMatrix:
        return self.As[-1]

    @property
    def values_dtype(self) -> torch.dtype:
        """The storage dtype of the smoothers' values (``precond_dtype``,
        else the vectors' dtype)."""
        return self.gss[-1].colored.vals_d.dtype

    @property
    def b(self) -> PVector:
        return self.bs[-1]

    def nnz_per_level(self) -> List[int]:
        return [A.nnz() for A in self.As]

    # -- level transfers in standard order (the tests' composition) ----
    def _restrict(self, l: int, r_own: torch.Tensor) -> PVector:
        """Injection: the even-coordinate points of the level-l box, in
        standard order (``restrict_core`` is the cycle's)."""
        nx, ny, nz = self.level_shapes[l]
        P = r_own.shape[0]
        clay = self.As[l - 1].row_layout()
        r3 = r_own[:, : nx * ny * nz].reshape(P, nx, ny, nz)
        rc_own = _pad_to(r3[:, ::2, ::2, ::2].reshape(P, -1), clay.n_own_pad)
        ghost = rc_own.new_zeros((P, clay.n_ghost_pad))
        return PVector(rc_own, ghost, clay, self.backend)

    def _prolong(self, l: int, xc_own: torch.Tensor, n_own_pad: int) -> torch.Tensor:
        """Injection transpose: the coarse values at the even points of a
        zero level-l box, in standard order (``prolong_add_core_`` adds it
        in the cycle)."""
        nx, ny, nz = self.level_shapes[l]
        nxc, nyc, nzc = self.level_shapes[l - 1]
        P = xc_own.shape[0]
        fine = xc_own.new_zeros((P, nx, ny, nz))
        fine[:, ::2, ::2, ::2] = xc_own[:, : nxc * nyc * nzc].reshape(P, nxc, nyc, nzc)
        return _pad_to(fine.reshape(P, -1), n_own_pad)

    # -- V-cycle -------------------------------------------------------
    def _cycle(self, l: int, b: PVector) -> PVector:
        """The V-cycle from level ``l`` on a standard-order rhs, to a
        standard-order x (``__call__``: the generic and df64 routes)."""
        x_own = self.gss[l].flat_interleave(self._cycle_flat_g(l, b))
        rlay = self.As[l].row_layout()
        ghost = x_own.new_zeros((x_own.shape[0], rlay.n_ghost_pad))
        return PVector(x_own, ghost, rlay, self.backend)

    def _cycle_flat_g(self, l: int, b: PVector) -> torch.Tensor:
        """The V-cycle from level ``l`` on a standard-order rhs; returns the
        core x.  ``_cycle`` enters here."""
        return self._vcycle(l, self.gss[l].make_bd(b))

    def _vcycle(self, l: int, bd: torch.Tensor) -> torch.Tensor:
        """The V-cycle from level ``l`` on the core rhs ``bd``, for one part
        and for many; returns the core x.  Across parts each smoother
        application folds the frozen ghost contribution into its rhs and
        the level residual subtracts it with fresh ghosts
        (``GaussSeidel.ghost_couple_core``, which does nothing without
        ghosts): the hybrid Gauss-Seidel, in the core layout.  A zero-guess
        pre-smooth has zero ghosts and couples nothing; the coarsest level
        smooths only, from a zero guess whose coupling still exchanges, as
        the reference's.  Where a level couples, ``bd`` is consumed: the
        post-smooth's rhs is built in it.  The transfers run core to core:
        the residual's restriction is the coarse rhs, and the coarse x's
        prolongation is added into x in place."""
        with span("mg.level", level=l):
            gs = self.gss[l]
            if l == 0:
                return gs.smooth_bd(None, gs.ghost_couple_core(None, bd, subtract=True))
            xflat = gs.smooth_bd(None, bd)  # pre-smooth
            rd = gs.ghost_couple_core(xflat, gs.flat_residual(xflat, bd), subtract=True)
            coarse = self.gss[l - 1].colored
            xc = self._vcycle(l - 1, restrict_core(rd, self.level_shapes[l],
                                                   (coarse.m, coarse.Lq)))
            prolong_add_core_(xflat, xc, self.level_shapes[l])
            return gs.smooth_bd(xflat, gs.ghost_couple_core(xflat, bd, subtract=True))

    def flat_viable(self) -> bool:
        """True when the finest level smooths without ghost exchanges."""
        return self.gss[-1].flat_viable()

    def flat_viable_ghosted(self) -> bool:
        """True when the finest level can run the ghosted flat pipeline
        (every level of the port smooths with the colored sweep)."""
        return self.n_levels >= 2

    def apply_flat(self, bd: torch.Tensor) -> torch.Tensor:
        """The preconditioner in the de-interleaved layout: residual core
        [P, m, Lq] in, correction core out, ``bd`` left as it was.  The
        cycle consumes its rhs only where the finest level couples ghosts,
        so only there does it run on a copy."""
        return self._vcycle(self.n_levels - 1, bd if self.flat_viable() else bd.clone())

    def __call__(self, r: PVector) -> PVector:
        return self._cycle(self.n_levels - 1, r)


def _pad_to(a: torch.Tensor, n: int) -> torch.Tensor:
    if a.shape[1] == n:
        return a.contiguous()
    if a.shape[1] > n:
        return a[:, :n].contiguous()
    return torch.nn.functional.pad(a, (0, n - a.shape[1]))
