"""Gauss-Seidel smoothing on partitioned matrices.

Counterpart of ``partitionedarrays_tpu/solvers/smoothers.py``: the colored
DIA tier of ``GaussSeidel`` (:123-204), ``_order_seq`` and the flat-space
methods (:313-461) that let the MG V-cycle keep x in the de-interleaved
core layout of ``solvers/gs_dia.py`` between smoothing steps.  The names
keep the reference's "flat" although the state is the ``[P, m, Lq]`` core.

Across parts the reference freezes ghost values per application (hybrid
"processor-block" GS); with one part there are no ghosts.  A matrix whose
own block is not DIA, and the slot-wave and sorted-ELL tiers, come with
the generic slice.
"""
from __future__ import annotations

import torch

from ..backends import GHOSTED_PARTS
from ..psparse import PSparseMatrix
from ..pvector import PVector
from .gs_dia import ColoredDIAGS, find_mod_coloring


class GaussSeidel:
    """Multicolor Gauss-Seidel smoother, ``sweep`` "forward", "backward" or
    "symmetric".  Called on a vector it applies as a preconditioner from a
    zero initial guess."""

    def __init__(
        self,
        A: PSparseMatrix,
        iterations: int = 1,
        sweep: str = "symmetric",
        colored: ColoredDIAGS = None,
    ):
        """``colored``: sweep state built elsewhere (``convert.py``);
        by default it is built from A's DIA values.  The reference's
        reduced-precision ``values_dtype`` is not ported yet (ROADMAP)."""
        if sweep not in ("forward", "backward", "symmetric"):
            raise ValueError(sweep)
        self.A = A
        self.iterations = iterations
        self.sweep = sweep
        oo = A.device().oo
        if oo.kind != "dia" or find_mod_coloring(oo.offsets) is None:
            raise NotImplementedError("GaussSeidel needs a DIA own block with a mod-m coloring")
        if colored is None:
            k0 = oo.offsets.index(0) if 0 in oo.offsets else None
            diag = oo.vals[:, k0, :] if k0 is not None else torch.zeros_like(oo.vals[:, 0, :])
            colored = ColoredDIAGS.from_device(oo.offsets, oo.vals, diag)
        self.colored = colored
        self.n_colors = colored.m

    def _order_seq(self):
        fwd = list(range(self.n_colors))
        orders = {
            "forward": [fwd],
            "backward": [fwd[::-1]],
            "symmetric": [fwd, fwd[::-1]],
        }[self.sweep]
        return tuple(
            c for _ in range(self.iterations) for order in orders for c in order
        )

    def flat_viable(self) -> bool:
        clay = self.A.col_layout()
        return not (clay.n_ghost_pad > 0 and clay.consistent_plan.n_rounds > 0)

    def __call__(self, b: PVector) -> PVector:
        """Smooth ``A x = b`` from x = 0 and return x."""
        if not self.flat_viable():
            raise NotImplementedError(GHOSTED_PARTS)
        x_own = self.flat_interleave(self.smooth_bd(None, self.make_bd(b)))
        return PVector(x_own, torch.zeros_like(b.ghost), b.layout, b.backend)

    # -- flat-space pipeline (colored path, no ghost columns) ----------
    def make_bd(self, b: PVector) -> torch.Tensor:
        """De-interleaved rhs [P, m, Lq]; reused by pre and post smoothing."""
        return self.flat_deinterleave(b.own)

    def smooth_bd(self, xflat, bd: torch.Tensor) -> torch.Tensor:
        """Sweeps on the core x; ``xflat=None`` means a zero guess."""
        col = self.colored
        return col.sweeps_core(xflat, bd, col.vals_d, col.invd_d, self._order_seq())

    def flat_residual(self, xflat: torch.Tensor, bd: torch.Tensor) -> torch.Tensor:
        """Level residual bd - A_oo x of the core x, as a core."""
        return bd - self.colored.ax_core(xflat, self.colored.vals_d)

    def flat_ax(self, xflat: torch.Tensor) -> torch.Tensor:
        """A_own_own @ x in the core layout: the A-apply of the flat CG."""
        return self.colored.ax_core(xflat, self.colored.vals_d)

    def flat_interleave(self, xflat: torch.Tensor) -> torch.Tensor:
        """Core -> standard own order [P, n_own_pad].  The reference's
        ``flat_interleave_core`` is the same map here: the core carries no
        margins."""
        return self.colored.interleave_core(xflat)

    def flat_deinterleave(self, own: torch.Tensor) -> torch.Tensor:
        """Standard own values [P, n_own_pad] -> core."""
        return self.colored.deinterleave(own)

    def flat_add_std(self, xflat: torch.Tensor, corr_own: torch.Tensor) -> torch.Tensor:
        """xflat + a standard-order correction, in the core layout."""
        return xflat + self.colored.deinterleave(corr_own)
