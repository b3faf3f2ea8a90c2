"""Colored Gauss-Seidel for DIA (banded) blocks on a de-interleaved vector.

Counterpart of ``partitionedarrays_tpu/solvers/gs_dia.py`` (``ColoredDIAGS``
:48-352).  For a banded own-own block with diagonal offsets O:

1. Pick the smallest m >= 2 such that no nonzero offset is a multiple of
   m.  Then color(i) = i mod m is a valid coloring: no two coupled rows
   share a color.
2. De-interleave x into a core ``xd[c, i] = x[m*i + c]`` of shape
   ``[m, Lq]``.  A stride-m sample of a shifted sequence is a shifted
   contiguous run of the core, so each diagonal's contribution to the
   color-c rows is a contiguous read at a fixed offset ``tap[c][d]``.
3. A color update is then a DIA SpMV into the core, and a sweep over all
   colors reads the diagonal values once: a true Gauss-Seidel sweep at the
   data volume of one SpMV.

All tensors carry the part axis first: vals_d ``[P, m, n_off, Lq]``, cores
``[P, m, Lq]``.  The sweep is kernel K3 and the core SpMV kernel K4
(``ops/gs_dia_kernels.py``).  The reference's de-interleave by 0/1 matmul
is a TPU layout trick; here it is a reshape and a transpose.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..ops.gs_dia_kernels import TapTable, ax_core, gs_sweeps


def _round_up(x: int, mlt: int) -> int:
    return ((x + mlt - 1) // mlt) * mlt


def find_mod_coloring(offsets, max_m: int = 512) -> Optional[int]:
    """Smallest m >= 2 with o % m != 0 for every nonzero offset."""
    nz = [abs(int(o)) for o in offsets if o != 0]
    if not nz:
        return 2
    for m in range(2, max_m + 1):
        if all(o % m for o in nz):
            return m
    return None


class ColoredDIAGS:
    """Sweep state of one DIA block: the geometry from ``_plan`` and the
    de-interleaved values ``vals_d`` and inverse diagonal ``invd_d``."""

    def _plan(self, offsets: Tuple[int, ...], R: int):
        """Static geometry, identical to the reference's ``_plan`` so that
        ``m``, ``Lq``, ``Kp`` and ``schedule`` agree number for number."""
        self.offsets = tuple(int(o) for o in offsets)
        m = find_mod_coloring(self.offsets)
        if m is None:
            raise ValueError(f"no mod-m coloring for offsets {self.offsets}")
        self.m = m
        self.R = R
        L = -(-R // m)
        # the reference pads the core length to its TPU kernel tile; kept so
        # that the two packages share one geometry
        tile = 16384 if L > 32768 else 1024
        self.Lq = _round_up(max(L, 1), tile)
        # max |de-interleaved row shift|
        K = max((abs((c + o) // m) + 1 for o in self.offsets for c in range(m)), default=1)
        self.Kp = _round_up(K, 1024)
        # flat position of tap d of color c in the reference's buffer
        # [Kp zero margin | core rows back to back | margin]: the color-c
        # update reads xflat[schedule[c][d] + i].  A tap that strays outside
        # its target row multiplies a diagonal value that is exactly zero.
        self.schedule = []
        for c in range(m):
            offs = []
            for o in self.offsets:
                j = c + o
                s = j % m
                k = (j - s) // m
                offs.append(s * self.Lq + self.Kp + k)
            self.schedule.append(tuple(offs))
        # the same taps relative to the start of the core (no margins)
        self.taps = TapTable([[t - self.Kp for t in row] for row in self.schedule])

    @classmethod
    def from_device(cls, offsets, vals: torch.Tensor, diag: torch.Tensor) -> "ColoredDIAGS":
        """Build from the block's values ``vals[P, n_off, R]`` and diagonal
        ``diag[P, R]``, on their device."""
        self = cls.__new__(cls)
        P, n_off, R = vals.shape
        self._plan(offsets, R)
        m, Lq = self.m, self.Lq
        Rq = m * Lq
        vp = vals.new_zeros((P, n_off, Rq))
        vp[:, :, :R] = vals
        self.vals_d = vp.view(P, n_off, Lq, m).permute(0, 3, 1, 2).contiguous()
        dp = diag.new_zeros((P, Rq))
        dp[:, :R] = diag
        dd = dp.view(P, Lq, m).transpose(1, 2)
        # zero on padding rows -> their update is a no-op
        self.invd_d = torch.where(
            dd != 0, 1.0 / torch.where(dd != 0, dd, torch.ones_like(dd)), torch.zeros_like(dd)
        ).contiguous()
        return self

    @classmethod
    def from_arrays(
        cls, offsets, R: int, vals_d: torch.Tensor, invd_d: torch.Tensor
    ) -> "ColoredDIAGS":
        """Adopt de-interleaved state built elsewhere: vals_d
        ``[P, m, n_off, Lq]`` and invd_d ``[P, m, Lq]``."""
        self = cls.__new__(cls)
        self._plan(offsets, R)
        expect = (self.m, len(self.offsets), self.Lq)
        if tuple(vals_d.shape[1:]) != expect or tuple(invd_d.shape[1:]) != (self.m, self.Lq):
            raise ValueError(
                f"vals_d {tuple(vals_d.shape)} / invd_d {tuple(invd_d.shape)} "
                f"do not match m, n_off, Lq = {expect}"
            )
        self.vals_d = vals_d.contiguous()
        self.invd_d = invd_d.contiguous()
        return self

    # -- de/interleave -------------------------------------------------
    def deinterleave(self, x: torch.Tensor) -> torch.Tensor:
        """Own values x[P, >= R] -> core [P, m, Lq] (zero padded)."""
        P = x.shape[0]
        xp = x.new_zeros((P, self.m * self.Lq))
        xp[:, : self.R] = x[:, : self.R]
        return xp.view(P, self.Lq, self.m).transpose(1, 2).contiguous()

    def interleave_core(self, xcore: torch.Tensor) -> torch.Tensor:
        """Core [P, m, Lq] -> own values in standard order [P, R]."""
        P = xcore.shape[0]
        flat = xcore.transpose(1, 2).reshape(P, self.m * self.Lq)
        return flat[:, : self.R].contiguous()

    def zeros_core(self, P: int, dtype: torch.dtype, device) -> torch.Tensor:
        return torch.zeros((P, self.m, self.Lq), dtype=dtype, device=device)

    # -- the kernels ---------------------------------------------------
    def ax_core(self, xcore: torch.Tensor, vals_d: torch.Tensor) -> torch.Tensor:
        """A_own_own @ x in the core layout, core in and core out (K4)."""
        return ax_core(vals_d, xcore, self.taps)

    def sweeps_core(
        self,
        xcore: Optional[torch.Tensor],
        bd: torch.Tensor,
        vals_d: torch.Tensor,
        invd_d: torch.Tensor,
        order_seq: Sequence[int],
    ) -> torch.Tensor:
        """Run the color sequence ``order_seq`` on the core (K3);
        ``xcore=None`` means a zero initial guess."""
        if xcore is None:
            xcore = self.zeros_core(bd.shape[0], bd.dtype, bd.device)
        return gs_sweeps(vals_d, bd, invd_d, xcore, self.taps, tuple(int(c) for c in order_seq))
