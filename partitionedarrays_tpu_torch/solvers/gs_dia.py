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
``[P, m, Lq]``.  The sweep sequence of the smoothers is kernel K3 and the
core SpMV kernel K4 (``ops/gs_dia_kernels.py``).  The standalone ``sweep``
runs each color as the reference's ``sweep_flat`` does: a DIA SpMV of the
color's values over the core (kernel K2, ``ops/dia_spmv.py``) and an
update of the color's row.  The reference's de-interleave by 0/1 matmul is
a TPU layout trick; here it is a reshape and a transpose.

``values_dtype`` stores ``vals_d`` narrower than the vectors, the
reference's reduced-precision preconditioner values (``gs_dia.py:111-199``):
bfloat16 or float16 with float32 or float64 vectors, or float32 with
float64 vectors (``_build.NARROW_PAIRS``).  The values are rounded to
nearest even, as ``astype`` rounds them there (``round_values``: float64
to bfloat16 through float32, in torch and JAX alike; float64 to float16
once, as JAX does); ``invd_d`` stays in the vectors' dtype,
computed from the unrounded diagonal; K2, K3 and K4 widen each value to
the vectors' dtype before they multiply.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .. import _build
from ..ops.dia_spmv import dia_spmv_strided
from ..ops.gs_dia_kernels import TapTable, ax_core, gs_sweeps


def _round_up(x: int, mlt: int) -> int:
    return ((x + mlt - 1) // mlt) * mlt


def round_values(vals: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``vals`` rounded to ``dtype`` as the reference's ``astype`` rounds
    them, to nearest even.  torch rounds float64 to float16 through
    float32, twice, where XLA and numpy round once; so float64 goes to
    float32 rounded to odd (truncated, its last bit set where it was
    inexact: 24 bits hold the 11 of float16 and two more), whose rounding
    to nearest float16 is the once-rounded one.  bfloat16 keeps torch's
    rounding through float32, which is also XLA's."""
    if not (vals.dtype == torch.float64 and dtype == torch.float16):
        return vals.to(dtype)
    f = vals.to(torch.float32)
    back = f.to(torch.float64)
    bits = f.view(torch.int32)
    bits = bits - (back.abs() > vals.abs()).to(torch.int32)  # truncated
    bits = bits | (back != vals).to(torch.int32)  # odd where inexact
    return bits.view(torch.float32).to(torch.float16)


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
    de-interleaved values ``vals_d`` (in their storage dtype) and inverse
    diagonal ``invd_d`` (in the vectors' dtype).  ``plan_parts``: the part
    count K3's and K4's launches are planned for (None: the tensors'; the
    smoother sets the count of all parts, so that a process of a
    multi-process run sums in the serial backend's order)."""

    plan_parts = None

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
    def from_device(
        cls, offsets, vals: torch.Tensor, diag: torch.Tensor,
        values_dtype: Optional[torch.dtype] = None,
    ) -> "ColoredDIAGS":
        """Build from the block's values ``vals[P, n_off, R]`` and diagonal
        ``diag[P, R]``, on their device; ``vals_d`` in ``values_dtype``
        (default: the values' dtype)."""
        self = cls.__new__(cls)
        self._plan(offsets, vals.shape[2])
        self.set_values(vals, diag, values_dtype or vals.dtype)
        return self

    def set_values(
        self, vals: torch.Tensor, diag: torch.Tensor,
        values_dtype: Optional[torch.dtype] = None,
    ) -> None:
        """De-interleave new values of the same block (``vals[P, n_off,
        R]``, ``diag[P, R]``) into ``vals_d`` and ``invd_d``, keeping the
        coloring and the tap table, and ``vals_d``'s storage dtype unless
        ``values_dtype`` names another (so a refresh of a narrow smoother
        stays narrow)."""
        P, n_off, R = vals.shape
        if (n_off, R) != (len(self.offsets), self.R):
            raise ValueError(f"set_values: values {tuple(vals.shape)} for n_off, R = "
                             f"{(len(self.offsets), self.R)}")
        values_dtype = values_dtype or self.vals_d.dtype
        _build.check_pair("ColoredDIAGS", values_dtype, diag.dtype)
        m, Lq = self.m, self.Lq
        Rq = m * Lq
        vp = vals.new_zeros((P, n_off, Rq))
        vp[:, :, :R] = vals
        # rounded to nearest even after the de-interleave
        self.vals_d = round_values(vp.view(P, n_off, Lq, m).permute(0, 3, 1, 2).contiguous(),
                                   values_dtype)
        dp = diag.new_zeros((P, Rq))
        dp[:, :R] = diag
        dd = dp.view(P, Lq, m).transpose(1, 2)
        # zero on padding rows -> their update is a no-op
        self.invd_d = torch.where(
            dd != 0, 1.0 / torch.where(dd != 0, dd, torch.ones_like(dd)), torch.zeros_like(dd)
        ).contiguous()

    @classmethod
    def from_arrays(
        cls, offsets, R: int, vals_d: torch.Tensor, invd_d: torch.Tensor,
        values_dtype: Optional[torch.dtype] = None,
    ) -> "ColoredDIAGS":
        """Adopt de-interleaved state built elsewhere: vals_d
        ``[P, m, n_off, Lq]``, stored in ``values_dtype`` (default: its
        own dtype; another is rounded to), and invd_d ``[P, m, Lq]``."""
        self = cls.__new__(cls)
        self._plan(offsets, R)
        expect = (self.m, len(self.offsets), self.Lq)
        if tuple(vals_d.shape[1:]) != expect or tuple(invd_d.shape[1:]) != (self.m, self.Lq):
            raise ValueError(
                f"vals_d {tuple(vals_d.shape)} / invd_d {tuple(invd_d.shape)} "
                f"do not match m, n_off, Lq = {expect}"
            )
        values_dtype = values_dtype or vals_d.dtype
        _build.check_pair("ColoredDIAGS", values_dtype, invd_d.dtype)
        self.vals_d = round_values(vals_d.contiguous(), values_dtype)
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
        return ax_core(vals_d, xcore, self.taps, self.plan_parts)

    def sweeps_core(
        self,
        xcore: Optional[torch.Tensor],
        bd: torch.Tensor,
        vals_d: torch.Tensor,
        invd_d: torch.Tensor,
        order_seq: Sequence[int],
    ) -> torch.Tensor:
        """Run the color sequence ``order_seq`` on the core (K3, one
        launch); ``xcore=None`` means a zero initial guess."""
        return gs_sweeps(vals_d, bd, invd_d, xcore, self.taps, tuple(int(c) for c in order_seq),
                         self.plan_parts)

    def sweep_flat(
        self,
        xcore: torch.Tensor,
        bd: torch.Tensor,
        vals_d: torch.Tensor,
        invd_d: torch.Tensor,
        order: Sequence[int],
    ) -> torch.Tensor:
        """Color updates in ``order`` on the core, in place, one color at a
        time: ``x_c += (bd_c - A_c x) * invd_c`` where ``A_c x`` is the DIA
        SpMV of the color's values ``vals_d[:, c]`` over the whole core
        (K2).  ``bd`` [P, m, Lq] holds the rhs with the frozen ghost-column
        contribution already subtracted.  Returns ``xcore``."""
        P = xcore.shape[0]
        flat = xcore.view(P, self.m * self.Lq)
        for c in order:
            ax = dia_spmv_strided(self.taps.host[c], vals_d[:, c], flat)
            row = xcore[:, c]
            row.copy_(row + (bd[:, c] - ax) * invd_d[:, c])
        return xcore

    def sweep(
        self,
        xo: torch.Tensor,
        bo: torch.Tensor,
        ghost_contrib: torch.Tensor,
        vals_d: torch.Tensor,
        invd_d: torch.Tensor,
        order: Sequence[int],
    ) -> torch.Tensor:
        """A standalone sweep in standard order: own values ``xo``, rhs
        ``bo`` and ghost contribution ``A_oh g``, each [P, >= R], to the
        swept own values [P, R]."""
        xcore = self.deinterleave(xo)
        bd = self.deinterleave(bo - ghost_contrib)
        return self.interleave_core(self.sweep_flat(xcore, bd, vals_d, invd_d, order))
