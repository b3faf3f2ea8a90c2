"""K3 and K4: the colored DIA Gauss-Seidel kernels, wrappers and plain
versions.

Both work on the de-interleaved core layout of ``solvers/gs_dia.py``: the
unknowns of color ``c`` (rows ``m*i + c``) form row ``c`` of a
``[P, m, Lq]`` core, and tap ``d`` of color ``c`` reads the flattened core at
``tap[c][d] + i`` (zero outside ``[0, m*Lq)``).

- K4 ``ax_core`` replaces ``partitionedarrays_tpu/ops/gs_pallas.py::
  ax_core_pallas``: ``A_own_own @ x`` in the core layout.
- K3 ``gs_sweeps`` replaces ``partitionedarrays_tpu/ops/gs_pallas.py::
  gs_sweep_pallas``: a whole sequence of color updates (any number of
  forward, backward or symmetric sweeps) in ONE launch, as the TPU runs
  it.  Its output is a new core; from a zero guess (``xcore=None``) the
  launch itself writes the zeros.

Both also read values narrower than the vectors (``_build.NARROW_PAIRS``:
bfloat16 or float16 values with float32 or float64 vectors, float32
values with float64 vectors), the reference's reduced-precision preconditioner values:
each value is widened exactly to the vector dtype and the sums run in it,
in the kernels as in the plain versions here.

The CUDA kernels are ``csrc/gs_dia.cu``; its source note says why the
sequence is race-free with a barrier between color steps, what bounds K3
and K4 (device-memory bandwidth: the values, plus x; K3 reads each color's
values once per step) and how their designs meet that: both run the row
engine they share with K2 (``csrc/dia_rows.cuh``), K4 as one launch over
(row tiles, colors, parts), K3 as a persistent cooperative launch with
``grid.sync()`` between steps.  ``ops/dia_rows.py::ax_plan`` and
``sweep_plan`` pick the lanes per row group (and K3's CTAs) for each
level.  The TPU's padded flat buffer,
aligned windows and scalar-prefetched color schedule do not carry over:
the kernels read the core with masked loads, and the color sequence travels
as a device int array (``TapTable.steps_on``).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from .. import _build
from .dia_rows import AxPlan, SweepPlan, ax_plan, check_rows, sweep_plan, vec_of

_DTYPES = (torch.float32, torch.float64)


class TapTable:
    """Per-color tap offsets into the flattened ``[m, Lq]`` core, with one
    int32 copy per device for the kernels, and the color sequences K3 has
    run, as int32 step arrays per device."""

    def __init__(self, taps: Sequence[Sequence[int]]):
        self.host: Tuple[Tuple[int, ...], ...] = tuple(
            tuple(int(t) for t in row) for row in taps
        )
        self.m = len(self.host)
        self.n_off = len(self.host[0]) if self.host else 0
        self._dev: Dict[torch.device, torch.Tensor] = {}
        self._steps: Dict[Tuple[Tuple[int, ...], torch.device], torch.Tensor] = {}

    def on(self, device: torch.device) -> torch.Tensor:
        t = self._dev.get(device)
        if t is None:
            t = torch.tensor(self.host, dtype=torch.int32, device=device)
            self._dev[device] = t
        return t

    def steps_on(self, order: Sequence[int], device: torch.device) -> torch.Tensor:
        """The color sequence ``order`` as an int32 array on ``device``."""
        order = tuple(int(c) for c in order)
        key = (order, torch.device(device))
        t = self._steps.get(key)
        if t is None:
            bad = [c for c in order if not 0 <= c < self.m]
            if bad:
                raise ValueError(f"colors {bad} outside [0, {self.m})")
            t = torch.tensor(order, dtype=torch.int32, device=device)
            self._steps[key] = t
        return t

    def margins(self, Lq: int) -> Tuple[int, int]:
        """Zero margins (left, right) that keep every tap of a plain padded
        copy of the core in bounds."""
        lo = min(min(row) for row in self.host)
        hi = max(max(row) for row in self.host) + Lq
        return max(0, -lo), max(0, hi - self.m * Lq)


def _check(name, vals, cores, tap: TapTable):
    P, m, n_off, Lq = vals.shape
    if (m, n_off) != (tap.m, tap.n_off):
        raise ValueError(f"{name}: vals {tuple(vals.shape)} and taps {tap.m}x{tap.n_off}")
    for t in cores:
        if tuple(t.shape) != (P, m, Lq):
            raise ValueError(f"{name}: core {tuple(t.shape)} for vals {tuple(vals.shape)}")
        if t.dtype != cores[0].dtype:
            raise TypeError(f"{name}: vectors {cores[0].dtype} and {t.dtype} differ")
        if t.device != vals.device:
            raise ValueError(f"{name}: values on {vals.device}, a vector on {t.device}")
    _build.check_pair(name, vals.dtype, cores[0].dtype)
    if vals.device.type == "cpu":
        return False
    if vals.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {vals.device}")
    if cores[0].dtype not in _DTYPES:
        raise TypeError(f"{name}: no kernel for {cores[0].dtype}")
    if not all(t.is_contiguous() for t in (vals, *cores)):
        raise ValueError(f"{name}: tensors must be contiguous")
    return True


def _padded(xcore: torch.Tensor, tap: TapTable):
    """Flattened core with zero margins: [P, left + m*Lq + right]."""
    P, m, Lq = xcore.shape
    left, right = tap.margins(Lq)
    xflat = xcore.new_zeros((P, left + m * Lq + right))
    xflat[:, left : left + m * Lq] = xcore.reshape(P, m * Lq)
    return xflat, left


def _color_ax(vals, xflat, left, tap: TapTable, c: int, Lq: int):
    """Color c's rows of A x; the values widened to x's dtype."""
    acc = xflat.new_zeros((xflat.shape[0], Lq))
    for d, t in enumerate(tap.host[c]):
        acc = acc + vals[:, c, d].to(xflat.dtype) * xflat[:, left + t : left + t + Lq]
    return acc


def ax_core_plain(vals: torch.Tensor, xcore: torch.Tensor, tap: TapTable) -> torch.Tensor:
    """out[p, c, i] = sum_d vals[p, c, d, i] * core[p, tap[c][d] + i]."""
    _, m, _, Lq = vals.shape
    xflat, left = _padded(xcore, tap)
    return torch.stack(
        [_color_ax(vals, xflat, left, tap, c, Lq) for c in range(m)], dim=1
    )


def gs_sweeps_plain(
    vals: torch.Tensor,
    bd: torch.Tensor,
    invd: torch.Tensor,
    xcore: torch.Tensor,
    tap: TapTable,
    order: Sequence[int],
) -> torch.Tensor:
    """Color updates ``x_c += (bd_c - sum_d v_{c,d} x[tap_{c,d} + i]) *
    invd_c`` for c in ``order``, each seeing the previous ones."""
    P, m, _, Lq = vals.shape
    xflat, left = _padded(xcore, tap)
    for c in order:
        ax = _color_ax(vals, xflat, left, tap, c, Lq)
        row = xflat[:, left + c * Lq : left + (c + 1) * Lq]
        row.copy_(row + (bd[:, c] - ax) * invd[:, c])
    return xflat[:, left : left + m * Lq].reshape(P, m, Lq).clone()


def ax_core(
    vals: torch.Tensor, xcore: torch.Tensor, tap: TapTable, plan_parts: Optional[int] = None,
    _plan: Optional[AxPlan] = None,
) -> torch.Tensor:
    """K4.  vals [P, m, n_off, Lq] (the vectors' dtype or a narrow pair),
    xcore [P, m, Lq] -> [P, m, Lq].  A CPU tensor goes to
    ``ax_core_plain``; a CUDA tensor goes to the kernel, one launch over
    every color and part (Lq and every start in whole loads:
    ``dia_rows.check_rows``), or the call raises.  The lanes per row group
    are ``dia_rows.ax_plan`` of the shape, for ``plan_parts`` parts (default
    the tensors' P: a process of a multi-process run passes the count of
    all parts, so that its sums run in the serial backend's order);
    ``_plan`` overrides them for the GPU tests and ``chip_smoke.py``, which
    time and check every plan."""
    if not _check("ax_core", vals, (xcore,), tap):
        return ax_core_plain(vals, xcore, tap)
    P, m, n_off, Lq = vals.shape
    check_rows("ax_core", Lq, (vals, xcore), vec_of(xcore.element_size()))
    if max(n_off, m) * Lq >= 2**31:
        raise ValueError(f"ax_core: {max(n_off, m) * Lq} rows of a part exceed int32 offsets")
    plan = _plan or ax_plan(plan_parts or P, m, n_off, Lq, xcore.element_size())
    out = torch.empty_like(xcore)
    code = _build.entry("pat_ax_core", xcore.dtype, vals.dtype)(
        vals.data_ptr(), xcore.data_ptr(), out.data_ptr(),
        tap.on(vals.device).data_ptr(), P, m, n_off, Lq, plan.lanes, _build.stream_of(vals),
    )
    _build.check(code, "ax_core")
    return out


def gs_sweeps(
    vals: torch.Tensor,
    bd: torch.Tensor,
    invd: torch.Tensor,
    xcore: Optional[torch.Tensor],
    tap: TapTable,
    order: Sequence[int],
    plan_parts: Optional[int] = None,
    _plan: Optional[SweepPlan] = None,
) -> torch.Tensor:
    """K3.  Runs the color steps of ``order`` on a copy of ``xcore``
    [P, m, Lq] (``None``: a zero guess) and returns it; vals
    [P, m, n_off, Lq] (the vectors' dtype or a narrow pair), bd and invd
    [P, m, Lq].  A CPU tensor goes to
    ``gs_sweeps_plain``; a CUDA tensor goes to the kernel, one launch for
    the whole sequence (Lq and every start in whole 16-byte steps), or the
    call raises.  The launch's lanes and CTAs are
    ``dia_rows.sweep_plan`` of the shape, for ``plan_parts`` parts (as in
    ``ax_core``); ``_plan`` overrides them for the GPU tests and
    ``chip_smoke.py``, which time and check every plan."""
    cores = (bd, invd) if xcore is None else (bd, invd, xcore)
    if not _check("gs_sweeps", vals, cores, tap):
        start = torch.zeros_like(bd) if xcore is None else xcore
        return gs_sweeps_plain(vals, bd, invd, start, tap, order)
    P, m, n_off, Lq = vals.shape
    check_rows("gs_sweeps", Lq, (vals, *cores), vec_of(bd.element_size()))
    if m * n_off * Lq >= 2**31:
        raise ValueError(f"gs_sweeps: a part's {m * n_off * Lq} values exceed int32 offsets")
    plan = _plan or sweep_plan(plan_parts or P, m, n_off, Lq, bd.element_size())
    x = torch.empty_like(bd)
    code = _build.entry("pat_gs_sweeps", bd.dtype, vals.dtype)(
        vals.data_ptr(), bd.data_ptr(), invd.data_ptr(),
        None if xcore is None else xcore.data_ptr(), x.data_ptr(),
        tap.on(vals.device).data_ptr(), tap.steps_on(order, vals.device).data_ptr(),
        len(order), int(xcore is None), plan.lanes, plan.width,
        P, m, n_off, Lq, _build.stream_of(vals),
    )
    _build.check(code, "gs_sweeps")
    return x
