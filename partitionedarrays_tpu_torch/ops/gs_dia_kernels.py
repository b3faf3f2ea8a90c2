"""K3 and K4: the colored DIA Gauss-Seidel kernels, wrappers and plain
versions.

Both work on the de-interleaved core layout of ``solvers/gs_dia.py``: the
unknowns of color ``c`` (rows ``m*i + c``) form row ``c`` of a
``[P, m, Lq]`` core, and tap ``d`` of color ``c`` reads the flattened core at
``tap[c][d] + i`` (zero outside ``[0, m*Lq)``).

- K4 ``ax_core`` replaces ``partitionedarrays_tpu/ops/gs_pallas.py::
  ax_core_pallas``: ``A_own_own @ x`` in the core layout.
- K3 ``gs_sweeps`` replaces ``partitionedarrays_tpu/ops/gs_pallas.py::
  gs_sweep_pallas``: a sequence of color updates, run as one kernel launch
  per color step, in order.

The CUDA kernels are ``csrc/gs_dia.cu``; its source note says why one
launch per color is race-free, what bounds the kernels (device-memory
bandwidth: one pass over the values plus x) and how the design meets that.
The TPU's padded flat buffer, aligned windows and scalar-prefetched color
schedule do not carry over: the kernels read the core with masked loads.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from .. import _build

_DTYPES = (torch.float32, torch.float64)


class TapTable:
    """Per-color tap offsets into the flattened ``[m, Lq]`` core, with one
    int32 copy per device for the kernels."""

    def __init__(self, taps: Sequence[Sequence[int]]):
        self.host: Tuple[Tuple[int, ...], ...] = tuple(
            tuple(int(t) for t in row) for row in taps
        )
        self.m = len(self.host)
        self.n_off = len(self.host[0]) if self.host else 0
        self._dev: Dict[torch.device, torch.Tensor] = {}

    def on(self, device: torch.device) -> torch.Tensor:
        t = self._dev.get(device)
        if t is None:
            t = torch.tensor(self.host, dtype=torch.int32, device=device)
            self._dev[device] = t
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
        if t.dtype != vals.dtype:
            raise TypeError(f"{name}: values {vals.dtype} and vectors {t.dtype} differ")
        if t.device != vals.device:
            raise ValueError(f"{name}: values on {vals.device}, a vector on {t.device}")
    if vals.device.type == "cpu":
        return False
    if vals.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {vals.device}")
    if vals.dtype not in _DTYPES:
        raise TypeError(f"{name}: no kernel for {vals.dtype}")
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
    acc = torch.zeros_like(vals[:, c, 0])
    for d, t in enumerate(tap.host[c]):
        acc = acc + vals[:, c, d] * xflat[:, left + t : left + t + Lq]
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


def ax_core(vals: torch.Tensor, xcore: torch.Tensor, tap: TapTable) -> torch.Tensor:
    """K4.  vals [P, m, n_off, Lq], xcore [P, m, Lq] -> [P, m, Lq].  A CPU
    tensor goes to ``ax_core_plain``; a CUDA tensor goes to the kernel, or
    the call raises."""
    if not _check("ax_core", vals, (xcore,), tap):
        return ax_core_plain(vals, xcore, tap)
    P, m, n_off, Lq = vals.shape
    out = torch.empty_like(xcore)
    code = _build.entry("pat_ax_core", vals.dtype)(
        vals.data_ptr(), xcore.data_ptr(), out.data_ptr(),
        tap.on(vals.device).data_ptr(), P, m, n_off, Lq, _build.stream_of(vals),
    )
    ax_core.launches += 1
    _build.check(code, "ax_core")
    return out


ax_core.launches = 0


def gs_sweeps(
    vals: torch.Tensor,
    bd: torch.Tensor,
    invd: torch.Tensor,
    xcore: torch.Tensor,
    tap: TapTable,
    order: Sequence[int],
) -> torch.Tensor:
    """K3.  Runs the color steps of ``order`` on a copy of ``xcore``
    [P, m, Lq] and returns it; vals [P, m, n_off, Lq], bd and invd
    [P, m, Lq].  A CPU tensor goes to ``gs_sweeps_plain``; a CUDA tensor
    goes to the kernel, one launch per color step, or the call raises."""
    if not _check("gs_sweeps", vals, (bd, invd, xcore), tap):
        return gs_sweeps_plain(vals, bd, invd, xcore, tap, order)
    P, m, n_off, Lq = vals.shape
    x = xcore.clone()
    fn = _build.entry("pat_gs_color", vals.dtype)
    tap_dev = tap.on(vals.device).data_ptr()
    stream = _build.stream_of(vals)
    for c in order:
        code = fn(
            vals.data_ptr(), bd.data_ptr(), invd.data_ptr(), x.data_ptr(),
            tap_dev, int(c), P, m, n_off, Lq, stream,
        )
        gs_sweeps.launches += 1
        _build.check(code, "gs_sweeps")
    return x


gs_sweeps.launches = 0
