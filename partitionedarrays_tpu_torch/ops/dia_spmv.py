"""K1, K2 and K7: the DIA SpMV kernels, wrappers and plain versions.

K1 ``dia_spmv`` replaces ``partitionedarrays_tpu/ops/spmv_pallas.py::
dia_spmv_pallas_flat`` (the TPU kernel behind ``DeviceBlock.spmv``).  K2
``dia_spmv_strided`` replaces ``partitionedarrays_tpu/ops/spmv_pallas.py::
dia_spmv_pallas`` (the per-color SpMV of ``ColoredDIAGS.sweep_flat``): the
same product over values and x whose parts lie at any stride, so that one
color of the de-interleaved values is read in place.  The CUDA kernels are
``csrc/dia_spmv.cu``; its source note says what bounds them (device-memory
bandwidth: one pass over the values plus x) and how each design meets
that.  K1 is a row loop with one thread per row.  K2 runs the row engine
that it shares with K3 (``csrc/dia_rows.cuh``): 16-byte value loads along
the rows, a chunk of taps in flight per thread, a grid of (row tiles,
parts), and ``lanes`` threads per row group where rows are few
(``ops/dia_rows.py::row_lanes``).  A CUDA view that the engine's 16-byte
loads cannot read raises (``ops/dia_rows.py::check_rows``).
K2 also reads values narrower than x (``_build.NARROW_PAIRS``, the
reduced-precision values of ``ColoredDIAGS``), widened exactly to x's
dtype; K1 takes one dtype (``csrc/dia_spmv.cu`` says why no path needs
more).  ``dia_spmv_plain`` (``ops/dia.py``) is the plain PyTorch version
of both: the wrappers run it for CPU tensors, and the tests and
``chip_smoke.py`` hold the kernels against it.

K7 ``dia_spmv_df`` replaces ``partitionedarrays_tpu/ops/spmv_pallas.py::
dia_spmv_pallas_flat_df``: the same product in df64 (two-float) arithmetic
on (hi, lo) float32 pairs, the fine-operator SpMV of the df64 HPCG.  Its
CUDA kernel is ``csrc/dia_spmv_df.cu``, its plain version
``ops/df64.py::dia_spmv_df_plain`` (the same per-tap order).

The TPU kernels keep x resident in VMEM, walk 1024-aligned windows and
store the values segment-major to dodge sublane padding; none of that
carries over.  The TPU refused f64; here float32 and float64 go through the
same kernel.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Tuple

import torch

from .. import _build
from .df64 import dia_spmv_df_plain
from .dia import MAX_DIAGS, dia_spmv_plain
from .dia_rows import TARGET_THREADS, check_rows, row_lanes, vec_of

__all__ = ["dia_spmv", "dia_spmv_df", "dia_spmv_plain", "dia_spmv_strided"]

_DTYPES = (torch.float32, torch.float64)


def _check(name, offsets, vals, x, narrow: bool = False) -> bool:
    """Validate the operands; True when they go to the kernel.  With
    ``narrow`` the values may also be one of ``_build.NARROW_PAIRS`` with
    x."""
    if vals.dim() != 3 or x.dim() != 2 or vals.shape[0] != x.shape[0]:
        raise ValueError(f"{name}: vals {tuple(vals.shape)} and x {tuple(x.shape)}")
    if vals.shape[1] != len(offsets) and len(offsets) > 0:
        raise ValueError(f"{name}: {len(offsets)} offsets for {vals.shape[1]} diagonals")
    if narrow:
        _build.check_pair(name, vals.dtype, x.dtype)
    elif vals.dtype != x.dtype:
        raise TypeError(f"{name}: values {vals.dtype} and x {x.dtype} differ")
    if vals.device != x.device:
        raise ValueError(f"{name}: values on {vals.device}, x on {x.device}")
    if vals.device.type == "cpu":
        return False
    if vals.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {vals.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: no kernel for {x.dtype}")
    if len(offsets) > MAX_DIAGS:
        raise ValueError(f"{name}: {len(offsets)} diagonals > {MAX_DIAGS}")
    return True


@lru_cache(maxsize=None)
def _offsets_c(offsets: Tuple[int, ...]):
    return (ctypes.c_int * max(len(offsets), 1))(*(int(o) for o in offsets))


def _offsets_arg(offsets):
    """The offsets as a C int array, built once per offsets tuple."""
    return _offsets_c(tuple(offsets))


def dia_spmv(offsets: Tuple[int, ...], vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K1.  y[p, i] = sum_d vals[p, d, i] * x[p, i + offsets[d]], x zero
    outside ``[0, n_cols)``.  vals: [P, n_off, R]; x: [P, n_cols]; returns
    [P, R].

    A CPU tensor goes to ``dia_spmv_plain``; a CUDA tensor goes to the
    kernel, or the call raises."""
    if not _check("dia_spmv", offsets, vals, x):
        return dia_spmv_plain(offsets, vals, x)
    if not (vals.is_contiguous() and x.is_contiguous()):
        raise ValueError("dia_spmv: vals and x must be contiguous")
    P, _, R = vals.shape
    y = torch.empty((P, R), dtype=vals.dtype, device=vals.device)
    code = _build.entry("pat_dia_spmv", vals.dtype)(
        vals.data_ptr(), x.data_ptr(), y.data_ptr(), _offsets_arg(offsets), len(offsets),
        R, x.shape[1], P, _build.stream_of(vals),
    )
    _build.check(code, "dia_spmv")
    return y


def dia_spmv_strided(
    offsets: Tuple[int, ...], vals: torch.Tensor, x: torch.Tensor
) -> torch.Tensor:
    """K2.  The product of ``dia_spmv`` on views: vals [P, n_off, R] and
    x [P, n_cols] may have any part stride (dim 0), while each part's
    values are ``[n_off, R]`` contiguous and each part's x is contiguous
    (e.g. one color ``vals_d[:, c]`` of the de-interleaved values), in x's
    dtype or, narrower, one of ``_build.NARROW_PAIRS``.  Returns a
    contiguous [P, R] in x's dtype.

    A CPU tensor goes to ``dia_spmv_plain``; a CUDA tensor goes to the
    kernel (R and the values' part stride in whole row groups, their start
    a whole load: ``dia_rows.check_rows``), or the call raises."""
    if not _check("dia_spmv_strided", offsets, vals, x, narrow=True):
        return dia_spmv_plain(offsets, vals, x)
    P, n_off, R = vals.shape
    if (n_off > 1 and vals.stride(1) != R) or (R > 1 and vals.stride(2) != 1) or (
        x.shape[1] > 1 and x.stride(1) != 1
    ):
        raise ValueError(
            "dia_spmv_strided: each part's values and x must be contiguous, got "
            f"strides {vals.stride()} and {x.stride()}"
        )
    vec = vec_of(x.element_size())
    check_rows("dia_spmv_strided", R, (vals,), vec)
    y = torch.empty((P, R), dtype=x.dtype, device=vals.device)
    lanes = row_lanes(P * (R // vec), n_off, TARGET_THREADS)
    code = _build.entry("pat_dia_spmv_strided", x.dtype, vals.dtype)(
        vals.data_ptr(), x.data_ptr(), y.data_ptr(), _offsets_arg(offsets), len(offsets),
        R, x.shape[1], P, vals.stride(0), x.stride(0), lanes, _build.stream_of(vals),
    )
    _build.check(code, "dia_spmv_strided")
    return y


def dia_spmv_df(
    offsets: Tuple[int, ...], vals_hi: torch.Tensor, vals_lo: torch.Tensor, x
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7.  The product of ``dia_spmv`` in df64: values ``vals_hi``,
    ``vals_lo`` [P, n_off, R] and x a pair (hi, lo) of [P, n_cols], all
    float32; returns the pair (hi, lo) of [P, R].

    A CPU tensor goes to ``dia_spmv_df_plain``; a CUDA tensor goes to the
    kernel, or the call raises."""
    xh, xl = x
    if vals_lo.shape != vals_hi.shape or xl.shape != xh.shape:
        raise ValueError(
            f"dia_spmv_df: hi/lo shapes {tuple(vals_hi.shape)}/{tuple(vals_lo.shape)} "
            f"and {tuple(xh.shape)}/{tuple(xl.shape)}"
        )
    if any(t.dtype != torch.float32 for t in (vals_hi, vals_lo, xh, xl)):
        raise TypeError("dia_spmv_df: the words of a df64 pair are float32")
    if len({t.device for t in (vals_hi, vals_lo, xh, xl)}) != 1:
        raise ValueError("dia_spmv_df: operands on more than one device")
    if not _check("dia_spmv_df", offsets, vals_hi, xh):
        return dia_spmv_df_plain(offsets, vals_hi, vals_lo, x)
    if not all(t.is_contiguous() for t in (vals_hi, vals_lo, xh, xl)):
        raise ValueError("dia_spmv_df: values and x must be contiguous")
    P, _, R = vals_hi.shape
    yh = torch.empty((P, R), dtype=torch.float32, device=vals_hi.device)
    yl = torch.empty_like(yh)
    code = _build.entry("pat_dia_spmv_df", torch.float32)(
        vals_hi.data_ptr(), vals_lo.data_ptr(), xh.data_ptr(), xl.data_ptr(),
        yh.data_ptr(), yl.data_ptr(), _offsets_arg(offsets), len(offsets),
        R, xh.shape[1], P, _build.stream_of(vals_hi),
    )
    _build.check(code, "dia_spmv_df")
    return yh, yl
