"""K1: the standard-order DIA SpMV, kernel wrapper and plain version.

Replaces ``partitionedarrays_tpu/ops/spmv_pallas.py::dia_spmv_pallas_flat``
(the TPU kernel behind ``DeviceBlock.spmv``).  The CUDA kernel is
``csrc/dia_spmv.cu``; its source note says what bounds it (device-memory
bandwidth: one pass over the values plus x) and how the design meets that.
``dia_spmv_plain`` (``ops/dia.py``) is the plain PyTorch version: the
wrapper runs it for CPU tensors, and the tests and ``chip_smoke.py`` hold
the kernel against it.

The TPU kernel keeps x resident in VMEM, walks 1024-aligned windows and
stores the values segment-major to dodge sublane padding; none of that
carries over.  The TPU refused f64; here float32 and float64 go through the
same kernel.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import _build
from .dia import MAX_DIAGS, dia_spmv_plain

__all__ = ["dia_spmv", "dia_spmv_plain"]

_DTYPES = (torch.float32, torch.float64)


def dia_spmv(offsets: Tuple[int, ...], vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y[p, i] = sum_d vals[p, d, i] * x[p, i + offsets[d]], x zero outside
    ``[0, n_cols)``.  vals: [P, n_off, R]; x: [P, n_cols]; returns [P, R].

    A CPU tensor goes to ``dia_spmv_plain``; a CUDA tensor goes to the
    kernel, or the call raises."""
    if vals.dim() != 3 or x.dim() != 2 or vals.shape[0] != x.shape[0]:
        raise ValueError(f"dia_spmv: vals {tuple(vals.shape)} and x {tuple(x.shape)}")
    if vals.shape[1] != len(offsets) and len(offsets) > 0:
        raise ValueError(f"dia_spmv: {len(offsets)} offsets for {vals.shape[1]} diagonals")
    if vals.dtype != x.dtype:
        raise TypeError(f"dia_spmv: values {vals.dtype} and x {x.dtype} differ")
    if vals.device != x.device:
        raise ValueError(f"dia_spmv: values on {vals.device}, x on {x.device}")
    if vals.device.type == "cpu":
        return dia_spmv_plain(offsets, vals, x)
    if vals.device.type != "cuda":
        raise ValueError(f"dia_spmv: no kernel for device {vals.device}")
    if vals.dtype not in _DTYPES:
        raise TypeError(f"dia_spmv: no kernel for {vals.dtype}")
    if not (vals.is_contiguous() and x.is_contiguous()):
        raise ValueError("dia_spmv: vals and x must be contiguous")
    if len(offsets) > MAX_DIAGS:
        raise ValueError(f"dia_spmv: {len(offsets)} diagonals > {MAX_DIAGS}")
    P, _, R = vals.shape
    y = torch.empty((P, R), dtype=vals.dtype, device=vals.device)
    offs = (ctypes.c_int * max(len(offsets), 1))(*(int(o) for o in offsets))
    code = _build.entry("pat_dia_spmv", vals.dtype)(
        vals.data_ptr(), x.data_ptr(), y.data_ptr(), offs, len(offsets),
        R, x.shape[1], P, _build.stream_of(vals),
    )
    dia_spmv.launches += 1
    _build.check(code, "dia_spmv")
    return y


dia_spmv.launches = 0
