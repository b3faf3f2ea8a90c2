"""K5: the SpMV of a non-banded block, kernel wrapper and plain version.

Replaces ``partitionedarrays_tpu/ops/slot_spmv.py::slot_spmv`` (the TPU
kernel behind ``DeviceBlock.spmv`` for ELL blocks; on the HPCG path it
serves the own-ghost block ``oh``).  The block is a compressed-row ELL
(``ops/blocks.py::stack_rows``) that keeps only the rows with nonzeros:

- ``rows[P, Nr]``: the own row of each compressed row (-1 on padding rows);
- ``cols[P, K, Nr]``, ``vals[P, K, Nr]``: lane k of compressed row i,
  column-major so that neighbouring threads read neighbouring addresses;
  padding lanes carry column -1 and value 0.

The product accumulates into an output ``y[P, R]``:

    y[p, rows[p, i]] += sum_k vals[p, k, i] * x[p, cols[p, k, i]]  (cols >= 0)

or, with ``subtract``, is taken from it (``-=``, the kernel's SUB entries).

The CUDA kernel is ``csrc/ghost_spmv.cu`` over the compressed-row engine
``csrc/ell_rows.cuh``; its source note says what bounds it (device-memory
bandwidth) and how the design meets the paths' two regimes, many short rows
and few long ones.  Its launch plan (warps per group of 32 rows, each
group's lane count) is ``ops/ell_rows.py::plan_of``, kept with the block
(``DeviceBlock.plan``).  The reference's slot format (128-lane windows,
one-hot routing) and its padded ``[P, R, K]`` ELL twin are not mirrored: at
64^3 per part the full ELL would be read as 319 MB per call, the compressed
rows as about 15 MB.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import _build
from .ell_rows import EllPlan, plan_of

_DTYPES = (torch.float32, torch.float64)


def ghost_spmv_plain(
    rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
    y: torch.Tensor, subtract: bool = False,
) -> torch.Tensor:
    """``y[p, rows[p, i]] += sum_k vals[p, k, i] * x[p, cols[p, k, i]]`` over
    the lanes with ``cols >= 0`` (``-=`` with ``subtract``), in place on
    ``y``; returns y.  A gather, a masked sum over the lanes and an
    ``index_add_``: padding columns and rows are clamped to slot 0, and a
    padding row (all lanes padding) adds an exact zero."""
    P, K, Nr = cols.shape
    if Nr == 0 or K == 0:
        return y
    live = cols >= 0
    xg = torch.gather(x, 1, cols.clamp(min=0).reshape(P, K * Nr)).reshape(P, K, Nr)
    contrib = torch.where(live, vals * xg, torch.zeros_like(xg)).sum(dim=1)
    R = y.shape[1]
    part = torch.arange(P, device=rows.device).unsqueeze(1) * R
    y.view(-1).index_add_(0, (part + rows.clamp(min=0)).reshape(-1), contrib.reshape(-1),
                          alpha=-1 if subtract else 1)
    return y


def ghost_spmv(
    rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
    y: torch.Tensor, plan: Optional[EllPlan] = None, subtract: bool = False,
) -> torch.Tensor:
    """K5.  Accumulate the block product into ``y`` (in place; ``subtract``:
    take it from ``y``) and return it.  rows [P, Nr] int32; cols, vals [P,
    K, Nr]; x [P, n_cols]; y [P, R] contiguous.  ``plan``: the block's ``ell_rows.plan_of(cols)``
    (``DeviceBlock.plan``); None computes it here, which copies the columns
    to the host.

    A CPU tensor goes to ``ghost_spmv_plain``; a CUDA tensor goes to the
    kernel, or the call raises."""
    P, K, Nr = cols.shape
    if tuple(vals.shape) != (P, K, Nr) or tuple(rows.shape) != (P, Nr):
        raise ValueError(
            f"ghost_spmv: rows {tuple(rows.shape)}, cols {tuple(cols.shape)}, "
            f"vals {tuple(vals.shape)}"
        )
    if x.dim() != 2 or y.dim() != 2 or x.shape[0] != P or y.shape[0] != P:
        raise ValueError(f"ghost_spmv: x {tuple(x.shape)} and y {tuple(y.shape)} for P={P}")
    if not (vals.dtype == x.dtype == y.dtype):
        raise TypeError(f"ghost_spmv: values {vals.dtype}, x {x.dtype}, y {y.dtype} differ")
    devices = {t.device for t in (rows, cols, vals, x, y)}
    if len(devices) != 1:
        raise ValueError(f"ghost_spmv: operands on {sorted(map(str, devices))}")
    if vals.device.type == "cpu":
        return ghost_spmv_plain(rows, cols, vals, x, y, subtract)
    if vals.device.type != "cuda":
        raise ValueError(f"ghost_spmv: no kernel for device {vals.device}")
    if vals.dtype not in _DTYPES:
        raise TypeError(f"ghost_spmv: no kernel for {vals.dtype}")
    if rows.dtype != torch.int32 or cols.dtype != torch.int32:
        raise TypeError("ghost_spmv: rows and cols must be int32")
    if not all(t.is_contiguous() for t in (rows, cols, vals, x, y)):
        raise ValueError("ghost_spmv: tensors must be contiguous")
    if Nr == 0 or K == 0:
        return y
    if K * Nr >= 2**31:
        raise ValueError(f"ghost_spmv: a part's {K * Nr} lanes exceed int32 offsets")
    if plan is None:
        plan = plan_of(cols)
    glanes = plan.group_lanes
    if tuple(glanes.shape) != (P, -(-Nr // 32)) or glanes.dtype != torch.int32 \
            or glanes.device != cols.device:
        raise ValueError(f"ghost_spmv: the plan's lane counts {tuple(glanes.shape)} do not "
                         f"fit cols {tuple(cols.shape)}")
    code = _build.entry("pat_ghost_spmv_sub" if subtract else "pat_ghost_spmv", vals.dtype)(
        rows.data_ptr(), cols.data_ptr(), vals.data_ptr(), glanes.data_ptr(), x.data_ptr(),
        y.data_ptr(), Nr, K, x.shape[1], y.shape[1], P, plan.lanes, _build.stream_of(vals),
    )
    _build.check(code, "ghost_spmv")
    return y
