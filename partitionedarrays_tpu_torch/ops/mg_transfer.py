"""The HPCG V-cycle's level transfers in the de-interleaved core layout:
kernel wrappers and plain versions.

Restriction is injection of the even-coordinate points of a part's C-ordered
box ``(nx, ny, nz)``, prolongation its transpose.  Both address the levels'
cores ``[P, m, Lq]`` (``solvers/gs_dia.py``) through the de-interleave map:
own point j sits at core slot ``(j mod m) * Lq + j // m``
(``parallel/exchange_plan.py::core_slot``).  Coarse point ``jc = (ix, iy,
iz)`` of the ``(nx/2, ny/2, nz/2)`` box is fine point ``j = ((2 ix) ny +
2 iy) nz + 2 iz``.

- ``restrict_core(rd, box, coarse_core)``: the coarse core whose slot of
  each coarse point holds the fine core's value at its fine point, and
  whose padding is zero, as a de-interleave leaves it.
- ``prolong_add_core_(xf, xc, box)``: ``xf`` at each coarse point's fine
  slot plus ``xc`` at its coarse slot, in place; every other slot of ``xf``
  is untouched.  One rounding a slot, so ``xf`` ends bit for bit as
  ``xf + deinterleave(prolongation of xc)`` in standard order.

The map depends only on the fine box and the two cores' ``(m, Lq)``, which
every part shares (HPCG's part boxes are equal).  The CUDA kernels are
``csrc/mg_transfer.cu``, one thread per coarse core slot; its source note
says what bounds them.  They replace no TPU kernel: the reference's
selection matmul and dilated pad are layout devices of XLA in standard
order (``partitionedarrays_tpu/models/hpcg/mg.py``).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .. import _build
from ..parallel.exchange_plan import core_slot

_DTYPES = (torch.float32, torch.float64)


def _slots(box: Sequence[int], fine_core: Tuple[int, int], coarse_core: Tuple[int, int],
           device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(coarse core slots, fine core slots) of the coarse points, in the
    coarse box's C order (int64)."""
    nx, ny, nz = box
    nyc, nzc = ny // 2, nz // 2
    jc = torch.arange((nx // 2) * nyc * nzc, device=device)
    iz, q = jc % nzc, jc // nzc
    iy, ix = q % nyc, q // nyc
    j = ((2 * ix) * ny + 2 * iy) * nz + 2 * iz
    return core_slot(jc, coarse_core), core_slot(j, fine_core)


def restrict_core_plain(rd: torch.Tensor, box: Sequence[int],
                        coarse_core: Tuple[int, int]) -> torch.Tensor:
    """``restrict_core`` by a gather into a zero coarse core."""
    P, m, Lq = rd.shape
    mc, Lqc = coarse_core
    cs, fs = _slots(box, (m, Lq), coarse_core, rd.device)
    rc = rd.new_zeros((P, mc * Lqc))
    rc[:, cs] = rd.reshape(P, m * Lq)[:, fs]
    return rc.view(P, mc, Lqc)


def prolong_add_core_plain_(xf: torch.Tensor, xc: torch.Tensor,
                            box: Sequence[int]) -> torch.Tensor:
    """``prolong_add_core_`` by a gather, an add and a scatter of the even
    slots."""
    P, m, Lq = xf.shape
    _, mc, Lqc = xc.shape
    cs, fs = _slots(box, (m, Lq), (mc, Lqc), xf.device)
    flat = xf.view(P, m * Lq)
    flat[:, fs] = flat[:, fs] + xc.reshape(P, mc * Lqc)[:, cs]
    return xf


def _check(name: str, fine: torch.Tensor, coarse: torch.Tensor, box: Sequence[int]):
    """Validate a level pair; True where the kernel is to run (a CUDA
    tensor), False for the plain version (a CPU tensor)."""
    if fine.dim() != 3 or coarse.dim() != 3 or fine.shape[0] != coarse.shape[0]:
        raise ValueError(f"{name}: cores {tuple(fine.shape)} and {tuple(coarse.shape)}")
    nx, ny, nz = box
    if min(box) <= 0 or nx % 2 or ny % 2 or nz % 2:
        raise ValueError(f"{name}: box {tuple(box)} is not even")
    _, m, Lq = fine.shape
    _, mc, Lqc = coarse.shape
    if nx * ny * nz > m * Lq or (nx // 2) * (ny // 2) * (nz // 2) > mc * Lqc:
        raise ValueError(f"{name}: box {tuple(box)} for cores {tuple(fine.shape)} and "
                         f"{tuple(coarse.shape)}")
    if fine.dtype != coarse.dtype:
        raise TypeError(f"{name}: cores of {fine.dtype} and {coarse.dtype}")
    if fine.device != coarse.device:
        raise ValueError(f"{name}: cores on {fine.device} and {coarse.device}")
    if fine.device.type == "cpu":
        return False
    if fine.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {fine.device}")
    if fine.dtype not in _DTYPES:
        raise TypeError(f"{name}: no kernel for {fine.dtype}")
    if not (fine.is_contiguous() and coarse.is_contiguous()):
        raise ValueError(f"{name}: cores must be contiguous")
    if m * Lq >= 2**31 or mc * Lqc >= 2**31 or fine.shape[0] > 65535:
        raise ValueError(f"{name}: cores {tuple(fine.shape)}, {tuple(coarse.shape)} exceed "
                         "int32 offsets or the grid's parts")
    return True


def restrict_core(rd: torch.Tensor, box: Sequence[int],
                  coarse_core: Tuple[int, int]) -> torch.Tensor:
    """Injection of the fine core ``rd [P, m, Lq]`` of the part box ``box``
    (the fine level's ``(nx, ny, nz)``) into a new coarse core ``[P, mc,
    Lqc]``, ``coarse_core = (mc, Lqc)``.  A CPU tensor goes to
    ``restrict_core_plain``; a CUDA tensor goes to the kernel (C entry
    ``mg_restrict_core``), or the call raises."""
    box = tuple(int(v) for v in box)
    mc, Lqc = (int(v) for v in coarse_core)
    if rd.dim() != 3:
        raise ValueError(f"restrict_core: core {tuple(rd.shape)}")
    P, m, Lq = rd.shape
    rc = rd.new_empty((P, mc, Lqc))
    if not _check("restrict_core", rd, rc, box):
        return restrict_core_plain(rd, box, (mc, Lqc))
    code = _build.entry("pat_mg_restrict_core", rd.dtype)(
        rd.data_ptr(), rc.data_ptr(), *box, m, Lq, mc, Lqc, P, _build.stream_of(rd),
    )
    _build.check(code, "mg_restrict_core")
    return rc


def prolong_add_core_(xf: torch.Tensor, xc: torch.Tensor, box: Sequence[int]) -> torch.Tensor:
    """Add the prolongation of the coarse core ``xc [P, mc, Lqc]`` into the
    fine core ``xf [P, m, Lq]`` of the part box ``box``, in place; returns
    xf.  A CPU tensor goes to ``prolong_add_core_plain_``; a CUDA tensor goes
    to the kernel (C entry ``mg_prolong_core``), or the call raises."""
    box = tuple(int(v) for v in box)
    if not _check("prolong_add_core_", xf, xc, box):
        return prolong_add_core_plain_(xf, xc, box)
    P, m, Lq = xf.shape
    _, mc, Lqc = xc.shape
    code = _build.entry("pat_mg_prolong_core", xf.dtype)(
        xf.data_ptr(), xc.data_ptr(), *box, m, Lq, mc, Lqc, P, _build.stream_of(xf),
    )
    _build.check(code, "mg_prolong_core")
    return xf
