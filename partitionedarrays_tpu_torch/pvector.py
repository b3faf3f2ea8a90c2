"""PVector: a partitioned vector in split own/ghost storage.

Counterpart of ``partitionedarrays_tpu/pvector.py`` (the core at :60-160,
:292-300 and :545-605, the df64 pairs at :715-790).  The parts are stacked
along dim 0: ``own[P, n_own_pad]`` and ``ghost[P, n_ghost_pad]``, with
padding lanes kept at zero so that dots and norms need no mask.

A df64 vector is a (hi, lo) pair of float32 PVectors on one layout; its
dots and norms run compensated (``ops/df64.py``).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .backends import SerialBackend
from .config import numpy_dtype, torch_dtype
from .ops import df64 as df
from .parallel.exchange_plan import VectorLayout, layout_of
from .parallel.partition import PRange


class PVector:
    """own: [P, n_own_pad]; ghost: [P, n_ghost_pad]."""

    def __init__(
        self,
        own: torch.Tensor,
        ghost: torch.Tensor,
        layout: VectorLayout,
        backend: SerialBackend,
    ):
        self.own = own
        self.ghost = ghost
        self.layout = layout
        self.backend = backend

    @property
    def dtype(self) -> torch.dtype:
        return self.own.dtype

    @property
    def n_global(self) -> int:
        return self.layout.pr.n_global

    def copy(self) -> "PVector":
        return PVector(self.own, self.ghost, self.layout, self.backend)

    def __repr__(self):
        return (
            f"PVector(n_global={self.n_global}, P={self.layout.n_parts}, "
            f"dtype={self.own.dtype}, device={self.own.device})"
        )


def pfill(value, pr: PRange, backend, dtype=torch.float32, device="cuda") -> PVector:
    lay = layout_of(pr)
    dt = torch_dtype(dtype)
    own = torch.zeros((lay.n_parts, lay.n_own_pad), dtype=dt, device=device)
    for p, n in enumerate(lay.n_own):
        own[p, :n] = value
    ghost = torch.zeros((lay.n_parts, lay.n_ghost_pad), dtype=dt, device=device)
    for p, n in enumerate(lay.n_ghost):
        ghost[p, :n] = value
    return PVector(own, ghost, lay, backend)


def pzeros(pr: PRange, backend, dtype=torch.float32, device="cuda") -> PVector:
    return pfill(0, pr, backend, dtype, device)


def pones(pr: PRange, backend, dtype=torch.float32, device="cuda") -> PVector:
    return pfill(1, pr, backend, dtype, device)


def pvector_from_own(
    own_parts: Sequence[np.ndarray], pr: PRange, backend, dtype=None, device="cuda"
) -> PVector:
    """Build from per-part own values (host arrays); ghosts start at zero."""
    lay = layout_of(pr)
    parts = [np.asarray(o) for o in own_parts]
    np_dtype = numpy_dtype(dtype if dtype is not None else parts[0].dtype)
    own = np.zeros((lay.n_parts, lay.n_own_pad), dtype=np_dtype)
    for p, o in enumerate(parts):
        own[p, : o.size] = o
    dt = torch_dtype(np_dtype)
    ghost = torch.zeros((lay.n_parts, lay.n_ghost_pad), dtype=dt, device=device)
    return PVector(torch.from_numpy(own).to(device), ghost, lay, backend)


def pdot(x: PVector, y: PVector) -> torch.Tensor:
    """Global dot product over own values, as a 0-d tensor on the device."""
    return x.backend.psum((x.own * y.own).sum(dim=1))


def pnorm(x: PVector) -> torch.Tensor:
    return torch.sqrt(pdot(x, x))


def axpy(a, x: PVector, y: PVector) -> PVector:
    """y + a*x on own and ghost values."""
    return PVector(y.own + a * x.own, y.ghost + a * x.ghost, y.layout, y.backend)


# -- df64 (two-float) pairs ---------------------------------------------------

DFPair = Tuple[PVector, PVector]


def _pair_on(hi: torch.Tensor, lo: torch.Tensor, layout: VectorLayout, backend) -> DFPair:
    """(hi, lo) own words -> a pair of PVectors with zero float32 ghosts."""
    zg = hi.new_zeros((layout.n_parts, layout.n_ghost_pad))
    return PVector(hi, zg, layout, backend), PVector(lo, zg, layout, backend)


def pvector_df64(
    own_f64_parts: Sequence[np.ndarray], pr: PRange, backend, device="cuda"
) -> DFPair:
    """(hi, lo) PVector pair from per-part float64 own values (exact split,
    on ``device``)."""
    lay = layout_of(pr)
    own = np.zeros((lay.n_parts, lay.n_own_pad), dtype=np.float64)
    for p, o in enumerate(own_f64_parts):
        o = np.asarray(o, dtype=np.float64)
        own[p, : o.size] = o
    hi, lo = df.from_f64(torch.from_numpy(own).to(device))
    return _pair_on(hi, lo, lay, backend)


def pvector_split_df64(v: PVector) -> DFPair:
    """Split a PVector's own values into a df64 pair, on its device."""
    hi, lo = df.from_f64(v.own)
    return _pair_on(hi, lo, v.layout, v.backend)


def collect_df64(pair: DFPair) -> np.ndarray:
    """A df64 pair as one host float64 array in global order (exact)."""
    vh, vl = pair
    own = df.to_f64(vh.own, vl.own).cpu().numpy()
    out = np.zeros(vh.n_global, dtype=np.float64)
    for p, part in enumerate(vh.layout.pr.parts):
        out[part.own_to_global] = own[p, : part.n_own]
    return out


def pdot_df64(x_pair: DFPair, y_pair: DFPair):
    """Compensated global dot of two df64 pairs -> (hi, lo) 0-d tensors."""
    (xh, xl), (yh, yl) = x_pair, y_pair
    return df.dot_parts((xh.own, xl.own), (yh.own, yl.own))


def pnorm_df64(x_pair: DFPair):
    """Compensated 2-norm of a df64 pair -> (hi, lo) 0-d tensors."""
    return df.sqrt(pdot_df64(x_pair, x_pair))


def axpy_df64(alpha, x_pair: DFPair, y_pair: DFPair) -> DFPair:
    """y + alpha*x on df64 pairs.  ``alpha``: a (hi, lo) pair of 0-d
    tensors, a Python number (split exactly from float64) or a tensor
    (taken as float32 with a zero lo word)."""
    (xh, xl), (yh, yl) = x_pair, y_pair
    dev = yh.own.device
    if not (isinstance(alpha, tuple) and len(alpha) == 2):
        if isinstance(alpha, (int, float, np.floating)):
            alpha = df.from_f64(torch.tensor(float(alpha), dtype=torch.float64, device=dev))
        else:
            a = torch.as_tensor(alpha, dtype=torch.float32, device=dev)
            alpha = (a, torch.zeros_like(a))
    oh, ol = df.add((yh.own, yl.own), df.scale((xh.own, xl.own), alpha))
    return _pair_on(oh, ol, yh.layout, yh.backend)
