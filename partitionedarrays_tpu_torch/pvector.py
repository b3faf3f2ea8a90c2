"""PVector: a partitioned vector in split own/ghost storage.

Counterpart of ``partitionedarrays_tpu/pvector.py`` (the core at :60-160,
:292-300 and :545-605).  The parts are stacked along dim 0:
``own[P, n_own_pad]`` and ``ghost[P, n_ghost_pad]``, with padding lanes kept
at zero so that dots and norms need no mask.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .backends import SerialBackend
from .config import numpy_dtype, torch_dtype
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


def pfill(value, pr: PRange, backend, dtype=torch.float32, device="cpu") -> PVector:
    lay = layout_of(pr)
    dt = torch_dtype(dtype)
    own = torch.zeros((lay.n_parts, lay.n_own_pad), dtype=dt, device=device)
    for p, n in enumerate(lay.n_own):
        own[p, :n] = value
    ghost = torch.zeros((lay.n_parts, lay.n_ghost_pad), dtype=dt, device=device)
    for p, n in enumerate(lay.n_ghost):
        ghost[p, :n] = value
    return PVector(own, ghost, lay, backend)


def pzeros(pr: PRange, backend, dtype=torch.float32, device="cpu") -> PVector:
    return pfill(0, pr, backend, dtype, device)


def pones(pr: PRange, backend, dtype=torch.float32, device="cpu") -> PVector:
    return pfill(1, pr, backend, dtype, device)


def pvector_from_own(
    own_parts: Sequence[np.ndarray], pr: PRange, backend, dtype=None, device="cpu"
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
