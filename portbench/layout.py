"""Vectors between the benchmark's global order and the port's layout."""
from __future__ import annotations

import numpy as np
import torch

from partitionedarrays_tpu_torch.pvector import PVector

DTYPES = {"float64": (np.float64, torch.float64), "float32": (np.float32, torch.float32)}


def _own_ids(A, device):
    pr = A.row_prange
    return [torch.as_tensor(pr.parts[p].own_to_global, device=device)
            for p in A.backend.local_parts()]


def to_pvector(v: torch.Tensor, A, dtype) -> PVector:
    """The global vector ``v`` (rows in global order) on ``A``'s rows, in
    ``dtype``, ghosts zero."""
    lay = A.row_layout()
    ids = _own_ids(A, v.device)
    own = torch.zeros((len(ids), lay.n_own_pad), dtype=dtype, device=v.device)
    for k, g in enumerate(ids):
        own[k, : g.numel()] = v[g].to(dtype)
    return PVector(own, own.new_zeros((len(ids), lay.n_ghost_pad)), lay, A.backend)


def from_pvector(x: PVector, A) -> torch.Tensor:
    """The own values of ``x`` as one float64 vector in global order."""
    out = torch.zeros(A.shape[0], dtype=torch.float64, device=x.own.device)
    for k, g in enumerate(_own_ids(A, x.own.device)):
        out[g] = x.own[k, : g.numel()].double()
    return out
