"""The serial backend: all parts of a partitioned object on one device.

Counterpart of ``partitionedarrays_tpu/backends.py::SerialBackend``.  The
JAX package drives per-part functions through ``vmap`` over a stacked part
axis; here the part axis is simply dim 0 of every tensor (``[P, ...]``) and
code is written over the stacked tensors directly.  A reduction over parts
(``psum``) is a sum over dim 0.

Only one part is supported so far: many parts need ghost exchange rounds,
which come with the ghosted HPCG slice.
"""
from __future__ import annotations

import torch

GHOSTED_PARTS = "ghosted parts: ROADMAP slice B"


class SerialBackend:
    """``n_parts`` parts stacked along dim 0 of every tensor."""

    def __init__(self, n_parts: int = 1):
        if n_parts < 1:
            raise ValueError(f"n_parts must be positive, got {n_parts}")
        self.n_parts = int(n_parts)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of per-part values ``x[P, ...]`` over the parts."""
        return x.sum(dim=0)

    def __repr__(self):
        return f"SerialBackend(n_parts={self.n_parts})"
