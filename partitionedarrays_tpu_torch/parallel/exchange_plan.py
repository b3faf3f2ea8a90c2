"""Padded vector layouts and halo-exchange plans.

Counterpart of ``partitionedarrays_tpu/parallel/exchange_plan.py``
(``VectorLayout`` :243-293, ``ExchangePlan.apply`` :104-136).  A vector on
``P`` parts is stored as ``own[P, n_own_pad]`` and ``ghost[P, n_ghost_pad]``
with sizes padded to a multiple of 8 and the padding kept at zero.

So far only partitions without ghosts exist, and their exchange plans have
zero rounds.  The plan object exists so that the code that will run the
rounds already calls it; a plan with rounds raises.

When the rounds come, note that the reference marks padding lanes with an
out-of-range sentinel (``OOB``) and relies on JAX's ``mode="fill"`` and
``mode="drop"``; torch indexing raises on the CPU and device-asserts on
CUDA, so the port will need a dump slot or a mask instead.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..backends import GHOSTED_PARTS
from .partition import PRange


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m if x > 0 else 0


class ExchangePlan:
    """A one-direction exchange from source slots into destination slots.

    ``perms[r]`` lists the (source part, destination part) pairs of round
    ``r``.  Only the plan with no rounds is supported.
    """

    def __init__(self, perms: Tuple = ()):
        self.perms = tuple(tuple(p) for p in perms)

    @property
    def n_rounds(self) -> int:
        return len(self.perms)

    def apply(
        self, src_vals: torch.Tensor, dst_vals: torch.Tensor, combine: str
    ) -> torch.Tensor:
        """Run all rounds; ``combine`` is "add" (assemble) or "set"
        (consistent)."""
        if combine not in ("add", "set"):
            raise ValueError(combine)
        if self.n_rounds == 0:
            return dst_vals
        raise NotImplementedError(GHOSTED_PARTS)


class VectorLayout:
    """Padded sizes and exchange plans of vectors partitioned by ``pr``."""

    def __init__(self, pr: PRange, pad: int = 8):
        self.pr = pr
        self.n_parts = pr.n_parts
        self.n_own = np.array([p.n_own for p in pr.parts], dtype=np.int64)
        self.n_ghost = np.array([p.n_ghost for p in pr.parts], dtype=np.int64)
        self.n_own_pad = _round_up(int(self.n_own.max()), pad)
        self.n_ghost_pad = _round_up(int(self.n_ghost.max()), pad)
        self.assemble_plan = ExchangePlan()
        self.consistent_plan = ExchangePlan()

    def __repr__(self):
        return (
            f"VectorLayout(P={self.n_parts}, n_own_pad={self.n_own_pad}, "
            f"n_ghost_pad={self.n_ghost_pad}, rounds="
            f"{self.assemble_plan.n_rounds})"
        )


def layout_of(pr: PRange) -> VectorLayout:
    """The layout of ``pr``, built once and kept on the range."""
    if pr._layout is None:
        pr._layout = VectorLayout(pr)
    return pr._layout
