"""The general generator that every traffic mix (``traffic/<mix>.json``)
is read by.

A mix is a closed loop of units of work (a CG set, a solve) sent one after
another, each waited for before the next, each from a zero guess, on
right-hand sides drawn in set-up from the seed: ``rhs.pool`` of
them, from ``rhs.dist`` ("normal" or "uniform"), always drawn in float64
on the device and then rounded to the configuration's type, so that one
seed gives the same inputs whatever the type.  Unit ``i`` takes
right-hand side ``i % pool``.  ``trace_units`` is how many units a
``--trace 1`` run profiles after its window.  The problem's scale is the
configuration's: a cell at another scale names another configuration file.
"""
from __future__ import annotations

from typing import Mapping

import torch


def rhs_pool(mix: Mapping, n_rows: int, seed: int, device) -> torch.Tensor:
    """``[pool, n_rows]`` float64 right-hand sides drawn from ``seed`` on
    ``device`` in one call."""
    spec = mix["rhs"]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    shape = (int(spec.get("pool", 1)), int(n_rows))
    if spec["dist"] == "normal":
        return torch.randn(shape, generator=g, dtype=torch.float64, device=device)
    if spec["dist"] == "uniform":
        return torch.rand(shape, generator=g, dtype=torch.float64, device=device)
    raise ValueError(f"unknown right-hand side distribution {spec['dist']!r}")
