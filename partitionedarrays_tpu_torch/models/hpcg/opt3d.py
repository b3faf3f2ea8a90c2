"""Process-grid factorization: split P into (px, py, pz) minimizing the
communication surface (parity: HPCG/src/compute_optimal_xyz.jl:8-64 +
mixed_base_counter.jl — implemented directly as a divisor-triple search).

Copied unchanged from ``partitionedarrays_tpu/models/hpcg/opt3d.py``: the
port must not import the JAX package, whose ``__init__`` loads jax."""
from __future__ import annotations

from typing import Tuple


def compute_optimal_shape_xyz(p: int) -> Tuple[int, int, int]:
    best = None
    best_cost = None
    for px in range(1, p + 1):
        if p % px:
            continue
        q = p // px
        for py in range(1, q + 1):
            if q % py:
                continue
            pz = q // py
            # surface-area proxy for a unit cube split into px*py*pz bricks
            cost = px * py + py * pz + px * pz
            if best_cost is None or cost < best_cost or (
                cost == best_cost and (px, py, pz) < best
            ):
                best = (px, py, pz)
                best_cost = cost
    return best
