#!/usr/bin/env python3
"""What the AMG cycle's CUDA graph (``AMGPreconditioner.__call__``) costs and
saves on one card, on the hierarchies of the 3-D Q1 elasticity problem
(float64, the rigid-body modes, ``AMGParams(coarse_size=400, block_size=3,
max_levels=4)``, as ``portbench``'s ``amg_elasticity`` configuration).

    python3 scripts/amg_graph_cost.py [--nodes 40 16] [--out FILE]

Per mesh, in one process, each the median of host seconds from the call to
the card's synchronise, the card synchronised before the call:

- ``eager_ms``: the cycle run eagerly (``M._cycle(0, r, False)``);
- ``capture_ms``: a key's first call after ``M._drop_graphs()`` (the
  warm-up cycle on a side stream, whose result it returns, the capture and
  the graph's instantiation), as after every setup and ``update``;
- ``replay_ms``: a later call (input copy, replay, output clone);
- ``capture_extra_ms`` = capture - eager: what a key pays over the eager
  cycle it replaces, and ``break_even_calls`` = that over (eager -
  replay): the replays a key needs between two updates before the graph
  has paid for itself;
- ``update_s``: ``M.update(A)`` after a refill of A's values (the reuse
  tier's re-setup), for scale.

Prints one JSON line per mesh and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _ms(fn, n, before=None):
    import torch

    out = []
    for _ in range(n):
        if before is not None:
            before()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(out), out


def measure(nodes: int, repeats: int) -> dict:
    import numpy as np
    import torch

    from partitionedarrays_tpu_torch.backends import SerialBackend
    from partitionedarrays_tpu_torch.models.gallery import (
        linear_elasticity_fem, node_coordinates_unit_cube, nullspace_linear_elasticity)
    from partitionedarrays_tpu_torch.psparse import psparse, psparse_refill
    from partitionedarrays_tpu_torch.pvector import prandn
    from partitionedarrays_tpu_torch.solvers.amg import AMGParams, AMGPreconditioner

    dev = torch.device("cuda")
    n3 = (nodes,) * 3
    I, J, V, rows, cols = linear_elasticity_fem(n3, (1, 1, 1), dtype=np.float64)
    A, cache = psparse(I, J, V, rows, cols, SerialBackend(1), reuse=True, device=dev)
    coords, _ = node_coordinates_unit_cube(n3, (1, 1, 1))
    M = AMGPreconditioner(A, AMGParams(coarse_size=400, block_size=3, max_levels=4),
                          nullspace=nullspace_linear_elasticity(coords, A.row_prange))
    r = prandn(torch.Generator().manual_seed(11), A.row_prange, A.backend, A.dtype, dev)
    M(r)  # the kernels' lazy tables, cuBLAS
    eager, _ = _ms(lambda: M._cycle(0, r, False), 3 * repeats)
    capture, captures = _ms(lambda: M(r), repeats, before=M._drop_graphs)
    replay, _ = _ms(lambda: M(r), 3 * repeats)
    eager2, _ = _ms(lambda: M._cycle(0, r, False), 3 * repeats)
    eager = statistics.median([eager, eager2])
    t0 = time.perf_counter()
    psparse_refill(A, [v * 1.5 for v in V], cache)
    M.update(A)
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    extra = capture - eager
    return {
        "nodes": nodes, "rows": A.shape[0], "levels": [lev.A.shape[0] for lev in M.levels],
        "eager_ms": eager, "capture_ms": capture, "captures_ms": captures,
        "replay_ms": replay, "capture_extra_ms": extra,
        "break_even_calls": extra / (eager - replay) if eager > replay else None,
        "update_s": update_s,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, nargs="+", default=[40, 16])
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--out")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    rows = []
    for nodes in args.nodes:
        rows.append(measure(nodes, args.repeats))
        print(json.dumps(rows[-1]), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps({"card": card, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
