"""Setup-tier halo exchange on host arrays.

Copied from ``partitionedarrays_tpu/parallel/primitives.py::host_consistent``
(:258-276), the one primitive the port's setup code needs (the AMG power
method).  All parts are visible in one process, so the exchange is a loop
over the assembly graph.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .partition import PRange


def host_consistent(pr: PRange, own_parts: Sequence[np.ndarray]) -> List[np.ndarray]:
    """Per-part ghost values of ``pr`` filled from their owners' own values
    (the consistent direction of the assembly graph)."""
    g = pr.assembly_graph()
    ghosts = [
        np.zeros(li.n_ghost, dtype=np.asarray(own_parts[p]).dtype)
        for p, li in enumerate(pr.parts)
    ]
    for o in range(pr.n_parts):
        for k, dst in enumerate(g.neighbors_rcv[o]):
            payload = np.asarray(own_parts[o])[g.rcv_own[o][k]]
            j = g.neighbors_snd[dst].index(o)
            ghosts[dst][g.snd_ghost[dst][j]] = payload
    return ghosts
