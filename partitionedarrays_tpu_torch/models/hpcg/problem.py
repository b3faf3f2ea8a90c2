"""HPCG problem generation: the 27-point 3-D Laplacian.

Counterpart of ``partitionedarrays_tpu/models/hpcg/problem.py``
(``build_hpcg_problem`` :69-102, structured branch): diagonal 26,
off-diagonals -1 over the 3x3x3 neighbourhood, rhs ``b_i = 26 - (number of
off-diagonal entries of row i)``, zero Dirichlet outside the box.  The
local ``(nx, ny, nz)`` box is replicated on a ``(px, py, pz)`` part grid.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from ...config import numpy_dtype
from ...ops.stencil import stencil_psparse, stencil_rhs_counts
from ...pvector import pvector_from_own

STENCIL_27PT = [
    ((dx, dy, dz), 26.0 if dx == dy == dz == 0 else -1.0)
    for dx in (-1, 0, 1)
    for dy in (-1, 0, 1)
    for dz in (-1, 0, 1)
]


def build_hpcg_problem(
    local_shape: Sequence[int],
    parts_per_dir: Sequence[int],
    backend,
    dtype=np.float64,
    structured: bool = True,
    device="cuda",
):
    """The partitioned 27-point matrix and rhs, built in closed form on
    ``device``.  The generic triplet pipeline (``structured=False``) comes
    with the port's COO assembly."""
    if not structured:
        raise NotImplementedError("structured=False needs psparse COO assembly (ROADMAP)")
    dtype = numpy_dtype(dtype)
    nx, ny, nz = (int(v) for v in local_shape)
    px, py, pz = (int(v) for v in parts_per_dir)
    gshape = (px * nx, py * ny, pz * nz)
    A = stencil_psparse(
        (px, py, pz), gshape, STENCIL_27PT, backend, dtype=dtype, device=device
    )
    offdiag = [d for d, _ in STENCIL_27PT if d != (0, 0, 0)]
    bs = [
        (26.0 - c).astype(dtype)
        for c in stencil_rhs_counts((px, py, pz), gshape, offdiag)
    ]
    b = pvector_from_own(bs, A.row_prange, backend, dtype=dtype, device=device)
    return A, b
