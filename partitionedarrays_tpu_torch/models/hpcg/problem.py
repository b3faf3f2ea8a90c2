"""HPCG problem generation: the 27-point 3-D Laplacian.

Counterpart of ``partitionedarrays_tpu/models/hpcg/problem.py``
(``build_hpcg_problem`` :69-117): diagonal 26, off-diagonals -1 over the
3x3x3 neighbourhood, rhs ``b_i = 26 - (number of off-diagonal entries of
row i)``, zero Dirichlet outside the box.  The local ``(nx, ny, nz)`` box
is replicated on a ``(px, py, pz)`` part grid.  ``hpcg_triplets_for_box``
(:19-58) is copied from the reference.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from ...config import numpy_dtype
from ...ops.stencil import stencil_psparse, stencil_rhs_counts
from ...parallel.partition import PRange, uniform_partition
from ...psparse import psparse
from ...pvector import pvector_from_own

STENCIL_27PT = [
    ((dx, dy, dz), 26.0 if dx == dy == dz == 0 else -1.0)
    for dx in (-1, 0, 1)
    for dy in (-1, 0, 1)
    for dz in (-1, 0, 1)
]


def hpcg_triplets_for_box(
    own_gids: np.ndarray, gshape: Tuple[int, int, int], dtype=np.float64
):
    """COO triplets of the 27-pt operator restricted to the given rows."""
    gx, gy, gz = gshape
    x, y, z = np.unravel_index(own_gids, gshape)
    # all 26 neighbor offsets at once (broadcast over [26, n])
    d = np.array(
        [
            (dx, dy, dz)
            for dx in (-1, 0, 1)
            for dy in (-1, 0, 1)
            for dz in (-1, 0, 1)
            if not (dx == dy == dz == 0)
        ],
        dtype=np.int64,
    )
    xs = x[None, :] + d[:, 0:1]
    ys = y[None, :] + d[:, 1:2]
    zs = z[None, :] + d[:, 2:3]
    valid = (
        (xs >= 0) & (xs < gx) & (ys >= 0) & (ys < gy) & (zs >= 0) & (zs < gz)
    )
    idx = (xs * gy + ys) * gz + zs  # clip-free; masked below
    row_off_count = valid.sum(axis=0).astype(np.int64)
    vflat = valid.ravel()
    I = np.concatenate(
        [np.broadcast_to(own_gids[None, :], valid.shape).ravel()[vflat], own_gids]
    )
    J = np.concatenate([idx.ravel()[vflat], own_gids])
    V = np.concatenate(
        [
            np.full(int(vflat.sum()), -1.0, dtype=dtype),
            np.full(own_gids.size, 26.0, dtype=dtype),
        ]
    )
    # rhs: 26 - number of off-diagonal entries
    b = (26.0 - row_off_count).astype(dtype)
    return I, J, V, b


def build_hpcg_problem(
    local_shape: Sequence[int],
    parts_per_dir: Sequence[int],
    backend,
    dtype=np.float64,
    structured: bool = True,
    device="cuda",
):
    """The partitioned 27-point matrix and rhs on ``device``: in closed
    form (``structured=True``), or through the generic triplet pipeline
    (``psparse``, on any number of parts), which gives the same matrix and
    cross-validates it."""
    dtype = numpy_dtype(dtype)
    nx, ny, nz = (int(v) for v in local_shape)
    px, py, pz = (int(v) for v in parts_per_dir)
    gshape = (px * nx, py * ny, pz * nz)
    if structured:
        A = stencil_psparse(
            (px, py, pz), gshape, STENCIL_27PT, backend, dtype=dtype, device=device
        )
        offdiag = [d for d, _ in STENCIL_27PT if d != (0, 0, 0)]
        bs = [
            (26.0 - c).astype(dtype)
            for c in stencil_rhs_counts((px, py, pz), gshape, offdiag)
        ]
    else:
        pr = PRange(uniform_partition((px, py, pz), gshape))
        Is, Js, Vs, bs = [], [], [], []
        for li in pr.parts:
            I, J, V, b = hpcg_triplets_for_box(li.own_to_global, gshape, dtype)
            Is.append(I)
            Js.append(J)
            Vs.append(V)
            bs.append(b)
        A = psparse(Is, Js, Vs, pr, pr, backend, assembled=True, dtype=dtype, device=device)
    return A, pvector_from_own(bs, A.row_prange, backend, dtype=dtype, device=device)
