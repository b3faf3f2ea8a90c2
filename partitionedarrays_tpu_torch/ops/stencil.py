"""Direct construction of constant-coefficient stencil operators.

Counterpart of ``partitionedarrays_tpu/ops/stencil.py`` (the equal-box
branch of ``stencil_psparse`` :109-357, and ``stencil_rhs_counts``
:426-447).  On a C-ordered box the own-own block of a constant stencil is
exactly DIA, one diagonal per distinct local offset, and each diagonal's
values are a product of 1-D boundary masks.  So the diagonals are built on
the device from per-axis masks, with no triplets, no sort and no host copy
of the values.  Legs that leave the global domain are dropped
(zero-Dirichlet truncation).

Only one part is supported so far: with more parts, legs cross into
neighbour boxes and the matrix gets a ghost block (ROADMAP slice B).
"""
from __future__ import annotations

from functools import reduce
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..backends import GHOSTED_PARTS
from ..config import numpy_dtype, torch_dtype
from ..parallel.exchange_plan import layout_of
from ..parallel.partition import PRange, uniform_partition
from .blocks import make_dia_block


def _axis_masks(loc, org, gshape, delta):
    """Per-axis 1-D masks for the stencil leg ``delta`` from a box with local
    dims ``loc`` at global origin ``org``: (inside_local[d], inside_global[d])."""
    in_loc, in_glob = [], []
    for d in range(len(loc)):
        t = np.arange(loc[d], dtype=np.int64) + delta[d]
        in_loc.append((t >= 0) & (t < loc[d]))
        g = org[d] + t
        in_glob.append((g >= 0) & (g < gshape[d]))
    return in_loc, in_glob


def _outer_and(masks: Sequence[np.ndarray]) -> np.ndarray:
    """AND of 1-D boolean masks broadcast over the box (C order), raveled."""
    nd = len(masks)
    shaped = [
        m.reshape((1,) * d + (-1,) + (1,) * (nd - d - 1)) for d, m in enumerate(masks)
    ]
    return reduce(np.logical_and, shaped).ravel()


def _terms_for(loc, stencil) -> Dict[int, List]:
    """Local offset -> [(delta, value), ...]: on small boxes distinct legs
    can share one offset (their masks never overlap)."""
    nd = len(loc)
    strides = [int(np.prod(loc[d + 1 :], dtype=np.int64)) for d in range(nd)]
    terms: Dict[int, list] = {}
    for delta, value in stencil:
        off = int(sum(d * s for d, s in zip(delta, strides)))
        terms.setdefault(off, []).append((delta, value))
    return terms


def stencil_psparse(
    parts_per_dir: Sequence[int],
    gshape: Sequence[int],
    stencil: Sequence[Tuple[Tuple[int, ...], float]],
    backend,
    dtype=np.float64,
    device="cpu",
):
    """Assembled PSparseMatrix of a constant-coefficient stencil operator.

    ``stencil``: iterable of (offset tuple, value), the center included.
    The own-own DIA values ``[P, n_off, n_own_pad]`` are built on ``device``.
    """
    from ..psparse import DeviceSpMat, PSparseMatrix

    gshape = tuple(int(v) for v in gshape)
    parts_per_dir = tuple(int(v) for v in parts_per_dir)
    stencil = [(tuple(int(x) for x in d), float(v)) for d, v in stencil]
    parts = uniform_partition(parts_per_dir, gshape)
    P = len(parts)
    if P != 1 or backend.n_parts != P:
        raise NotImplementedError(GHOSTED_PARTS)
    loc = parts[0].shape
    nd = len(loc)
    R = int(np.prod(loc))
    terms = _terms_for(loc, stencil)
    all_offs = sorted(terms)
    pr = PRange(parts)
    lay = layout_of(pr)
    np_dtype = numpy_dtype(dtype)

    vals = torch.zeros(
        (P, max(len(all_offs), 1), lay.n_own_pad), dtype=torch_dtype(dtype), device=device
    )
    for k, o in enumerate(all_offs):
        for delta, value in terms[o]:
            in_loc, _ = _axis_masks(loc, (0,) * nd, loc, delta)
            fs = [torch.from_numpy(m.astype(np_dtype)).to(device) for m in in_loc]
            v = fs[0] * value
            for d in range(1, nd):
                v = v.reshape(v.shape + (1,)) * fs[d]
            vals[:, k, :R] += v.reshape(-1)
    nnz = P * int(torch.count_nonzero(vals[0]))
    oo = make_dia_block(tuple(all_offs), lay.n_own_pad, vals)
    return PSparseMatrix(DeviceSpMat(oo), pr, pr, backend, nnz)


def stencil_rhs_counts(
    parts_per_dir: Sequence[int],
    gshape: Sequence[int],
    offsets: Sequence[Tuple[int, ...]],
) -> List[np.ndarray]:
    """Per-part count of stencil legs that stay inside the global domain
    (per own row, C order), for right-hand sides like HPCG's
    ``b = 26 - n_offdiag``."""
    gshape = tuple(int(v) for v in gshape)
    counts = []
    for part in uniform_partition(parts_per_dir, gshape):
        acc = np.zeros(part.n_own, dtype=np.int64)
        for delta in offsets:
            _, in_glob = _axis_masks(part.shape, part.origin, gshape, delta)
            acc += _outer_and(in_glob)
        counts.append(acc)
    return counts
