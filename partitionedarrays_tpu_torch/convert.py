"""Build the port's HPCG objects from the JAX reference's state.

The reference's state arrives as numpy arrays (``np.asarray`` of the JAX
arrays), so that both packages can be fed exactly the same operator,
right-hand side and smoother values.  This module imports no JAX.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from .backends import GHOSTED_PARTS, SerialBackend
from .models.hpcg.mg import HPCGMGPreconditioner
from .ops.blocks import make_dia_block
from .parallel.exchange_plan import layout_of
from .parallel.partition import PRange, uniform_partition
from .psparse import DeviceSpMat, PSparseMatrix
from .pvector import PVector
from .solvers.gs_dia import ColoredDIAGS
from .solvers.smoothers import GaussSeidel


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def from_jax_arrays(
    levels: Sequence[Mapping], backend: Optional[SerialBackend] = None, device="cpu"
) -> HPCGMGPreconditioner:
    """An HPCG MG preconditioner (with its operators and rhs) on ``device``.

    ``levels`` runs coarsest first; each level maps

    - ``local_shape``: the box (nx, ny, nz);
    - ``offsets``: the DIA offsets of the own block;
    - ``oo_vals``: ``A.device().oo.vals``, ``[P, n_off, R]``;
    - ``b_own``: ``b.own``, ``[P, n_own_pad]``;
    - ``vals_d``: the ``ColoredDIAGS`` values, ``[P, m, n_off, Lq]`` (the
      reference's layout when its ``flat_vals`` is False);
    - ``invd_d``: the ``ColoredDIAGS`` inverse diagonal, ``[P, m, Lq]``.
    """
    As, bs, gss, shapes = [], [], [], []
    for lev in levels:
        oo_vals = np.asarray(lev["oo_vals"])
        P = oo_vals.shape[0]
        if P != 1:
            raise NotImplementedError(GHOSTED_PARTS)
        if backend is None:
            backend = SerialBackend(P)
        shape = tuple(int(v) for v in lev["local_shape"])
        pr = PRange(uniform_partition((1,) * len(shape), shape))
        lay = layout_of(pr)
        if oo_vals.shape[2] != lay.n_own_pad:
            raise ValueError(f"oo_vals {oo_vals.shape} for a box of {lay.n_own_pad} padded rows")
        offsets = tuple(int(o) for o in lev["offsets"])
        vals = _tensor(oo_vals, device)
        A = PSparseMatrix(
            DeviceSpMat(make_dia_block(offsets, lay.n_own_pad, vals)),
            pr, pr, backend, nnz=int(np.count_nonzero(oo_vals)),
        )
        own = _tensor(lev["b_own"], device)
        b = PVector(own, own.new_zeros((P, lay.n_ghost_pad)), lay, backend)
        colored = ColoredDIAGS.from_arrays(
            offsets, lay.n_own_pad, _tensor(lev["vals_d"], device), _tensor(lev["invd_d"], device)
        )
        As.append(A)
        bs.append(b)
        gss.append(GaussSeidel(A, colored=colored))
        shapes.append(shape)
    return HPCGMGPreconditioner.from_levels(As, bs, gss, shapes, backend)
