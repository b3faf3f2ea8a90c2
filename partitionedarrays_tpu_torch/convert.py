"""Build the port's HPCG objects from the JAX reference's state.

The reference's state arrives as numpy arrays (``np.asarray`` of the JAX
arrays), so that both packages can be fed exactly the same operator,
right-hand side and smoother values.  This module imports no JAX.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import scipy.sparse as sp
import torch

from .backends import SerialBackend
from .models.hpcg.mg import HPCGMGPreconditioner
from .ops.blocks import freeze_block, make_dia_block
from .parallel.exchange_plan import layout_of
from .parallel.partition import PRange, uniform_partition
from .psparse import DeviceSpMat, PSparseMatrix
from .pvector import PVector
from .solvers.gs_dia import ColoredDIAGS
from .solvers.smoothers import GaussSeidel


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def from_jax_arrays(
    levels: Sequence[Mapping], backend: Optional[SerialBackend] = None, device="cuda"
) -> HPCGMGPreconditioner:
    """An HPCG MG preconditioner (with its operators and rhs) on ``device``.

    ``levels`` runs coarsest first; each level maps

    - ``local_shape``: the box (nx, ny, nz) of each part;
    - ``offsets``: the DIA offsets of the own block;
    - ``oo_vals``: ``A.device().oo.vals``, ``[P, n_off, R]``;
    - ``b_own``: ``b.own``, ``[P, n_own_pad]``;
    - ``vals_d``: the ``ColoredDIAGS`` values, ``[P, m, n_off, Lq]`` (the
      reference's layout when its ``flat_vals`` is False);
    - ``invd_d``: the ``ColoredDIAGS`` inverse diagonal, ``[P, m, Lq]``;

    and, with more than one part,

    - ``parts_per_dir``: the part grid (px, py, pz);
    - ``ghost_to_global``, ``ghost_to_owner``: per part, the column
      partition's ghosts (``A.col_prange[p]``);
    - ``oh_indptr``, ``oh_indices``, ``oh_data``: per part, the CSR arrays of
      the own-ghost block ``A.blocks[p]["oh"]``.

    The port builds its own layouts, exchange plans and device blocks from
    these.
    """
    As, bs, gss, shapes = [], [], [], []
    for lev in levels:
        oo_vals = np.asarray(lev["oo_vals"])
        P = oo_vals.shape[0]
        if backend is None:
            backend = SerialBackend(P)
        shape = tuple(int(v) for v in lev["local_shape"])
        ppd = tuple(int(v) for v in lev.get("parts_per_dir", (1,) * len(shape)))
        if int(np.prod(ppd)) != P:
            raise ValueError(f"{P} parts of oo_vals on a part grid {ppd}")
        gshape = tuple(s * p for s, p in zip(shape, ppd))
        row_parts = uniform_partition(ppd, gshape)
        if P > 1:
            col_parts = [
                part.replace_ghost(g, o)
                for part, g, o in zip(row_parts, lev["ghost_to_global"], lev["ghost_to_owner"])
            ]
            row_pr, col_pr = PRange(row_parts), PRange(col_parts)
        else:
            row_pr = col_pr = PRange(row_parts)
        rlay, clay = layout_of(row_pr), layout_of(col_pr)
        if oo_vals.shape[2] != rlay.n_own_pad:
            raise ValueError(f"oo_vals {oo_vals.shape} for a box of {rlay.n_own_pad} padded rows")
        offsets = tuple(int(o) for o in lev["offsets"])
        oo = make_dia_block(offsets, clay.n_own_pad, _tensor(oo_vals, device))
        nnz = int(np.count_nonzero(oo_vals))
        oh = None
        if P > 1:
            oh_csrs = [
                sp.csr_matrix((np.asarray(d), np.asarray(i), np.asarray(ip)),
                              shape=(part.n_own, part.n_ghost))
                for d, i, ip, part in zip(
                    lev["oh_data"], lev["oh_indices"], lev["oh_indptr"], col_parts
                )
            ]
            oh = freeze_block(oh_csrs, rlay.n_own_pad, max(clay.n_ghost_pad, 1), device=device)
            nnz += sum(m.nnz for m in oh_csrs)
        A = PSparseMatrix(DeviceSpMat(oo, oh), row_pr, col_pr, backend, nnz=nnz)
        own = _tensor(lev["b_own"], device)
        b = PVector(own, own.new_zeros((P, rlay.n_ghost_pad)), rlay, backend)
        colored = ColoredDIAGS.from_arrays(
            offsets, rlay.n_own_pad, _tensor(lev["vals_d"], device), _tensor(lev["invd_d"], device)
        )
        As.append(A)
        bs.append(b)
        gss.append(GaussSeidel(A, colored=colored))
        shapes.append(shape)
    return HPCGMGPreconditioner.from_levels(As, bs, gss, shapes, backend)
