"""Build the port's objects from the JAX reference's state.

The reference's state arrives as numpy arrays (``np.asarray`` of the JAX
arrays) and scipy matrices, so that both packages can be fed exactly the
same operator, right-hand side and smoother values: ``from_jax_arrays``
(an HPCG MG hierarchy) and ``psparse_from_host_blocks`` (any partitioned
matrix, e.g. an AMG level operator).  This module imports no JAX.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import scipy.sparse as sp
import torch

from .backends import SerialBackend
from .config import torch_dtype, values_dtype
from .models.hpcg.mg import HPCGMGPreconditioner
from .ops.blocks import freeze_block, make_dia_block
from .parallel.exchange_plan import layout_of
from .parallel.partition import INT, LocalIndices, PRange, uniform_partition
from .psparse import DeviceSpMat, PSparseMatrix
from .pvector import PVector
from .solvers.gs_dia import ColoredDIAGS
from .solvers.smoothers import GaussSeidel


def _tensor(a, device) -> torch.Tensor:
    """A numpy array as a tensor on ``device``; a bfloat16 array (the
    reference's reduced-precision values: ``ml_dtypes``' dtype, which torch
    cannot read) through its bits, so that ``ml_dtypes`` is never
    imported."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


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
      reference's layout when its ``flat_vals`` is False), in the vectors'
      dtype or narrower (its ``values_dtype``: bfloat16 arrays of
      ``ml_dtypes`` are taken bit for bit);
    - ``invd_d``: the ``ColoredDIAGS`` inverse diagonal, ``[P, m, Lq]``;
    - optionally ``values_dtype``: the storage dtype of ``vals_d`` (a torch
      or numpy dtype or its name), to which it is rounded;

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
            offsets, rlay.n_own_pad, _tensor(lev["vals_d"], device), _tensor(lev["invd_d"], device),
            values_dtype(lev.get("values_dtype")),
        )
        As.append(A)
        bs.append(b)
        gss.append(GaussSeidel(A, colored=colored))
        shapes.append(shape)
    return HPCGMGPreconditioner.from_levels(As, bs, gss, shapes, backend)


def _local_indices(parts: Sequence[Mapping]):
    """Per-part index maps -> ``LocalIndices`` with an owner table built
    from every part's own ids."""
    n_global = int(parts[0]["n_global"])
    owner = np.full(n_global, -1, dtype=INT)
    for p, part in enumerate(parts):
        owner[np.asarray(part["own_to_global"], dtype=INT)] = p

    def g2owner(q):
        q = np.asarray(q, dtype=INT).ravel()
        return np.where(q >= 0, owner[np.clip(q, 0, None)], -1).astype(INT)

    return [
        LocalIndices(
            n_global, p, len(parts), part["own_to_global"], part.get("ghost_to_global", ()),
            part.get("ghost_to_owner", ()), global_to_owner=g2owner,
        )
        for p, part in enumerate(parts)
    ]


def psparse_from_host_blocks(
    blocks: Sequence[Mapping],
    row_parts: Sequence[Mapping],
    col_parts: Sequence[Mapping],
    backend: Optional[SerialBackend] = None,
    assembled: bool = True,
    device="cuda",
    device_dtype=None,
) -> PSparseMatrix:
    """A partitioned matrix built by the reference, on ``device``.

    - ``blocks[p]``: part p's host blocks ``"oo"`` and ``"oh"`` (and
      ``"ho"``, ``"hh"`` when ``assembled`` is False), scipy sparse or
      dense numpy, in the reference's local numbering (the reference's
      ``A.blocks[p]``);
    - ``row_parts[p]``, ``col_parts[p]``: part p's ``n_global``,
      ``own_to_global`` and, with ghosts, ``ghost_to_global`` and
      ``ghost_to_owner`` (the reference's ``A.row_prange[p]`` and
      ``A.col_prange[p]``), in the reference's order, which fixes the
      ghost columns' order and the exchange plans.

    The blocks freeze on first use, in ``device_dtype`` (default: the
    blocks' dtype)."""
    names = ("oo", "oh") if assembled else ("oo", "oh", "ho", "hh")
    host = [{k: sp.csr_matrix(b[k]) for k in names} for b in blocks]
    rows, cols = _local_indices(row_parts), _local_indices(col_parts)
    for p, (b, li_r, li_c) in enumerate(zip(host, rows, cols)):
        if b["oo"].shape != (li_r.n_own, li_c.n_own) or b["oh"].shape != (li_r.n_own, li_c.n_ghost):
            raise ValueError(f"part {p}: blocks {b['oo'].shape}, {b['oh'].shape} do not fit "
                             f"{li_r.n_own} own rows, {li_c.n_own} own and {li_c.n_ghost} ghost columns")
    if backend is None:
        backend = SerialBackend(len(host))
    return PSparseMatrix(
        None, PRange(rows), PRange(cols), backend, blocks=host, device=device,
        device_dtype=None if device_dtype is None else torch_dtype(device_dtype),
        assembled=assembled,
    )
