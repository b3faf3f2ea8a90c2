"""Smoothed-aggregation algebraic multigrid.

Counterpart of ``partitionedarrays_tpu/solvers/amg.py``: ``aggregate``
(:51-102, the native library; its Python body is ``aggregate_plain``),
``strength_graph`` and ``aggregate_psparse`` (:105-182), ``_detect_box`` and ``box_aggregate_psparse`` (:185-242),
``constant_prolongator`` and ``tentative_prolongator`` with the
per-aggregate nullspace QR (:249-340), ``_diag_parts`` and ``_dinv_parts``
(:343-385), the host power method ``spectral_radius`` (:388-429), ``_make_S``
and ``smoothed_prolongator`` (:494-545), ``_GalerkinCache`` with its
reuse plans (:548-664), ``AMGLevel``, ``AMGParams`` and
``AMGPreconditioner`` (``_setup`` with ``reuse_aggregates``, the box
levels' ``struct`` and the Schwarz level smoother :717-805;
``_coarse_factorize``, ``update`` :905-942, ``_coarse_solve``, the
structured transfers :991-1062, the flat
cycle :1064-1181 and the dispatch of ``_cycle`` :1184-1226 for V and W
cycles, ``statistics``), ``amg`` and ``default_nullspace``.

The coarsening runs on the host with numpy and scipy, the same operations
in the same order as the reference, so aggregates, omega, P and the coarse
operators agree with it number for number.  A box-stencil operator (a DIA
own block on a C-ordered box) under epsilon 0, block size 1 and no
nullspace is aggregated in 3x3x3 boxes, so every coarse operator is again
a box stencil; its levels apply P = (I - omega D^-1 A) P0 as a 3^3 sum-pool
or upsample (plain tensor code) beside one SpMV, and never as a matrix.
The cycle runs on the device: the level smoothers (``GaussSeidel``: the
colored tier K3/K4 on a DIA band, the tile tier K6 elsewhere; or, under
``smoother="schwarz"``, ``AdditiveSchwarz``: ILU(0) solves on K6 or dense
LU factors, with which a box level keeps no ``struct`` and applies P as a
matrix, as in the reference), the residuals (K1 or K5), the transfers (on a box level whose smoother is
colored, the flat cycle keeps x in the smoother's de-interleaved core and
applies A by K4; on another box level by K1; elsewhere by the frozen P and
its transpose on K5), and the coarsest solve as a dense inverse or LU
factors applied by torch.

Every step runs on any number of parts of the serial backend: aggregation
is uncoupled per part, the power method exchanges ghosts on the host, the
Galerkin products are the distributed ``spmm``/``spmtm``, the restriction
``spmtv`` assembles its cross-part contributions back to their owners, and
a box level with ghost columns takes the ghosted flat cycle
(``_cycle_flat_g``: the frozen ghost contribution folded into the core
rhs).  Per-part boxes of unequal shape fall back to generic aggregation,
as in the reference.  On a multi-process backend each process aggregates
and multiplies its own parts (the counts and the products' messages
cross processes), and the coarsest operator is gathered on every process.

``update(A)`` re-coarsens for new values of A at the setup's sparsity:
each level's P, AP and Ac are refilled through its ``_GalerkinCache`` (at
the frozen aggregates and omega), its smoother and box transfer are
refreshed, the coarse factors recomputed and every frozen block restacked;
it never falls back to a new setup.

The reference's ``zsel`` (its z-axis pool as a TPU matmul) is not ported:
the pool pads all three axes.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple, Union

import numpy as np
import scipy.linalg as sla
import scipy.sparse as sp
import torch

from ..ops.native import vanek_aggregate_native
from ..ops.sparse_host import compresscoo, precompute_nzindex
from ..parallel.partition import PRange, variable_partition
from ..parallel.primitives import host_consistent
from ..psparse import (
    PSparseMatrix,
    _canonicalize_blocks,
    _data_parts,
    gather_global_scipy,
    host_blocks,
    psparse,
    spmm,
    spmm_into,
    spmtm,
    spmtm_into,
    spmtv,
    spmv,
)
from ..pvector import PVector
from .smoothers import AdditiveSchwarz, GaussSeidel


def _host_dtype(A: PSparseMatrix) -> np.dtype:
    return host_blocks(A)[0]["oo"].dtype


# -- aggregation (host, per part own-own block) -------------------------------

def aggregate(A: sp.csr_matrix, epsilon: float = 0.0) -> np.ndarray:
    """Vanek et al. alg. 5.1 aggregation of a local sparse matrix: node ->
    aggregate id.  Strength: |a_ij| > epsilon * sqrt(a_ii * a_jj).  Runs
    the native library (``ops/native.py``), as the reference does."""
    if A.shape[0] == 0:
        return np.zeros(0, dtype=np.int64)
    return vanek_aggregate_native(A, epsilon)


def aggregate_plain(A: sp.csr_matrix, epsilon: float = 0.0) -> np.ndarray:
    """``aggregate`` in Python (the reference's fallback, amg.py:67-102):
    the plain version the tests hold the native library to."""
    n = A.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    A = A.tocsr()
    d = np.abs(A.diagonal())
    agg = np.full(n, -1, dtype=np.int64)
    # strong neighborhoods (including self)
    neigh: List[np.ndarray] = []
    for i in range(n):
        lo, hi = A.indptr[i], A.indptr[i + 1]
        js = A.indices[lo:hi]
        vs = np.abs(A.data[lo:hi])
        thr = epsilon * np.sqrt(d[i] * d[js])
        neigh.append(js[(vs > thr) | (js == i)])
    next_agg = 0
    # pass 1: seed aggregates from fully unaggregated neighborhoods
    for i in range(n):
        if agg[i] != -1:
            continue
        ns = neigh[i]
        if (agg[ns] == -1).all():
            agg[ns] = next_agg
            agg[i] = next_agg
            next_agg += 1
    # pass 2: attach the remaining nodes to a neighboring aggregate
    pending = np.flatnonzero(agg == -1)
    attach = agg.copy()
    for i in pending:
        for j in neigh[i]:
            if agg[j] != -1:
                attach[i] = agg[j]
                break
    agg = attach
    # pass 3: leftover nodes form their own aggregates
    for i in range(n):
        if agg[i] == -1:
            agg[i] = next_agg
            next_agg += 1
    return agg


def strength_graph(A: sp.spmatrix, block_size: int, epsilon: Optional[float] = None) -> sp.csr_matrix:
    """Collapse a block system (``block_size`` dofs per node) to its node
    graph of Frobenius block norms.  ``epsilon=None`` keeps the norms (for
    ``aggregate``); a number gives the thresholded 0/1 graph, the diagonal
    included when epsilon <= 1.  ``block_size == 1`` returns A itself."""
    bs = int(block_size)
    if bs < 1:
        raise ValueError("Block size must be equal to or larger than 1.")
    if A.shape[0] != A.shape[1]:
        raise ValueError("Matrix must be square.")
    if A.shape[0] % bs != 0:
        raise ValueError("Matrix size must be multiple of block size.")
    if bs == 1:
        return A.tocsr()
    if epsilon is not None and epsilon < 0:
        raise ValueError("Expected epsilon >= 0.")
    coo = A.tocoo()
    ni = coo.row // bs
    nj = coo.col // bs
    n_nodes = -(-A.shape[0] // bs)
    G = sp.coo_matrix((coo.data**2, (ni, nj)), shape=(n_nodes, n_nodes)).tocsr()
    G.sum_duplicates()
    G.data = np.sqrt(G.data)
    if epsilon is None:
        return G
    G = G.tocoo()
    d = np.zeros(G.shape[0])
    diag_mask = G.row == G.col
    d[G.row[diag_mask]] = G.data[diag_mask]
    keep = (G.data != 0) & (G.data >= epsilon * np.sqrt(d[G.row] * d[G.col])) & ~diag_mask
    I, J = G.row[keep], G.col[keep]
    V = np.ones(keep.sum())
    if epsilon <= 1:
        I = np.concatenate([I, np.arange(G.shape[0])])
        J = np.concatenate([J, np.arange(G.shape[0])])
        V = np.concatenate([V, np.ones(G.shape[0])])
    return sp.coo_matrix((V, (I, J)), shape=G.shape).tocsr()


def aggregate_psparse(A: PSparseMatrix, epsilon: float = 0.0, block_size: int = 1):
    """Uncoupled per-part aggregation on the own-own blocks; with
    ``block_size`` > 1 on the node strength graph, every dof taking its
    node's aggregate.  Returns (aggregate ids per dof per part, coarse
    PRange of the aggregates)."""
    P = A.row_prange.n_parts
    aggs = [None] * P
    for p in _data_parts(A):
        b = host_blocks(A)[p]
        node_agg = aggregate(strength_graph(b["oo"], block_size), epsilon)
        aggs[p] = node_agg if block_size == 1 else np.repeat(node_agg, block_size)[: b["oo"].shape[0]]
    counts = _part_counts(A, [int(a.max()) + 1 if a is not None and a.size else 0 for a in aggs])
    return aggs, PRange(variable_partition(counts))


def _part_counts(A: PSparseMatrix, counts) -> List[int]:
    """Per-part counts known on each part's process, made known to all
    (summed: a part's count is zero elsewhere)."""
    if not A.backend.is_multiprocess:
        return list(counts)
    return [int(c) for c in np.sum(A.backend.allgather_object(np.asarray(counts)), axis=0)]


def _detect_box(offsets, n_own: int):
    """The box shape (nx, ny, nz) when ``offsets`` form a tensor-product
    stencil with taps in the 1-ring on a C-ordered box of n_own rows, else
    None."""
    offs = sorted({abs(int(o)) for o in offsets if o != 0})
    if not offs or n_own <= 0:
        return None
    cands = sorted(set(offs) | {n_own})
    for s3 in cands:
        if n_own % s3:
            continue
        for s2 in [c for c in cands if c <= s3 and s3 % c == 0]:
            ok = all(
                any(
                    o == a * s3 + b * s2 + c
                    for a in (-1, 0, 1) for b in (-1, 0, 1) for c in (-1, 0, 1)
                )
                for o in offsets
            )
            if ok:
                return (n_own // s3, s3 // s2, s2)
    return None


def box_aggregate_psparse(A: PSparseMatrix):
    """3x3x3 box aggregation of a box-stencil operator: a DIA own block
    whose offsets form a tensor-product stencil on a C-ordered box of the
    same shape on every part.  The aggregates are the diameter-3 blocks,
    numbered in C order (a ragged last block on an axis whose length is
    not a multiple of 3), so every coarse operator is again a box stencil.
    Returns (aggregate ids per part, coarse PRange, (fine box, coarse
    box)), or None for any other operator."""
    oo = A.device().oo
    if oo.kind != "dia":
        return None
    aggs, shapes, counts = [], [], []
    for li in A.row_prange.parts:
        shape = _detect_box(oo.offsets, li.n_own)
        if shape is None:
            return None
        nx, ny, nz = shape
        nxc, nyc, nzc = -(-nx // 3), -(-ny // 3), -(-nz // 3)
        x, y, z = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
        agg = ((x // 3) * nyc + (y // 3)) * nzc + (z // 3)
        aggs.append(agg.reshape(-1).astype(np.int64))
        shapes.append(((nx, ny, nz), (nxc, nyc, nzc)))
        counts.append(nxc * nyc * nzc)
    if len(set(shapes)) != 1:
        return None  # the batched transfers need one box shape on every part
    return aggs, PRange(variable_partition(counts)), shapes[0]


# -- prolongators (host) -------------------------------------------------------

def constant_prolongator(A: PSparseMatrix, aggs: List[np.ndarray], coarse: PRange) -> PSparseMatrix:
    """Piecewise-constant P0: row i has a 1 in the column of its aggregate."""
    fine_parts = A.row_prange.parts
    I = [li.own_to_global if a is not None else None for li, a in zip(fine_parts, aggs)]
    J = [cp.own_to_global[a] if a is not None else None for cp, a in zip(coarse.parts, aggs)]
    V = [np.ones(a.size, dtype=_host_dtype(A)) if a is not None else None for a in aggs]
    fine_rows = PRange([li.remove_ghost() for li in fine_parts])
    return psparse(I, J, V, fine_rows, coarse, A.backend, assembled=True, device=A.torch_device)


def tentative_prolongator(A: PSparseMatrix, aggs, coarse: PRange, nullspace=None):
    """Tentative prolongator; with a nullspace (a list of modes per part)
    each aggregate's thin QR gives orthonormal columns and the coarse
    nullspace.  Returns (P0, coarse nullspace, coarse dof PRange)."""
    if nullspace is None:
        return constant_prolongator(A, aggs, coarse), None, coarse
    n_modes = len(next(m for m in nullspace if m is not None))
    counts = _part_counts(A, [int(a.max() + 1) * n_modes if a is not None and a.size else 0
                              for a in aggs])
    coarse_dofs = PRange(variable_partition(counts))
    tri = []
    coarse_ns = []
    for li_f, li_cd, a, modes in zip(A.row_prange.parts, coarse_dofs.parts, aggs, nullspace):
        if a is None:  # a part of another process
            tri.append((None, None, None))
            coarse_ns.append(None)
            continue
        n_agg = int(a.max() + 1) if a.size else 0
        B = np.stack(modes, axis=1) if modes else np.zeros((a.size, 0))
        Is, Js, Vs = [], [], []
        Bc = np.zeros((n_agg * n_modes, n_modes), dtype=B.dtype)
        order = np.argsort(a, kind="stable")
        bounds = np.searchsorted(a[order], np.arange(n_agg + 1))
        for g in range(n_agg):
            rows = order[bounds[g] : bounds[g + 1]]
            Q, Rf = np.linalg.qr(B[rows])  # [na, kq], [kq, n_modes]
            kq = Q.shape[1]
            for k in range(n_modes):
                Is.append(li_f.own_to_global[rows])
                Js.append(np.full(rows.size, li_cd.own_to_global[g * n_modes + k]))
                Vs.append(Q[:, k] if k < kq else np.zeros(rows.size, dtype=B.dtype))
            Bc[g * n_modes : g * n_modes + kq, :] = Rf
        tri.append((
            np.concatenate(Is) if Is else np.zeros(0, dtype=np.int64),
            np.concatenate(Js) if Js else np.zeros(0, dtype=np.int64),
            np.concatenate(Vs) if Vs else np.zeros(0),
        ))
        coarse_ns.append([Bc[:, k] for k in range(n_modes)])
    fine_rows = PRange([li.remove_ghost() for li in A.row_prange.parts])
    P0 = psparse(
        [t[0] for t in tri], [t[1] for t in tri], [t[2] for t in tri],
        fine_rows, coarse_dofs, A.backend, assembled=True, device=A.torch_device,
    )
    return P0, coarse_ns, coarse_dofs


def _diag_parts(A: PSparseMatrix) -> List[np.ndarray]:
    """Per-part diagonal of the own-own block, matched by global ids (zero
    on a part of another process)."""
    out = []
    for b, li_r, li_c in zip(host_blocks(A), A.row_prange.parts, A.col_prange.parts):
        d = np.zeros(li_r.n_own, dtype=b["oo"].dtype)
        coo = b["oo"].tocoo()
        m = li_c.own_to_global[coo.col] == li_r.own_to_global[coo.row]
        d[coo.row[m]] = coo.data[m]
        out.append(d)
    return out


def _dinv_parts(A: PSparseMatrix) -> List[np.ndarray]:
    return [np.where(d != 0, 1.0 / np.where(d != 0, d, 1.0), 0.0) for d in _diag_parts(A)]


def _box_dinv(A: PSparseMatrix) -> torch.Tensor:
    """A's inverse diagonal ``[P, n_own_pad]`` in its device dtype on its
    device (a box level's ``BoxTransfer.dinv``)."""
    lay = A.row_layout()
    local = A.backend.local_parts()
    dinv = torch.zeros((len(local), lay.n_own_pad), dtype=torch.float64)
    parts = _dinv_parts(A)
    for k, p in enumerate(local):
        dinv[k, : parts[p].size] = torch.from_numpy(parts[p])
    return dinv.to(A.torch_device, A.dtype)


def spectral_radius(A: PSparseMatrix, Dinv=None, iters: int = 20) -> float:
    """Power-method estimate of rho(D^-1 A) on the host blocks, from
    ``np.random.default_rng(0)`` drawn part by part, with one host ghost
    exchange per iteration (``host_consistent``).  ``Dinv``: per-part
    inverse diagonals (default: A's)."""
    parts = A.row_prange.parts
    dinv = _dinv_parts(A) if Dinv is None else [np.asarray(d) for d in Dinv]
    blocks = host_blocks(A)
    data = set(_data_parts(A))
    rng = np.random.default_rng(0)
    x = [rng.standard_normal(li.n_own) for li in parts]
    lam = 1.0

    def norm(vs):
        sq = sum(float(v @ v) for p, v in enumerate(vs) if p in data)
        if A.backend.is_multiprocess:
            sq = float(sum(A.backend.allgather_object(sq)))
        return np.sqrt(sq)

    for _ in range(iters):
        xg = host_consistent(A.col_prange, x, A.backend)
        y = [
            dv * (b["oo"] @ xo + (b["oh"] @ g if g.size else 0.0)) if p in data
            else np.zeros_like(xo)
            for p, (b, xo, g, dv) in enumerate(zip(blocks, x, xg, dinv))
        ]
        ny, nx = norm(y), norm(x)
        if ny == 0:
            return 1.0
        lam = ny / nx if nx else 1.0
        x = [v / ny for v in y]
    return float(abs(lam))


def _make_S(A: PSparseMatrix, omega: float, dinv) -> PSparseMatrix:
    """S = I - omega D^-1 A, formed blockwise by scipy (entries of A that
    are stored zeros, and rows with a zero diagonal, are pruned by the
    scaling product, as in the reference)."""
    dtype = _host_dtype(A)
    data = set(_data_parts(A))
    s_blocks = []
    for p, (b, dv, li_r, li_c) in enumerate(zip(host_blocks(A), dinv, A.row_prange.parts,
                                                A.col_prange.parts)):
        if p not in data:  # a part of another process: placeholders
            s_blocks.append({k: sp.csr_matrix(b[k].shape, dtype=dtype) for k in ("oo", "oh")})
            continue
        scale = sp.diags(omega * dv)
        jco = li_c.global_to_own(li_r.own_to_global)
        rows = np.flatnonzero(jco >= 0)
        D = sp.csr_matrix((np.ones(rows.size, dtype=dtype), (rows, jco[rows])), shape=b["oo"].shape)
        s_blocks.append({"oo": (D - scale @ b["oo"]).tocsr(), "oh": (-(scale @ b["oh"])).tocsr()})
    S = PSparseMatrix(
        None, A.row_prange, A.col_prange, A.backend, blocks=s_blocks,
        device=A.torch_device, device_dtype=A.dtype,
    )
    return S


def smoothed_prolongator(A: PSparseMatrix, P0: PSparseMatrix, omega: Optional[float] = None,
                         return_omega: bool = False):
    """P = (I - omega D^-1 A) P0, omega = 4 / (3 rho(D^-1 A)) by default."""
    dinv = _dinv_parts(A)
    if omega is None:
        omega = 4.0 / (3.0 * max(spectral_radius(A, dinv), 1e-12))
    P = spmm(_make_S(A, float(omega), dinv), P0)
    return (P, float(omega)) if return_omega else P


class _GalerkinCache:
    """One level's re-coarsening plan at fixed sparsity: the tentative
    prolongator P0 (aggregates and nullspace frozen), omega (frozen), S = I
    - omega D^-1 A with its refill maps, and the reuse plans of P = S P0,
    AP = A P and Ac = P^T AP.  Setup builds P and Ac through it and
    ``refill`` recomputes the same objects' values for a new A, as a fresh
    setup at the same omega would.

    S's pattern is the union of A's full stored pattern and the identity,
    whatever the values: a scaling product would prune A's stored zeros
    (and the rows of a zero diagonal), and a later refill that puts a
    value there would then be dropped."""

    def __init__(self, A: PSparseMatrix, P0: PSparseMatrix, omega: float):
        _canonicalize_blocks(A)
        self.P0 = P0
        self.omega = float(omega)
        dtype = _host_dtype(A)
        s_blocks, self._s_maps = [], {}
        data = set(_data_parts(A))
        for p, (ab, dv, li_r, li_c) in enumerate(zip(host_blocks(A), _dinv_parts(A),
                                                     A.row_prange.parts, A.col_prange.parts)):
            a_oo, a_oh = ab["oo"], ab["oh"]
            if p not in data:  # a part of another process: placeholders
                s_blocks.append({k: sp.csr_matrix(ab[k].shape, dtype=dtype) for k in ("oo", "oh")})
                continue
            jco = li_c.global_to_own(li_r.own_to_global)
            drows = np.flatnonzero(jco >= 0)
            coo = a_oo.tocoo()
            I_s = np.concatenate([coo.row, drows])
            J_s = np.concatenate([coo.col, jco[drows]])
            V_s = np.concatenate([-self.omega * dv[coo.row] * coo.data, np.ones(drows.size)])
            s_oo = compresscoo(I_s, J_s, V_s, *a_oo.shape).astype(dtype)
            rows_oh = np.repeat(np.arange(a_oh.shape[0], dtype=np.int64), np.diff(a_oh.indptr))
            s_oh = sp.csr_matrix(
                ((-self.omega * dv[rows_oh] * a_oh.data).astype(dtype), a_oh.indices.copy(),
                 a_oh.indptr.copy()),
                shape=a_oh.shape,
            )
            s_blocks.append({"oo": s_oo, "oh": s_oh})
            map_a = precompute_nzindex(s_oo, coo.row, coo.col)
            diag_pos = precompute_nzindex(s_oo, drows, jco[drows])
            if (map_a < 0).any() or (diag_pos < 0).any():
                raise AssertionError("S misses an entry of A or of the identity")
            self._s_maps[p] = (map_a, coo.row.astype(np.int64), diag_pos, rows_oh)
        self.S = PSparseMatrix(
            None, A.row_prange, A.col_prange, A.backend, blocks=s_blocks,
            device=A.torch_device, device_dtype=A.dtype,
        )
        self.P, self._cP = spmm(self.S, P0, reuse=True)
        self.AP, self._c1 = spmm(A, self.P, reuse=True)
        self.Ac, self._c2 = spmtm(self.P, self.AP, reuse=True)

    def refill(self, A: PSparseMatrix) -> PSparseMatrix:
        """S from A's new values, then P, AP and Ac through their frozen
        plans; returns the refilled coarse operator."""
        _canonicalize_blocks(A)
        dinv = _dinv_parts(A)
        for p, (map_a, rows_a, diag_pos, rows_oh) in self._s_maps.items():
            sb, ab, dv = self.S.blocks[p], host_blocks(A)[p], dinv[p]
            soo = sb["oo"].data
            soo[:] = 0
            soo[map_a] = -self.omega * dv[rows_a] * ab["oo"].data
            np.add.at(soo, diag_pos, 1.0)
            sb["oh"].data[:] = -self.omega * dv[rows_oh] * ab["oh"].data
        self.S.invalidate_device()
        # P0 is frozen: its fetched rows need no refresh
        spmm_into(self.P, self.S, self.P0, self._cP, refresh_b=False)
        spmm_into(self.AP, A, self.P, self._c1)
        spmtm_into(self.Ac, self.P, self.AP, self._c2)
        return self.Ac


# -- hierarchy -----------------------------------------------------------------

class BoxTransfer(NamedTuple):
    """What a box-aggregated level applies P = (I - omega D^-1 A) P0 with:
    the fine and coarse box shapes, omega, and D^-1 ``[P, n_own_pad]`` in
    the level's dtype on its device."""

    fine: Tuple[int, int, int]
    coarse: Tuple[int, int, int]
    omega: float
    dinv: torch.Tensor


@dataclass
class AMGLevel:
    A: PSparseMatrix
    P: Optional[PSparseMatrix]  # None on the coarsest level
    smoother: Optional[Union[GaussSeidel, AdditiveSchwarz]]
    struct: Optional[BoxTransfer] = None  # on a box-aggregated level


@dataclass
class AMGParams:
    """Level parameters, as the reference's.  ``smoother``: "gs" (the
    symmetric Gauss-Seidel) or "schwarz" (``AdditiveSchwarz`` of each
    level, ``smoother_iters`` Richardson corrections an application)."""

    max_levels: int = 6
    coarse_size: int = 100
    epsilon: float = 0.0
    omega: Optional[float] = None
    smoother_iters: int = 1
    cycle: str = "v"  # or "w"
    block_size: int = 1
    smoother: str = "gs"


class AMGPreconditioner:
    """Callable preconditioner: one cycle on A z = r from z = 0."""

    def __init__(self, A: PSparseMatrix, params: Optional[AMGParams] = None, nullspace=None):
        self.params = params or AMGParams()
        self.nullspace = nullspace
        self._setup(A, reuse_aggregates=False)

    @property
    def aggregates(self):
        """(aggregates per part, coarse PRange) of every coarsened level."""
        return [(aggs, coarse) for aggs, coarse, _ in self._aggs]

    def _setup(self, A: PSparseMatrix, reuse_aggregates: bool = False) -> None:
        """The hierarchy from A.  ``reuse_aggregates``: a new setup on the
        aggregates of the last one (no aggregation; the power method, the
        products and the smoothers run anew), for a matrix of another
        sparsity on the same partition, where ``update``'s refill does not
        apply."""
        params = self.params
        if params.smoother not in ("gs", "schwarz"):
            raise ValueError(f"AMG smoother {params.smoother!r}: 'gs' or 'schwarz'")
        old_aggs = self._aggs if reuse_aggregates else None
        self.levels: List[AMGLevel] = []
        self._galerkin: List[_GalerkinCache] = []
        self._aggs = []  # (aggregates, coarse PRange, box shapes) per level
        self.omegas = []
        current = A
        ns = self.nullspace
        bs = params.block_size if ns is not None else 1
        for level in range(params.max_levels - 1):
            if current.shape[0] <= params.coarse_size:
                break
            if old_aggs is not None:
                if level >= len(old_aggs):
                    break
                aggs, coarse, shapes = old_aggs[level]
            else:
                box = (
                    box_aggregate_psparse(current)
                    if params.epsilon == 0 and bs == 1 and ns is None
                    else None
                )
                if box is not None:
                    aggs, coarse, shapes = box
                else:
                    (aggs, coarse), shapes = aggregate_psparse(current, params.epsilon, bs), None
            self._aggs.append((aggs, coarse, shapes))
            P0, ns, _ = tentative_prolongator(current, aggs, coarse, ns)
            # the coarse level has n_modes dofs per aggregate
            bs = len(next(m for m in ns if m is not None)) if ns is not None else 1
            if params.omega is not None:
                omega = float(params.omega)
            else:
                omega = 4.0 / (3.0 * max(spectral_radius(current, _dinv_parts(current)), 1e-12))
            self.omegas.append(omega)
            gk = _GalerkinCache(current, P0, omega)
            self._galerkin.append(gk)
            struct = None
            if params.smoother == "schwarz":
                # the structured transfers assume a Gauss-Seidel smoother:
                # a box level then applies P as a matrix
                smoother = AdditiveSchwarz(current, iterations=params.smoother_iters)
            else:
                if shapes is not None:
                    struct = BoxTransfer(*shapes, omega, _box_dinv(current))
                smoother = GaussSeidel(current, params.smoother_iters, "symmetric")
            self.levels.append(AMGLevel(current, gk.P, smoother, struct))
            current = gk.Ac
            if current.shape[0] >= self.levels[-1].A.shape[0]:
                break  # aggregation stalled
        self.levels.append(AMGLevel(current, None, None))
        self.backend = A.backend
        self._coarse_factorize(current)
        self._freeze_levels()

    def _freeze_levels(self) -> None:
        """Freeze every level now, as the reference (a box level never
        applies P)."""
        for lev in self.levels:
            lev.A.device()
            if lev.P is not None and lev.struct is None:
                lev.P.device()
                lev.P.device_transpose()

    def update(self, A: PSparseMatrix) -> "AMGPreconditioner":
        """The hierarchy for new values of A at the sparsity of the setup,
        with no aggregation, no power method and no symbolic product: each
        level refills S (at its frozen omega), P, AP and Ac through its
        ``_GalerkinCache``, refreshes its smoother's values and its box
        transfer's D^-1, then the coarse factors are recomputed and every
        level's frozen blocks restack their new values.  The result equals
        a fresh setup at the same omegas and aggregates."""
        if len(self._galerkin) != len(self.levels) - 1:
            raise RuntimeError("AMGPreconditioner.update: the hierarchy has no reuse plans")
        current = A
        for lev, gk in zip(self.levels, self._galerkin):
            lev.A = current
            Ac = gk.refill(current)
            lev.P = gk.P
            lev.smoother.refresh_values(current)
            if lev.struct is not None:
                lev.struct = lev.struct._replace(dinv=_box_dinv(current))
            current = Ac
        self.levels[-1].A = current
        self._coarse_factorize(current)
        self._freeze_levels()
        return self

    def _coarse_factorize(self, current: PSparseMatrix) -> None:
        """Dense LU of the gathered coarsest operator: an explicit inverse
        for n <= 512 with a benign pivot growth, the LU factors otherwise,
        a pseudo-inverse (with a warning) when numerically singular."""
        G = gather_global_scipy(current, max_rows=200_000).toarray()
        lu, piv = sla.lu_factor(G, check_finite=False)
        du = np.abs(np.diag(lu))
        growth = float(du.max() / du.min()) if du.size and du.min() > 0 else np.inf
        dev, dt = current.torch_device, current.dtype
        if du.size and du.min() <= 1e-12 * max(du.max(), 1.0):
            warnings.warn(
                "AMG coarse operator is numerically singular "
                f"(|u_ii| ratio {growth:.2e}); using a pseudo-inverse — "
                "the coarse correction is a least-squares projection, not "
                "a solve. Supply a nullspace or loosen coarse_size.",
                RuntimeWarning,
                stacklevel=2,
            )
            self.coarse_kind = "inv"
            self._coarse = (torch.from_numpy(np.linalg.pinv(G)).to(dev, dt),)
        elif G.shape[0] <= 512 and growth < 1e6:
            ginv = sla.lu_solve((lu, piv), np.eye(G.shape[0], dtype=G.dtype), check_finite=False)
            self.coarse_kind = "inv"
            self._coarse = (torch.from_numpy(ginv).to(dev, dt),)
        else:
            self.coarse_kind = "lu"
            # scipy's pivots are 0-based, torch's (LAPACK's) 1-based
            self._coarse = (
                torch.from_numpy(lu).to(dev, dt),
                torch.from_numpy(piv.astype(np.int32) + 1).to(dev),
            )
        lay = current.row_layout()
        flat, gids = [], []
        for k, p in enumerate(current.backend.local_parts()):
            li = current.row_prange.parts[p]
            flat.append(k * lay.n_own_pad + np.arange(li.n_own))
            gids.append(li.own_to_global)
        self._coarse_slots = torch.from_numpy(np.concatenate(flat)).to(dev)
        self._coarse_gids = torch.from_numpy(np.concatenate(gids)).to(dev)

    def _coarse_solve(self, b: PVector) -> PVector:
        """Gather the own values into one global vector, apply the dense
        inverse (or LU solve), scatter back to the own slots."""
        n = b.layout.pr.n_global
        flat = b.own.new_zeros(n)
        flat[self._coarse_gids] = b.own.reshape(-1)[self._coarse_slots]
        flat = b.backend.allreduce(flat)  # the other processes' parts
        if self.coarse_kind == "inv":
            z = self._coarse[0].to(b.own.dtype) @ flat
        else:
            lu, piv = self._coarse
            z = torch.linalg.lu_solve(lu.to(b.own.dtype), piv, flat.unsqueeze(1))[:, 0]
        own = torch.zeros_like(b.own)
        own.view(-1)[self._coarse_slots] = z[self._coarse_gids]
        return PVector(own, torch.zeros_like(b.ghost), b.layout, b.backend)

    # -- structured transfers (box-aggregated levels) ----------------------
    # The 3^3 sum-pool and upsample of a C-ordered (fx, fy, fz) box: every
    # axis is padded to a multiple of 3 (the ragged last block sums fewer
    # rows), then reshaped and summed, or expanded, reshaped and cut.
    @staticmethod
    def _box_pool3(v: torch.Tensor, st: BoxTransfer) -> torch.Tensor:
        (fx, fy, fz), (cx, cy, cz) = st.fine, st.coarse
        P = v.shape[0]
        f3 = v[:, : fx * fy * fz].reshape(P, fx, fy, fz)
        f3 = torch.nn.functional.pad(f3, (0, 3 * cz - fz, 0, 3 * cy - fy, 0, 3 * cx - fx))
        return f3.reshape(P, cx, 3, cy, 3, cz, 3).sum((2, 4, 6)).reshape(P, -1)

    @staticmethod
    def _box_up3(c: torch.Tensor, st: BoxTransfer) -> torch.Tensor:
        (fx, fy, fz), (cx, cy, cz) = st.fine, st.coarse
        P = c.shape[0]
        c3 = c[:, : cx * cy * cz].reshape(P, cx, 1, cy, 1, cz, 1)
        f3 = c3.expand(P, cx, 3, cy, 3, cz, 3).reshape(P, 3 * cx, 3 * cy, 3 * cz)
        return f3[:, :fx, :fy, :fz].reshape(P, -1)

    def _restrict_struct(self, level: AMGLevel, r: PVector, cl) -> PVector:
        """rc = P^T r = P0^T (r - omega A D^-1 r): one SpMV (K1 on a DIA
        level) and the box sum-pool."""
        st = level.struct
        clay = level.A.col_layout()
        v = r.own - st.omega * spmv(level.A, _own_vec(r.own * st.dinv, clay, r.backend)).own
        return _own_vec(_pad2(self._box_pool3(v, st), cl.n_own_pad), cl, r.backend)

    def _prolong_struct(self, level: AMGLevel, ec: PVector) -> torch.Tensor:
        """The own values of e = P ec = w - omega D^-1 A w, w = P0 ec (the
        box upsample): one SpMV (K1 on a DIA level)."""
        st = level.struct
        clay = level.A.col_layout()
        w_own = _pad2(self._box_up3(ec.own, st), level.A.row_layout().n_own_pad)
        return w_own - st.omega * (st.dinv * spmv(level.A, _own_vec(w_own, clay, ec.backend)).own)

    # -- the flat cycle: a box level whose smoother is colored runs in the
    #    smoother's de-interleaved core, from the pre-smooth to the
    #    post-smooth; one interleave (the restricted residual) and one
    #    de-interleave (the prolongated correction) per level, the
    #    transfers' A-apply by K4 with the smoother's own D^-1
    def _flat_ok(self, l: int) -> bool:
        level = self.levels[l]
        return (
            level.P is not None
            and level.struct is not None
            and level.smoother.colored is not None
            and level.smoother.flat_viable()
        )

    def _restrict_flat(self, level: AMGLevel, rd: torch.Tensor, cl) -> PVector:
        """rc = P0^T (r - omega A D^-1 r) from the core residual ``rd``."""
        gs, st = level.smoother, level.struct
        u = gs.flat_ax(rd * gs.colored.invd_d)
        v_std = gs.flat_interleave(rd - st.omega * u)
        return _own_vec(_pad2(self._box_pool3(v_std, st), cl.n_own_pad), cl, level.A.backend)

    def _prolong_flat(self, level: AMGLevel, ec: PVector) -> torch.Tensor:
        """e = w - omega D^-1 A w, w = P0 ec (the box upsample), as a core."""
        gs, st = level.smoother, level.struct
        w_std = _pad2(self._box_up3(ec.own, st), level.A.row_layout().n_own_pad)
        w_core = gs.flat_deinterleave(w_std)
        return w_core - st.omega * (gs.colored.invd_d * gs.flat_ax(w_core))

    def _cycle_flat(self, l: int, bd: torch.Tensor, w: bool) -> torch.Tensor:
        """The V- or W-cycle from level ``l`` on the core rhs ``bd``;
        returns the core x."""
        level = self.levels[l]
        gs = level.smoother
        xflat = gs.smooth_bd(None, bd)  # zero-guess pre-smooth
        rd = gs.flat_residual(xflat, bd)
        nxt = self.levels[l + 1]
        cl = nxt.A.row_layout()
        rc = self._restrict_flat(level, rd, cl)
        if nxt.P is None:
            ec = self._coarse_solve(rc)
        elif self._flat_ok(l + 1):
            xfc = self._cycle_flat(l + 1, nxt.smoother.make_bd(rc), w)
            ec = _own_vec(nxt.smoother.flat_interleave(xfc), cl, rc.backend)
        else:
            ec = self._cycle(l + 1, rc, w)
        if w and nxt.P is not None:
            rc2 = _residual_vec(nxt.A, rc, ec)
            ec2 = self._cycle(l + 1, rc2, w)
            ec = PVector(ec.own + ec2.own, ec.ghost, ec.layout, ec.backend)
        return gs.smooth_bd(xflat + self._prolong_flat(level, ec), bd)  # post-smooth

    def _cycle_flat_g(self, l: int, b: PVector, w: bool) -> torch.Tensor:
        """The flat cycle of a box level with ghost columns (the hybrid
        Gauss-Seidel across parts): the sweeps stay in the core with the
        ghost-column contribution, frozen per application, folded into the
        core rhs; the structured transfers run in standard order, their
        SpMV doing the exchange.  Two ghost exchanges per level per cycle
        for the smoothing (the zero-guess pre-smooth needs none), one in
        each transfer.  Returns the core x."""
        level = self.levels[l]
        gs = level.smoother
        bd0 = gs.make_bd(b)
        xflat = gs.smooth_bd(None, bd0)  # zero-guess pre-smooth
        gc = gs.ghost_contrib(gs.flat_interleave(xflat))
        r_own = gs.flat_interleave(gs.flat_residual(xflat, bd0)) - gc
        nxt = self.levels[l + 1]
        rc = self._restrict_struct(level, _own_vec(r_own, level.A.row_layout(), b.backend),
                                   nxt.A.row_layout())
        ec = self._cycle(l + 1, rc, w)
        if w and nxt.P is not None:
            rc2 = _residual_vec(nxt.A, rc, ec)
            ec2 = self._cycle(l + 1, rc2, w)
            ec = PVector(ec.own + ec2.own, ec.ghost, ec.layout, ec.backend)
        xflat = gs.flat_add_std(xflat, self._prolong_struct(level, ec))
        gc2 = gs.ghost_contrib(gs.flat_interleave(xflat))
        return gs.smooth_bd(xflat, gs.flat_deinterleave(b.own - gc2))  # post-smooth

    def _cycle(self, l: int, b: PVector, w: bool) -> PVector:
        """One cycle from level ``l`` (twice into the coarser level for a
        W-cycle): the flat cycle on a box level whose smoother is colored
        (the ghosted flat cycle where the level has ghost columns); else
        zero-guess pre-smooth, residual, restriction (the structured one
        on a box level, P^T elsewhere), the coarser cycle, prolongation,
        post-smooth."""
        level = self.levels[l]
        if level.P is None:
            return self._coarse_solve(b)
        if level.struct is not None and level.smoother.colored is not None:
            gs = level.smoother
            if self._flat_ok(l):
                xflat = self._cycle_flat(l, gs.make_bd(b), w)
            else:
                xflat = self._cycle_flat_g(l, b, w)
            return _own_vec(gs.flat_interleave(xflat), level.A.row_layout(), b.backend)
        x = level.smoother(b)
        r = _residual_vec(level.A, b, x)
        cl = self.levels[l + 1].A.row_layout()
        if level.struct is not None:
            rc = self._restrict_struct(level, r, cl)
        else:
            rc = _view(cl, spmtv(level.P, _row_view(level.P, r)))
        ec = self._cycle(l + 1, rc, w)
        if w and self.levels[l + 1].P is not None:
            rc2 = _residual_vec(self.levels[l + 1].A, rc, ec)
            ec2 = self._cycle(l + 1, rc2, w)
            ec = PVector(ec.own + ec2.own, ec.ghost, ec.layout, ec.backend)
        if level.struct is not None:
            e_own = self._prolong_struct(level, ec)
        else:
            e_own = spmv(level.P, _col_view(level.P, ec)).own
        x = PVector(x.own + e_own, x.ghost, x.layout, x.backend)
        return level.smoother.apply(x, b)

    def __call__(self, r: PVector) -> PVector:
        return self._cycle(0, r, self.params.cycle == "w")

    def statistics(self) -> dict:
        nnzs = [lev.A.nnz() for lev in self.levels]
        rows = [lev.A.shape[0] for lev in self.levels]
        return {
            "levels": len(self.levels),
            "rows_per_level": rows,
            "nnz_per_level": nnzs,
            "grid_complexity": sum(rows) / rows[0] if rows[0] else 0.0,
            "operator_complexity": sum(nnzs) / nnzs[0] if nnzs[0] else 0.0,
        }


def _residual_vec(A: PSparseMatrix, b: PVector, x: PVector) -> PVector:
    """r = -1 * A x + 1 * b (the 5-argument SpMV), on b's layout."""
    r = spmv(A, _col_view(A, x), alpha=-1.0, beta=1.0, y=_row_view(A, b))
    return PVector(r.own, torch.zeros_like(b.ghost), b.layout, b.backend)


def _view(lay, v: PVector) -> PVector:
    if v.layout is lay:
        return v
    no = lay.n_own_pad
    return _own_vec(v.own[:, :no] if v.own.shape[1] >= no else _pad2(v.own, no), lay, v.backend)


def _own_vec(own: torch.Tensor, lay, backend) -> PVector:
    """The PVector of own values ``own`` on layout ``lay``, ghosts zero."""
    return PVector(own, own.new_zeros((own.shape[0], lay.n_ghost_pad)), lay, backend)


def _col_view(A: PSparseMatrix, v: PVector) -> PVector:
    return _view(A.col_layout(), v)


def _row_view(A: PSparseMatrix, v: PVector) -> PVector:
    return _view(A.row_layout(), v)


def _pad2(a: torch.Tensor, n: int) -> torch.Tensor:
    return torch.nn.functional.pad(a, (0, n - a.shape[1]))


def amg(A: PSparseMatrix, params: Optional[AMGParams] = None, nullspace=None) -> AMGPreconditioner:
    return AMGPreconditioner(A, params, nullspace)


def default_nullspace(A: PSparseMatrix) -> List[List[np.ndarray]]:
    """The constant vector, per part."""
    return [[np.ones(li.n_own)] for li in A.row_prange.parts]
