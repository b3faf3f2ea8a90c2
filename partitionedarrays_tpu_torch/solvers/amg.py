"""Smoothed-aggregation algebraic multigrid.

Counterpart of ``partitionedarrays_tpu/solvers/amg.py``: ``aggregate`` (the
Python version, :51-102), ``strength_graph`` and ``aggregate_psparse``
(:105-182), ``constant_prolongator`` and ``tentative_prolongator`` with the
per-aggregate nullspace QR (:249-340), ``_diag_parts`` and ``_dinv_parts``
(:343-385), the host power method ``spectral_radius`` (:388-429), ``_make_S``
and ``smoothed_prolongator`` (:494-545), the Galerkin product of
``_GalerkinCache`` (:548-631) without its reuse maps, ``AMGLevel``,
``AMGParams`` and ``AMGPreconditioner`` (the generic branch of ``_setup``,
``_coarse_factorize``, ``_coarse_solve``, the generic ``_cycle`` :1184-1226
for V and W cycles, ``statistics``), ``amg`` and ``default_nullspace``.

The coarsening runs on the host with numpy and scipy, the same operations
in the same order as the reference, so aggregates, omega, P and the coarse
operators agree with it number for number.  The cycle runs on the device:
the level smoothers (``GaussSeidel``: the colored tier K3/K4 on a DIA band,
the tile tier K6 on the Galerkin levels), the residuals (K1 or K5), the
restriction by the frozen transpose of P and the prolongation by P (K5),
and the coarsest solve as a dense inverse or LU factors applied by torch.

Where the reference takes another branch, the port raises
``NotImplementedError`` naming the ROADMAP item, never silently taking a
different one: box aggregation and the structured/flat cycle (epsilon 0,
block size 1, no nullspace, a box-stencil DIA operator), ``update`` (the
reuse tier), and the Schwarz level smoother.  ``ops/native.py`` is not
ported: the Python ``aggregate`` is the reference's fallback, and the tests
hold its aggregates against the reference's (native) ones.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import scipy.linalg as sla
import scipy.sparse as sp
import torch

from ..ops.sparse_host import compresscoo
from ..parallel.partition import PRange, variable_partition
from ..psparse import (
    PSparseMatrix,
    gather_global_scipy,
    host_blocks,
    psparse,
    spmm,
    spmtm,
    spmtv,
    spmv,
)
from ..pvector import PVector
from .smoothers import GaussSeidel

_BOX = "box aggregation and the structured AMG cycle: ROADMAP Queue 1 item 13"


def _host_dtype(A: PSparseMatrix) -> np.dtype:
    return host_blocks(A)[0]["oo"].dtype


# -- aggregation (host, per part own-own block) -------------------------------

def aggregate(A: sp.csr_matrix, epsilon: float = 0.0) -> np.ndarray:
    """Vanek et al. alg. 5.1 aggregation of a local sparse matrix: node ->
    aggregate id.  Strength: |a_ij| > epsilon * sqrt(a_ii * a_jj)."""
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
    aggs = []
    for b in host_blocks(A):
        node_agg = aggregate(strength_graph(b["oo"], block_size), epsilon)
        aggs.append(node_agg if block_size == 1 else np.repeat(node_agg, block_size)[: b["oo"].shape[0]])
    counts = [int(a.max()) + 1 if a.size else 0 for a in aggs]
    return aggs, PRange(variable_partition(counts))


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


def _is_box_stencil(A: PSparseMatrix) -> bool:
    """True where the reference's ``box_aggregate_psparse`` succeeds: a DIA
    own block whose offsets are a box stencil of the same shape on every
    part."""
    oo = A.device().oo
    if oo.kind != "dia":
        return False
    shapes = {_detect_box(oo.offsets, li.n_own) for li in A.row_prange.parts}
    return None not in shapes and len(shapes) == 1


# -- prolongators (host) -------------------------------------------------------

def constant_prolongator(A: PSparseMatrix, aggs: List[np.ndarray], coarse: PRange) -> PSparseMatrix:
    """Piecewise-constant P0: row i has a 1 in the column of its aggregate."""
    fine_parts = A.row_prange.parts
    I = [li.own_to_global for li in fine_parts]
    J = [cp.own_to_global[a] for cp, a in zip(coarse.parts, aggs)]
    V = [np.ones(a.size, dtype=_host_dtype(A)) for a in aggs]
    fine_rows = PRange([li.remove_ghost() for li in fine_parts])
    return psparse(I, J, V, fine_rows, coarse, A.backend, assembled=True, device=A.torch_device)


def tentative_prolongator(A: PSparseMatrix, aggs, coarse: PRange, nullspace=None):
    """Tentative prolongator; with a nullspace (a list of modes per part)
    each aggregate's thin QR gives orthonormal columns and the coarse
    nullspace.  Returns (P0, coarse nullspace, coarse dof PRange)."""
    if nullspace is None:
        return constant_prolongator(A, aggs, coarse), None, coarse
    n_modes = len(next(m for m in nullspace if m is not None))
    counts = [int(a.max() + 1) * n_modes if a.size else 0 for a in aggs]
    coarse_dofs = PRange(variable_partition(counts))
    tri = []
    coarse_ns = []
    for li_f, li_cd, a, modes in zip(A.row_prange.parts, coarse_dofs.parts, aggs, nullspace):
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
    """Per-part diagonal of the own-own block, matched by global ids."""
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


def spectral_radius(A: PSparseMatrix, Dinv=None, iters: int = 20) -> float:
    """Power-method estimate of rho(D^-1 A) on the host blocks, from
    ``np.random.default_rng(0)``.  ``Dinv``: per-part inverse diagonals
    (default: A's)."""
    parts = A.row_prange.parts
    dinv = _dinv_parts(A) if Dinv is None else [np.asarray(d) for d in Dinv]
    blocks = host_blocks(A)
    if A.col_layout().n_ghost_pad:
        raise NotImplementedError("spectral_radius with ghost columns: ROADMAP Queue 1 item 10")
    rng = np.random.default_rng(0)
    x = [rng.standard_normal(li.n_own) for li in parts]
    lam = 1.0
    for _ in range(iters):
        # no ghost columns: the reference's ghost term is the 0.0 it adds
        y = [dv * (b["oo"] @ xo + 0.0) for b, xo, dv in zip(blocks, x, dinv)]
        ny = np.sqrt(sum(float(v @ v) for v in y))
        nx = np.sqrt(sum(float(v @ v) for v in x))
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
    s_blocks = []
    for b, dv, li_r, li_c in zip(host_blocks(A), dinv, A.row_prange.parts, A.col_prange.parts):
        scale = sp.diags(omega * dv)
        jco = li_c.global_to_own(li_r.own_to_global)
        rows = np.flatnonzero(jco >= 0)
        D = sp.csr_matrix((np.ones(rows.size, dtype=dtype), (rows, jco[rows])), shape=b["oo"].shape)
        s_blocks.append({"oo": (D - scale @ b["oo"]).tocsr(), "oh": (-(scale @ b["oh"])).tocsr()})
    return PSparseMatrix(
        None, A.row_prange, A.col_prange, A.backend, blocks=s_blocks,
        device=A.torch_device, device_dtype=A.dtype,
    )


def smoothed_prolongator(A: PSparseMatrix, P0: PSparseMatrix, omega: Optional[float] = None,
                         return_omega: bool = False):
    """P = (I - omega D^-1 A) P0, omega = 4 / (3 rho(D^-1 A)) by default."""
    dinv = _dinv_parts(A)
    if omega is None:
        omega = 4.0 / (3.0 * max(spectral_radius(A, dinv), 1e-12))
    P = spmm(_make_S(A, float(omega), dinv), P0)
    return (P, float(omega)) if return_omega else P


def _galerkin(A: PSparseMatrix, P0: PSparseMatrix, omega: float):
    """(P, Ac) as the reference's setup builds them (``_GalerkinCache``):
    S = I - omega D^-1 A over the full stored pattern of A plus the
    identity (no pruning), P = S P0, AP = A P, Ac = P^T AP."""
    dtype = _host_dtype(A)
    dinv = _dinv_parts(A)
    s_blocks = []
    for ab, dv, li_r, li_c in zip(host_blocks(A), dinv, A.row_prange.parts, A.col_prange.parts):
        a_oo, a_oh = ab["oo"], ab["oh"]
        jco = li_c.global_to_own(li_r.own_to_global)
        drows = np.flatnonzero(jco >= 0)
        coo = a_oo.tocoo()
        I_s = np.concatenate([coo.row, drows])
        J_s = np.concatenate([coo.col, jco[drows]])
        V_s = np.concatenate([-omega * dv[coo.row] * coo.data, np.ones(drows.size)])
        s_oo = compresscoo(I_s, J_s, V_s, *a_oo.shape).astype(dtype)
        rows_oh = np.repeat(np.arange(a_oh.shape[0], dtype=np.int64), np.diff(a_oh.indptr))
        s_oh = sp.csr_matrix(
            ((-omega * dv[rows_oh] * a_oh.data).astype(dtype), a_oh.indices.copy(), a_oh.indptr.copy()),
            shape=a_oh.shape,
        )
        s_blocks.append({"oo": s_oo, "oh": s_oh})
    S = PSparseMatrix(
        None, A.row_prange, A.col_prange, A.backend, blocks=s_blocks,
        device=A.torch_device, device_dtype=A.dtype,
    )
    P = spmm(S, P0)
    return P, spmtm(P, spmm(A, P))


# -- hierarchy -----------------------------------------------------------------

@dataclass
class AMGLevel:
    A: PSparseMatrix
    P: Optional[PSparseMatrix]  # None on the coarsest level
    smoother: Optional[GaussSeidel]


@dataclass
class AMGParams:
    """Level parameters, as the reference's (its ``smoother="schwarz"``
    raises here: ROADMAP Queue 1 item 12)."""

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
        self._setup(A)

    def _setup(self, A: PSparseMatrix) -> None:
        params = self.params
        if params.smoother != "gs":
            raise NotImplementedError(f"AMG smoother {params.smoother!r}: ROADMAP Queue 1 item 12")
        self.levels: List[AMGLevel] = []
        self.aggregates = []  # (aggregates, coarse PRange) per level
        self.omegas = []
        current = A
        ns = self.nullspace
        bs = params.block_size if ns is not None else 1
        for _ in range(params.max_levels - 1):
            if current.shape[0] <= params.coarse_size:
                break
            if params.epsilon == 0 and bs == 1 and ns is None and _is_box_stencil(current):
                raise NotImplementedError(_BOX)
            aggs, coarse = aggregate_psparse(current, params.epsilon, bs)
            self.aggregates.append((aggs, coarse))
            P0, ns, _ = tentative_prolongator(current, aggs, coarse, ns)
            # the coarse level has n_modes dofs per aggregate
            bs = len(next(m for m in ns if m is not None)) if ns is not None else 1
            if params.omega is not None:
                omega = float(params.omega)
            else:
                omega = 4.0 / (3.0 * max(spectral_radius(current, _dinv_parts(current)), 1e-12))
            self.omegas.append(omega)
            P, Ac = _galerkin(current, P0, omega)
            self.levels.append(AMGLevel(current, P, GaussSeidel(current, params.smoother_iters, "symmetric")))
            current = Ac
            if Ac.shape[0] >= self.levels[-1].A.shape[0]:
                break  # aggregation stalled
        self.levels.append(AMGLevel(current, None, None))
        self.backend = A.backend
        self._coarse_factorize(current)
        for lev in self.levels:  # freeze every level now, as the reference
            lev.A.device()
            if lev.P is not None:
                lev.P.device()
                lev.P.device_transpose()

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
        for p, li in enumerate(current.row_prange.parts):
            flat.append(p * lay.n_own_pad + np.arange(li.n_own))
            gids.append(li.own_to_global)
        self._coarse_slots = torch.from_numpy(np.concatenate(flat)).to(dev)
        self._coarse_gids = torch.from_numpy(np.concatenate(gids)).to(dev)

    def _coarse_solve(self, b: PVector) -> PVector:
        """Gather the own values into one global vector, apply the dense
        inverse (or LU solve), scatter back to the own slots."""
        n = b.layout.pr.n_global
        flat = b.own.new_zeros(n)
        flat[self._coarse_gids] = b.own.reshape(-1)[self._coarse_slots]
        if self.coarse_kind == "inv":
            z = self._coarse[0].to(b.own.dtype) @ flat
        else:
            lu, piv = self._coarse
            z = torch.linalg.lu_solve(lu.to(b.own.dtype), piv, flat.unsqueeze(1))[:, 0]
        own = torch.zeros_like(b.own)
        own.view(-1)[self._coarse_slots] = z[self._coarse_gids]
        return PVector(own, torch.zeros_like(b.ghost), b.layout, b.backend)

    def _cycle(self, l: int, b: PVector, w: bool) -> PVector:
        """The reference's generic cycle: zero-guess pre-smooth, residual,
        restriction by P^T, the coarser cycle (twice for a W-cycle),
        prolongation by P, post-smooth."""
        level = self.levels[l]
        if level.P is None:
            return self._coarse_solve(b)
        x = level.smoother(b)
        r = _residual_vec(level.A, b, x)
        cl = self.levels[l + 1].A.row_layout()
        rc = spmtv(level.P, _row_view(level.P, r))
        rc_own = rc.own[:, : cl.n_own_pad] if rc.own.shape[1] >= cl.n_own_pad else _pad2(rc.own, cl.n_own_pad)
        rc = PVector(rc_own, rc_own.new_zeros((rc_own.shape[0], cl.n_ghost_pad)), cl, b.backend)
        ec = self._cycle(l + 1, rc, w)
        if w and self.levels[l + 1].P is not None:
            rc2 = _residual_vec(self.levels[l + 1].A, rc, ec)
            ec2 = self._cycle(l + 1, rc2, w)
            ec = PVector(ec.own + ec2.own, ec.ghost, ec.layout, ec.backend)
        e_own = spmv(level.P, _col_view(level.P, ec)).own
        x = PVector(x.own + e_own, x.ghost, x.layout, x.backend)
        return level.smoother.apply(x, b)

    def __call__(self, r: PVector) -> PVector:
        return self._cycle(0, r, self.params.cycle == "w")

    def update(self, A: PSparseMatrix):
        raise NotImplementedError("AMGPreconditioner.update (the reuse tier): ROADMAP Queue 1 item 13")

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
    own = v.own[:, :no] if v.own.shape[1] >= no else _pad2(v.own, no)
    return PVector(own, own.new_zeros((own.shape[0], lay.n_ghost_pad)), lay, v.backend)


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
