"""Built-in test problems as per-part COO triplets (host numpy, setup-time).

Copied from ``partitionedarrays_tpu/models/gallery.py``: ``laplacian_fdm``
(:25-64), ``plaplacian_fdm`` (:67-90), ``_q1_reference_stiffness`` and
``laplacian_fem`` (:93-197), ``node_coordinates_unit_cube`` (:200-215),
``node_to_dof_partition`` (:218-252), ``linear_elasticity_fem``
(:255-342) and ``nullspace_linear_elasticity`` (:345-371) with its alias
``near_nullspace_linear_elasticity`` (:375).  The same numpy
operations in the same order, so the triplets equal the reference's bit
for bit.  Each generator returns ``(I, J, V, row_partition,
col_partition)`` ready for ``psparse`` (``plaplacian_fdm`` returns the
assembled matrix itself); all indices are 0-based and nodes linearized in
C order.
"""
from __future__ import annotations

from itertools import product as iproduct
from typing import List, Sequence, Tuple

import numpy as np

from ..parallel.partition import INT, LocalIndices, uniform_partition


def _coords(gids: np.ndarray, shape) -> Tuple[np.ndarray, ...]:
    return np.unravel_index(gids, shape)


def laplacian_fdm(nodes_per_dir: Sequence[int], parts_per_dir: Sequence[int], dtype=np.float64):
    """(2D+1)-point finite-difference Laplacian with zero Dirichlet boundary
    outside the grid, scaled by prod(n_d + 1).  Every row is owned (the
    assembled input state)."""
    nodes = tuple(int(n) for n in nodes_per_dir)
    parts = tuple(int(p) for p in parts_per_dir)
    D = len(nodes)
    alpha = dtype(np.prod([n + 1 for n in nodes]))
    node_partition = uniform_partition(parts, nodes)
    Is, Js, Vs = [], [], []
    for li in node_partition:
        own = li.own_to_global
        cs = _coords(own, nodes)
        I = [own]
        J = [own]
        V = [np.full(own.size, alpha * 2 * D, dtype=dtype)]
        for d in range(D):
            for step in (-1, 1):
                cj = list(cs)
                cj[d] = cs[d] + step
                valid = (cj[d] >= 0) & (cj[d] < nodes[d])
                nb = np.ravel_multi_index(
                    tuple(np.clip(c, 0, nodes[k] - 1) if k == d else c for k, c in enumerate(cj)),
                    nodes,
                )
                I.append(own[valid])
                J.append(nb[valid])
                V.append(np.full(int(valid.sum()), -alpha, dtype=dtype))
        Is.append(np.concatenate(I))
        Js.append(np.concatenate(J))
        Vs.append(np.concatenate(V))
    return Is, Js, Vs, node_partition, node_partition


def plaplacian_fdm(nodes_per_dir: Sequence[int], parts_per_dir: Sequence[int], backend,
                   dtype=np.float64, device="cuda"):
    """The operator of ``laplacian_fdm`` as an assembled PSparseMatrix on
    ``device``, built in closed form by ``ops/stencil.py::stencil_psparse``
    (no triplets; the own-own block is DIA, on any part grid)."""
    from ..ops.stencil import stencil_psparse

    nodes = tuple(int(n) for n in nodes_per_dir)
    D = len(nodes)
    alpha = float(np.prod([n + 1 for n in nodes]))
    stencil = [((0,) * D, alpha * 2 * D)]
    for d in range(D):
        for step in (-1, 1):
            stencil.append((tuple(step if k == d else 0 for k in range(D)), -alpha))
    return stencil_psparse(tuple(int(p) for p in parts_per_dir), nodes, stencil, backend,
                           dtype=dtype, device=device)


def _q1_reference_stiffness(h_per_dir, dtype=np.float64) -> np.ndarray:
    """Q1 element stiffness with 2-point Gauss quadrature per dimension,
    ``K[i, j] = sum_q dV grad(phi_i)(x_q) . grad(phi_j)(x_q)``."""
    D = len(h_per_dir)
    gp = np.array([-np.sqrt(3) / 3, np.sqrt(3) / 3], dtype=dtype)
    sf = np.stack([0.5 * (1 - gp), 0.5 * (gp + 1)], axis=1)  # [pt, node]
    sg = np.stack([np.full(2, -0.5, dtype), np.full(2, 0.5, dtype)], axis=1)
    n = 2**D
    nodes = list(iproduct(*[range(2)] * D))
    points = list(iproduct(*[range(2)] * D))
    grad = np.zeros((n, len(points), D), dtype=dtype)  # [node, point, d]
    for a, nt in enumerate(nodes):
        for q, pt in enumerate(points):
            for d in range(D):
                v = dtype(1)
                for i in range(D):
                    if i == d:
                        v *= (2.0 / h_per_dir[d]) * sg[pt[i], nt[i]]
                    else:
                        v *= sf[pt[i], nt[i]]
                grad[a, q, d] = v
    dV = np.prod(h_per_dir) / (2**D)
    K = dV * np.einsum("aqd,bqd->ab", grad, grad)
    return K.astype(dtype)


def laplacian_fem(nodes_per_dir: Sequence[int], parts_per_dir: Sequence[int], dtype=np.float64):
    """Q1 FEM Laplacian on the unit cube with ``nodes_per_dir`` free
    (interior) nodes.  Assembly loops over owned cells, so parts contribute
    to rows they do not own (the disassembled input state)."""
    nodes = tuple(int(n) for n in nodes_per_dir)
    parts_pd = tuple(int(p) for p in parts_per_dir)
    D = len(nodes)
    cells = tuple(n + 1 for n in nodes)
    h = np.array([1.0 / (n + 1) for n in nodes], dtype=dtype)
    Aref = _q1_reference_stiffness(h, dtype)
    node_partition = uniform_partition(parts_pd, nodes)
    cell_partition = uniform_partition(parts_pd, cells)
    local_nodes = list(iproduct(*[range(2)] * D))  # offsets of the 2^D corners
    Is, Js, Vs = [], [], []
    for li in cell_partition:
        I, J, V = _fem_part_triplets(li, cells, nodes, local_nodes, Aref, dtype, D)
        Is.append(I)
        Js.append(J)
        Vs.append(V)
    return Is, Js, Vs, node_partition, node_partition


def _fem_part_triplets(li, cells, nodes, local_nodes, Aref, dtype, D):
    """Triplets contributed by one part's owned cells."""
    n_loc = len(local_nodes)
    own_cells = li.own_to_global
    ccs = np.stack(_coords(own_cells, cells), axis=1)  # [ncell, D]
    # global node id (or -1 on the boundary) of each cell corner
    corner = np.empty((own_cells.size, n_loc), dtype=INT)
    for a, off in enumerate(local_nodes):
        nc = ccs + np.array(off) - 1  # node coords = cell + local - 1
        valid = np.all((nc >= 0) & (nc < np.array(nodes)), axis=1)
        idx = np.ravel_multi_index(tuple(np.clip(nc[:, d], 0, nodes[d] - 1) for d in range(D)), nodes)
        corner[:, a] = np.where(valid, idx, -1)
    I, J, V = [], [], []
    for a in range(n_loc):
        for b in range(n_loc):
            m = (corner[:, a] >= 0) & (corner[:, b] >= 0)
            I.append(corner[m, a])
            J.append(corner[m, b])
            V.append(np.full(int(m.sum()), Aref[a, b], dtype=dtype))
    return np.concatenate(I), np.concatenate(J), np.concatenate(V)


def node_coordinates_unit_cube(
    nodes_per_dir: Sequence[int], parts_per_dir: Sequence[int], dtype=np.float64
):
    """Per-part coordinates ``[n_own, D]`` of the owned free nodes of the
    unit cube, and the node partition."""
    nodes = tuple(int(n) for n in nodes_per_dir)
    parts = tuple(int(p) for p in parts_per_dir)
    h = np.array([1.0 / (n + 1) for n in nodes], dtype=dtype)
    node_partition = uniform_partition(parts, nodes)
    out = []
    for li in node_partition:
        cs = np.stack(_coords(li.own_to_global, nodes), axis=1).astype(dtype)
        out.append((cs + 1.0) * h)
    return out, node_partition


def node_to_dof_partition(node_partition, n_components: int) -> List[LocalIndices]:
    """Scalar node partition -> vector dof partition with
    dof = node * n_components + component."""
    nc = int(n_components)
    n_global = node_partition[0].n_global * nc
    base = list(node_partition)
    g2o = next(li.global_to_owner for li in base if li.global_to_owner is not None)

    def g2owner(q):
        q = np.asarray(q, dtype=INT)
        out = np.asarray(g2o(q // nc), dtype=INT)
        return np.where(q >= 0, out, -1)

    out = []
    for li in base:
        own = (li.own_to_global[:, None] * nc + np.arange(nc)[None, :]).ravel()
        ghost = (li.ghost_to_global[:, None] * nc + np.arange(nc)[None, :]).ravel()
        gowner = np.repeat(li.ghost_to_owner, nc)
        out.append(
            LocalIndices(n_global, li.part, li.n_parts, own, ghost, gowner, global_to_owner=g2owner)
        )
    return out


def linear_elasticity_fem(
    nodes_per_dir: Sequence[int],
    parts_per_dir: Sequence[int],
    E: float = 1.0,
    nu: float = 0.33,
    dtype=np.float64,
):
    """Q1 FEM small-strain linear elasticity on the unit cube: D dofs per
    node, dof = node * D + component, assembled over owned cells (the
    disassembled input state)."""
    nodes = tuple(int(n) for n in nodes_per_dir)
    parts = tuple(int(p) for p in parts_per_dir)
    D = len(nodes)
    cells = tuple(n + 1 for n in nodes)
    h = np.array([1.0 / (n + 1) for n in nodes], dtype=dtype)
    lam = (E * nu) / ((1 + nu) * (1 - 2 * nu))
    mu = E / (2 * (1 + nu))

    # element stiffness of the vector problem, K[(a, i), (b, j)], with
    # quadrature over 2^D Gauss points
    gp = np.array([-np.sqrt(3) / 3, np.sqrt(3) / 3], dtype=dtype)
    sf = np.stack([0.5 * (1 - gp), 0.5 * (gp + 1)], axis=1)  # [pt, node]
    sgd = np.stack([np.full(2, -0.5, dtype), np.full(2, 0.5, dtype)], axis=1)
    local_nodes = list(iproduct(*[range(2)] * D))
    points = list(iproduct(*[range(2)] * D))
    n_loc = len(local_nodes)
    grad = np.zeros((n_loc, len(points), D), dtype=dtype)
    for a, nt in enumerate(local_nodes):
        for q, pt in enumerate(points):
            for d in range(D):
                v = dtype(1)
                for i in range(D):
                    if i == d:
                        v *= (2.0 / h[d]) * sgd[pt[i], nt[i]]
                    else:
                        v *= sf[pt[i], nt[i]]
                grad[a, q, d] = v
    dV = np.prod(h) / (2**D)
    ndof = n_loc * D
    Ke = np.zeros((ndof, ndof), dtype=dtype)
    for q in range(len(points)):
        B = np.zeros((D, D, ndof), dtype=dtype)  # strain operator eps_kl
        for a in range(n_loc):
            for i in range(D):
                col = a * D + i
                for l in range(D):
                    B[i, l, col] += 0.5 * grad[a, q, l]
                    B[l, i, col] += 0.5 * grad[a, q, l]
        tr = np.einsum("kkc->c", B)
        Ke += dV * (lam * np.outer(tr, tr) + 2 * mu * np.einsum("klc,kld->cd", B, B))

    node_partition = uniform_partition(parts, nodes)
    cell_partition = uniform_partition(parts, cells)
    dof_partition = node_to_dof_partition(node_partition, D)
    Is, Js, Vs = [], [], []
    for li in cell_partition:
        own_cells = li.own_to_global
        ccs = np.stack(_coords(own_cells, cells), axis=1)
        corner = np.empty((own_cells.size, n_loc), dtype=INT)
        for a, off in enumerate(local_nodes):
            ncrd = ccs + np.array(off) - 1
            valid = np.all((ncrd >= 0) & (ncrd < np.array(nodes)), axis=1)
            idx = np.ravel_multi_index(
                tuple(np.clip(ncrd[:, d], 0, nodes[d] - 1) for d in range(D)), nodes
            )
            corner[:, a] = np.where(valid, idx, -1)
        I, J, V = [], [], []
        for a in range(n_loc):
            for i in range(D):
                ra = a * D + i
                for b in range(n_loc):
                    for j in range(D):
                        rb = b * D + j
                        if Ke[ra, rb] == 0:
                            continue
                        m = (corner[:, a] >= 0) & (corner[:, b] >= 0)
                        I.append(corner[m, a] * D + i)
                        J.append(corner[m, b] * D + j)
                        V.append(np.full(int(m.sum()), Ke[ra, rb], dtype=dtype))
        Is.append(np.concatenate(I))
        Js.append(np.concatenate(J))
        Vs.append(np.concatenate(V))
    return Is, Js, Vs, dof_partition, dof_partition


def nullspace_linear_elasticity(coords_parts: List[np.ndarray], dof_partition=None):
    """Rigid-body modes (1, 3 or 6 for D = 1, 2, 3) per part, as per-part
    arrays over the own dofs."""
    D = coords_parts[0].shape[1]
    n_modes = {1: 1, 2: 3, 3: 6}[D]
    modes_parts = []
    for xs in coords_parts:
        n_nodes = xs.shape[0]
        B = np.zeros((n_modes, n_nodes, D))
        for d in range(D):  # translations
            B[d, :, d] = 1.0
        if D == 2:  # rotations
            B[2, :, 0] = -xs[:, 1]
            B[2, :, 1] = xs[:, 0]
        elif D == 3:
            B[3, :, 0] = -xs[:, 1]
            B[3, :, 1] = xs[:, 0]
            B[4, :, 1] = -xs[:, 2]
            B[4, :, 2] = xs[:, 1]
            B[5, :, 0] = -xs[:, 2]
            B[5, :, 2] = xs[:, 0]
        modes_parts.append([B[m].ravel() for m in range(n_modes)])
    return modes_parts


# the reference's alias (gallery.py:375, src/gallery.jl)
near_nullspace_linear_elasticity = nullspace_linear_elasticity
