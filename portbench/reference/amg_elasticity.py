"""The plain reference of the elasticity configuration, in NumPy and plain
PyTorch.

It assembles the operator from the configuration alone: small-strain
linear elasticity (Young's modulus E, Poisson's ratio nu) on the unit cube
meshed by (n + 1)^3 trilinear hexahedra with n free nodes a direction (the
boundary nodes fixed), three dofs a node (dof = 3 node + component, nodes
in C order), the element stiffness in Voigt form, B^T D B integrated with
2x2x2 Gauss points, summed on the card as coordinate triplets.

``compare`` judges the solves: the true residual ``|b - A x| / |b|`` of
each solution the port kept from the window, in float64 on this operator;
the largest is the number compared.  ``values_bits_short`` holds the
configuration's precision: the bits that the narrowest type the port
stores a level's operator or smoother values in lacks against it.
"""
from __future__ import annotations

from itertools import product
from typing import Sequence

import numpy as np
import torch

from portbench.precision import bits_short

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def element_stiffness(h: Sequence[float], E: float, nu: float) -> np.ndarray:
    """[24, 24] stiffness of one hexahedron of sides ``h``; local node a is
    the corner ``corners()[a]``, dof 3 a + component."""
    lam = E * nu / ((1 + nu) * (1 - 2 * nu))
    mu = E / (2 * (1 + nu))
    D = np.zeros((6, 6))
    D[:3, :3] = lam
    D[np.arange(3), np.arange(3)] += 2 * mu
    D[np.arange(3, 6), np.arange(3, 6)] = mu
    h = np.asarray(h, dtype=np.float64)
    signs = 2.0 * np.array(corners(), dtype=np.float64) - 1.0  # [8, 3] in {-1, 1}
    K = np.zeros((24, 24))
    g = 1.0 / np.sqrt(3.0)
    for xi in product((-g, g), repeat=3):
        xi = np.array(xi)
        # dN_a/dx_d = (s_ad / 2) prod_{e != d} (1 + s_ae xi_e) / 2 * (2 / h_d)
        f = (1.0 + signs * xi) / 2.0  # [8, 3]
        grad = np.empty((8, 3))
        for d in range(3):
            others = [e for e in range(3) if e != d]
            grad[:, d] = signs[:, d] / 2.0 * f[:, others[0]] * f[:, others[1]] * (2.0 / h[d])
        B = np.zeros((6, 24))
        for a in range(8):
            gx, gy, gz = grad[a]
            B[:, 3 * a:3 * a + 3] = [[gx, 0, 0], [0, gy, 0], [0, 0, gz],
                                     [gy, gx, 0], [0, gz, gy], [gz, 0, gx]]
        K += B.T @ D @ B * np.prod(h) / 8.0
    return K


def corners():
    return list(product((0, 1), repeat=3))


def assemble(nodes: Sequence[int], E: float, nu: float, device) -> torch.Tensor:
    """The global operator as a coalesced float64 sparse tensor on
    ``device``."""
    n = np.array([int(v) for v in nodes])
    h = 1.0 / (n + 1)
    Ke = torch.from_numpy(element_stiffness(h, E, nu)).to(device)
    cells = n + 1
    cx, cy, cz = torch.meshgrid(*[torch.arange(int(c), device=device) for c in cells],
                                indexing="ij")
    cell = torch.stack([cx.reshape(-1), cy.reshape(-1), cz.reshape(-1)], dim=1)  # [ncell, 3]
    nt = torch.as_tensor(n, device=device)
    dofs = []
    for off in corners():
        node = cell + torch.as_tensor(off, device=device) - 1
        inside = ((node >= 0) & (node < nt)).all(dim=1)
        nid = (node[:, 0] * n[1] + node[:, 1]) * n[2] + node[:, 2]
        for comp in range(3):
            dofs.append(torch.where(inside, 3 * nid + comp, -1))
    dofs = torch.stack(dofs, dim=1)  # [ncell, 24], -1 on a fixed node
    I = dofs[:, :, None].expand(-1, 24, 24)
    J = dofs[:, None, :].expand(-1, 24, 24)
    keep = (I >= 0) & (J >= 0)
    V = Ke[None].expand(dofs.shape[0], 24, 24)
    n_dof = 3 * int(np.prod(n))
    with torch.sparse.check_sparse_tensor_invariants():
        A = torch.sparse_coo_tensor(torch.stack([I[keep], J[keep]]), V[keep], (n_dof, n_dof))
        return A.coalesce()


def true_relres(A: torch.Tensor, x: torch.Tensor, b: torch.Tensor) -> float:
    r = b - torch.sparse.mm(A, x.unsqueeze(1)).squeeze(1)
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b))


def compare(config: dict, mix: dict, inputs: dict, outputs: dict, device) -> dict:
    A = assemble(config["nodes_per_dir"], float(config["E"]), float(config["nu"]), device)
    rhs = inputs["rhs"].to(device=device, dtype=torch.float64)
    gaps = [true_relres(A, x.to(device=device, dtype=torch.float64), rhs[k])
            for k, x in sorted(outputs["x"].items())]
    return {"true_relres": max(gaps),
            "values_bits_short": bits_short(config["dtype"], outputs["stored_dtypes"])}
