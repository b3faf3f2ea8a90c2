"""Each plain reference agrees with the port on the CPU at a tiny size."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.reference import amg_elasticity as ref_amg  # noqa: E402
from portbench.reference import hpcg as ref_hpcg  # noqa: E402


@pytest.mark.parametrize("n", [8, 16, 32, 64, 128, 256])
def test_hpcg_coloring_is_the_ports(n):
    from partitionedarrays_tpu_torch.solvers.gs_dia import find_mod_coloring

    offs = [dx * n * n + dy * n + dz for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]
    assert ref_hpcg.mod_coloring((n, n, n)) == find_mod_coloring(offs)


def test_hpcg_reference_set_equals_the_ports():
    from partitionedarrays_tpu_torch.backends import SerialBackend
    from partitionedarrays_tpu_torch.models.hpcg.cg import hpcg_cg_flat
    from partitionedarrays_tpu_torch.models.hpcg.mg import HPCGMGPreconditioner
    from portbench.layout import from_pvector, to_pvector

    mg = HPCGMGPreconditioner((16, 16, 16), (1, 1, 1), SerialBackend(1), n_levels=4,
                              dtype=np.float64, device="cpu")
    b = torch.randn(16 ** 3, dtype=torch.float64, generator=torch.Generator().manual_seed(5))
    x, norms = hpcg_cg_flat(mg, to_pvector(b, mg.A, torch.float64), iterations=20)
    x_ref, n_ref = ref_hpcg.hpcg_set((16, 16, 16), 4, 20, b)
    assert float((norms - n_ref).abs().max() / n_ref[0]) < 1e-13
    x = from_pvector(x, mg.A)
    assert float((x - x_ref).norm() / x_ref.norm()) < 1e-13
    # and the reference's operator is the port's
    from partitionedarrays_tpu_torch.psparse import centralize

    G = torch.from_numpy(centralize(mg.A).toarray())
    lev = ref_hpcg.Level((16, 16, 16), "cpu", torch.float64)
    assert torch.allclose(G @ b, lev.apply(b.reshape(16, 16, 16)).reshape(-1), rtol=0, atol=1e-12)


def test_elasticity_reference_operator_equals_the_ports():
    from partitionedarrays_tpu_torch.backends import SerialBackend
    from partitionedarrays_tpu_torch.models.gallery import linear_elasticity_fem
    from partitionedarrays_tpu_torch.psparse import centralize, psparse

    nodes = (6, 5, 4)
    A = psparse(*linear_elasticity_fem(nodes, (1, 1, 1)), SerialBackend(1), device="cpu")
    G = torch.from_numpy(centralize(A).toarray())
    R = ref_amg.assemble(nodes, 1.0, 0.33, "cpu").to_dense()
    assert float((G - R).abs().max() / R.abs().max()) < 1e-14


def test_elasticity_true_residual_of_the_ports_solve():
    from partitionedarrays_tpu_torch.backends import SerialBackend
    from partitionedarrays_tpu_torch.models.gallery import (
        linear_elasticity_fem, node_coordinates_unit_cube, nullspace_linear_elasticity)
    from partitionedarrays_tpu_torch.psparse import psparse
    from partitionedarrays_tpu_torch.solvers.amg import AMGParams, AMGPreconditioner
    from partitionedarrays_tpu_torch.solvers.krylov import cg
    from portbench.layout import from_pvector, to_pvector

    nodes = (5, 5, 5)
    A = psparse(*linear_elasticity_fem(nodes, (1, 1, 1)), SerialBackend(1), device="cpu")
    coords, _ = node_coordinates_unit_cube(nodes, (1, 1, 1))
    M = AMGPreconditioner(A, AMGParams(coarse_size=30, block_size=3, max_levels=4),
                          nullspace=nullspace_linear_elasticity(coords))
    b = torch.randn(A.shape[0], dtype=torch.float64, generator=torch.Generator().manual_seed(3))
    x, info = cg(A, to_pvector(b, A, torch.float64), M=M, rtol=1e-8, maxiter=200)
    R = ref_amg.assemble(nodes, 1.0, 0.33, "cpu")
    relres = ref_amg.true_relres(R, from_pvector(x, A), b)
    assert relres <= 1e-8 * 1.01 and float(info.residual) / float(b.norm()) <= 1e-8
