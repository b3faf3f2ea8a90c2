"""The PyTorch port never loads JAX.

A fresh interpreter imports the port's modules, builds small HPCG problems
on one part and on (2,2,2) parts, and runs short MG-preconditioned CG solves
on the CPU (the flat CG, the ghosted flat CG with its exchanges and
own-ghost products, and the df64 CG), then the generic solvers (``cg``,
``cg_df64``, a solver of ``solvers/interfaces.py``), and the elasticity
SA-AMG path (gallery, COO ``psparse``, the tile Gauss-Seidel tier, ``cg``
and ``amg_solver``), and the box-stencil AMG (``laplacian_fdm``, the flat
cycle under ``cg``, and under ``cg_df64`` from an ``astype`` float32
copy); afterwards ``jax`` must not be among the loaded modules.
"""
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

SCRIPT = """
import sys
import numpy as np
import torch
torch.set_num_threads(1)
import partitionedarrays_tpu_torch.convert
import partitionedarrays_tpu_torch.ops.ghost_spmv
import partitionedarrays_tpu_torch.ops.sparse_host
from partitionedarrays_tpu_torch.backends import SerialBackend
from partitionedarrays_tpu_torch.models.hpcg.cg import hpcg_cg_flat, hpcg_cg_flat_g
from partitionedarrays_tpu_torch.models.hpcg.mg import HPCGMGPreconditioner
mg = HPCGMGPreconditioner((8, 8, 8), (1, 1, 1), SerialBackend(1), n_levels=2, device="cpu")
_, norms = hpcg_cg_flat(mg, mg.b, iterations=5)
assert float(norms[-1] / norms[0]) < 1e-3, norms
mg = HPCGMGPreconditioner((4, 4, 4), (2, 2, 2), SerialBackend(8), n_levels=2, device="cpu")
assert mg.A.col_layout().consistent_plan.n_rounds > 0
_, norms = hpcg_cg_flat_g(mg, mg.b, iterations=5)
assert float(norms[-1] / norms[0]) < 1e-3, norms
import partitionedarrays_tpu_torch.ops.df64
from partitionedarrays_tpu_torch.models.hpcg.cg import hpcg_cg_df64
from partitionedarrays_tpu_torch.models.hpcg.driver import df64_problem
from partitionedarrays_tpu_torch.solvers.interfaces import LinearProblem, jacobi_solver, solve
from partitionedarrays_tpu_torch.solvers.krylov import cg, cg_df64
from partitionedarrays_tpu_torch.solvers.smoothers import JacobiCorrection
mg32 = HPCGMGPreconditioner((4, 4, 4), (2, 2, 2), SerialBackend(8), n_levels=2,
                            dtype=np.float32, device="cpu")
A, b = df64_problem((4, 4, 4), (2, 2, 2), mg32.backend, "cpu")
_, norms = hpcg_cg_df64(A, b, M=mg32, iterations=5)
assert float(norms[-1] / norms[0]) < 1e-3, norms
_, info = cg_df64(A, b, rtol=1e-10)
assert float(info.residual) < 1e-9 * float(norms[0]), info
_, info = cg(mg.A, mg.b, M=JacobiCorrection(mg.A), rtol=1e-6)
assert info.iterations > 0, info
solve(jacobi_solver(iterations=2), LinearProblem(mg.A, mg.b))
import partitionedarrays_tpu_torch.ops.tile_gs
from partitionedarrays_tpu_torch.models.gallery import (
    linear_elasticity_fem, node_coordinates_unit_cube, nullspace_linear_elasticity,
)
from partitionedarrays_tpu_torch.psparse import psparse, spmv
from partitionedarrays_tpu_torch.pvector import pones
from partitionedarrays_tpu_torch.solvers.amg import AMGParams, AMGPreconditioner
from partitionedarrays_tpu_torch.solvers.interfaces import amg_solver
I, J, V, rows, cols = linear_elasticity_fem((7, 7, 7), (1, 1, 1))
A = psparse(I, J, V, rows, cols, SerialBackend(1), device="cpu")
coords, _ = node_coordinates_unit_cube((7, 7, 7), (1, 1, 1))
ns = nullspace_linear_elasticity(coords)
params = AMGParams(coarse_size=30, block_size=3, max_levels=4)
M = AMGPreconditioner(A, params, nullspace=ns)
assert M.levels[1].smoother.tile_gs is not None
b = spmv(A, pones(A.col_prange, A.backend, dtype=A.dtype, device="cpu"))
_, info = cg(A, b, M=M, rtol=1e-8)
assert info.iterations < 20, info
solve(amg_solver(params, ns, iterations=2), LinearProblem(A, b))
from partitionedarrays_tpu_torch.models.gallery import laplacian_fdm
from partitionedarrays_tpu_torch.pvector import pvector_df64
I, J, V, rows, cols = laplacian_fdm((9, 9, 9), (1, 1, 1))
A = psparse(I, J, V, rows, cols, SerialBackend(1), device="cpu")
M = AMGPreconditioner(A, AMGParams(coarse_size=10))
assert M.levels[0].struct is not None and M._flat_ok(0)
b = spmv(A, pones(A.col_prange, A.backend, dtype=A.dtype, device="cpu"))
_, info = cg(A, b, M=M, rtol=1e-8)
assert info.iterations < 20, info
M32 = AMGPreconditioner(A.astype(np.float32), AMGParams(coarse_size=10))
b2 = pvector_df64([b.own[0, : A.shape[0]].numpy()], A.row_prange, A.backend, device="cpu")
_, info = cg_df64(A, b2, M=M32, rtol=1e-10)
assert info.iterations < 30, info
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
print("JAX_MODULES", loaded)
sys.exit(1 if loaded else 0)
"""


def test_port_does_not_load_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO), OPENBLAS_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "JAX_MODULES []" in proc.stdout
