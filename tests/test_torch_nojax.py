"""The PyTorch port never loads JAX.

A fresh interpreter imports the port's modules, builds small HPCG problems
on one part and on (2,2,2) parts, and runs short MG-preconditioned CG solves
on the CPU (the flat CG, the ghosted flat CG with its exchanges and
own-ghost products, and the df64 CG), then the generic solvers (``cg``,
``cg_df64``, a solver of ``solvers/interfaces.py``), and the elasticity
SA-AMG path (gallery, COO ``psparse``, the tile Gauss-Seidel tier, ``cg``
and ``amg_solver``), the box-stencil AMG (``laplacian_fdm``, the flat
cycle under ``cg``, and under ``cg_df64`` from an ``astype`` float32
copy), and the partitioned matrix across parts (subassembled COO,
``assemble_matrix``, ``consistent_matrix``, the distributed products,
``convert.psparse_from_host_blocks``, the COO ``pvector`` and its tasks,
``lu_solver``, the elasticity AMG-CG and the box AMG-CG with the ghosted
flat cycle on (2,2,2) parts), and the reuse tier (``psparse(reuse=True)``,
``DeviceRefill``, ``psparse_refill``, ``AMGPreconditioner.update``,
``psystem`` and its refill, and the implicit reaction-diffusion run of
``examples/implicit_reuse.py`` through ``backward_euler`` and
``newton_raphson``), and the Schwarz tier (the native setup library,
``AdditiveSchwarz`` in its ilu0 and dense tiers under ``cg``,
``additive_schwarz_solver``, AMG with Schwarz level smoothers and its
``update``), and the reduced-precision preconditioner values
(``hpcg_benchmark(precond_dtype=...)`` on the flat and df64 routes, the
HPCG aliases), and the partition, vector and matrix utilities
(``plaplacian_fdm`` on part boxes of unequal shape, ``repartition_system``
onto contiguous blocks, the AMG-CG on the repartitioned system and
``repartition`` of its solution back), and the remaining layers (float16
preconditioner values, ``b_cg`` on a block system, ``PTimer``, a checkpoint
round trip, the primitives and jagged arrays, the ``compat`` names and the
port's examples), and ``newton_krylov`` (both products, with a Gauss-Seidel
preconditioner, on a one-process mesh backend) and the host helpers of
``ops/sparse_host.py``, and a sweep of the sorted-by-color tier and
``ops/ell.py``; afterwards neither ``jax`` nor ``ml_dtypes`` (the
reference's bfloat16 numpy dtype, read by ``convert.py`` without it) may be
among the loaded modules.  A second interpreter blocks ``jax`` outright
(an import raises) and imports every module of the port and every example
of its own.
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
import partitionedarrays_tpu_torch.parallel.primitives
from partitionedarrays_tpu_torch.convert import psparse_from_host_blocks
from partitionedarrays_tpu_torch.psparse import (
    assemble_matrix, centralize, consistent_matrix, rap, spmm, spmtm, spmtv, transpose_psparse,
)
from partitionedarrays_tpu_torch.pvector import assemble, collect, consistent, pmaximum, pvector
from partitionedarrays_tpu_torch.solvers.interfaces import lu_solver
I, J, V, rows, cols = linear_elasticity_fem((5, 5, 5), (2, 2, 2))
A = assemble_matrix(psparse(I, J, V, rows, cols, SerialBackend(8), assemble=False,
                            device="cpu")).wait()
assert consistent_matrix(A, A.col_prange).wait().blocks[0]["ho"].nnz > 0
R = transpose_psparse(A)
assert abs(centralize(rap(R, A, A)) - centralize(spmm(spmtm(A, A), A))).max() < 1e-9
C = psparse_from_host_blocks(
    A.blocks, [dict(n_global=li.n_global, own_to_global=li.own_to_global) for li in A.row_prange.parts],
    [dict(n_global=li.n_global, own_to_global=li.own_to_global, ghost_to_global=li.ghost_to_global,
          ghost_to_owner=li.ghost_to_owner) for li in A.col_prange.parts], device="cpu")
x = pvector([li.own_to_global for li in A.col_prange.parts],
            [np.ones(li.n_own) for li in A.col_prange.parts], A.col_prange, A.backend, device="cpu")
y = consistent(x).wait()
assert float(pmaximum(spmtv(C, y))) > 0 and collect(assemble(y).wait()).size == A.shape[0]
b = spmv(A, pones(A.col_prange, A.backend, dtype=A.dtype, device="cpu"))
xs = solve(lu_solver(), LinearProblem(A, b))
assert np.abs(collect(xs) - 1).max() < 1e-8
coords, _ = node_coordinates_unit_cube((5, 5, 5), (2, 2, 2))
M = AMGPreconditioner(A, AMGParams(coarse_size=30, block_size=3, max_levels=4),
                      nullspace=nullspace_linear_elasticity(coords, A.row_prange))
_, info = cg(A, b, M=M, rtol=1e-8)
assert info.iterations < 30, info
I, J, V, rows, cols = laplacian_fdm((12, 12, 12), (2, 2, 2))
A = psparse(I, J, V, rows, cols, SerialBackend(8), assembled=True, device="cpu")
M = AMGPreconditioner(A, AMGParams(coarse_size=10))
assert M.levels[0].struct is not None and not M._flat_ok(0)
b = spmv(A, pones(A.col_prange, A.backend, dtype=A.dtype, device="cpu"))
_, info = cg(A, b, M=M, rtol=1e-8)
assert info.iterations < 20, info
from partitionedarrays_tpu_torch import backward_euler, newton_raphson, psystem, psystem_refill
from partitionedarrays_tpu_torch.psparse import device_refill_plan, psparse_refill, spmm_into
from partitionedarrays_tpu_torch.pvector import pvector_refill
A, cache = psparse(I, J, V, rows, cols, SerialBackend(8), assembled=True, reuse=True, device="cpu")
M = AMGPreconditioner(A, AMGParams(coarse_size=10))
V2 = [v * (1.0 + 0.5 * (i == j)) for i, j, v in zip(I, J, V)]
plan = device_refill_plan(A, cache)
dev = plan(plan.stack_values(V2))
psparse_refill(A, V2, cache)
assert torch.equal(dev.oo.vals, A.device().oo.vals)
M.update(A)
_, info = cg(A, b, M=M, rtol=1e-8)
assert info.iterations < 20, info
Ib = [li.own_to_global for li in A.row_prange.parts]
A2, b2, sc = psystem(I, J, V, Ib, [np.ones(i.size) for i in Ib], rows, cols, SerialBackend(8),
                     reuse=True, device="cpu")
b3 = psystem_refill(A2, V2, [np.full(i.size, 2.0) for i in Ib], sc)
assert float(pmaximum(b3)) == 2.0
sys.path.insert(0, "examples")
import implicit_reuse
r = implicit_reuse.reaction_diffusion(implicit_reuse.port("cpu"), nodes=(4, 4, 4), steps=1)
assert r["newton"] and max(r["relres"]) < 1e-9, r["relres"]
from partitionedarrays_tpu_torch.ops.native import (
    coo_to_csr_native, greedy_coloring_native, ilu0, vanek_aggregate_native,
)
from partitionedarrays_tpu_torch.solvers.interfaces import additive_schwarz_solver
from partitionedarrays_tpu_torch.solvers.smoothers import AdditiveSchwarz, additive_schwarz
from partitionedarrays_tpu_torch.models.hpcg.problem import build_hpcg_problem
I, J, V, _, _ = laplacian_fdm((6, 6, 6), (1, 1, 1))
G = coo_to_csr_native(I[0], J[0], V[0], 216, 216)
assert ilu0(G)[1].nnz > 0 and greedy_coloring_native(G).max() > 0
assert vanek_aggregate_native(G, 0.0).max() > 0
A, b = build_hpcg_problem((16, 16, 16), (2, 1, 1), SerialBackend(2), device="cpu")
for S in (AdditiveSchwarz(A, mode="ilu0"), additive_schwarz(A, mode="dense")):
    _, info = cg(A, b, M=S, rtol=1e-6)
    assert info.iterations < 30, info
solve(additive_schwarz_solver(iterations=2), LinearProblem(A, b))
I, J, V, rows, cols = laplacian_fdm((40, 40), (1, 1))
A = psparse(I, J, V, rows, cols, SerialBackend(1), device="cpu")
M = AMGPreconditioner(A, AMGParams(coarse_size=20, smoother="schwarz"))
assert [lev.smoother.mode for lev in M.levels[:2]] == ["ilu0", "dense"]
b = spmv(A, pones(A.col_prange, A.backend, dtype=A.dtype, device="cpu"))
_, info = cg(A, b, M=M, rtol=1e-8)
assert info.iterations < 30, info
M.update(A)
from partitionedarrays_tpu_torch.models.hpcg import (
    build_matrix, hpcg_benchmark_debug, pc_setup, pc_solve, restrict_operator,
)
for precision in (None, "df64"):
    r = hpcg_benchmark_debug(local_shape=(8, 8, 8), parts_per_dir=(1, 1, 1), n_levels=2,
                             iterations=5, ref_sets=1, timed_sets=1, precision=precision,
                             precond_dtype="bfloat16", device="cpu").summary()
    assert r["precond_values_dtype"] == "bfloat16" and r["validation_passed"], r
mg = pc_setup((4, 4, 4), (1, 1, 1), SerialBackend(1), n_levels=2, device="cpu")
assert pc_solve(mg, mg.b).own.shape == mg.b.own.shape
assert build_matrix((4, 4, 4))[0].nnz > 0 and restrict_operator(4, 4, 4).size == 8
from partitionedarrays_tpu_torch import (
    PRange, local_range, plaplacian_fdm, repartition, repartition_system, variable_partition,
)
from partitionedarrays_tpu_torch.pvector import pvector_from_own
A = plaplacian_fdm((9, 10, 11), (2, 2, 2), SerialBackend(8), device="cpu")
assert len(A.device().oo.offsets) == 11 and A._oo_dia_host is not None
own = [np.zeros(li.n_own) for li in A.row_prange.parts]
own[0][:10] = 1.0
b = pvector_from_own(own, A.row_prange, A.backend, device="cpu")
new_rows = PRange(variable_partition([len(local_range(p, 8, 990)) for p in range(8)]))
A2, b2 = repartition_system(A, b, new_rows)
assert abs(centralize(A2) - centralize(A)).max() == 0
x2, info = cg(A2, b2, M=AMGPreconditioner(A2, AMGParams(coarse_size=50)), rtol=1e-8)
assert info.iterations < 20, info
x, _ = cg(A, b, M=AMGPreconditioner(A, AMGParams(coarse_size=50)), rtol=1e-8)
assert np.abs(collect(repartition(x2, A.row_prange)) - collect(x)).max() < 1e-6 * np.abs(collect(x)).max()
r = hpcg_benchmark_debug(local_shape=(8, 8, 8), parts_per_dir=(1, 1, 1), n_levels=2,
                         iterations=5, ref_sets=1, timed_sets=1, precond_dtype="float16",
                         device="cpu").summary()
assert r["precond_values_dtype"] == "float16" and r["validation_passed"], r
import tempfile
from partitionedarrays_tpu_torch import BMatrix, BVector, PTimer, b_cg, compat, gather, scatter
from partitionedarrays_tpu_torch.ops.jagged import JaggedArray
from partitionedarrays_tpu_torch.psparse import sparse_diag_matrix
from partitionedarrays_tpu_torch.pvector import pfill
from partitionedarrays_tpu_torch.utils import checkpoint, profiling
A = plaplacian_fdm((6, 6, 6), (2, 2, 2), SerialBackend(8), device="cpu")
C = sparse_diag_matrix(pfill(0.1, A.row_prange, A.backend, np.float64, device="cpu"))
rhs = pfill(1.0, A.row_prange, A.backend, np.float64, device="cpu")
timer = PTimer(device="cpu")
timer.tic("b_cg")
xb, its, rel = b_cg(BMatrix([[A, C], [C, A]]), BVector([rhs, rhs]), rtol=1e-8)
assert timer.toc("b_cg") > 0 and rel < 1e-8 and its > 0
d = tempfile.mkdtemp()
checkpoint.save_psparse(d + "/A.pt", A)
assert (centralize(checkpoint.load_psparse(d + "/A.pt", A.backend, device="cpu")) != centralize(A)).nnz == 0
g = gather(torch.arange(6.0).reshape(3, 2), destination=0)
assert torch.equal(scatter(g), torch.arange(6.0).reshape(3, 2))
assert isinstance(gather([np.arange(2), np.arange(3)])[0], JaggedArray)
assert compat.laplace_matrix((3, 3)).nnz == 33
with profiling.trace(d, device="cpu"):
    with profiling.annotate("region"):
        spmv(A, rhs)
import torch_jacobi_tutorial
assert torch_jacobi_tutorial.main(n=12, niters=20, n_parts=3, device="cpu")["error"] < 1e-10
from partitionedarrays_tpu_torch import (MeshBackend, newton_krylov, nziterator, pvector_from_own,
                                        split_locally, spmv_local, with_mesh)
from partitionedarrays_tpu_torch.pvector import PVector
from partitionedarrays_tpu_torch.solvers.smoothers import GaussSeidel
A = plaplacian_fdm((6, 6), (2, 2), with_mesh(lambda b: b, 4), device="cpu")
b = pvector_from_own([np.ones(li.n_own) for li in A.row_prange.parts], A.row_prange, A.backend,
                     device="cpu")
res = lambda x: PVector(spmv(A, x).own + x.own ** 3 - b.own, x.ghost * 0, x.layout, x.backend)
for jvp in ("auto", "fd"):
    xn, its, rn = newton_krylov(res, b * 0.0, M=GaussSeidel(A, 1, "symmetric"), jvp=jvp,
                                rtol=1e-8)
    assert int(its) > 0 and float(rn) < 1e-6, (jvp, its, rn)
from partitionedarrays_tpu_torch import csr_to_ell, ell_spmv
gs = GaussSeidel(A, 1, "symmetric", _sorted=True)
assert gs.sorted is not None and float(gs(b).own.abs().max()) > 0
c, v = csr_to_ell(A.blocks[0]["oo"], A.row_layout().n_own_pad)
assert ell_spmv(torch.from_numpy(c), torch.from_numpy(v), b.own[0]).shape == (c.shape[0],)
G = centralize(A)
assert len(list(nziterator(G))) == G.nnz and np.allclose(spmv_local(G, np.ones(36)), G @ np.ones(36))
assert split_locally(G, np.arange(30), np.arange(30, 36), np.arange(30), np.arange(30, 36))[1].shape == (30, 6)
loaded = sorted(m for m in sys.modules
                if m in ("jax", "ml_dtypes") or m.startswith(("jax.", "jaxlib", "ml_dtypes.")))
print("JAX_MODULES", loaded)
sys.exit(1 if loaded else 0)
"""


BLOCKED = """
import importlib
import pkgutil
import sys


class NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "partitionedarrays_tpu"):
            raise ImportError(f"{name} is blocked")
        return None


sys.meta_path.insert(0, NoJax())
import partitionedarrays_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
sys.path.insert(0, "examples")
examples = sorted(p.stem for p in __import__("pathlib").Path("examples").glob("torch_*.py"))
for name in examples:
    assert importlib.import_module(name).main.__defaults__[-1] == "cuda", name
print("IMPORTED", len(names), "MODULES", len(examples), "EXAMPLES")
"""


def test_every_module_imports_with_jax_blocked():
    """Every module of the port (the new layers among them: block_arrays,
    compat, utils, ops.jagged, parallel.primitives, backends,
    parallel.host_exchange, ops.ell) and every example of its own import
    with ``jax``, ``ml_dtypes`` and the JAX package blocked."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OPENBLAS_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for name in ("block_arrays", "compat", "utils.ptimer", "utils.profiling", "utils.checkpoint",
                 "ops.jagged", "parallel.primitives", "backends", "parallel.host_exchange",
                 "solvers.nonlinear", "ops.sparse_host", "ops.ell"):
        assert (REPO / "partitionedarrays_tpu_torch" / (name.replace(".", "/") + ".py")).exists()
    assert "MODULES 6 EXAMPLES" in proc.stdout, proc.stdout


def test_port_does_not_load_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO), OPENBLAS_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "JAX_MODULES []" in proc.stdout
