"""Fixed-sparsity reuse on the PyTorch port (``examples/reuse_example.py``):
an implicit time-stepping loop that re-assembles its operator every step
without redoing any setup.

The reference's in-place forms: the ``psystem!`` refill
(src/p_sparse_matrix.jl:2475-2539), ``sparse_matrix!`` and the
``amg_update!`` re-coarsening (PartitionedSolvers/src/amg.jl:925-942).
Each step of (I + dt(t) K) x = x_prev

1. refills the system matrix and right side at frozen sparsity
   (``psystem_refill``: a value scatter, no owner or ghost discovery),
2. re-coarsens the AMG hierarchy through its frozen Galerkin plans
   (``M.update``: no aggregation, no symbolic products),
3. solves with CG.

    python examples/torch_reuse_example.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from partitionedarrays_tpu_torch.backends import SerialBackend
from partitionedarrays_tpu_torch.models.gallery import laplacian_fdm
from partitionedarrays_tpu_torch.parallel.partition import PRange
from partitionedarrays_tpu_torch.psparse import psystem, psystem_refill, spmv
from partitionedarrays_tpu_torch.pvector import collect
from partitionedarrays_tpu_torch.solvers.amg import AMGParams, amg
from partitionedarrays_tpu_torch.solvers.krylov import cg


def main(n=(32, 32), parts=(2, 2), steps=3, device="cuda") -> dict:
    backend = SerialBackend(int(np.prod(parts)))
    # heat-equation-like system: I + dt K, K the FDM Laplacian
    I, J, V, rows, cols = laplacian_fdm(n, parts)
    rowsR, colsR = PRange(rows), PRange(cols)
    # right side: one entry per own row (the "load vector")
    Ib = [li.own_to_global for li in rowsR.partition()]
    rng = np.random.default_rng(0)
    x_prev = [rng.standard_normal(i.size) for i in Ib]

    def system_values(dt):
        return [dt * np.asarray(Vi) + (np.asarray(Ii) == np.asarray(Ji)).astype(np.float64)
                for Ii, Ji, Vi in zip(I, J, V)]

    dt0 = 1e-2
    A, b, cache = psystem(I, J, system_values(dt0), Ib, x_prev, rowsR, colsR, backend,
                          reuse=True, device=device)
    M = amg(A, AMGParams(coarse_size=20))
    iterations, relres = [], []
    for step in range(1, steps + 1):
        dt = dt0 / step  # an adaptive step: new values, the same sparsity
        b = psystem_refill(A, system_values(dt), x_prev, cache)  # values only
        M.update(A)  # re-coarsened through the frozen plans
        x, info = cg(A, b, M=M, rtol=1e-10, maxiter=100)
        bg = collect(b)
        rel = float(np.linalg.norm(collect(spmv(A, x)) - bg) / np.linalg.norm(bg))
        print(f"step {step}: dt={dt:.3e} iters={int(info.iterations)} relres={rel:.2e}")
        assert rel < 1e-8
        iterations.append(int(info.iterations))
        relres.append(rel)
        x_prev = [np.asarray(v) for v in x.own_values()]
    print(f"reuse example: OK ({steps} implicit steps, zero re-setup)")
    return {"iterations": iterations, "relres": relres}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(device=parser.parse_args().device)
