"""Smoothed-aggregation AMG example on the PyTorch port
(``examples/amg_example.py``'s problem; the reference's PartitionedSolvers
amg usage, amg.jl and amg_tests.jl).

Build a 3-D FDM Laplacian, set up the default smoothed-aggregation AMG
hierarchy, and use one V-cycle per iteration as the CG preconditioner.

    python examples/torch_amg_example.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from partitionedarrays_tpu_torch.backends import SerialBackend
from partitionedarrays_tpu_torch.models.gallery import laplacian_fdm
from partitionedarrays_tpu_torch.psparse import psparse, spmv
from partitionedarrays_tpu_torch.pvector import collect, pvector_from_own
from partitionedarrays_tpu_torch.solvers.amg import amg
from partitionedarrays_tpu_torch.solvers.krylov import _as_col_vector, cg


def main(nodes=(16, 16, 16), parts=(2, 2, 1), device="cuda") -> dict:
    backend = SerialBackend(int(np.prod(parts)))
    I, J, V, rows, cols = laplacian_fdm(nodes, parts, dtype=np.float64)
    A = psparse(I, J, V, rows, cols, backend, assembled=True, device=device)

    rng = np.random.default_rng(2)
    x_dense = rng.standard_normal(A.shape[0])
    x_exact = pvector_from_own([x_dense[li.own_to_global] for li in A.row_prange.partition()],
                               A.row_prange, backend, device=device)
    b = spmv(A, _as_col_vector(A, x_exact))

    M = amg(A)
    stats = M.statistics()
    print("amg hierarchy:", stats)

    x, info = cg(A, b, M=M, rtol=1e-12, maxiter=200)
    err = float(np.linalg.norm(collect(x) - x_dense))
    print(f"amg-cg: n={A.shape[0]} iters={int(info.iterations)}  |x-x*|={err:.2e}")
    assert err < 1e-5, err
    assert int(info.iterations) < 60
    return {"iterations": int(info.iterations), "error": err, "statistics": stats}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(device=parser.parse_args().device)
