"""FEM Poisson example on the PyTorch port (``examples/fem_example.py``'s
problem, the reference's test/fem_example.jl).

Assemble the Q1 FEM Laplacian on the unit cube: each part loops over its
owned cells and contributes entries to rows owned by neighbouring parts,
the disassembled input state that exercises the off-owner assembly (the
reversed exchange graph).  Solve with Jacobi-preconditioned CG and check
against a manufactured solution.

    python examples/torch_fem_example.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from partitionedarrays_tpu_torch.backends import SerialBackend
from partitionedarrays_tpu_torch.models.gallery import laplacian_fem
from partitionedarrays_tpu_torch.psparse import psparse, spmv
from partitionedarrays_tpu_torch.pvector import collect, pvector_from_own
from partitionedarrays_tpu_torch.solvers.krylov import _as_col_vector, cg
from partitionedarrays_tpu_torch.solvers.smoothers import JacobiCorrection


def main(nodes=(8, 8, 8), parts=(2, 2, 1), device="cuda") -> dict:
    backend = SerialBackend(int(np.prod(parts)))
    I, J, V, rows, cols = laplacian_fem(nodes, parts, dtype=np.float64)
    # disassembled triplets: owners found, ghosts united, exchanged, merged
    A = psparse(I, J, V, rows, cols, backend, device=device)

    rng = np.random.default_rng(1)
    x_dense = rng.standard_normal(A.shape[0])
    x_exact = pvector_from_own([x_dense[li.own_to_global] for li in A.row_prange.partition()],
                               A.row_prange, backend, device=device)
    b = spmv(A, _as_col_vector(A, x_exact))

    x, info = cg(A, b, M=JacobiCorrection(A), rtol=1e-12, maxiter=2000)
    err = float(np.linalg.norm(collect(x) - x_dense))
    print(f"fem: n={A.shape[0]} parts={np.prod(parts)} "
          f"iters={int(info.iterations)}  |x-x*|={err:.2e}")
    assert err < 1e-5, err
    return {"iterations": int(info.iterations), "error": err}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(device=parser.parse_args().device)
