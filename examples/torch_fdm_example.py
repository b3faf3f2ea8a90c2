"""FDM Poisson example on the PyTorch port (``examples/fdm_example.py``'s
problem, the reference's test/fdm_example.jl).

Build the 3-D 7-point finite-difference Laplacian from the gallery over a
(2,2,1) box partition, manufacture b = A @ x_exact, solve with CG, and
check ``norm(x - x_exact) < 1e-5``, the reference's own acceptance
threshold (test/fdm_example.jl:124-128).

    python examples/torch_fdm_example.py [--device cpu]
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
from partitionedarrays_tpu_torch.solvers.krylov import _as_col_vector, cg


def main(nodes=(10, 10, 10), parts=(2, 2, 1), device="cuda") -> dict:
    backend = SerialBackend(int(np.prod(parts)))
    I, J, V, rows, cols = laplacian_fdm(nodes, parts, dtype=np.float32)
    A = psparse(I, J, V, rows, cols, backend, assembled=True, device=device)

    rng = np.random.default_rng(0)
    x_dense = rng.standard_normal(A.shape[0]).astype(np.float32)
    x_exact = pvector_from_own([x_dense[li.own_to_global] for li in A.row_prange.partition()],
                               A.row_prange, backend, device=device)
    b = spmv(A, _as_col_vector(A, x_exact))

    x, info = cg(A, b, rtol=1e-10, maxiter=2000)
    err = float(np.linalg.norm(collect(x) - x_dense))
    print(f"fdm: n={np.prod(nodes)} parts={np.prod(parts)} "
          f"iters={int(info.iterations)}  |x-x*|={err:.2e}")
    assert err < 1e-5, err
    return {"iterations": int(info.iterations), "error": err}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(device=parser.parse_args().device)
