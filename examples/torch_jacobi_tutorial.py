"""The Jacobi tutorial on the PyTorch port (``examples/jacobi_tutorial.py``,
the reference's docs/jacobi_tutorial.jl).

1-D Laplace boundary-value problem with u(0) = -1, u(n+1) = 1, solved by
Jacobi sweeps u_i <- (u_{i-1} + u_{i+1}) / 2 over a ghosted block
partition.  Any number of parts gives the sequential version's result
exactly.

    python examples/torch_jacobi_tutorial.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from partitionedarrays_tpu_torch.backends import SerialBackend
from partitionedarrays_tpu_torch.parallel.partition import PRange, uniform_partition
from partitionedarrays_tpu_torch.psparse import psparse, spmv
from partitionedarrays_tpu_torch.pvector import PVector, collect, pvector_from_own, pzeros
from partitionedarrays_tpu_torch.solvers.krylov import _as_col_vector


def jacobi_sequential(n, niters):
    """The double-buffered Jacobi iteration on the host."""
    u = np.zeros(n + 2)
    u[0], u[-1] = -1.0, 1.0
    un = u.copy()
    for _ in range(niters):
        un[1:-1] = 0.5 * (u[:-2] + u[2:])
        u, un = un, u.copy()
    return u[1:-1]


def main(n=50, niters=200, n_parts=4, device="cuda") -> dict:
    backend = SerialBackend(n_parts)
    pr = PRange(uniform_partition(n_parts, n, ghost=1))

    # the averaging operator and the boundary's contribution
    Is, Js, Vs, cs = [], [], [], []
    for li in pr.partition():
        I, J, V = [], [], []
        c = np.zeros(li.n_own)
        for k, g in enumerate(li.own_to_global):
            for nb in (g - 1, g + 1):
                if 0 <= nb < n:
                    I.append(g), J.append(nb), V.append(0.5)
            if g == 0:
                c[k] -= 0.5
            if g == n - 1:
                c[k] += 0.5
        Is.append(np.array(I)), Js.append(np.array(J)), Vs.append(np.array(V))
        cs.append(c)
    A = psparse(Is, Js, Vs, pr, pr, backend, assembled=True, device=device)
    cvec = pvector_from_own(cs, A.row_prange, backend, dtype=np.float64, device=device)
    u = pzeros(A.row_prange, backend, dtype=np.float64, device=device)

    for _ in range(niters):
        Au = spmv(A, _as_col_vector(A, u))  # with the ghost exchange
        u = PVector(Au.own + cvec.own, u.ghost, u.layout, u.backend)

    err = float(np.abs(collect(u) - jacobi_sequential(n, niters)).max())
    print(f"jacobi: n={n} parts={n_parts} iters={niters}  max|err|={err:.2e}")
    assert err < 1e-10
    return {"iterations": niters, "error": err}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(device=parser.parse_args().device)
