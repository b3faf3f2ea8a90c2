"""Per-process construction and setup algebra on the PyTorch port
(``examples/per_process_example.py``'s problem and flow).

Each process builds only its own parts' triplets (``laplacian_fem(...,
parts=)``) and the matrix with ``psparse_local``: the triplets owned by
another part move to their owners, and only the off-owner surface crosses
processes.  The setup algebra (``spmm``, ``repartition_system``, the
smoothed-aggregation AMG setup) then runs on the per-process blocks, and an
AMG-preconditioned CG solves the system, checked against scipy.

Here one process holds every part (``SerialBackend``); under
``with_multihost`` each process passes ``backend.local_parts()`` and the
same code runs unchanged.

    python examples/torch_per_process_example.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from partitionedarrays_tpu_torch.backends import SerialBackend
from partitionedarrays_tpu_torch.models.gallery import laplacian_fem
from partitionedarrays_tpu_torch.parallel.partition import PRange, variable_partition
from partitionedarrays_tpu_torch.psparse import (host_blocks, psparse_local, repartition_system,
                                                 spmm, spmv)
from partitionedarrays_tpu_torch.pvector import collect, pones, pvector_local
from partitionedarrays_tpu_torch.solvers.amg import AMGParams, AMGPreconditioner
from partitionedarrays_tpu_torch.solvers.krylov import cg


def main(nodes=(33, 33), parts=(4, 1), device="cuda") -> dict:
    P = int(np.prod(parts))
    backend = SerialBackend(P)
    local = list(backend.local_parts())  # every part in one process

    # only the local parts' triplets are made (O(local) host memory)
    I, J, V, rows, cols = laplacian_fem(nodes, parts, dtype=np.float64, parts=local)
    A = psparse_local(I, J, V, PRange(rows), PRange(cols), backend, device=device)
    b = pvector_local(I, V, PRange(rows), backend, dtype=np.float64, device=device)
    # b_i = sum_j a_ij = (A 1)_i
    ones = pones(A.col_prange, backend, dtype=np.float64, device=device)
    assert np.abs(collect(spmv(A, ones)) - collect(b)).max() < 1e-9

    # the setup algebra on per-process blocks
    A2 = spmm(A, A)
    sizes = [A.shape[0] // P] * P
    sizes[0] += A.shape[0] - sum(sizes)
    A3, _ = repartition_system(A, b, PRange(variable_partition(sizes, A.shape[0])))

    M = AMGPreconditioner(A, AMGParams(coarse_size=30, max_levels=3, epsilon=0.02))
    x, info = cg(A, b, M=M, rtol=1e-10, maxiter=100)

    # the serial scipy solve of the assembled operator
    If, Jf, Vf, _, _ = laplacian_fem(nodes, (1, 1), dtype=np.float64)
    n = int(np.prod(nodes))
    G = sp.csr_matrix((Vf[0], (If[0], Jf[0])), shape=(n, n))
    x_star = spla.spsolve(G.tocsc(), G @ np.ones(n))
    err = float(np.abs(collect(x) - x_star).max())
    spmm_nnz = int(sum(bk["oo"].nnz for bk in host_blocks(A2)))
    rows0 = A3.row_prange.parts[0].n_own
    print(f"per-process: n={n} parts={P} amg-cg iters={int(info.iterations)}"
          f"  |x-x*|={err:.2e}  (spmm nnz={spmm_nnz}, repartitioned rows part0={rows0})")
    assert err < 1e-6, err
    return {"iterations": int(info.iterations), "error": err, "spmm_nnz": spmm_nnz,
            "rows0": rows0}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(device=parser.parse_args().device)
