"""HPCG on the PyTorch port: 27-point problem, geometric MG, CG, the
three-phase driver and the rating report.

The reference-name aliases of ``partitionedarrays_tpu/models/hpcg/
__init__.py:15-84`` map the Julia driver's names onto this package:
``hpcg_benchmark_debug`` (the serial backend), ``pc_setup``/``pc_solve``
(the geometric MG), ``ref_cg``/``opt_cg`` (the preconditioned CG) and
``build_matrix``/``build_p_matrix`` (the 27-point problem).  Each builds
its tensors on ``device``, the card unless the caller asks for the CPU.
``hpcg_benchmark_mesh`` and its alias ``hpcg_benchmark_mpi`` run the
benchmark on a ``MeshBackend``: each process of the ``torch.distributed``
group (``backends.with_multihost``) holds its block of parts, on its card.
"""
import numpy as np

from ...backends import MeshBackend, SerialBackend
from ...ops.sparse_host import compresscoo
from .cg import hpcg_cg, hpcg_cg_flat
from .driver import hpcg_benchmark
from .mg import HPCGMGPreconditioner, restrict_operator
from .opt3d import compute_optimal_shape_xyz
from .problem import STENCIL_27PT, build_hpcg_problem, hpcg_triplets_for_box
from .report import HPCGReport


def hpcg_benchmark_debug(n_parts: int = 1, **kw) -> HPCGReport:
    """The benchmark on the serial backend of ``n_parts`` parts (reference
    ``hpcg_benchmark_debug``); ``kw`` go to ``hpcg_benchmark``, ``device``
    among them."""
    return hpcg_benchmark(SerialBackend(n_parts), **kw)


def hpcg_benchmark_mesh(n_parts=None, **kw) -> HPCGReport:
    """The benchmark on a mesh backend of ``n_parts`` parts (default: one
    per process) over the current process group (reference
    ``hpcg_benchmark_mesh``, the Julia ``hpcg_benchmark_mpi``); every
    process of the group calls it.  ``kw`` go to ``hpcg_benchmark``."""
    return hpcg_benchmark(MeshBackend(n_parts), **kw)


hpcg_benchmark_mpi = hpcg_benchmark_mesh


def build_p_matrix(parts_per_dir, local_shape, backend, dtype=None, device="cuda"):
    """The partitioned 27-point matrix and rhs (reference
    ``build_p_matrix``), float64 by default."""
    return build_hpcg_problem(
        local_shape, parts_per_dir, backend,
        dtype=dtype if dtype is not None else np.float64, device=device,
    )


def build_matrix(gshape, dtype=None):
    """The sequential 27-point operator as a scipy CSR matrix and its rhs
    (reference ``build_matrix``), float64 by default: host arrays, so no
    device."""
    dt = dtype if dtype is not None else np.float64
    n = int(np.prod(gshape))
    I, J, V, b = hpcg_triplets_for_box(np.arange(n), tuple(gshape), dt)
    return compresscoo(I, J, V, n, n), b


def pc_setup(local_shape, parts_per_dir, backend, n_levels: int = 4, dtype=None,
             device="cuda") -> HPCGMGPreconditioner:
    """The geometric MG preconditioner (reference ``pc_setup``), float64
    by default."""
    return HPCGMGPreconditioner(
        local_shape, parts_per_dir, backend, n_levels=n_levels,
        dtype=dtype if dtype is not None else np.float64, device=device,
    )


def pc_solve(mg: HPCGMGPreconditioner, r):
    """One V-cycle on the residual ``r`` (reference ``pc_solve!``)."""
    return mg(r)


# the reference splits the CG driver into a reference and an optimizable
# variant; both are the preconditioned CG here, as there
ref_cg = hpcg_cg
opt_cg = hpcg_cg
