"""partitionedarrays_tpu_torch: the PyTorch and CUDA port of
partitionedarrays_tpu, for one NVIDIA H100.

The JAX package ``partitionedarrays_tpu`` is the reference; this package
mirrors its layout module by module and imports torch, never jax.  Tensors
carry the part axis first (``[P, ...]``), every constructor takes a
``device`` that defaults to the card (``"cuda"``, no fallback), and the
TPU kernels on the ported path are CUDA kernels written for Hopper
(``csrc/``), built with ``nvcc`` on first use.  A CPU tensor runs each
kernel's plain PyTorch version instead.

So far the port covers the HPCG benchmark on one part and on many parts
stacked on one device (ghost exchange, own-ghost block) in float32,
float64 and df64, the Krylov solvers of ``solvers/krylov.py``, the COO
assembly of ``models/gallery.py``'s problems and smoothed-aggregation AMG
(``solvers/amg.py``) on one part and on many parts of the serial backend,
the fixed-sparsity reuse tier (``psparse_refill``, ``psystem_refill``,
the ``_into`` products, ``AMGPreconditioner.update``) and the Newton and
backward-Euler layers (``solvers/nonlinear.py``, ``solvers/ode.py``), and
additive Schwarz (``AdditiveSchwarz``: dense LU or ILU(0) local solves, the
latter as exact triangular solves on the tile kernel; also as AMG level
smoothers) with the native host setup library (``ops/native.py``), and the
partition, vector and matrix utilities (the partition constructors and
index maps, ``repartition``, ``repartition_system``, the closed-form
``plaplacian_fdm`` on any part grid); see ROADMAP.md.
"""
from . import config
from .backends import SerialBackend
from .models.gallery import (
    laplacian_fdm,
    laplacian_fem,
    linear_elasticity_fem,
    node_coordinates_unit_cube,
    node_to_dof_partition,
    nullspace_linear_elasticity,
    plaplacian_fdm,
)
from .models.hpcg import HPCGMGPreconditioner, build_hpcg_problem, hpcg_benchmark
from .parallel.exchange_plan import ExchangePlan, VectorLayout
from .parallel.partition import (
    AssemblyGraph,
    LocalIndices,
    PRange,
    assembly_local_indices,
    assembly_neighbors,
    block_owner_1d,
    find_owner,
    ghost_length,
    ghost_to_global,
    ghost_to_local,
    ghost_to_owner,
    global_length,
    global_to_ghost,
    global_to_local,
    global_to_own,
    local_length,
    local_permutation,
    local_range,
    local_to_ghost,
    local_to_global,
    local_to_own,
    local_to_owner,
    map_ghost_to_global,
    map_global_to_ghost,
    map_global_to_local,
    map_global_to_own,
    map_local_to_global,
    map_own_to_global,
    matching_ghost_indices,
    matching_local_indices,
    matching_own_indices,
    own_and_ghost_indices,
    own_length,
    own_to_global,
    own_to_local,
    own_to_owner,
    part_id,
    partition,
    partition_from_color,
    permute_indices,
    remove_ghost,
    renumber_partition,
    replace_ghost,
    to_global,
    to_local,
    trivial_partition,
    uniform_partition,
    union_ghost,
    variable_partition,
)
from .psparse import (
    DeviceSpMat,
    PSparseMatrix,
    as_prange,
    assemble_matrix,
    assemble_matrix_into,
    centralize,
    consistent_matrix,
    consistent_matrix_into,
    dense_diag,
    identity_minus,
    psparse_from_blocks,
    psparse_from_global,
    psparse_refill,
    psystem,
    psystem_refill,
    rap,
    rap_into,
    renumber_matrix,
    repartition_matrix,
    repartition_system,
    replicate_psparse,
    sparse_diag_matrix,
    split_format,
    split_matrix,
    split_matrix_blocks,
    spmm,
    spmm_into,
    spmtm,
    spmtm_into,
    spmtv,
    spmv,
    to_global_scipy,
    transpose_psparse,
)
from .pvector import (
    PVector,
    Task,
    assemble,
    axpy,
    axpy_df64,
    collect,
    collect_df64,
    consistent,
    find_local_indices,
    pall,
    pany,
    pchebyshev,
    pcityblock,
    pdistance,
    pdot,
    pdot_df64,
    peuclidean,
    pfill,
    pmaximum,
    pminimum,
    pnorm,
    pnorm_df64,
    pones,
    prand,
    prandn,
    psqeuclidean,
    psum_reduce,
    pvector_df64,
    pvector_from_local,
    pvector_from_own,
    pvector_from_split_blocks,
    pvector_layout,
    pvector_local,
    pvector_refill,
    pvector_split_df64,
    pzeros,
    renumber_pvector,
    repartition,
    split_vector,
    split_vector_blocks,
)
from .solvers.amg import AMGParams, AMGPreconditioner
from .solvers.interfaces import additive_schwarz_solver
from .solvers.nonlinear import newton_raphson
from .solvers.ode import backward_euler
from .solvers.smoothers import AdditiveSchwarz, additive_schwarz

# the COO constructors ``psparse.psparse`` and ``pvector.pvector`` are not
# exported here: their names are those of their modules
__all__ = ["config"] + sorted(
    name for name, value in globals().items()
    if not name.startswith("_") and not isinstance(value, type(config))
)
