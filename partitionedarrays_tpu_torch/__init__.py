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
``plaplacian_fdm`` on any part grid), float16 preconditioner values, and
the remaining layers: block arrays with ``b_cg`` (``block_arrays.py``),
the timer, profiling and checkpoint utilities (``utils/``), the host
primitives and jagged arrays, and the reference's names (``compat.py``),
the matrix-free Newton (``newton_krylov``, forward derivatives of K1 and
K5), and the multi-process tier: ``MeshBackend`` over ``torch.distributed``
(``with_multihost``), each process holding its own parts, with per-process
construction (``psparse_local``, ``pvector_local``), AMG setup and
``hpcg_benchmark_mpi``, and the sorted-by-color Gauss-Seidel tier with
``ops/ell.py``.  Every public name of the JAX package is here but its two
TPU settings (``pallas_enabled``, ``enable_compilation_cache``); see
ROADMAP.md.
"""
from . import config
from .backends import (
    AXIS,
    Backend,
    MeshBackend,
    SerialBackend,
    mesh_backend,
    serial_backend,
    stack_parts,
    with_mesh,
    with_multihost,
    with_serial,
)
from .block_arrays import (
    BMatrix,
    BRange,
    BVector,
    b_all,
    b_any,
    b_assemble,
    b_axpy,
    b_cg,
    b_collect,
    b_consistent,
    b_dot,
    b_euclidean,
    b_maximum,
    b_minimum,
    b_mul,
    b_norm,
    b_sum,
)
from .compat import (
    AbstractLocalIndices,
    BArray,
    DebugArray,
    GhostIndices,
    MPIArray,
    OwnAndGhostIndices,
    OwnAndGhostVectors,
    OwnIndices,
    PermutedLocalIndices,
    SplitMatrix,
    SplitVector,
    assembly_graph,
    distribute_with_mpi,
    ghost_ghost_values,
    ghost_own_values,
    ghost_values,
    global_to_owner,
    laplace_matrix,
    local_values,
    old_psparse,
    old_pvector,
    own_ghost_values,
    own_own_values,
    own_values,
    psparse_from_split_blocks,
    renumber,
    statistics,
    tic,
    toc,
    with_debug,
    with_mpi,
)
from .models.gallery import (
    laplacian_fdm,
    laplacian_fem,
    linear_elasticity_fem,
    near_nullspace_linear_elasticity,
    node_coordinates_unit_cube,
    node_to_dof_partition,
    nullspace_linear_elasticity,
    plaplacian_fdm,
)
from .models.hpcg import (
    HPCGMGPreconditioner,
    HPCGReport,
    build_hpcg_problem,
    build_matrix,
    build_p_matrix,
    compute_optimal_shape_xyz,
    hpcg_benchmark,
    hpcg_benchmark_debug,
    hpcg_benchmark_mesh,
    hpcg_benchmark_mpi,
    hpcg_cg,
    opt_cg,
    pc_setup,
    pc_solve,
    ref_cg,
)
from .ops.dia import csr_diagonals, dia_spmv
from .ops.ell import csr_to_ell, ell_spmv
from .ops.jagged import (
    GenericJaggedArray,
    JaggedArray,
    jagged_array,
    length_to_ptrs,
    ptrs_to_lengths,
    rewind_ptrs,
)
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
from .parallel.primitives import (
    MAIN,
    ExchangeGraph,
    FakeTask,
    allocate_emit,
    allocate_exchange,
    allocate_gather,
    allocate_multicast,
    allocate_scatter,
    array_of_tuples,
    cartesian_indices,
    emit,
    exchange,
    fake_async,
    find_rcv_ids,
    find_rcv_ids_gather_scatter,
    find_rcv_ids_ibarrier,
    gather,
    getany,
    i_am_main,
    is_consistent,
    linear_indices,
    map_main,
    map_parts,
    multicast,
    reduction,
    scan,
    scatter,
    tuple_of_arrays,
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
    psparse_local,
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
from .ops.sparse_host import (
    compresscoo,
    indextype,
    nzindex,
    nziterator,
    precompute_nzindex,
    sparse_matrix,
    sparse_matrix_refill,
    split_locally,
    sub_sparse_matrix,
)
from .ops.stencil import stencil_psparse, stencil_rhs_counts
from .ops.sparse_host import spmtv as spmtv_local
from .ops.sparse_host import spmv as spmv_local
from .solvers.amg import (
    AMGLevel,
    AMGParams,
    AMGPreconditioner,
    aggregate,
    amg,
    constant_prolongator,
    default_nullspace,
    smoothed_prolongator,
    spectral_radius,
    tentative_prolongator,
)
from .solvers.interfaces import (
    LinearProblem,
    NonlinearProblem,
    ODEProblem,
    additive_schwarz_solver,
    amg_solver,
    cg_solver,
    gauss_seidel_solver,
    history,
    jacobi_solver,
    lu_solver,
    preconditioner,
    richardson_solver,
    smooth,
    solve,
)
from .solvers.krylov import CGInfo, cg, cg_df64, pipelined_cg, richardson_iteration
from .solvers.nonlinear import NewtonInfo, newton_krylov, newton_raphson
from .solvers.ode import backward_euler, single_stage_solver
from .solvers.smoothers import (
    AdditiveSchwarz,
    GaussSeidel,
    JacobiCorrection,
    additive_schwarz,
    gauss_seidel,
    greedy_coloring,
    identity_solver,
    jacobi,
)
from .utils.ptimer import PTimer, barrier, current_time

# the COO constructors ``psparse.psparse`` and ``pvector.pvector`` are not
# exported here: their names are those of their modules
__all__ = ["config"] + sorted(
    name for name, value in globals().items()
    if not name.startswith("_") and not isinstance(value, type(config))
)
