"""The reference's names that this framework redesigned under another shape,
as thin aliases over the port's functions.

Counterpart of ``partitionedarrays_tpu/compat.py`` (:35-259), so that users
coming from PartitionedArrays.jl find the names they know:

- the backend names: ``DebugArray`` and ``with_debug`` are the serial
  backend, as in the reference.  ``MPIArray``, ``with_mpi`` and
  ``distribute_with_mpi`` name the multi-process backend, which the port
  does not have yet: they raise, naming ROADMAP item 15;
- the index types (``OwnIndices``, ``GhostIndices``,
  ``OwnAndGhostIndices``, ``PermutedLocalIndices``): one ``LocalIndices``
  with an optional permutation and owner map;
- the value accessors, ``renumber``, ``psparse_from_split_blocks``, the
  functional ``tic``/``toc``/``statistics`` of ``PTimer``, ``BArray``, the
  split-storage names (the split own/ghost layout is the only one),
  ``old_pvector``/``old_psparse``, ``assembly_graph`` and
  ``laplace_matrix``.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from .backends import SerialBackend
from .block_arrays import BMatrix, BVector
from .parallel.partition import LocalIndices, PRange, renumber_partition
from .psparse import (
    PSparseMatrix,
    psparse,
    psparse_from_blocks,
    renumber_matrix,
    split_format,
)
from .pvector import PVector, pvector, renumber_pvector, split_vector

# -- backend names (src/debug_array.jl:34, src/mpi_array.jl:105) ---------------
DebugArray = SerialBackend


def with_serial(f: Callable, n_parts: int):
    """Run ``f(backend)`` on the serial backend (reference ``with_debug``)."""
    return f(SerialBackend(n_parts))


with_debug = with_serial


def _multi_process(name: str):
    raise NotImplementedError(
        f"{name}: the multi-process backend is ROADMAP item 15; the port runs every part "
        "in one process (SerialBackend, DebugArray)")


class MPIArray:
    """The reference's MPI backend name: the port has no multi-process
    backend yet (ROADMAP item 15)."""

    def __init__(self, *args, **kwargs):
        _multi_process("MPIArray")


def with_mpi(f: Callable, *args, **kwargs):
    """Reference ``with_mpi``: raises, naming ROADMAP item 15."""
    _multi_process("with_mpi")


def distribute_with_mpi(n_parts_or_devices=None):
    """Reference entry point (src/mpi_array.jl:42-53): raises, naming
    ROADMAP item 15."""
    _multi_process("distribute_with_mpi")


# -- index types (src/p_range.jl:877-946, 1231-1469) ----------------------------
AbstractLocalIndices = LocalIndices


class OwnIndices:
    """Reference ``OwnIndices`` (src/p_range.jl:877-896)."""

    def __init__(self, n_global: int, owner: int, indices):
        self.n_global = int(n_global)
        self.owner = int(owner)
        self.indices = np.asarray(indices)


class GhostIndices:
    """Reference ``GhostIndices`` (src/p_range.jl:913-946)."""

    def __init__(self, n_global: int, indices=(), owners=()):
        self.n_global = int(n_global)
        self.indices = np.asarray(indices, dtype=np.int64).reshape(-1)
        self.owners = np.asarray(owners, dtype=np.int64).reshape(-1)


def OwnAndGhostIndices(own: OwnIndices, ghost: GhostIndices, global_to_owner=None,
                       n_parts: Optional[int] = None) -> LocalIndices:
    """Reference ``OwnAndGhostIndices`` (src/p_range.jl:1231-1370): the own
    block, then the ghost block."""
    return LocalIndices(own.n_global, own.owner,
                        n_parts if n_parts is not None else own.owner + 1,
                        own.indices, ghost.indices, ghost.owners,
                        global_to_owner=global_to_owner)


def PermutedLocalIndices(li: LocalIndices, perm) -> LocalIndices:
    """Reference ``PermutedLocalIndices`` (src/p_range.jl:1372-1469)."""
    return LocalIndices(li.n_global, li.part, li.n_parts, li.own_to_global,
                        li.ghost_to_global, li.ghost_to_owner, perm=np.asarray(perm),
                        global_to_owner=li.global_to_owner)


def global_to_owner(li: LocalIndices, queries):
    """Reference ``global_to_owner`` (src/p_range.jl:151-160)."""
    if li.global_to_owner is None:
        raise ValueError("global_to_owner: these local indices carry no owner map")
    return li.global_to_owner(np.asarray(queries))


# -- value accessors (src/p_vector.jl:361-391) ------------------------------------
def local_values(x: PVector):
    """Each part's own and ghost values in its local order (host arrays)."""
    return x.local_values()


def own_values(x: PVector):
    return x.own


def ghost_values(x: PVector):
    return x.ghost


def own_own_values(A: PSparseMatrix):
    return A.own_own_values()


def own_ghost_values(A: PSparseMatrix):
    return A.own_ghost_values()


def ghost_own_values(A: PSparseMatrix):
    return A.ghost_own_values()


def ghost_ghost_values(A: PSparseMatrix):
    return A.ghost_ghost_values()


# -- renumber (src/p_range.jl:782, p_vector.jl:1509, p_sparse_matrix.jl:2595) ---
def renumber(x, *args, **kwargs):
    """``renumber_pvector``, ``renumber_matrix`` or ``renumber_partition`` by
    the argument's type."""
    if isinstance(x, PVector):
        return renumber_pvector(x, *args, **kwargs)
    if isinstance(x, PSparseMatrix):
        return renumber_matrix(x, *args, **kwargs)
    if isinstance(x, PRange):
        return PRange(renumber_partition(x.partition()))
    return renumber_partition(x, *args, **kwargs)


# the split-blocks constructor (src/p_sparse_matrix.jl:1307)
psparse_from_split_blocks = psparse_from_blocks


# -- PTimer's functional forms (src/p_timer.jl:98-121, 73-84) ------------------------
def tic(t, name: str) -> None:
    t.tic(name)


def toc(t, name: str) -> float:
    return t.toc(name)


def statistics(t):
    return t.statistics()


# -- block arrays (src/block_arrays.jl:54) ------------------------------------------
def BArray(blocks):
    """Reference ``BArray``: a BMatrix for a nested list of blocks, else a
    BVector."""
    blocks = list(blocks)
    if blocks and isinstance(blocks[0], (list, tuple)):
        return BMatrix(blocks)
    return BVector(blocks)


# -- split-storage type names (src/p_vector.jl:46-265, p_sparse_matrix.jl:582) ----
def SplitVector(x: PVector) -> PVector:
    """Reference ``SplitVector``: the split own/ghost layout is the only one,
    so the vector itself."""
    return split_vector(x)


def OwnAndGhostVectors(x: PVector) -> PVector:
    """Reference ``OwnAndGhostVectors``, deprecated there for SplitVector."""
    return SplitVector(x)


def SplitMatrix(A: PSparseMatrix) -> PSparseMatrix:
    """Reference ``SplitMatrix``: the four-block split form."""
    return split_format(A)


def old_pvector(*args, **kwargs):
    """The reference's pre-0.4 constructor name (src/PartitionedArrays.jl:127)."""
    return pvector(*args, **kwargs)


def old_psparse(*args, **kwargs):
    """The reference's pre-0.4 constructor name (src/PartitionedArrays.jl:157)."""
    return psparse(*args, **kwargs)


def assembly_graph(pr_or_partition):
    """Reference ``assembly_graph`` (src/p_range.jl:403-450), memoized on
    the PRange."""
    if isinstance(pr_or_partition, PRange):
        return pr_or_partition.assembly_graph()
    return PRange(list(pr_or_partition)).assembly_graph()


def laplace_matrix(nodes_per_dir, parts_per_dir=None, backend=None, dtype=np.float64,
                   device="cuda"):
    """Reference ``laplace_matrix`` (src/p_sparse_matrix.jl:2628-2707,
    deprecated there for the gallery's ``laplacian_fdm``): the unscaled
    (2D+1)-point Laplacian, diagonal 2D and off-diagonals -1, zero
    Dirichlet outside the box, nodes in C order.  Without ``parts_per_dir``
    a scipy CSR; with it an assembled PSparseMatrix on ``device``."""
    from .models.gallery import laplacian_fdm
    from .ops.sparse_host import compresscoo

    nodes = tuple(int(n) for n in nodes_per_dir)
    alpha = np.prod([n + 1 for n in nodes]).astype(dtype)
    if parts_per_dir is None:
        I, J, V, _, _ = laplacian_fdm(nodes, (1,) * len(nodes), dtype=dtype)
        n = int(np.prod(nodes))
        return compresscoo(np.concatenate(I), np.concatenate(J), np.concatenate(V) / alpha, n, n)
    if backend is None:
        raise ValueError("laplace_matrix: the distributed form needs a backend")
    I, J, V, rows, cols = laplacian_fdm(nodes, parts_per_dir, dtype=dtype)
    return psparse(I, J, [v / alpha for v in V], PRange(rows), PRange(cols), backend,
                   assembled=True, device=device)
