"""The gallery of the PyTorch port against the JAX reference: the triplets of
linear elasticity (2-D and 3-D), of the FEM and FDM Laplacians, the node
coordinates and the rigid-body nullspace, and the partitions that come with
them (node partitions, dof partitions, ``variable_partition``).  Both
packages build them with numpy on the host; everything must be equal bit
for bit.
"""
import numpy as np
import pytest

from partitionedarrays_tpu.models import gallery as jax_gallery
from partitionedarrays_tpu.parallel import p_range as jax_p_range

from partitionedarrays_tpu_torch.models import gallery
from partitionedarrays_tpu_torch.parallel import partition

CASES = [
    ("linear_elasticity_fem", (6, 6), (1, 1), np.float64),
    ("linear_elasticity_fem", (5, 4, 6), (1, 1, 1), np.float64),
    ("linear_elasticity_fem", (6, 6, 6), (1, 1, 1), np.float32),
    ("linear_elasticity_fem", (6, 5, 4), (2, 1, 2), np.float64),
    ("laplacian_fem", (7, 6), (1, 1), np.float64),
    ("laplacian_fem", (5, 6, 4), (2, 2, 1), np.float32),
    ("laplacian_fdm", (6, 7, 5), (1, 1, 1), np.float64),
    ("laplacian_fdm", (9, 8), (2, 2), np.float32),
]


def _same_array(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


def _same_part(li, ref):
    assert (li.part, li.n_parts, li.n_global) == (ref.part, ref.n_parts, ref.n_global)
    _same_array(li.own_to_global, ref.own_to_global)
    _same_array(li.ghost_to_global, ref.ghost_to_global)
    _same_array(li.ghost_to_owner, ref.ghost_to_owner)
    q = np.arange(-1, ref.n_global + 1)
    if ref.global_to_owner is not None:
        _same_array(li.global_to_owner(q), ref.global_to_owner(q))
    _same_array(li.global_to_own(q), ref.global_to_own(q))
    _same_array(li.global_to_ghost(q), ref.global_to_ghost(q))


@pytest.mark.parametrize("name,nodes,parts,dtype", CASES, ids=lambda v: str(v))
def test_triplets_and_partitions_are_bit_equal(name, nodes, parts, dtype):
    got = getattr(gallery, name)(nodes, parts, dtype=dtype)
    want = getattr(jax_gallery, name)(nodes, parts, dtype=dtype)
    for k in range(3):  # I, J, V per part
        assert len(got[k]) == len(want[k])
        for a, b in zip(got[k], want[k]):
            _same_array(a, b)
    for k in (3, 4):  # row and column partitions
        for li, ref in zip(got[k], want[k]):
            _same_part(li, ref)


@pytest.mark.parametrize("nodes,parts", [((6, 6), (1, 1)), ((4, 5, 3), (1, 1, 1)), ((4, 4, 4), (2, 1, 2))])
def test_coordinates_and_nullspace_are_bit_equal(nodes, parts):
    coords, node_part = gallery.node_coordinates_unit_cube(nodes, parts)
    coords_ref, node_part_ref = jax_gallery.node_coordinates_unit_cube(nodes, parts)
    for a, b in zip(coords, coords_ref):
        _same_array(a, b)
    for li, ref in zip(node_part, node_part_ref):
        _same_part(li, ref)
    ns = gallery.nullspace_linear_elasticity(coords)
    ns_ref = jax_gallery.nullspace_linear_elasticity(coords_ref, None)
    assert len(ns) == len(ns_ref)
    for modes, modes_ref in zip(ns, ns_ref):
        assert len(modes) == len(modes_ref) == {2: 3, 3: 6}[len(nodes)]
        for a, b in zip(modes, modes_ref):
            _same_array(a, b)
    dofs = gallery.node_to_dof_partition(node_part, len(nodes))
    dofs_ref = jax_gallery.node_to_dof_partition(node_part_ref, len(nodes))
    for li, ref in zip(dofs, dofs_ref):
        _same_part(li, ref)


@pytest.mark.parametrize("sizes", [[7], [3, 0, 5, 2], [4, 4]])
def test_variable_partition_matches(sizes):
    got = partition.variable_partition(sizes)
    want = jax_p_range.variable_partition(sizes)
    for li, ref in zip(got, want):
        _same_part(li, ref)


def test_local_indices_maps_match():
    """Ghost editing and the global -> local map of ``LocalIndices``, with a
    local permutation."""
    args = (20, 1, 3, [5, 6, 7, 8], [2, 15, 11], [0, 2, 2])
    perm = [4, 0, 1, 5, 2, 3, 6]
    li = partition.LocalIndices(*args, perm=perm)
    ref = jax_p_range.LocalIndices(*args, perm=np.asarray(perm))
    q = np.arange(-1, 21)
    _same_array(li.global_to_local(q), ref.global_to_local(q))
    _same_array(li.local_to_global(), ref.local_to_global())
    _same_array(li.local_to_owner(), ref.local_to_owner())
    new = ([11, 19, 3, 19, 6], [2, 2, 0, 2, 1])
    _same_part(li.union_ghost(*new), ref.union_ghost(*new))
    _same_part(li.remove_ghost(), ref.remove_ghost())
