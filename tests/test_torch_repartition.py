"""The partition, vector and matrix utilities of the PyTorch port against
the JAX reference on the CPU (Pallas off): the partition constructors
(``uniform_partition`` with ghost layers and periodicity,
``variable_partition``, ``partition_from_color``, ``trivial_partition``,
``renumber_partition``, ``permute_indices``) and the free index maps;
``repartition_plan``; the vector utilities (``repartition``,
``find_local_indices``, ``renumber_pvector``, ``pvector_local``,
``pvector_from_local``, the split blocks, ``prand``/``prandn``); and the
matrix utilities (``repartition_matrix``, ``repartition_system``,
``renumber_matrix``, ``split_matrix_blocks``, ``psparse_from_blocks`` and
the host blocks of a matrix adopted from device arrays).

Index arrays, plan tables, moved values and matrix blocks are held equal
bit for bit: they are the same host work in the same order, and moving a
value does not round it.  ``prand``/``prandn`` draw from a torch
generator, so only their layout and moments are held (moments within
five standard errors of the law's).
"""
import importlib

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from partitionedarrays_tpu import config as jax_config
from partitionedarrays_tpu.backends import SerialBackend as JaxSerialBackend
from partitionedarrays_tpu.models import gallery as jax_gallery
from partitionedarrays_tpu.parallel import exchange_plan as jax_plan
from partitionedarrays_tpu.parallel import p_range as jp

from partitionedarrays_tpu_torch import convert
from partitionedarrays_tpu_torch import psparse as ps
from partitionedarrays_tpu_torch import pvector as pv
from partitionedarrays_tpu_torch.backends import SerialBackend
from partitionedarrays_tpu_torch.config import torch_dtype
from partitionedarrays_tpu_torch.models import gallery
from partitionedarrays_tpu_torch.models.hpcg.problem import build_hpcg_problem
from partitionedarrays_tpu_torch.parallel import exchange_plan
from partitionedarrays_tpu_torch.parallel import partition as tp
from partitionedarrays_tpu_torch.solvers.gs_dia import ColoredDIAGS

jax_psparse = importlib.import_module("partitionedarrays_tpu.psparse")
jax_pvector = importlib.import_module("partitionedarrays_tpu.pvector")
jax_problem = importlib.import_module("partitionedarrays_tpu.models.hpcg.problem")

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def reference_without_pallas():
    saved = jax_config.use_pallas
    jax_config.use_pallas = False
    yield
    jax_config.use_pallas = saved


def _ghosted(mod):
    """A colored partition of 24 ids on 4 parts, with ghosts added by
    ``union_ghost`` (every part takes the next part's first two ids)."""
    color = np.array([(7 * i) % 4 for i in range(24)])
    parts = mod.partition_from_color(4, color)
    out = []
    for li in parts:
        nxt = parts[(li.part + 1) % 4].own_to_global[:2]
        out.append(li.union_ghost(nxt, np.full(2, (li.part + 1) % 4)))
    return out


# name -> a function of the partition module: the same call in either package
PARTITIONS = {
    "uniform": lambda m: m.uniform_partition((2, 3), (7, 8)),
    "uniform_ghost": lambda m: m.uniform_partition((2, 2), (5, 6), ghost=1),
    "uniform_periodic": lambda m: m.uniform_partition((2, 2), (5, 6), ghost=1, periodic=True),
    "uniform_per_axis": lambda m: m.uniform_partition((3, 2), (7, 6), ghost=(2, 1),
                                                      periodic=(False, True)),
    "uniform_1d": lambda m: m.uniform_partition(3, 10, ghost=2),
    "variable": lambda m: m.variable_partition([2, 8, 4, 6]),
    "color_ghosted": _ghosted,
    "trivial": lambda m: m.trivial_partition(3, 9),
    "trivial_main": lambda m: m.trivial_partition(3, 9, main=2),
    "renumbered": lambda m: m.renumber_partition(_ghosted(m)),
    "permuted": lambda m: [m.permute_indices(li, np.arange(li.n_local)[::-1])
                           for li in _ghosted(m)],
}

MAPS = ("local_to_global", "local_to_owner", "own_to_local", "ghost_to_local", "local_to_own",
        "local_to_ghost", "own_to_owner", "local_permutation")


def _same_part(li, li_ref, ids):
    for name in ("own_to_global", "ghost_to_global", "ghost_to_owner"):
        np.testing.assert_array_equal(getattr(li, name), getattr(li_ref, name), err_msg=name)
    for name in MAPS:
        np.testing.assert_array_equal(getattr(li, name)(), getattr(li_ref, name)(), err_msg=name)
    for name in ("global_to_own", "global_to_ghost", "global_to_local"):
        np.testing.assert_array_equal(getattr(li, name)(ids), getattr(li_ref, name)(ids),
                                      err_msg=name)
    assert (li.part, li.n_parts, li.n_global) == (li_ref.part, li_ref.n_parts, li_ref.n_global)


@pytest.mark.parametrize("name", list(PARTITIONS))
def test_partition_matches_jax(name):
    parts, parts_ref = PARTITIONS[name](tp), PARTITIONS[name](jp)
    assert len(parts) == len(parts_ref)
    ids = np.arange(-2, parts[0].n_global + 2)
    for li, li_ref in zip(parts, parts_ref):
        _same_part(li, li_ref, ids)
    queries = [np.arange(parts[0].n_global)] * len(parts)
    for got, want in zip(tp.find_owner(parts, queries), jp.find_owner(parts_ref, queries)):
        np.testing.assert_array_equal(got, want)
    g = tp.PRange(parts).assembly_graph()
    g_ref = jp.PRange(parts_ref).assembly_graph()
    assert g.neighbors_snd == g_ref.neighbors_snd and g.neighbors_rcv == g_ref.neighbors_rcv
    for a, b in zip(g.snd_ghost + g.rcv_own, g_ref.snd_ghost + g_ref.rcv_own):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_local_range_matches_jax():
    for args in [(0, 3, 10), (2, 3, 10), (1, 4, 9, 2), (0, 4, 9, 2, True), (3, 4, 9, 1, True)]:
        assert tp.local_range(*args) == jp.local_range(*args)


def test_free_index_maps_match_jax():
    """Every free function of the reference's ``p_range`` that the port
    copies, on a ghosted and permuted part, gives the reference's result."""
    parts, parts_ref = PARTITIONS["permuted"](tp), PARTITIONS["permuted"](jp)
    li, li_ref = parts[1], parts_ref[1]
    ids = np.arange(-1, 26)
    for name in ("local_to_global", "local_to_owner", "own_to_global", "ghost_to_global",
                 "ghost_to_owner", "own_to_owner", "own_to_local", "ghost_to_local",
                 "local_to_own", "local_to_ghost", "local_permutation"):
        got = getattr(tp, name)(li)
        want = getattr(jp, name)(li_ref)
        np.testing.assert_array_equal(got, want, err_msg=name)
    for name in ("global_to_local", "global_to_own", "global_to_ghost"):
        np.testing.assert_array_equal(getattr(tp, name)(li, ids), getattr(jp, name)(li_ref, ids))
    for name in ("map_global_to_local", "map_global_to_own", "map_global_to_ghost"):
        np.testing.assert_array_equal(getattr(tp, name)(ids, li), getattr(jp, name)(ids, li_ref))
    lids = np.array([-1, 0, 3, 1, li.n_local - 1])
    for name in ("map_local_to_global", "map_own_to_global", "map_ghost_to_global"):
        k = {"map_local_to_global": li.n_local, "map_own_to_global": li.n_own,
             "map_ghost_to_global": li.n_ghost}[name]
        q = np.clip(lids, -1, k - 1)
        np.testing.assert_array_equal(getattr(tp, name)(q, li), getattr(jp, name)(q, li_ref))
    for name in ("part_id", "own_length", "ghost_length", "local_length", "global_length"):
        assert getattr(tp, name)(li) == getattr(jp, name)(li_ref), name
    gids = [p.local_to_global() for p in parts]
    for got, want in zip(tp.to_local(gids, parts), jp.to_local(gids, parts_ref)):
        np.testing.assert_array_equal(got, want)
    lids_all = [np.arange(p.n_local) for p in parts]
    for got, want in zip(tp.to_global(lids_all, parts), jp.to_global(lids_all, parts_ref)):
        np.testing.assert_array_equal(got, want)
    for edit in (lambda m, x: m.replace_ghost(x, [5, 6], [2, 3]),
                 lambda m, x: m.remove_ghost(x),
                 lambda m, x: m.union_ghost(x, [5, 6, 5, 0], [2, 3, 2, 0])):
        _same_part(edit(tp, li), edit(jp, li_ref), ids)
    for name, other in (("matching_local_indices", 1), ("matching_ghost_indices", 2)):
        assert getattr(tp, name)(li, parts[other]) == getattr(jp, name)(li_ref, parts_ref[other])
    _same_part(tp.own_and_ghost_indices(24, 1, 4, [3, 4], [9], [2]),
               jp.own_and_ghost_indices(24, 1, 4, [3, 4], [9], [2]), ids)
    got, want = tp.assembly_neighbors(parts), jp.assembly_neighbors(parts_ref)
    assert got == want
    got, want = tp.assembly_local_indices(parts), jp.assembly_local_indices(parts_ref)
    assert got[0] == want[0] and got[2] == want[2]
    for a, b in zip(got[1] + got[3], want[1] + want[3]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


# (from, to) partitions of one global range, the same call in either package
REPARTITIONS = {
    # the reference's tests/test_pvector.py::test_repartition
    "uniform_to_variable": (lambda m: m.uniform_partition(4, 20, ghost=1),
                            lambda m: m.variable_partition([2, 8, 4, 6])),
    "box_to_slabs": (lambda m: m.uniform_partition((2, 2, 2), (5, 6, 7)),
                     lambda m: m.variable_partition([30, 31, 20, 29, 0, 40, 30, 30])),
    "color_to_trivial": (lambda m: _ghosted(m), lambda m: m.trivial_partition(4, 24, main=3)),
}


@pytest.mark.parametrize("name", list(REPARTITIONS))
def test_repartition_plan_matches_jax(name):
    src, dst = REPARTITIONS[name]
    plan = exchange_plan.repartition_plan(tp.PRange(src(tp)), tp.PRange(dst(tp)))
    plan_ref = jax_plan.repartition_plan(jp.PRange(src(jp)), jp.PRange(dst(jp)))
    assert plan.perms == tuple(tuple(tuple(e) for e in p) for p in plan_ref.perms)
    for a, b in zip(plan.snd_idx + plan.rcv_idx, plan_ref.snd_idx + plan_ref.rcv_idx):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("name", list(REPARTITIONS))
def test_repartition_matches_jax(name, dtype):
    src, dst = REPARTITIONS[name]
    pr, pr_ref = tp.PRange(src(tp)), jp.PRange(src(jp))
    rng = np.random.default_rng(3)
    own = [rng.standard_normal(li.n_own).astype(dtype) for li in pr.parts]
    x = pv.pvector_from_own(own, pr, SerialBackend(pr.n_parts), device="cpu")
    x_ref = jax_pvector.pvector_from_own(own, pr_ref, JaxSerialBackend(pr.n_parts))
    new, new_ref = tp.PRange(dst(tp)), jp.PRange(dst(jp))
    y = pv.repartition(x, new)
    y_ref = jax_pvector.repartition(x_ref, new_ref)
    np.testing.assert_array_equal(y.own.numpy(), np.asarray(y_ref.own))
    np.testing.assert_array_equal(pv.collect(y), pv.collect(x))
    assert pr._repartition_plans[new] is not None
    assert pv.repartition(y, pr).own.equal(x.own)  # and back, on its own cached plan
    assert pv.repartition(x, new).own.equal(y.own)
    assert len(pr._repartition_plans) == 1


def _mask_case(dtype):
    parts, parts_ref = _ghosted(tp), _ghosted(jp)
    rng = np.random.default_rng(5)
    own = [(rng.random(li.n_own) < 0.6).astype(dtype) for li in parts]
    x = pv.pvector_from_own(own, tp.PRange(parts), SerialBackend(4), device="cpu")
    x_ref = jax_pvector.pvector_from_own(own, jp.PRange(parts_ref), JaxSerialBackend(4))
    return x, x_ref


def test_find_local_indices_and_renumber_pvector_match_jax():
    x, x_ref = _mask_case(np.float64)
    (pr, new_of_old), (pr_ref, new_of_old_ref) = (pv.find_local_indices(x),
                                                  jax_pvector.find_local_indices(x_ref))
    np.testing.assert_array_equal(new_of_old, new_of_old_ref)
    ids = np.arange(-1, pr.n_global + 1)
    for li, li_ref in zip(pr.parts, pr_ref.partition()):
        _same_part(li, li_ref, ids)
    y, y_ref = pv.renumber_pvector(x), jax_pvector.renumber_pvector(x_ref)
    np.testing.assert_array_equal(y.own.numpy(), np.asarray(y_ref.own))
    for li, li_ref in zip(y.layout.pr.parts, y_ref.layout.pr.partition()):
        _same_part(li, li_ref, np.arange(-1, 25))


def test_pvector_local_from_local_and_split_blocks_match_jax():
    pr, pr_ref = tp.PRange(_ghosted(tp)), jp.PRange(_ghosted(jp))
    rng = np.random.default_rng(8)
    I = [rng.integers(0, 24, 15) for _ in range(4)]
    V = [rng.standard_normal(15) for _ in range(4)]
    v = pv.pvector_local(I, V, pr, SerialBackend(4), device="cpu")
    v_ref = jax_pvector.pvector_local(I, V, pr_ref, JaxSerialBackend(4))
    np.testing.assert_array_equal(v.own.numpy(), np.asarray(v_ref.own))
    assert not v.ghost.any()
    with pytest.raises(ValueError, match="local part's contributions are missing"):
        pv.pvector_local([None] + I[1:], V, pr, SerialBackend(4), device="cpu")
    local = [rng.standard_normal(li.n_local) for li in pr.parts]
    w = pv.pvector_from_local(local, pr, SerialBackend(4), device="cpu")
    w_ref = jax_pvector.pvector_from_local(local, pr_ref, JaxSerialBackend(4))
    np.testing.assert_array_equal(w.own.numpy(), np.asarray(w_ref.own))
    np.testing.assert_array_equal(w.ghost.numpy(), np.asarray(w_ref.ghost))
    for got, want in zip(w.local_values(), local):
        np.testing.assert_array_equal(got, want)
    own, ghost = pv.split_vector_blocks(pv.split_vector(w))
    u = pv.pvector_from_split_blocks(own, ghost, pr, w.backend)
    assert u.own is w.own and u.ghost is w.ghost and pv.pvector_layout(pr) is u.layout
    with pytest.raises(ValueError):
        pv.pvector_from_split_blocks(own[:, :-1], ghost, pr, w.backend)


@pytest.mark.parametrize("draw,mean,var", [("prand", 0.5, 1 / 12), ("prandn", 0.0, 1.0)])
def test_random_vectors_layout_and_moments(draw, mean, var):
    """Layout equal to the reference's on a ghosted partition; padding zero;
    the ghosts equal their owners' values; the sample mean and variance
    within five standard errors of the law's."""
    rows = tp.uniform_partition((2, 2), (100, 101), ghost=1)
    rows_ref = jp.uniform_partition((2, 2), (100, 101), ghost=1)
    g = torch.Generator().manual_seed(12)
    x = getattr(pv, draw)(g, tp.PRange(rows), SerialBackend(4), dtype=torch.float64, device="cpu")
    x_ref = getattr(jax_pvector, draw)(jax.random.key(0), jp.PRange(rows_ref),
                                       JaxSerialBackend(4))
    lay, lay_ref = x.layout, x_ref.layout
    assert (lay.n_own_pad, lay.n_ghost_pad) == (lay_ref.n_own_pad, lay_ref.n_ghost_pad)
    assert tuple(x.own.shape) == tuple(x_ref.own.shape)
    assert x.own.dtype == torch.float64
    mask = pv._own_mask(lay, "cpu")
    assert not x.own[~mask].any()
    vals = pv.collect(x)
    assert vals.size == 10100
    for li, gh in zip(rows, x.ghost_values()):
        np.testing.assert_array_equal(gh, vals[li.ghost_to_global])
    n = vals.size
    assert abs(vals.mean() - mean) <= 5 * np.sqrt(var / n)
    assert abs(vals.var() - var) <= 5 * var * np.sqrt(2 / n) * (1.5 if draw == "prand" else 1)
    y = getattr(pv, draw)(torch.Generator().manual_seed(12), tp.PRange(rows), SerialBackend(4),
                          dtype=torch.float64, device="cpu")
    assert torch.equal(x.own, y.own)  # the generator fixes the values


def _system(dtype):
    """The reference's test_repartition_system_joint: the 6^3 Laplacian on
    (2,2,1) parts and a numpy rhs, in both packages."""
    I, J, V, rows, cols = gallery.laplacian_fdm((6, 6, 6), (2, 2, 1), dtype=dtype)
    A = ps.psparse(I, J, V, rows, cols, SerialBackend(4), assembled=True, device="cpu")
    I, J, V, rows, cols = jax_gallery.laplacian_fdm((6, 6, 6), (2, 2, 1), dtype=dtype)
    A_ref = jax_psparse.psparse(I, J, V, jp.PRange(rows), jp.PRange(cols), JaxSerialBackend(4),
                                assembled=True)
    rng = np.random.default_rng(0)
    own = [rng.standard_normal(li.n_own).astype(dtype) for li in A.row_prange.parts]
    b = pv.pvector_from_own(own, A.row_prange, A.backend, device="cpu")
    b_ref = jax_pvector.pvector_from_own(own, A_ref.row_prange, A_ref.backend)
    return (A, b), (A_ref, b_ref)


def _same_matrix(A, A_ref):
    """Partitions (own, ghost ids and owners) and every host block bit for
    bit, and the global matrix."""
    for pr, pr_ref in ((A.row_prange, A_ref.row_prange), (A.col_prange, A_ref.col_prange)):
        for li, li_ref in zip(pr.parts, pr_ref.partition()):
            for name in ("own_to_global", "ghost_to_global", "ghost_to_owner"):
                np.testing.assert_array_equal(getattr(li, name), getattr(li_ref, name))
    for b, b_ref in zip(ps.host_blocks(A), A_ref.blocks):
        assert set(b) == {k for k in b_ref if b_ref[k] is not None}
        for k in b:
            got, want = sp.csr_matrix(b[k]), sp.csr_matrix(b_ref[k])
            assert got.shape == want.shape and got.dtype == want.dtype
            np.testing.assert_array_equal(got.indptr, want.indptr)
            np.testing.assert_array_equal(got.indices, want.indices)
            np.testing.assert_array_equal(got.data, want.data)
    G, G_ref = ps.to_global_scipy(A), jax_psparse.to_global_scipy(A_ref)
    assert (G != G_ref).nnz == 0


NEW_ROWS = {
    # the reference's uneven [n/2, n/4, n/8, rest]
    "uneven": lambda m, n: m.variable_partition([n // 2, n // 4, n // 8,
                                                 n - n // 2 - n // 4 - n // 8]),
    "two_parts": lambda m, n: m.variable_partition([n // 2, n - n // 2, 0, 0], n),
    "colored": lambda m, n: m.partition_from_color(4, (np.arange(n) * 5 // 3) % 4),
}


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("name", list(NEW_ROWS))
def test_repartition_system_matches_jax(name, dtype):
    (A, b), (A_ref, b_ref) = _system(dtype)
    n = A.shape[0]
    new, new_ref = tp.PRange(NEW_ROWS[name](tp, n)), jp.PRange(NEW_ROWS[name](jp, n))
    A2, b2 = ps.repartition_system(A, b, new)
    A2_ref, b2_ref = jax_psparse.repartition_system(A_ref, b_ref, new_ref)
    _same_matrix(A2, A2_ref)
    assert A2.row_prange is b2.layout.pr and A2.dtype == torch_dtype(dtype)
    assert (ps.to_global_scipy(A2) != ps.to_global_scipy(A)).nnz == 0
    np.testing.assert_array_equal(b2.own.numpy(), np.asarray(b2_ref.own))
    np.testing.assert_array_equal(pv.collect(b2), pv.collect(b))
    A3 = ps.repartition_matrix(A, new, new)
    _same_matrix(A3, jax_psparse.repartition_matrix(A_ref, new_ref, new_ref))
    # the SpMV on the new partition, on the plain kernel versions
    y = ps.spmv(A2, pv.repartition(ps.spmv(A, pv.pones(A.col_prange, A.backend, dtype=A.dtype,
                                                       device="cpu")), new))
    y_ref = ps.spmv(A, ps.spmv(A, pv.pones(A.col_prange, A.backend, dtype=A.dtype,
                                           device="cpu")))
    np.testing.assert_allclose(pv.collect(y), pv.collect(y_ref), rtol=0,
                               atol=1e-12 if dtype == np.float64 else 1e-4)


def test_renumber_and_split_matrix_match_jax():
    """``renumber_matrix`` relabels the partitions and keeps every block
    (the frozen ones too); the split accessors and ``psparse_from_blocks``
    return and take the same blocks."""
    (A, _), (A_ref, _) = _system(np.float64)
    new, new_ref = tp.PRange(NEW_ROWS["colored"](tp, 216)), jp.PRange(NEW_ROWS["colored"](jp, 216))
    A, A_ref = ps.repartition_matrix(A, new, new), jax_psparse.repartition_matrix(
        A_ref, new_ref, new_ref)
    R, R_ref = ps.renumber_matrix(A), jax_psparse.renumber_matrix(A_ref)
    _same_matrix(R, R_ref)
    assert R.device() is A.device() and R.nnz() == A.nnz()
    blocks = ps.split_matrix_blocks(ps.split_matrix(ps.split_format(A)))
    blocks_ref = jax_psparse.split_matrix_blocks(A_ref)
    assert blocks[2] == blocks[3] == [None] * 4
    for got, want in zip(blocks[0] + blocks[1], blocks_ref[0] + blocks_ref[1]):
        assert (sp.csr_matrix(got) != sp.csr_matrix(want)).nnz == 0
    C = ps.psparse_from_blocks(ps.host_blocks(A), A.row_prange, A.col_prange.parts, A.backend,
                               device="cpu")
    assert ps.replicate_psparse(C) is C
    x = pv.pones(A.col_prange, A.backend, dtype=A.dtype, device="cpu")
    assert torch.equal(ps.spmv(C, x).own, ps.spmv(A, x).own)


@pytest.mark.parametrize("parts", [(1, 1, 1), (2, 2, 2)], ids=["one_part", "parts"])
def test_host_blocks_of_an_adopted_matrix_match_jax(parts):
    """An HPCG operator carried across from the reference's device arrays
    (``convert.from_jax_arrays``: no host blocks) gets host blocks from its
    frozen ones, equal to the reference's own host blocks."""
    shape = (4, 4, 4)
    P = int(np.prod(parts))
    A_ref, b_ref = jax_problem.build_hpcg_problem(shape, parts, JaxSerialBackend(P),
                                                  dtype=np.float64)
    dev = A_ref.device()
    lev = dict(local_shape=shape, parts_per_dir=parts, offsets=dev.oo.offsets,
               oo_vals=np.array(dev.oo.vals), b_own=np.array(b_ref.own))
    if P > 1:
        lev.update(ghost_to_global=[li.ghost_to_global for li in A_ref.col_prange.partition()],
                   ghost_to_owner=[li.ghost_to_owner for li in A_ref.col_prange.partition()],
                   oh_indptr=[b["oh"].indptr for b in A_ref.blocks],
                   oh_indices=[b["oh"].indices for b in A_ref.blocks],
                   oh_data=[b["oh"].data for b in A_ref.blocks])
    vals = torch.from_numpy(np.array(dev.oo.vals))
    c = ColoredDIAGS.from_device(dev.oo.offsets, vals, vals[:, list(dev.oo.offsets).index(0)])
    lev.update(vals_d=c.vals_d.numpy(), invd_d=c.invd_d.numpy())
    A = convert.from_jax_arrays([lev], device="cpu").A
    assert A.blocks is None
    for b, b_ref in zip(ps.host_blocks(A), A_ref.blocks):
        for k in ("oo", "oh"):
            got, want = sp.csr_matrix(b[k]), sp.csr_matrix(b_ref[k])
            got.eliminate_zeros()
            want.eliminate_zeros()
            assert got.shape == want.shape and (got != want).nnz == 0
    G, G_ref = ps.to_global_scipy(A), jax_psparse.to_global_scipy(A_ref)
    assert (G != G_ref).nnz == 0
    A_port, _ = build_hpcg_problem(shape, parts, SerialBackend(P), device="cpu")
    assert (G != ps.to_global_scipy(A_port)).nnz == 0
