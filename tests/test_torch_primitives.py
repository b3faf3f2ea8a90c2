"""The "array of parts" primitives and jagged arrays of the PyTorch port
against the JAX reference's (``partitionedarrays_tpu/parallel/primitives.py``
and ``ops/jagged.py``, host code): the same inputs, as lists of parts, give
the reference's results entry for entry (the reference's own cases of
test/primitives_tests.jl and test/jagged_array_tests.jl among them); the
same parts stacked on dim 0 of one tensor (``[P, ...]``, the serial
backend's layout) give the same entries as a stacked tensor on the input's
device; the setup tier's ``host_consistent`` equals the reference's on a
ghosted partition."""
import importlib

import numpy as np
import pytest
import torch

from partitionedarrays_tpu.parallel import p_range as jp

from partitionedarrays_tpu_torch.ops import jagged as tj
from partitionedarrays_tpu_torch.parallel import partition as tpart
from partitionedarrays_tpu_torch.parallel import primitives as tprim

jprim = importlib.import_module("partitionedarrays_tpu.parallel.primitives")
jjag = importlib.import_module("partitionedarrays_tpu.ops.jagged")

torch.set_num_threads(1)

RANK = [1, 2, 3, 4]
A3 = [3 * (r % 3) for r in RANK]  # the reference's a = 3 mod(rank, 3)
VECTORS = [np.arange(1, r + 1, dtype=np.int64) for r in RANK]
ROWS = np.arange(12, dtype=np.float64).reshape(4, 3) - 4.0


def _plain(x):
    """A result as nested python lists (JaggedArrays, arrays and tensors
    as lists of their entries)."""
    if isinstance(x, (tj.JaggedArray, jjag.JaggedArray)):
        return [_plain(v) for v in x]
    if isinstance(x, torch.Tensor):
        return x.cpu().tolist()
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


CASES = {
    "gather_scalars_to_1": lambda m: m.gather([10, 20, 30, 40], destination=1),
    "gather_scalars_to_all": lambda m: m.gather(A3, destination="all"),
    "gather_vectors_to_0": lambda m: m.gather(VECTORS, destination=0),
    "gather_vectors_to_all": lambda m: m.gather(VECTORS, destination="all"),
    "allocate_gather": lambda m: m.allocate_gather(VECTORS, destination=2),
    "scatter_list": lambda m: m.scatter([[1, 2, 3, 4]], source=0),
    "scatter_gathered": lambda m: m.scatter(m.gather(VECTORS, destination=0), source=0),
    "allocate_scatter": lambda m: m.allocate_scatter(m.gather(VECTORS, 3), source=3),
    "multicast": lambda m: m.multicast([7, None, None], source=0),
    "multicast_vectors": lambda m: m.multicast(VECTORS, source=1),
    "emit": lambda m: m.emit([None, 5, None], source=1),
    "allocate_multicast": lambda m: m.allocate_multicast(VECTORS, source=2),
    "scan_inclusive": lambda m: m.scan(lambda x, y: x + y, A3, 0, type="inclusive"),
    "scan_exclusive": lambda m: m.scan(lambda x, y: x + y, A3, 1, type="exclusive"),
    "scan_max": lambda m: m.scan(max, [4, 1, 7, 2], -1),
    "reduction_to_main": lambda m: m.reduction(lambda x, y: x + y, RANK, init=0),
    "reduction_to_all": lambda m: m.reduction(lambda x, y: x + y, RANK, init=10,
                                              destination="all"),
    "reduction_no_init": lambda m: m.reduction(lambda x, y: x * y, RANK, destination=2),
    "map_parts": lambda m: m.map_parts(lambda a, b: a + b, [1, 2], [10, 20]),
    "map_main": lambda m: m.map_main(lambda v: v * 2, [3, 4, 5]),
    "map_main_otherwise": lambda m: m.map_main(lambda v: v * 2, [3, 4, 5], main=1,
                                               otherwise=lambda v: -v),
    "tuple_of_arrays": lambda m: m.tuple_of_arrays([(1, "a"), (2, "b")]),
    "array_of_tuples": lambda m: m.array_of_tuples(([1, 2], ["a", "b"])),
    "getany": lambda m: m.getany([5, 6]),
    "i_am_main": lambda m: [m.i_am_main(p) for p in range(3)] + [m.i_am_main(2, main=2)],
    "indices": lambda m: [m.linear_indices(3), m.cartesian_indices((2, 3))],
    "fake_async": lambda m: m.fake_async(lambda: 42).fetch(),
}


@pytest.mark.parametrize("name", list(CASES))
def test_primitive_matches_jax(name):
    assert _plain(CASES[name](tprim)) == _plain(CASES[name](jprim))


def _graph_cases(m):
    """The reference's 4-rank pattern (test/primitives_tests.jl:163-210,
    0-based), its discovery, reverse and consistency, and the scalar and
    vector exchanges through it."""
    rcv_ids = [[1, 2], [3], [0, 1], [0, 2]]
    snd_ids = [[2, 3], [0, 2], [0, 3], [1]]
    g = m.ExchangeGraph(snd_ids, rcv_ids)
    found = m.ExchangeGraph(snd_ids)
    snd = [[10 * (d + 1) for d in s] for s in snd_ids]
    sndv = [[np.arange(p + 1) for _ in s] for p, s in enumerate(snd_ids)]
    return [
        g.snd, g.rcv, found.rcv, g.reverse().snd, g.reverse().rcv, m.is_consistent(g),
        m.is_consistent(m.ExchangeGraph(snd_ids, [[1], [3], [0, 1], [0, 2]])),
        m.find_rcv_ids(snd_ids), m.find_rcv_ids_gather_scatter(snd_ids),
        m.find_rcv_ids_ibarrier(snd_ids), m.exchange(snd, g).wait(),
        m.exchange(sndv, g).wait(), m.allocate_exchange(g, [[2, 3], [1, 4], [5, 6], [7]]),
        g.n_parts, repr(g),
    ]


def test_exchange_graph_matches_jax():
    assert _plain(_graph_cases(tprim)) == _plain(_graph_cases(jprim))


STACKED = {
    "gather_to_2": lambda m, x: m.gather(x, destination=2),
    "gather_to_all": lambda m, x: m.gather(x, destination="all"),
    "multicast": lambda m, x: m.multicast(x, source=3),
    "scan_inclusive": lambda m, x: m.scan(lambda a, b: a + b, x, 0.0),
    "scan_exclusive": lambda m, x: m.scan(lambda a, b: a + b, x, 0.5, type="exclusive"),
    "reduction_to_all": lambda m, x: m.reduction(lambda a, b: a + b, x, destination="all"),
    "reduction_to_1": lambda m, x: m.reduction(lambda a, b: a * b, x, destination=1),
    "map_parts": lambda m, x: m.map_parts(lambda a, b: a * b + 1, x, x),
}


@pytest.mark.parametrize("name", list(STACKED))
def test_stacked_parts_match_jax(name):
    """A ``[P, n]`` tensor of parts gives the reference's result on the
    list of its rows, entry for entry; a result with one value per part is
    a ``[P, ...]`` tensor again."""
    got = STACKED[name](tprim, torch.from_numpy(ROWS))
    want = STACKED[name](jprim, [row for row in ROWS])
    if name in ("gather_to_all", "multicast", "scan_inclusive", "scan_exclusive",
                "reduction_to_all", "map_parts"):
        assert isinstance(got, torch.Tensor) and got.shape[0] == 4
        # stacked, a scalar (the exclusive scan's init) broadcasts to the rows
        want = np.stack(np.broadcast_arrays(*[np.asarray(w) for w in want]))
    assert _plain(got) == _plain(want)


def test_stacked_gather_and_scatter_round_trip():
    """``gather`` of a ``[P, n]`` tensor gives the destination the whole
    tensor (the others an empty ``[0, n]`` one); ``scatter`` hands its rows
    back, stacked, equal to the input; a list of 1-D tensors gathers into
    a JaggedArray on their device, with the reference's entries."""
    x = torch.from_numpy(ROWS)
    g = tprim.gather(x, destination=0)
    assert torch.equal(g[0], x) and all(tuple(e.shape) == (0, 3) for e in g[1:])
    assert torch.equal(tprim.scatter(g, source=0), x)
    vectors = [torch.from_numpy(v) for v in VECTORS]
    gv = tprim.gather(vectors, destination=1)
    assert isinstance(gv[1], tj.JaggedArray) and isinstance(gv[1].data, torch.Tensor)
    assert _plain(gv) == _plain(jprim.gather(VECTORS, destination=1))
    back = tprim.scatter(gv, source=1)
    assert all(torch.equal(a, b) for a, b in zip(back, vectors))


def test_host_consistent_matches_jax():
    """Ghost values from their owners on the host, on a ghosted 1-D
    partition of 4 parts."""
    own_t = tpart.PRange(tpart.uniform_partition(4, 23, ghost=1))
    own_j = jp.PRange(jp.uniform_partition(4, 23, ghost=1))
    vals = [li.own_to_global * 1.5 for li in own_t.parts]
    got = tprim.host_consistent(own_t, vals)
    want = jprim.host_consistent(own_j, [li.own_to_global * 1.5 for li in own_j.partition()])
    assert _plain(got) == _plain(want)


JAGGED = {
    "from_lists": lambda m: m.JaggedArray.from_lists([[1, 2], [], [3, 4, 5]]),
    "from_empty_lists": lambda m: m.JaggedArray.from_lists([[], []]),
    "from_no_lists": lambda m: m.JaggedArray.from_lists([]),
    "empty": lambda m: m.JaggedArray.empty([2, 0, 3], np.float64),
    "length_to_ptrs": lambda m: m.length_to_ptrs([2, 0, 3, 1]),
    "ptrs_to_lengths": lambda m: m.ptrs_to_lengths([0, 2, 2, 5, 6]),
    "rewind_ptrs": lambda m: m.rewind_ptrs([2, 2, 5, 6, 6]),
    "jagged_array": lambda m: m.jagged_array(np.arange(6), [0, 1, 3, 6]),
    "generic": lambda m: m.GenericJaggedArray(np.arange(4), [0, 4]),
}


@pytest.mark.parametrize("name", list(JAGGED))
def test_jagged_matches_jax(name):
    got, want = JAGGED[name](tj), JAGGED[name](jjag)
    assert _plain(got) == _plain(want)
    if isinstance(want, jjag.JaggedArray):
        assert np.array_equal(got.ptrs, want.ptrs) and got.data.dtype == want.data.dtype
        assert list(got.lengths()) == list(want.lengths()) and len(got) == len(want)


def test_jagged_views_copies_and_equality():
    for m in (tj, jjag):
        a = m.JaggedArray.from_lists([np.array([1.0, 2.0]), np.array([3.0])])
        b = a.copy()
        a[0] = [7.0, 8.0]  # a view of the flat buffer
        assert a.data.tolist() == [7.0, 8.0, 3.0] and b.data.tolist() == [1.0, 2.0, 3.0]
        assert a != b and b == m.jagged_array(b.data.copy(), b.ptrs)
        assert [list(x) for x in a] == [[7.0, 8.0], [3.0]]
    t = tj.JaggedArray.from_lists([torch.tensor([1.0, 2.0]), torch.tensor([3.0])])
    c = t.copy()
    t[1] = torch.tensor([9.0])
    assert isinstance(t.data, torch.Tensor) and t.data.tolist() == [1.0, 2.0, 9.0]
    assert c.data.tolist() == [1.0, 2.0, 3.0] and c != t
    assert c == tj.JaggedArray(np.array([1.0, 2.0, 3.0]), c.ptrs)
