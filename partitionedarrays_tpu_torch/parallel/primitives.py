"""Host-side "array of parts" primitives.

Copied from ``partitionedarrays_tpu/parallel/primitives.py`` (the
reference's backend-generic collectives, src/primitives.jl): ``map_parts``,
``map_main`` (:185-199), ``i_am_main`` (:145), ``getany`` (:29),
``tuple_of_arrays`` (:51-97), ``gather`` and ``allocate_gather``
(:234-330), ``scatter`` (:357-437), ``multicast``/``emit`` (:469-561),
``scan`` (:599-628), ``reduction`` (:681-698), ``ExchangeGraph`` and the
discovery of receivers (:728-859), ``exchange`` (:921-1042), the fake-async
task (:122-141) and ``host_consistent``.  All parts are visible in one
process, so each primitive is the reference's sequential form, and the
receivers of a graph are its transpose.

Parts are either a sequence (one item per part, as in the reference) or a
tensor whose dim 0 is the part axis, as the serial backend stacks them
(``[P, ...]``).  A primitive that returns one value per part returns a
stacked tensor on the input's device for a stacked input: ``gather``
(destination "all"), ``scatter`` of a stacked payload, ``multicast``,
``scan``, and ``map_parts`` when every result is a tensor of one shape.
``gather`` to one destination gives that part the whole ``[P, ...]``
tensor and the others an empty ``[0, ...]`` one (the reference's
JaggedArray of the parts' vectors, stacked since they have one length).
"""
from __future__ import annotations

import functools
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops.jagged import JaggedArray
from .partition import PRange

MAIN = 0


class FakeTask:
    """Runs its thunk on the first ``wait``/``fetch`` (the reference's
    FakeTask and ``@fake_async``, src/primitives.jl:122-141)."""

    def __init__(self, thunk: Callable[[], Any]):
        self._thunk = thunk
        self._done = False
        self._value = None

    def wait(self):
        if not self._done:
            self._value = self._thunk()
            self._done = True
        return self._value

    fetch = wait


def fake_async(thunk: Callable[[], Any]) -> FakeTask:
    return FakeTask(thunk)


# -- part indexing -------------------------------------------------------------

def linear_indices(n_parts: int) -> List[int]:
    return list(range(n_parts))


def cartesian_indices(shape: Sequence[int]) -> List[Tuple[int, ...]]:
    return list(np.ndindex(*tuple(shape)))


def i_am_main(part: int, main: int = MAIN) -> bool:
    return part == main


def getany(parts: Sequence) -> Any:
    """One part's value (reference ``getany``, src/primitives.jl:29)."""
    return parts[0]


def _stack_like(values: List, like) -> Union[torch.Tensor, List]:
    """``values`` (one per part) stacked on dim 0 on ``like``'s device when
    ``like`` is a tensor and every value is a tensor or a scalar of one
    broadcast shape (a scalar ``init`` of ``scan`` broadcasts to the
    rows); else the list."""
    if not isinstance(like, torch.Tensor) or not all(
            isinstance(v, torch.Tensor) or np.isscalar(v) for v in values):
        return values
    tensors = [torch.as_tensor(v, device=like.device) for v in values]
    try:
        shape = torch.broadcast_shapes(*(t.shape for t in tensors))
    except RuntimeError:
        return values
    dtype = functools.reduce(torch.promote_types, (t.dtype for t in tensors))
    return torch.stack([t.to(dtype).expand(shape) for t in tensors])


def map_parts(f: Callable, *arrays):
    """``f`` of each part's items; stacked when every input is stacked."""
    out = [f(*items) for items in zip(*arrays)]
    stacked = arrays and all(isinstance(a, torch.Tensor) for a in arrays)
    return _stack_like(out, arrays[0]) if stacked else out


def map_main(f: Callable, *arrays, main: int = MAIN, otherwise=None) -> List:
    """``f`` on the main part only, ``otherwise`` (or None) on the others
    (reference ``map_main``, src/primitives.jl:185-199)."""
    out = []
    for p, items in enumerate(zip(*arrays)):
        if p == main:
            out.append(f(*items))
        else:
            out.append(otherwise(*items) if otherwise else None)
    return out


def tuple_of_arrays(array_of_tuples: Sequence[Tuple]) -> Tuple[List, ...]:
    """Reference ``tuple_of_arrays`` (src/primitives.jl:51-97)."""
    if not len(array_of_tuples):
        return ()
    k = len(array_of_tuples[0])
    return tuple([t[i] for t in array_of_tuples] for i in range(k))


def array_of_tuples(tuple_of_arrays_: Tuple[Sequence, ...]) -> List[Tuple]:
    return list(zip(*tuple_of_arrays_))


# -- collectives -----------------------------------------------------------------

def _vector_payload(values: List) -> bool:
    return bool(values) and all(
        (isinstance(v, torch.Tensor) and v.dim() == 1)
        or (isinstance(v, (np.ndarray, list)) and np.asarray(v).ndim == 1)
        for v in values
    )


def _jagged(values: List) -> JaggedArray:
    if isinstance(values[0], torch.Tensor):
        return JaggedArray.from_lists(values)
    return JaggedArray.from_lists([np.asarray(v) for v in values])


def _empty_like_gather(collected):
    if isinstance(collected, torch.Tensor):
        return collected[:0]
    if isinstance(collected, JaggedArray):
        return JaggedArray(collected.data[:0], np.zeros(1, np.int64))
    return []


def gather(parts, destination: Union[int, str] = MAIN):
    """Each part's value collected on the destination part, or on every
    part with ``destination="all"`` (reference ``gather``,
    src/primitives.jl:234-330).  Vector payloads of a sequence collect into
    a JaggedArray (on their device for tensors); a stacked ``[P, ...]``
    tensor is its own collection."""
    if isinstance(parts, torch.Tensor):
        collected, P = parts, parts.shape[0]
    else:
        values = list(parts)
        P = len(values)
        collected = _jagged(values) if _vector_payload(values) else list(values)
    if destination == "all":
        if isinstance(collected, torch.Tensor):
            return collected.unsqueeze(0).expand(P, *collected.shape).clone()
        return [collected.copy() if isinstance(collected, JaggedArray) else list(collected)
                for _ in range(P)]
    return [collected if p == destination else _empty_like_gather(collected) for p in range(P)]


def allocate_gather(parts, destination=MAIN):
    """Reference ``allocate_gather`` (src/primitives.jl:256-297): the
    buffers are the gathered values."""
    return gather(parts, destination)


def scatter(parts_on_source: Sequence, source: int = MAIN):
    """The source part's collection, one item per part, handed out
    (reference ``scatter``, src/primitives.jl:357-437); a ``[P, ...]``
    tensor on the source scatters to its rows, stacked."""
    data = parts_on_source[source]
    if isinstance(data, torch.Tensor):
        return data.clone()
    if isinstance(data, JaggedArray):
        return [data[p].clone() if isinstance(data.data, torch.Tensor) else data[p].copy()
                for p in range(len(data))]
    return list(data)


def allocate_scatter(parts_on_source, source: int = MAIN):
    """Reference ``allocate_scatter`` (src/primitives.jl:357-437)."""
    return scatter(parts_on_source, source)


def multicast(parts, source: int = MAIN):
    """The source part's value on every part (reference ``multicast``,
    src/primitives.jl:469-561)."""
    if isinstance(parts, torch.Tensor):
        return parts[source].unsqueeze(0).expand_as(parts).clone()
    v = parts[source]
    return [v for _ in parts]


def allocate_multicast(parts, source: int = MAIN):
    """Reference ``allocate_multicast`` (src/primitives.jl:469-561)."""
    return multicast(parts, source)


# the reference's deprecated name for multicast
emit = multicast
allocate_emit = multicast


def scan(op: Callable, parts, init, type: str = "inclusive"):
    """Prefix reduction over the parts in order (reference ``scan``,
    src/primitives.jl:599-628)."""
    if type not in ("inclusive", "exclusive"):
        raise ValueError(f"scan type must be inclusive or exclusive, got {type!r}")
    out = []
    acc = init
    for v in parts:
        if type == "exclusive":
            out.append(acc)
            acc = op(acc, v)
        else:
            acc = op(acc, v)
            out.append(acc)
    return _stack_like(out, parts)


def reduction(op: Callable, parts, destination: Union[int, str] = MAIN, init=None):
    """``op`` folded over the parts in order, on the destination part (None
    on the others) or on every part (reference ``reduction``,
    src/primitives.jl:681-698)."""
    acc = init
    for v in parts:
        acc = v if acc is None else op(acc, v)
    P = len(parts)
    if destination == "all":
        return _stack_like([acc] * P, parts)
    return [acc if p == destination else None for p in range(P)]


# -- sparse neighborhood exchange ---------------------------------------------------

class ExchangeGraph:
    """Each part's send and receive neighbors (reference ``ExchangeGraph``,
    src/primitives.jl:728-783); the receivers default to the senders'
    transpose."""

    def __init__(self, snd: Sequence[Sequence[int]], rcv: Optional[Sequence[Sequence[int]]] = None):
        self.snd = [list(s) for s in snd]
        if rcv is None:
            rcv = find_rcv_ids(self.snd)
        self.rcv = [list(r) for r in rcv]

    @property
    def n_parts(self) -> int:
        return len(self.snd)

    def reverse(self) -> "ExchangeGraph":
        """Reference ``Base.reverse`` (src/primitives.jl:741)."""
        return ExchangeGraph(self.rcv, self.snd)

    def __repr__(self):
        return f"ExchangeGraph(P={self.n_parts})"


def find_rcv_ids(snd: Sequence[Sequence[int]]) -> List[List[int]]:
    """The transpose of the send graph: with every part in one process it
    replaces both the reference's gather-scatter (src/primitives.jl:826-859)
    and its NBX discovery (src/mpi_array.jl:640-680)."""
    rcv: List[List[int]] = [[] for _ in range(len(snd))]
    for i, dests in enumerate(snd):
        for d in dests:
            rcv[d].append(i)
    return rcv


# the reference's two discovery algorithms give the same transpose here
find_rcv_ids_gather_scatter = find_rcv_ids
find_rcv_ids_ibarrier = find_rcv_ids


def is_consistent(graph: ExchangeGraph) -> bool:
    """Reference ``is_consistent`` (src/primitives.jl:861-874)."""
    expect = find_rcv_ids(graph.snd)
    return all(sorted(a) == sorted(b) for a, b in zip(expect, graph.rcv))


def exchange(snd_data: Sequence, graph: ExchangeGraph) -> FakeTask:
    """``snd_data[p]``: payloads aligned with ``graph.snd[p]``; the task's
    value ``rcv_data[p]`` is aligned with ``graph.rcv[p]`` (reference
    ``exchange``, src/primitives.jl:921-1042).  Payloads move as they are:
    a tensor stays on its device."""

    def run():
        P = graph.n_parts
        inbox = [{} for _ in range(P)]
        for p in range(P):
            for k, d in enumerate(graph.snd[p]):
                inbox[d][p] = snd_data[p][k]
        return [[inbox[p][src] for src in graph.rcv[p]] for p in range(P)]

    return fake_async(run)


def allocate_exchange(graph: ExchangeGraph, lengths_snd: Sequence[Sequence[int]]):
    """Receive buffers of the given lengths (reference
    ``allocate_exchange``, src/primitives.jl:945-1002)."""
    lens = exchange([[np.int64(n) for n in ls] for ls in lengths_snd], graph).wait()
    return [[np.zeros(int(n)) for n in part_lens] for part_lens in lens]


def host_consistent(pr: PRange, own_parts: Sequence[np.ndarray], backend=None
                    ) -> List[np.ndarray]:
    """Per-part ghost values of ``pr`` filled from their owners' own values
    (the consistent direction of the assembly graph), on host arrays: the
    setup tier's halo exchange (the AMG power method).  On a multi-process
    ``backend`` only the local parts' own values are read and their ghosts
    filled (the payloads of other processes travel as host messages;
    COLLECTIVE); the other parts' ghosts stay zero."""
    from .host_exchange import exchange_part_messages

    g = pr.assembly_graph()
    local = range(pr.n_parts) if backend is None else backend.local_parts()
    dtype = np.asarray(own_parts[local[0]]).dtype
    ghosts = [np.zeros(li.n_ghost, dtype=dtype) for li in pr.parts]
    msgs = {}
    for o in local:
        for k, dst in enumerate(g.neighbors_rcv[o]):
            msgs[(o, dst)] = (np.asarray(own_parts[o], dtype=dtype)[g.rcv_own[o][k]],)
    if backend is not None:
        msgs = exchange_part_messages(backend, pr.n_parts, msgs, (dtype,))
    for (o, dst), (payload,) in sorted(msgs.items()):
        j = g.neighbors_snd[dst].index(o)
        ghosts[dst][g.snd_ghost[dst][j]] = payload
    return ghosts
