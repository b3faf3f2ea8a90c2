"""PVector: a partitioned vector in split own/ghost storage.

Counterpart of ``partitionedarrays_tpu/pvector.py``: the ``Task`` shim
(:36), the core (:60-160, :292-300), the COO constructor ``pvector``
(:411-471), ``consistent`` and ``assemble`` as tasks (:512-536), the
reductions (:545-598), ``collect`` (:607), the distances (:634-712), the
df64 pairs (:715-790), and the reuse form of the COO constructor
(``PVectorAssemblyCache``, ``pvector(reuse=True)``, ``pvector_refill``,
:396-484), which does not copy the reference's silent downcast of wider
values; and the vector utilities: ``pvector_layout`` (:239),
``prand``/``prandn`` (:262-286; from a ``torch.Generator``, so their values
are not the reference's, only their law and layout), ``pvector_local``
(:302, on the serial backend), ``pvector_from_local`` (:377), the
split-block helpers (:616-632), ``find_local_indices`` (:798),
``renumber_pvector`` (:836) and ``repartition`` (:845), whose plan
(``exchange_plan.repartition_plan``) is built once per pair of partitions.
The parts are stacked along dim 0:
``own[P, n_own_pad]`` and ``ghost[P, n_ghost_pad]``, with padding lanes
kept at zero so that dots and norms need no mask.  On a multi-process
backend (``backends.MeshBackend``) a process holds its own parts only,
``[P_local, ...]``; the per-part host views (``own_values`` ...) then give
None for the other processes' parts, ``collect`` gathers the whole vector
on every process, and the reductions all-reduce.

A df64 vector is a (hi, lo) pair of float32 PVectors on one layout; its
dots and norms run compensated (``ops/df64.py``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .backends import Backend
from .config import numpy_dtype, torch_dtype
from .ops import df64 as df
from .parallel.exchange_plan import VectorLayout, layout_of, repartition_plan
from .parallel.partition import INT, LocalIndices, PRange, find_owner, renumber_partition


class Task:
    """The reference's task calling convention (``t = consistent(v);
    t.wait()``) around an already computed result."""

    def __init__(self, value):
        self._value = value

    def wait(self):
        return self._value

    fetch = wait


class PVector:
    """own: [P, n_own_pad]; ghost: [P, n_ghost_pad]."""

    def __init__(
        self,
        own: torch.Tensor,
        ghost: torch.Tensor,
        layout: VectorLayout,
        backend: Backend,
    ):
        self.own = own
        self.ghost = ghost
        self.layout = layout
        self.backend = backend

    @property
    def dtype(self) -> torch.dtype:
        return self.own.dtype

    @property
    def n_global(self) -> int:
        return self.layout.pr.n_global

    def copy(self) -> "PVector":
        return PVector(self.own, self.ghost, self.layout, self.backend)

    # -- arithmetic on own and ghost values (the reference's operators,
    # pvector.py:118-160); padding lanes stay zero
    def _binary(self, other, f, keeps_zero: bool = False) -> "PVector":
        if isinstance(other, PVector):
            return PVector(f(self.own, other.own), f(self.ghost, other.ghost), self.layout,
                           self.backend)
        own, ghost = f(self.own, other), f(self.ghost, other)
        if not keeps_zero:  # a scalar reaches the padding: mask it again
            own = torch.where(_own_mask(self.layout, own.device, self.backend), own, 0)
            ghost = torch.where(_ghost_mask(self.layout, ghost.device, self.backend), ghost, 0)
        return PVector(own, ghost, self.layout, self.backend)

    def __add__(self, o) -> "PVector":
        return self._binary(o, torch.add)

    __radd__ = __add__

    def __sub__(self, o) -> "PVector":
        return self._binary(o, torch.sub)

    def __rsub__(self, o) -> "PVector":
        return self._binary(o, lambda a, b: b - a)

    def __mul__(self, o) -> "PVector":
        return self._binary(o, torch.mul, keeps_zero=True)

    __rmul__ = __mul__

    def __truediv__(self, o) -> "PVector":
        if isinstance(o, PVector):  # padding lanes: 0 / 1, not 0 / 0
            lay = self.layout
            mo = _own_mask(lay, self.own.device, self.backend)
            mg = _ghost_mask(lay, self.own.device, self.backend)
            return PVector(torch.where(mo, self.own / torch.where(mo, o.own, 1), 0),
                           torch.where(mg, self.ghost / torch.where(mg, o.ghost, 1), 0),
                           lay, self.backend)
        return self._binary(o, torch.div, keeps_zero=True)

    def __neg__(self) -> "PVector":
        return PVector(-self.own, -self.ghost, self.layout, self.backend)

    def own_values(self) -> List[Optional[np.ndarray]]:
        """Each part's own values, on the host (None for a part of another
        process)."""
        return _host_parts(self.own, self.layout.n_own, self.backend)

    def ghost_values(self) -> List[Optional[np.ndarray]]:
        """Each part's ghost values, on the host (None for a part of
        another process)."""
        return _host_parts(self.ghost, self.layout.n_ghost, self.backend)

    def local_values(self) -> List[Optional[np.ndarray]]:
        """Each part's own and ghost values in its local order, on the host
        (None for a part of another process)."""
        return [None if o is None else li._permuted(np.concatenate([o, g]))
                for li, o, g in zip(self.layout.pr.parts, self.own_values(), self.ghost_values())]

    def __repr__(self):
        return (
            f"PVector(n_global={self.n_global}, P={self.layout.n_parts}, "
            f"dtype={self.own.dtype}, device={self.own.device})"
        )


def _host_parts(t: torch.Tensor, sizes, backend) -> List[Optional[np.ndarray]]:
    """Per-part host views of a stacked ``[P_local, n_pad]`` tensor, the
    first ``sizes[p]`` lanes of each local part, None for the others."""
    h = t.cpu().numpy()
    out: List[Optional[np.ndarray]] = [None] * len(sizes)
    for k, p in enumerate(backend.local_parts()):
        out[p] = h[k, : sizes[p]]
    return out


def pfill(value, pr: PRange, backend, dtype=torch.float32, device="cuda") -> PVector:
    lay = layout_of(pr)
    dt = torch_dtype(dtype)
    own = torch.where(_own_mask(lay, device, backend),
                      torch.tensor(value, dtype=dt, device=device), 0).to(dt)
    ghost = torch.where(_ghost_mask(lay, device, backend),
                        torch.tensor(value, dtype=dt, device=device), 0).to(dt)
    return PVector(own, ghost, lay, backend)


def pzeros(pr: PRange, backend, dtype=torch.float32, device="cuda") -> PVector:
    return pfill(0, pr, backend, dtype, device)


def pones(pr: PRange, backend, dtype=torch.float32, device="cuda") -> PVector:
    return pfill(1, pr, backend, dtype, device)


def pvector_from_own(
    own_parts: Sequence[np.ndarray], pr: PRange, backend, dtype=None, device="cuda"
) -> PVector:
    """Build from per-part own values (host arrays); ghosts start at zero.
    On a multi-process backend only the local parts' values are read (the
    others may be None)."""
    lay = layout_of(pr)
    local = backend.local_parts()
    parts = [np.asarray(own_parts[p]) for p in local]
    np_dtype = numpy_dtype(dtype if dtype is not None else parts[0].dtype)
    own = np.zeros((len(local), lay.n_own_pad), dtype=np_dtype)
    for k, o in enumerate(parts):
        own[k, : o.size] = o
    dt = torch_dtype(np_dtype)
    ghost = torch.zeros((len(local), lay.n_ghost_pad), dtype=dt, device=device)
    return PVector(torch.from_numpy(own).to(device), ghost, lay, backend)


def pvector_layout(pr: PRange) -> VectorLayout:
    return layout_of(pr)


def _random(draw, generator: torch.Generator, pr: PRange, backend, dtype, device) -> PVector:
    """Own values drawn by ``draw`` on the generator's device, padding
    zeroed, then made consistent (the ghosts take their owners' values)."""
    lay = layout_of(pr)
    dt = torch_dtype(dtype)
    n = len(backend.local_parts())
    own = draw((n, lay.n_own_pad), generator=generator, dtype=dt,
               device=generator.device).to(device)
    own = torch.where(_own_mask(lay, own.device, backend), own, torch.zeros_like(own))
    ghost = torch.zeros((n, lay.n_ghost_pad), dtype=dt, device=device)
    return consistent(PVector(own, ghost, lay, backend)).wait()


def prand(generator: torch.Generator, pr: PRange, backend, dtype=torch.float32,
          device="cuda") -> PVector:
    """Own values uniform on [0, 1) from ``generator`` (drawn on its device,
    then moved to ``device``), ghosts consistent."""
    return _random(torch.rand, generator, pr, backend, dtype, device)


def prandn(generator: torch.Generator, pr: PRange, backend, dtype=torch.float32,
           device="cuda") -> PVector:
    """Own values standard normal from ``generator``, ghosts consistent."""
    return _random(torch.randn, generator, pr, backend, dtype, device)


def pvector_local(I_parts, V_parts, rows, backend, dtype=None, device="cuda") -> PVector:
    """The disassembled COO vector assembled on the row partition (no new
    ghosts): every part's (global id, value) contributions summed on their
    owners, each owner adding the parts' contributions in part order.  A
    process gives the contributions of its own parts only (the others may
    be None); those whose owner lives in another process travel as host
    messages (``parallel/host_exchange.py``), the rest stay in the
    process."""
    from .parallel.host_exchange import exchange_part_messages

    pr = rows if isinstance(rows, PRange) else PRange(list(rows))
    P = pr.n_parts
    local = backend.local_parts()
    if any(I_parts[p] is None or V_parts[p] is None for p in local):
        raise ValueError("pvector_local: a local part's contributions are missing")
    np_dtype = numpy_dtype(np.asarray(V_parts[local[0]]).dtype if dtype is None else dtype)
    lay = layout_of(pr)
    msgs = {}
    for p in local:
        I = np.asarray(I_parts[p], dtype=INT)
        V = np.asarray(V_parts[p], dtype=np_dtype)
        o = find_owner(pr.parts, [I])[0]
        order = np.argsort(o, kind="stable")
        bounds = np.searchsorted(o[order], np.arange(P + 1))
        for d in range(P):
            seg = order[bounds[d]:bounds[d + 1]]
            if seg.size:
                msgs[(p, d)] = (I[seg], V[seg])
    got = exchange_part_messages(backend, P, msgs, (INT, np_dtype))
    own = np.zeros((len(local), lay.n_own_pad), dtype=np_dtype)
    for (src, d) in sorted(got, key=lambda k: (k[1], k[0])):
        gid, val = got[(src, d)]
        np.add.at(own[d - local[0]], pr.parts[d].global_to_own(gid), val)
    ghost = torch.zeros((len(local), lay.n_ghost_pad), dtype=torch_dtype(np_dtype),
                        device=device)
    return PVector(torch.from_numpy(own).to(device), ghost, lay, backend)


def pvector_from_local(local_parts: Sequence[np.ndarray], pr: PRange, backend,
                       device="cuda") -> PVector:
    """Build from per-part local values (own and ghost, in local order)."""
    lay = layout_of(pr)
    local = backend.local_parts()
    parts = {p: np.asarray(local_parts[p]) for p in local}
    dt = np.result_type(*[lv.dtype for lv in parts.values()])
    own = np.zeros((len(local), lay.n_own_pad), dtype=dt)
    ghost = np.zeros((len(local), lay.n_ghost_pad), dtype=dt)
    for k, p in enumerate(local):
        li, lv = pr.parts[p], parts[p]
        own[k, : li.n_own] = lv[li.own_to_local()]
        ghost[k, : li.n_ghost] = lv[li.ghost_to_local()]
    return PVector(torch.from_numpy(own).to(device), torch.from_numpy(ghost).to(device), lay,
                   backend)


def split_vector_blocks(x: PVector):
    """The stacked (own, ghost) blocks."""
    return x.own, x.ghost


def split_vector(x: PVector) -> PVector:
    """The split form of ``x``: its storage always is."""
    return x


def pvector_from_split_blocks(own: torch.Tensor, ghost: torch.Tensor, pr: PRange,
                              backend) -> PVector:
    """Adopt stacked ``own[P, n_own_pad]`` and ``ghost[P, n_ghost_pad]``
    tensors as a vector on ``pr``."""
    lay = layout_of(pr)
    n = len(backend.local_parts())
    if tuple(own.shape) != (n, lay.n_own_pad) or tuple(ghost.shape) != (n, lay.n_ghost_pad):
        raise ValueError(f"blocks {tuple(own.shape)}, {tuple(ghost.shape)} for {lay}")
    return PVector(own, ghost, lay, backend)


def find_local_indices(mask: PVector):
    """The sub-partition of the ids whose own value in ``mask`` is nonzero,
    renumbered part by part in own order, and the map from old global id
    to new (-1 where not selected): (PRange, new_of_old)."""
    pr = mask.layout.pr
    sel = [np.asarray(v) != 0 for v in mask.own_values()]
    counts = [int(s.sum()) for s in sel]
    starts = np.zeros(len(counts) + 1, dtype=INT)
    np.cumsum(counts, out=starts[1:])
    new_of_old = np.full(pr.n_global, -1, dtype=INT)
    for li, s, start in zip(pr.parts, sel, starts[:-1]):
        new_of_old[li.own_to_global[s]] = np.arange(start, start + int(s.sum()), dtype=INT)

    def g2owner(q):
        q = np.asarray(q, dtype=INT)
        own = np.clip(np.searchsorted(starts, np.clip(q, 0, None), side="right") - 1,
                      0, len(counts) - 1)
        return np.where(q >= 0, own, -1)

    parts = []
    for li, s in zip(pr.parts, sel):
        kept = new_of_old[li.ghost_to_global] >= 0
        parts.append(LocalIndices(
            int(starts[-1]), li.part, li.n_parts, new_of_old[li.own_to_global[s]],
            new_of_old[li.ghost_to_global[kept]], li.ghost_to_owner[kept],
            global_to_owner=g2owner))
    return PRange(parts), new_of_old


def renumber_pvector(x: PVector, backend=None) -> PVector:
    """The same own values on the renumbered partition
    (``renumber_partition``: each part's own ids consecutive)."""
    new_pr = PRange(renumber_partition(x.layout.pr.parts))
    return pvector_from_own(x.own_values(), new_pr, backend or x.backend, device=x.own.device)


def repartition(x: PVector, new_rows: PRange, backend=None) -> PVector:
    """``x``'s own values moved onto the partition ``new_rows`` of the same
    ids (ghosts zero), by one exchange; the plan is built once per pair of
    partitions and kept on the source partition."""
    pr_from = x.layout.pr
    plan = pr_from._repartition_plans.get(new_rows)
    if plan is None:
        plan = pr_from._repartition_plans[new_rows] = repartition_plan(pr_from, new_rows)
    lay = layout_of(new_rows)
    n = x.own.shape[0]
    own = plan.apply(x.own, x.own.new_zeros((n, lay.n_own_pad)), "set", x.backend)
    ghost = x.own.new_zeros((n, lay.n_ghost_pad))
    return PVector(own, ghost, lay, backend or x.backend)


class PVectorAssemblyCache:
    """The frozen plan of a COO vector: the ghosted layout, each part's own
    and ghost scatter positions, the assemble flag and the values' dtype.
    A refill is one scatter-add per part and the assemble exchange, no
    ``find_owner`` or ``union_ghost``."""

    def __init__(self, layout: VectorLayout, backend, positions, assemble_result: bool, dtype,
                 device):
        self.layout = layout
        self.backend = backend
        self.positions = positions  # per part: (own slots, own mask, ghost slots, ghost mask)
        self.assemble_result = assemble_result
        self.dtype = np.dtype(dtype)
        self.device = device


def pvector(I_parts, V_parts, rows, backend, assemble_result: bool = True, dtype=None,
            reuse: bool = False, device="cuda"):
    """The COO constructor: per-part (global id, value) contributions,
    summed.  An id owned by another part lands in a ghost slot (the
    partition gains it as a ghost, by ``union_ghost``) and, with
    ``assemble_result``, is then added to its owner.  ``reuse=True``
    returns ``(v, cache)`` for ``pvector_refill``."""
    pr = rows if isinstance(rows, PRange) else PRange(list(rows))
    owners = find_owner(pr.parts, I_parts)
    pr2 = PRange([
        li.union_ghost(np.asarray(g)[o != li.part], o[o != li.part])
        for li, g, o in zip(pr.parts, I_parts, owners)
    ])
    lay = layout_of(pr2)
    np_dtype = numpy_dtype(np.asarray(V_parts[0]).dtype if dtype is None else dtype)
    positions = []
    for li, gids in zip(pr2.parts, I_parts):
        po = li.global_to_own(gids)
        pg = li.global_to_ghost(gids)
        positions.append((po[po >= 0], po >= 0, pg[pg >= 0], pg >= 0))
    cache = PVectorAssemblyCache(lay, backend, positions, assemble_result, np_dtype, device)
    v = _assemble_parts(V_parts, cache)
    return (v, cache) if reuse else v


def _assemble_parts(V_parts, cache: PVectorAssemblyCache) -> PVector:
    """The vector of contributions ``V_parts`` at the cached positions, in
    the cache's dtype (summed in the contributions' own dtype per part, as
    the build does)."""
    lay = cache.layout
    own = np.zeros((lay.n_parts, lay.n_own_pad), dtype=cache.dtype)
    ghost = np.zeros((lay.n_parts, lay.n_ghost_pad), dtype=cache.dtype)
    for p, ((po, mo, pg, mg), vals) in enumerate(zip(cache.positions, V_parts)):
        vals = np.asarray(vals)
        li = lay.pr.parts[p]
        o = np.zeros(li.n_own, dtype=vals.dtype)
        g = np.zeros(li.n_ghost, dtype=vals.dtype)
        np.add.at(o, po, vals[mo])
        np.add.at(g, pg, vals[mg])
        own[p, : li.n_own] = o
        ghost[p, : li.n_ghost] = g
    dev = cache.device
    v = PVector(torch.from_numpy(own).to(dev), torch.from_numpy(ghost).to(dev), lay, cache.backend)
    return assemble(v).wait() if cache.assemble_result else v


def pvector_refill(V_parts, cache: PVectorAssemblyCache) -> PVector:
    """The COO vector of new contributions at the structure of
    ``pvector(..., reuse=True)``: a scatter-add through the cached
    positions and the assemble exchange.  The values keep the cache's
    dtype; contributions of a wider type (float64 into a float32 vector)
    raise instead of being rounded silently."""
    for vals in V_parts:
        if np.result_type(np.asarray(vals).dtype, cache.dtype) != cache.dtype:
            raise TypeError(
                f"pvector_refill: {np.asarray(vals).dtype} values into a {cache.dtype} vector"
            )
    return _assemble_parts(V_parts, cache)


def consistent(v: PVector) -> Task:
    """Ghost values set from their owners' own values (one exchange)."""
    lay = v.layout
    if lay.n_ghost_pad == 0 or lay.consistent_plan.n_rounds == 0:
        return Task(v)
    ghost = lay.consistent_plan.apply(v.own, v.ghost, "set", v.backend)
    return Task(PVector(v.own, ghost, lay, v.backend))


def assemble(v: PVector) -> Task:
    """Ghost values added to their owners' own values, ghosts zeroed (one
    exchange)."""
    lay = v.layout
    if lay.n_ghost_pad == 0 or lay.assemble_plan.n_rounds == 0:
        return Task(v)
    own = lay.assemble_plan.apply(v.ghost, v.own, "add", v.backend)
    return Task(PVector(own, torch.zeros_like(v.ghost), lay, v.backend))


def collect(x: PVector) -> np.ndarray:
    """The whole vector on the host, in global order (on several processes
    the own values are all-gathered: COLLECTIVE)."""
    from .parallel.host_exchange import allgather_part_arrays

    own = x.own_values()
    if x.backend.is_multiprocess:
        own = allgather_part_arrays(
            x.backend, x.layout.n_parts,
            {p: v for p, v in enumerate(own) if v is not None}, numpy_dtype(x.dtype))
    out = np.zeros(x.n_global, dtype=numpy_dtype(x.dtype))
    for li, vals in zip(x.layout.pr.parts, own):
        out[li.own_to_global] = vals
    return out


def _own_mask(layout: VectorLayout, device, backend=None) -> torch.Tensor:
    """[P_local, n_own_pad] True on the own lanes, False on the padding
    (every part's without a backend)."""
    n = layout.n_own if backend is None else layout.n_own[backend.part_slice]
    n = torch.as_tensor(n, device=device)
    return torch.arange(layout.n_own_pad, device=device)[None, :] < n[:, None]


def _ghost_mask(layout: VectorLayout, device, backend=None) -> torch.Tensor:
    """[P_local, n_ghost_pad] True on the ghost lanes, False on the padding
    (every part's without a backend)."""
    n = layout.n_ghost if backend is None else layout.n_ghost[backend.part_slice]
    n = torch.as_tensor(n, device=device)
    return torch.arange(layout.n_ghost_pad, device=device)[None, :] < n[:, None]


def pdot(x: PVector, y: PVector) -> torch.Tensor:
    """Global dot product over own values, as a 0-d tensor on the device."""
    return x.backend.psum((x.own * y.own).sum(dim=1))


def pnorm(x: PVector) -> torch.Tensor:
    return torch.sqrt(pdot(x, x))


def axpy(a, x: PVector, y: PVector) -> PVector:
    """y + a*x on own and ghost values."""
    return PVector(y.own + a * x.own, y.ghost + a * x.ghost, y.layout, y.backend)


# -- reductions and distances over own values (0-d tensors on the device) ---

def psum_reduce(x: PVector) -> torch.Tensor:
    return x.backend.allreduce(x.own.sum())


def pmaximum(x: PVector) -> torch.Tensor:
    m = _own_mask(x.layout, x.own.device, x.backend)
    return x.backend.allreduce(
        torch.where(m, x.own, torch.full_like(x.own, -torch.inf)).max(), "max")


def pminimum(x: PVector) -> torch.Tensor:
    m = _own_mask(x.layout, x.own.device, x.backend)
    return x.backend.allreduce(
        torch.where(m, x.own, torch.full_like(x.own, torch.inf)).min(), "min")


def pany(x: PVector, pred=lambda v: v != 0) -> bool:
    hit = (_own_mask(x.layout, x.own.device, x.backend) & pred(x.own)).any()
    return bool(x.backend.allreduce(hit.to(torch.int32), "max"))


def pall(x: PVector, pred=lambda v: v != 0) -> bool:
    ok = (~_own_mask(x.layout, x.own.device, x.backend) | pred(x.own)).all()
    return bool(x.backend.allreduce(ok.to(torch.int32), "min"))


def peuclidean(x: PVector, y: PVector) -> torch.Tensor:
    return torch.sqrt(psqeuclidean(x, y))


def psqeuclidean(x: PVector, y: PVector) -> torch.Tensor:
    d = x.own - y.own
    return x.backend.allreduce((d * d).sum())


def pcityblock(x: PVector, y: PVector) -> torch.Tensor:
    return x.backend.allreduce((x.own - y.own).abs().sum())


def pchebyshev(x: PVector, y: PVector) -> torch.Tensor:
    return x.backend.allreduce((x.own - y.own).abs().max(), "max")


def pdistance(x: PVector, y: PVector, eval_op, reduce: str = "sum", eval_end=None):
    """A metric over own values: ``eval_op(a, b)`` elementwise on the own
    tensors, reduced by "sum", "max" or "min" (padding lanes masked with
    the reduction's identity), then ``eval_end`` of the result."""
    fill = {"sum": 0.0, "max": -torch.inf, "min": torch.inf}.get(reduce)
    if fill is None:
        raise ValueError(f"reduce must be sum/max/min, got {reduce!r}")
    vals = eval_op(x.own, y.own)
    vals = torch.where(_own_mask(x.layout, vals.device, x.backend), vals,
                       torch.full_like(vals, fill))
    s = x.backend.allreduce({"sum": torch.sum, "max": torch.max, "min": torch.min}[reduce](vals),
                            reduce)
    return eval_end(s) if eval_end is not None else s


# -- df64 (two-float) pairs ---------------------------------------------------

DFPair = Tuple[PVector, PVector]


def _pair_on(hi: torch.Tensor, lo: torch.Tensor, layout: VectorLayout, backend) -> DFPair:
    """(hi, lo) own words -> a pair of PVectors with zero float32 ghosts."""
    zg = hi.new_zeros((hi.shape[0], layout.n_ghost_pad))
    return PVector(hi, zg, layout, backend), PVector(lo, zg, layout, backend)


def pvector_df64(
    own_f64_parts: Sequence[np.ndarray], pr: PRange, backend, device="cuda"
) -> DFPair:
    """(hi, lo) PVector pair from per-part float64 own values (exact split,
    on ``device``)."""
    lay = layout_of(pr)
    local = backend.local_parts()
    own = np.zeros((len(local), lay.n_own_pad), dtype=np.float64)
    for k, p in enumerate(local):
        o = np.asarray(own_f64_parts[p], dtype=np.float64)
        own[k, : o.size] = o
    hi, lo = df.from_f64(torch.from_numpy(own).to(device))
    return _pair_on(hi, lo, lay, backend)


def pvector_split_df64(v: PVector) -> DFPair:
    """Split a PVector's own values into a df64 pair, on its device."""
    hi, lo = df.from_f64(v.own)
    return _pair_on(hi, lo, v.layout, v.backend)


def collect_df64(pair: DFPair) -> np.ndarray:
    """A df64 pair as one host float64 array in global order (exact)."""
    vh, vl = pair
    own = df.to_f64(vh.own, vl.own).cpu().numpy()
    out = np.zeros(vh.n_global, dtype=np.float64)
    for p, part in enumerate(vh.layout.pr.parts):
        out[part.own_to_global] = own[p, : part.n_own]
    return out


def pdot_df64(x_pair: DFPair, y_pair: DFPair):
    """Compensated global dot of two df64 pairs -> (hi, lo) 0-d tensors."""
    (xh, xl), (yh, yl) = x_pair, y_pair
    return df.dot_parts((xh.own, xl.own), (yh.own, yl.own))


def pnorm_df64(x_pair: DFPair):
    """Compensated 2-norm of a df64 pair -> (hi, lo) 0-d tensors."""
    return df.sqrt(pdot_df64(x_pair, x_pair))


def axpy_df64(alpha, x_pair: DFPair, y_pair: DFPair) -> DFPair:
    """y + alpha*x on df64 pairs.  ``alpha``: a (hi, lo) pair of 0-d
    tensors, a Python number (split exactly from float64) or a tensor
    (taken as float32 with a zero lo word)."""
    (xh, xl), (yh, yl) = x_pair, y_pair
    dev = yh.own.device
    if not (isinstance(alpha, tuple) and len(alpha) == 2):
        if isinstance(alpha, (int, float, np.floating)):
            alpha = df.from_f64(torch.tensor(float(alpha), dtype=torch.float64, device=dev))
        else:
            a = torch.as_tensor(alpha, dtype=torch.float32, device=dev)
            alpha = (a, torch.zeros_like(a))
    oh, ol = df.add((yh.own, yl.own), df.scale((xh.own, xl.own), alpha))
    return _pair_on(oh, ol, yh.layout, yh.backend)
