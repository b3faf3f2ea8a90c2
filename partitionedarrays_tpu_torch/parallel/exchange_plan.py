"""Padded vector layouts and halo-exchange plans.

Counterpart of ``partitionedarrays_tpu/parallel/exchange_plan.py``:
``color_edges``, ``_build_plan``, ``vector_exchange_plans`` and
``repartition_plan`` (:50-237) are copied, so that a plan's rounds
(``perms``) and padded index tables (``snd_idx``, ``rcv_idx``) equal the
reference's table for table.  A vector
on ``P`` parts is stored as ``own[P, n_own_pad]`` and ``ghost[P,
n_ghost_pad]`` with sizes padded to a multiple of 8 and the padding kept at
zero (``VectorLayout`` :243-293).

Parts in one process live on one device and each round only moves data
along dim 0, so ``ExchangePlan.apply`` does not run rounds between them: at
build time all rounds are folded into one pair of flat index tensors that
hold only the valid (source slot, destination slot) pairs, and an exchange
is one gather plus one ``index_copy_`` ("set") or ``index_add_`` ("add").
The padded tables keep the reference's out-of-range sentinel ``OOB`` for
their padding lanes; they stay host arrays, and no sentinel ever reaches
torch indexing (on the GPU an out-of-range index is a device assert, not a
fill).  On a multi-process backend the pairs that cross processes ride the
padded per-round tables as point-to-point messages (``_CrossPlan``).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..backends import SerialBackend, stage
from ..utils import profiling
from .partition import PRange, find_owner

# the reference's padding index: any index >= 2**31 - 2**8
OOB = np.int32(np.iinfo(np.int32).max - 255)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m if x > 0 else 0


def color_edges(edges: Sequence[Tuple[int, int]]) -> List[int]:
    """Greedy directed edge coloring: within one color, each node has at
    most one outgoing and at most one incoming edge."""
    out_used: dict = {}
    in_used: dict = {}
    colors = []
    for s, d in edges:
        su = out_used.setdefault(s, set())
        du = in_used.setdefault(d, set())
        c = 0
        while c in su or c in du:
            c += 1
        su.add(c)
        du.add(c)
        colors.append(c)
    return colors


class ExchangePlan:
    """A one-direction exchange from source slots into destination slots.

    - ``perms[r]``: the (source part, destination part) pairs of round r,
      completed to a full permutation as the reference does;
    - ``snd_idx[r]``, ``rcv_idx[r]``: int32 ``[P, K_r]`` host tables of the
      positions packed on the source and unpacked on the destination,
      padded with ``OOB``;
    - ``src_part``, ``src_pos``, ``dst_part``, ``dst_pos``: the valid pairs
      of all rounds, in round order (int64 host arrays).
    """

    def __init__(self, perms=(), snd_idx=(), rcv_idx=()):
        self.perms = tuple(tuple(tuple(int(v) for v in e) for e in p) for p in perms)
        self.snd_idx = tuple(np.asarray(a, dtype=np.int32) for a in snd_idx)
        self.rcv_idx = tuple(np.asarray(a, dtype=np.int32) for a in rcv_idx)
        if not len(self.perms) == len(self.snd_idx) == len(self.rcv_idx):
            raise ValueError("exchange plan: one snd_idx and rcv_idx table per round")
        sp, so, dp, do = [], [], [], []
        for r, perm in enumerate(self.perms):
            for s, d in perm:
                valid = self.rcv_idx[r][d] != OOB
                sp.append(np.full(int(valid.sum()), s, dtype=np.int64))
                so.append(self.snd_idx[r][s][valid].astype(np.int64))
                dp.append(np.full(int(valid.sum()), d, dtype=np.int64))
                do.append(self.rcv_idx[r][d][valid].astype(np.int64))
        cat = lambda xs: np.concatenate(xs) if xs else np.zeros(0, dtype=np.int64)
        self.src_part, self.src_pos = cat(sp), cat(so)
        self.dst_part, self.dst_pos = cat(dp), cat(do)
        if (self.src_pos == OOB).any():
            raise ValueError("exchange plan: a valid destination lane has no source")
        self._per_process: Dict[Tuple, "_CrossPlan"] = {}

    @property
    def n_rounds(self) -> int:
        return len(self.perms)

    def apply(
        self, src_vals: torch.Tensor, dst_vals: torch.Tensor, combine: str, backend=None
    ) -> torch.Tensor:
        """All rounds at once: the source slots' values of ``src_vals[P,
        n_src]`` are set into ("set", consistent) or added to ("add",
        assemble) the destination slots of a copy of ``dst_vals[P, n_dst]``,
        which is returned.  The tensors hold the parts of this process of
        ``backend`` (default: a serial backend, every part): pairs inside the
        process are one index op, and on a multi-process backend the pairs
        across processes travel as the padded rounds' messages
        (``_CrossPlan``).  An exchange with a round is counted, with the
        bytes this process sends, in ``profiling.COUNTS``, and a profiled one
        records the span ``exchange`` (attribute ``combine``)."""
        if combine not in ("add", "set"):
            raise ValueError(combine)
        if self.n_rounds == 0:
            return dst_vals
        if backend is None:
            backend = SerialBackend(self.snd_idx[0].shape[0])
        key = (tuple(backend.local_parts()), getattr(backend, "n_procs", 1),
               int(src_vals.shape[1]), int(dst_vals.shape[1]), src_vals.device)
        got = self._per_process.get(key)
        if got is None:
            got = self._per_process[key] = _CrossPlan(self, backend, src_vals.shape[1],
                                               dst_vals.shape[1], src_vals.device)
        profiling.count_exchange(combine, got.sent_entries * src_vals.element_size())
        with profiling.span("exchange", combine=combine):
            return got.apply(src_vals, dst_vals, combine)


def _scatter(dst_vals: torch.Tensor, dst: torch.Tensor, moved: torch.Tensor,
             combine: str) -> torch.Tensor:
    """A copy of ``dst_vals`` with ``moved`` set into or added to its flat
    positions ``dst``."""
    out = dst_vals.clone(memory_format=torch.contiguous_format)
    flat = out.view(-1)
    if combine == "add":
        flat.index_add_(0, dst, moved)
    else:
        # one owner per ghost: the destinations of "set" are unique
        flat.index_copy_(0, dst, moved)
    return out


class _CrossPlan:
    """An exchange plan on one process of a backend, for tensors
    ``[P_local, n]`` of the local parts (all of them on a serial backend,
    where there are no messages):

    - the pairs whose source and destination parts are both local: flat
      gather and scatter indices (all rounds folded into one index op);
    - each round's messages from a local part to a part of another process:
      the gather index of the message's K_r lanes (its valid lanes, then
      padding lanes that repeat the first, which the receiver ignores);
    - each round's messages to a local part from another process: where
      its valid lanes land.

    The messages are staged through host tensors, because gloo's
    point-to-point calls take no CUDA tensors; the tags are ``round * P +
    destination part`` (a part receives at most one message a round)."""

    def __init__(self, plan: ExchangePlan, backend, n_src: int, n_dst: int, device):
        if plan.src_pos.size and (plan.src_pos.max() >= n_src or plan.dst_pos.max() >= n_dst):
            raise ValueError(f"exchange plan: slots beyond the tensors ({n_src}, {n_dst})")
        self.backend = backend
        P = backend.n_parts
        local = backend.local_parts()
        lo = local[0]
        is_local = np.zeros(P, dtype=bool)
        is_local[local] = True
        both = is_local[plan.src_part] & is_local[plan.dst_part]
        src = (plan.src_part[both] - lo) * n_src + plan.src_pos[both]
        dst_local = (plan.dst_part[both] - lo) * n_dst + plan.dst_pos[both]
        send_idx, self.sends = [], []  # (destination rank, tag, lanes)
        recv_valid, recv_dst, self.recvs = [], [], []  # (source rank, tag, lanes)
        n_recv = 0
        for r, perm in enumerate(plan.perms):
            K = plan.snd_idx[r].shape[1]
            for s, d in perm:
                if is_local[s] == is_local[d]:
                    continue
                valid = plan.rcv_idx[r][d] != OOB
                nv = int(valid.sum())
                if nv == 0:
                    continue
                tag = r * P + d
                if is_local[s]:
                    lanes = plan.snd_idx[r][s][valid].astype(np.int64)
                    lanes = np.concatenate([lanes, np.full(K - nv, lanes[0], dtype=np.int64)])
                    send_idx.append((s - lo) * n_src + lanes)
                    self.sends.append((backend.rank_of(d), tag, K))
                else:
                    recv_valid.append(n_recv + np.flatnonzero(valid))
                    recv_dst.append((d - lo) * n_dst + plan.rcv_idx[r][d][valid].astype(np.int64))
                    self.recvs.append((backend.rank_of(s), tag, K))
                    n_recv += K
        cat = lambda xs: torch.from_numpy(
            np.concatenate(xs) if xs else np.zeros(0, dtype=np.int64)).to(device)
        self.src_local = cat([src])
        self.send_idx = cat(send_idx)
        self.recv_valid = cat(recv_valid)
        self.dst = cat([dst_local] + recv_dst)
        self.n_recv = n_recv
        self.wire_entries = int(sum(k for _, _, k in self.sends) + n_recv)
        # the entries this process's parts send: to local parts, and the
        # messages' lanes (padding included) to other processes
        self.sent_entries = int(src.size + sum(k for _, _, k in self.sends))

    def apply(self, src_vals: torch.Tensor, dst_vals: torch.Tensor, combine: str) -> torch.Tensor:
        flat_src = src_vals.reshape(-1)
        if not (self.sends or self.recvs):
            return _scatter(dst_vals, self.dst, flat_src.index_select(0, self.src_local),
                            combine)
        import torch.distributed as dist

        work = []
        if self.sends:
            out_host = stage(flat_src.index_select(0, self.send_idx))
            off = 0
            for rank, tag, K in self.sends:
                work.append(dist.isend(out_host[off: off + K], dst=rank, tag=tag))
                off += K
        in_host = torch.empty(self.n_recv, dtype=src_vals.dtype,
                              pin_memory=src_vals.device.type == "cuda")
        off = 0
        for rank, tag, K in self.recvs:
            work.append(dist.irecv(in_host[off: off + K], src=rank, tag=tag))
            off += K
        for w in work:
            w.wait()
        moved = flat_src.index_select(0, self.src_local)
        if self.recvs:
            got = in_host.to(src_vals.device, non_blocking=True)
            moved = torch.cat([moved, got.index_select(0, self.recv_valid)])
        return _scatter(dst_vals, self.dst, moved, combine)


def _build_plan(
    n_parts: int,
    edges: List[Tuple[int, int]],
    src_lists: List[np.ndarray],
    dst_lists: List[np.ndarray],
) -> ExchangePlan:
    """edges[e] = (source part, destination part); src_lists[e] = positions
    packed on the source; dst_lists[e] = positions unpacked on the
    destination (same order and length)."""
    colors = color_edges(edges)
    n_rounds = (max(colors) + 1) if colors else 0
    perms: List[List[Tuple[int, int]]] = [[] for _ in range(n_rounds)]
    K = [0] * n_rounds
    for e, c in enumerate(colors):
        perms[c].append(edges[e])
        K[c] = max(K[c], len(src_lists[e]))
    # complete each round to a full permutation; the added pairs' lanes are
    # all padding on the receiver
    for c in range(n_rounds):
        srcs = {s for s, _ in perms[c]}
        dsts = {d for _, d in perms[c]}
        free_s = [p for p in range(n_parts) if p not in srcs]
        free_d = [p for p in range(n_parts) if p not in dsts]
        perms[c] = perms[c] + list(zip(free_s, free_d))
    K = [_round_up(max(k, 1), 8) for k in K]
    snd = [np.full((n_parts, K[r]), OOB, dtype=np.int32) for r in range(n_rounds)]
    rcv = [np.full((n_parts, K[r]), OOB, dtype=np.int32) for r in range(n_rounds)]
    for e, c in enumerate(colors):
        s, d = edges[e]
        sl = np.asarray(src_lists[e], dtype=np.int32)
        dl = np.asarray(dst_lists[e], dtype=np.int32)
        snd[c][s, : sl.size] = sl
        rcv[c][d, : dl.size] = dl
    return ExchangePlan(perms, snd, rcv)


def vector_exchange_plans(pr: PRange) -> Tuple[ExchangePlan, ExchangePlan]:
    """(assemble_plan, consistent_plan) of a vector partitioned by ``pr``:
    assemble adds ghost values into their owners' own slots; consistent
    sets ghost slots from their owners' own values."""
    g = pr.assembly_graph()
    P = pr.n_parts
    edges: List[Tuple[int, int]] = []
    src_lists: List[np.ndarray] = []
    dst_lists: List[np.ndarray] = []
    rcv_ptr = [dict() for _ in range(P)]
    for o in range(P):
        for k, src in enumerate(g.neighbors_rcv[o]):
            rcv_ptr[o][src] = g.rcv_own[o][k]
    for j in range(P):
        for k, o in enumerate(g.neighbors_snd[j]):
            edges.append((j, o))
            src_lists.append(g.snd_ghost[j][k])
            dst_lists.append(rcv_ptr[o][j])
    assemble_plan = _build_plan(P, edges, src_lists, dst_lists)
    # consistent direction: reverse every edge, swap the index lists
    redges = [(d, s) for s, d in edges]
    consistent_plan = _build_plan(P, redges, dst_lists, src_lists)
    return assemble_plan, consistent_plan


def repartition_plan(pr_from: PRange, pr_to: PRange) -> ExchangePlan:
    """The plan that moves own values from one partition of a global range
    to another (``pvector.repartition``, combine "set"): for each target
    part, its own ids grouped by their owner on ``pr_from`` (a stable sort,
    so each group keeps the target's own order)."""
    if (pr_from.n_global, pr_from.n_parts) != (pr_to.n_global, pr_to.n_parts):
        raise ValueError(f"repartition: {pr_from} to {pr_to} (the same ids on as many parts)")
    edges: List[Tuple[int, int]] = []
    src_lists: List[np.ndarray] = []
    dst_lists: List[np.ndarray] = []
    for li_to in pr_to.parts:
        gids = li_to.own_to_global
        owners = find_owner(pr_from.parts, [gids])[0]
        order = np.argsort(owners, kind="stable")
        owners_s = owners[order]
        cuts = np.flatnonzero(np.diff(owners_s)) + 1
        for grp in np.split(np.arange(owners_s.size), cuts):
            if grp.size == 0:
                continue
            src = int(owners_s[grp[0]])
            src_pos = pr_from.parts[src].global_to_own(gids[order[grp]])
            if not (src_pos >= 0).all():
                raise ValueError("repartition: an id is not owned by its owner")
            edges.append((src, li_to.part))
            src_lists.append(src_pos)
            dst_lists.append(order[grp].astype(np.int64))
    return _build_plan(pr_from.n_parts, edges, src_lists, dst_lists)


class VectorLayout:
    """Padded sizes and exchange plans of vectors partitioned by ``pr``."""

    def __init__(self, pr: PRange, pad: int = 8):
        self.pr = pr
        self.n_parts = pr.n_parts
        self.n_own = np.array([p.n_own for p in pr.parts], dtype=np.int64)
        self.n_ghost = np.array([p.n_ghost for p in pr.parts], dtype=np.int64)
        self.n_own_pad = _round_up(int(self.n_own.max()), pad)
        self.n_ghost_pad = _round_up(int(self.n_ghost.max()), pad)
        self.assemble_plan, self.consistent_plan = vector_exchange_plans(pr)
        self.own_masks = {}  # pvector._own_mask's, by device and parts

    def __repr__(self):
        return (
            f"VectorLayout(P={self.n_parts}, n_own_pad={self.n_own_pad}, "
            f"n_ghost_pad={self.n_ghost_pad}, rounds="
            f"{self.assemble_plan.n_rounds})"
        )


def layout_of(pr: PRange) -> VectorLayout:
    """The layout of ``pr``, built once and kept on the range."""
    if pr._layout is None:
        pr._layout = VectorLayout(pr)
    return pr._layout
