"""Cross-process host messages of the setup algebra.

Counterpart of ``partitionedarrays_tpu/parallel/host_exchange.py``
(``exchange_part_messages`` :114, ``allgather_part_arrays`` :297).  The
setup operations (the owner shuffle of COO triplets, the matrix assemble
and consistent replies, the Galerkin products, repartition) hold each
process's parts only and exchange ragged part-to-part host messages:

- one process (``SerialBackend``, or a ``MeshBackend`` of one process):
  the messages are passed through as they are;
- several processes: only the messages whose destination part lives on
  another process go on the wire.  The cross messages are edge-colored
  (``exchange_plan.color_edges``) into rounds in which a part sends at most
  one message and receives at most one, and each round's messages are
  padded to the largest message of that round, so the bytes on the wire
  stay O(surface).  They travel as gloo point-to-point messages of host
  bytes.  The edge list itself (source, destination, length) is
  all-gathered: O(P x degree) integers.

The reference splits int64 into int32 words and bit-casts float64 because
JAX runs with 64-bit types off; here every field travels as its own bytes.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .exchange_plan import _round_up, color_edges


def _is_multiprocess(backend) -> bool:
    return bool(getattr(backend, "is_multiprocess", False))


def _pack(fields: Sequence[np.ndarray], dtypes: Sequence[np.dtype], K: int) -> np.ndarray:
    """The fields of one message, each padded to K entries, as bytes."""
    out = np.zeros(K * sum(d.itemsize for d in dtypes), dtype=np.uint8)
    off = 0
    for f, dt in zip(fields, dtypes):
        a = np.ascontiguousarray(np.asarray(f, dtype=dt))
        out[off: off + a.nbytes] = a.view(np.uint8)
        off += K * dt.itemsize
    return out


def _unpack(buf: np.ndarray, dtypes: Sequence[np.dtype], K: int, n: int):
    off = 0
    fields = []
    for dt in dtypes:
        fields.append(buf[off: off + K * dt.itemsize].view(dt)[:n].copy())
        off += K * dt.itemsize
    return tuple(fields)


def exchange_part_messages(
    backend,
    P: int,
    msgs: Dict[Tuple[int, int], Tuple[np.ndarray, ...]],
    dtypes: Sequence,
    stats: Optional[dict] = None,
) -> Dict[Tuple[int, int], Tuple[np.ndarray, ...]]:
    """Deliver part-to-part host messages.  ``msgs[(src, dst)]``: a tuple
    of equal-length arrays (one per entry of ``dtypes``) made in this
    process for a local ``src``.  Returns the messages whose ``dst`` is
    local, in the same form; an absent key is an empty message.  COLLECTIVE
    on several processes.  ``stats`` receives this process's wire cost:
    ``wire_bytes`` and ``wire_entries`` (sent and received, padding
    included), ``n_rounds`` and ``cross_msgs`` (all processes' cross
    messages)."""
    dtypes = [np.dtype(d) for d in dtypes]
    local = set(backend.local_parts())
    for (s, d), fields in msgs.items():
        if s not in local:
            raise ValueError(f"message from non-local part {s}")
        if len(fields) != len(dtypes):
            raise ValueError("message field count != dtypes")
    if stats is not None:
        stats.update(wire_bytes=0, wire_entries=0, n_rounds=0, cross_msgs=0)
    if not _is_multiprocess(backend):
        return dict(msgs)
    import torch.distributed as dist

    out = {k: v for k, v in msgs.items() if k[1] in local}
    cross = {k: v for k, v in msgs.items() if k[1] not in local and len(v[0])}
    mine = sorted((s, d, int(len(f[0]))) for (s, d), f in cross.items())
    edges = sorted(e for lst in backend.allgather_object(mine) for e in lst)
    if stats is not None:
        stats["cross_msgs"] = len(edges)
    if not edges:
        return out
    colors = color_edges([(s, d) for s, d, _ in edges])
    n_rounds = max(colors) + 1
    K = [0] * n_rounds
    for (s, d, n), c in zip(edges, colors):
        K[c] = max(K[c], n)
    K = [_round_up(k, 8) for k in K]
    row_bytes = sum(dt.itemsize for dt in dtypes)
    work, recvs = [], []
    for (s, d, n), c in zip(edges, colors):
        tag = c * P + d
        if s in local:
            buf = torch.from_numpy(_pack(cross[(s, d)], dtypes, K[c]))
            work.append(dist.isend(buf, dst=backend.rank_of(d), tag=tag))
        elif d in local:
            buf = torch.empty(K[c] * row_bytes, dtype=torch.uint8)
            work.append(dist.irecv(buf, src=backend.rank_of(s), tag=tag))
            recvs.append((s, d, n, K[c], buf))
        else:
            continue
        if stats is not None:
            stats["wire_bytes"] += K[c] * row_bytes
            stats["wire_entries"] += K[c] * len(dtypes)
    for w in work:
        w.wait()
    for s, d, n, k, buf in recvs:
        out[(s, d)] = _unpack(buf.numpy(), dtypes, k, n)
    if stats is not None:
        stats["n_rounds"] = n_rounds
    return out


def allgather_part_arrays(
    backend,
    P: int,
    arrs: Dict[int, np.ndarray],
    dtype,
    stats: Optional[dict] = None,
) -> List[np.ndarray]:
    """Replicate ragged per-part host arrays (metadata: ghost id lists and
    the like) to every process.  Each part's array is given by the process
    that holds it; returns the full per-part list, the same on every
    process (a part nobody gave is empty).  COLLECTIVE on several
    processes."""
    dtype = np.dtype(dtype)
    z = np.zeros(0, dtype=dtype)
    if not _is_multiprocess(backend):
        return [np.asarray(arrs.get(p, z), dtype=dtype) for p in range(P)]
    mine = {int(p): np.asarray(a, dtype=dtype) for p, a in arrs.items()}
    got: Dict[int, np.ndarray] = {}
    for part_arrs in backend.allgather_object(mine):
        got.update(part_arrs)
    if stats is not None:
        stats["allgather_bytes"] = stats.get("allgather_bytes", 0) + sum(
            a.nbytes for a in got.values())
    return [got.get(p, z) for p in range(P)]
