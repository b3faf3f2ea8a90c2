"""Backends: where the parts of a partitioned object live.

Counterpart of ``partitionedarrays_tpu/backends.py``.  The JAX package
drives per-part functions through ``vmap`` (``SerialBackend``) or
``shard_map`` over a device mesh (``MeshBackend``, multi-controller
``jax.distributed`` across processes).  Here the part axis is simply dim 0
of every tensor and code is written over the stacked tensors directly:

- ``SerialBackend``: every part in this process, ``[P, ...]`` tensors on
  one device.  A reduction over parts (``psum``) is a sum over dim 0, and
  a halo exchange is an index along dim 0 (``parallel/exchange_plan.py``).
- ``MeshBackend``: the parts split among the processes of a
  ``torch.distributed`` group in contiguous blocks (process r holds parts
  ``[r P / W, (r+1) P / W)``, the order in which the reference's mesh gives
  devices to processes).  A process holds only its own parts' values,
  stacked ``[P_local, ...]`` on its device; host metadata (``PRange``,
  layouts, exchange plans) is replicated.  ``psum`` sums the local parts,
  then all-reduces across processes.

The transport is gloo, whose point-to-point calls take no CUDA tensors: the
messages are staged through host tensors (``stage``), while the kernels run
on the card.  NCCL does not run two ranks on one card (ROADMAP).
"""
from __future__ import annotations

import datetime
import os
import sys
import traceback
from typing import Callable, Optional, Sequence

import numpy as np
import torch

AXIS = "parts"


class Backend:
    """Base: ``n_parts`` parts, some of them in this process."""

    kind = "base"
    n_parts: int
    is_multiprocess = False

    def local_parts(self) -> list:
        """The parts whose values live in this process, in order."""
        return list(range(self.n_parts))

    @property
    def part_slice(self) -> slice:
        """The local parts as a slice of the part axis."""
        parts = self.local_parts()
        return slice(parts[0], parts[-1] + 1) if parts else slice(0, 0)

    def rank_of(self, part: int) -> int:
        """The process that holds ``part``."""
        return 0

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of per-part values ``x[P_local, ...]`` over all parts."""
        return self.allreduce(x.sum(dim=0))

    def allreduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``x`` reduced across the processes ("sum", "max" or "min")."""
        return x

    def allgather_object(self, obj) -> list:
        """Every process's ``obj``, in rank order."""
        return [obj]

    def barrier(self) -> None:
        pass


class SerialBackend(Backend):
    """``n_parts`` parts stacked along dim 0 of every tensor."""

    kind = "serial"

    def __init__(self, n_parts: int = 1):
        if n_parts < 1:
            raise ValueError(f"n_parts must be positive, got {n_parts}")
        self.n_parts = int(n_parts)

    def __repr__(self):
        return f"SerialBackend(n_parts={self.n_parts})"


_REDUCE_OPS = ("sum", "max", "min")


class MeshBackend(Backend):
    """``n_parts`` parts split among the processes of the default
    ``torch.distributed`` group (or of none: one process holds them all).
    ``n_parts`` defaults to one part per process."""

    kind = "mesh"

    def __init__(self, n_parts: Optional[int] = None):
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            self.rank, self.n_procs = dist.get_rank(), dist.get_world_size()
        else:
            self.rank, self.n_procs = 0, 1
        self.n_parts = int(n_parts if n_parts is not None else self.n_procs)
        if self.n_parts < self.n_procs:
            raise ValueError(f"{self.n_parts} parts on {self.n_procs} processes: a process "
                             "without parts")
        self._bounds = [(r * self.n_parts) // self.n_procs for r in range(self.n_procs + 1)]
        self._owner = np.repeat(np.arange(self.n_procs), np.diff(self._bounds))

    @property
    def is_multiprocess(self) -> bool:
        return self.n_procs > 1

    def local_parts(self) -> list:
        return list(range(self._bounds[self.rank], self._bounds[self.rank + 1]))

    def rank_of(self, part: int) -> int:
        return int(self._owner[part])

    def allreduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        if op not in _REDUCE_OPS:
            raise ValueError(f"allreduce: op must be one of {_REDUCE_OPS}, got {op!r}")
        if not self.is_multiprocess:
            return x
        import torch.distributed as dist

        h = stage(x)
        dist.all_reduce(h, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
                               "min": dist.ReduceOp.MIN}[op])
        return h.to(x.device)

    def allgather_object(self, obj) -> list:
        if not self.is_multiprocess:
            return [obj]
        import torch.distributed as dist

        out = [None] * self.n_procs
        dist.all_gather_object(out, obj)
        return out

    def barrier(self) -> None:
        if self.is_multiprocess:
            import torch.distributed as dist

            dist.barrier()

    def __repr__(self):
        return (f"MeshBackend(n_parts={self.n_parts}, multiprocess={self.is_multiprocess}, "
                f"rank={self.rank}/{self.n_procs})")


def stage(x: torch.Tensor) -> torch.Tensor:
    """A contiguous host copy of ``x`` for the gloo transport (which takes
    no CUDA tensors); a host tensor is copied too, so that the transport
    never writes into a caller's tensor."""
    return x.detach().to("cpu", copy=True).contiguous()


# -- entry points (the reference's with_debug / with_mpi analogues) ---------

def serial_backend(n_parts: int) -> SerialBackend:
    return SerialBackend(n_parts)


def mesh_backend(n_parts: Optional[int] = None) -> MeshBackend:
    return MeshBackend(n_parts)


def with_serial(f: Callable, n_parts: int):
    """Run ``f(backend)`` on the serial backend."""
    return f(SerialBackend(n_parts))


# parity alias: the reference's debug entry point
with_debug = with_serial


def with_mesh(f: Callable, n_parts: Optional[int] = None):
    """Run ``f(backend)`` on a mesh backend over the current process group
    (one process: every part local)."""
    return f(MeshBackend(n_parts))


def _abort(exc_type, exc, tb) -> None:
    """Print the exception and end the process at once with a nonzero code:
    the peers, blocked in the transport, see the closed connections and
    fail in turn (the analogue of ``MPI.Abort``)."""
    traceback.print_exception(exc_type, exc, tb)
    sys.stderr.flush()
    sys.stdout.flush()
    os._exit(1)


def with_multihost(
    f: Callable = None,
    *,
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    n_parts: Optional[int] = None,
    timeout: float = 60.0,
):
    """Multi-process entry point (the reference's ``with_multihost``, the
    analogue of PartitionedArrays' ``with_mpi``): joins the gloo process
    group at ``coordinator_address`` ("host:port", rank 0 listens there)
    as ``process_id`` of ``num_processes``, selects the card ``cuda:{rank
    % device_count}`` where there is one, and returns (or runs ``f`` on) a
    ``MeshBackend`` of ``n_parts`` parts (default: one per process).

    Failure semantics: an exception in ``f``, or an uncaught one after
    ``backend = with_multihost(...)``, prints its trace and ends the
    process with code 1 (``os._exit``); every peer then fails on its next
    message from that process instead of waiting, and a peer waiting on a
    live but stuck process fails after ``timeout`` seconds.  So one
    failing rank ends every rank nonzero and none hangs."""
    import torch.distributed as dist

    if coordinator_address is not None and not dist.is_initialized():
        if num_processes is None or process_id is None:
            raise ValueError("with_multihost: num_processes and process_id are needed with "
                             "a coordinator_address")
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator_address}", world_size=int(num_processes),
            rank=int(process_id), timeout=datetime.timedelta(seconds=timeout))
    if dist.is_initialized() and torch.cuda.is_available():
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    sys.excepthook = _abort
    backend = MeshBackend(n_parts)
    if f is None:
        return backend
    try:
        return f(backend)
    except BaseException:
        if isinstance(sys.exc_info()[1], SystemExit) and sys.exc_info()[1].code in (0, None):
            raise
        _abort(*sys.exc_info())


def stack_parts(parts: Sequence[np.ndarray], pad_to: Optional[int] = None, fill=0):
    """Stack ragged per-part host arrays into one padded [P, n_pad, ...] array."""
    parts = [np.asarray(p) for p in parts]
    n = pad_to if pad_to is not None else max((p.shape[0] for p in parts), default=0)
    trail = parts[0].shape[1:] if parts else ()
    out = np.full((len(parts), n) + trail, fill, dtype=parts[0].dtype if parts else np.float32)
    for i, p in enumerate(parts):
        out[i, : p.shape[0]] = p
    return out
