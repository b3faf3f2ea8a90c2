"""Device traces, named regions, the port's spans and its counters, over
``torch.profiler``.

Counterpart of ``partitionedarrays_tpu/utils/profiling.py`` (``trace``,
``annotate``, ``device_memory_stats``), which wraps ``jax.profiler``: a
trace of the host and the card's kernels written as a Chrome trace (open it
in Perfetto or ``chrome://tracing``), regions that show around the
enclosed launches, and the card's allocator statistics.

The port's own instruments, one recorder:

- ``span(name, **attrs)`` marks a layer boundary of the port (a solve, a
  cycle level, a ghost exchange, a set-up phase).  It records only while a ``torch.profiler``
  session is active: whoever profiles gets the spans, and an unprofiled
  run pays one flag test and a shared no-op context.  A recorded span
  keeps its name, its attributes, its start and end on ``time.time_ns()``
  (the clock of an exported trace's ``baseTimeNanoseconds``), its parent,
  its request (the outermost span it runs in: one solve, one set) and the
  port's kernel launches between its enter and its exit.  ``spans()``
  returns them; ``trace()`` writes them into its ``trace.json``.
- ``COUNTS`` is the counter registry, always on: ``launches`` (every launch
  of a C entry, counted by ``_build.check``), ``launches.<entry>`` per
  entry name, and per ``combine`` of ``ExchangePlan.apply`` (``set`` or
  ``add``) ``exchanges.<combine>`` and ``exchange_bytes.<combine>``, the
  exchanges with at least one round and the bytes sent from this
  process's parts.

Spans are kept for the thread that runs the port's loops (they nest by one
stack); ``trace()`` starts each trace with none.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import Counter
from pathlib import Path
from typing import Iterator, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

# beside the package, in the directory git ignores (as the kernel builds)
DEFAULT_TRACE_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_trace"
SPAN_CAT = "pat_span"  # the Chrome trace category of the port's spans
SPAN_TID = 0  # their row in the trace, named "pat_span"

COUNTS: Counter = Counter()


def count_launch(entry: str) -> None:
    """One launch of the C entry ``entry``."""
    COUNTS["launches"] += 1
    COUNTS["launches." + entry] += 1


def count_exchange(combine: str, nbytes: int) -> None:
    """One exchange (``combine`` "set" or "add") that sent ``nbytes``."""
    COUNTS["exchanges." + combine] += 1
    COUNTS["exchange_bytes." + combine] += nbytes


def launches(entry: Optional[str] = None) -> int:
    """Launches of the C entry ``entry`` (None: of every entry) since the
    last ``reset_counts``."""
    return COUNTS["launches" if entry is None else "launches." + entry]


def reset_counts() -> None:
    """Set every counter to 0 (not inside an open span: its launch count
    would go negative)."""
    COUNTS.clear()


class Span:
    """One recorded span; times in ``time.time_ns()``, ``parent`` and
    ``request`` are indices into ``spans()`` (-1: no parent)."""

    __slots__ = ("name", "attrs", "start_ns", "end_ns", "parent", "request", "launches")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.start_ns = self.end_ns = None
        self.parent = self.request = -1
        self.launches = 0


_SPANS: List[Span] = []
_OPEN: List[int] = []  # indices of the open spans, outermost first
_OFF = contextlib.nullcontext()


class _Recording:
    __slots__ = ("span",)

    def __init__(self, span_: Span):
        self.span = span_

    def __enter__(self) -> Span:
        s = self.span
        i = len(_SPANS)
        if _OPEN:
            s.parent = _OPEN[-1]
            s.request = _SPANS[s.parent].request
        else:
            s.request = i
        _SPANS.append(s)
        _OPEN.append(i)
        s.launches = COUNTS["launches"]
        s.start_ns = time.time_ns()
        return s

    def __exit__(self, *exc) -> bool:
        s = self.span
        s.end_ns = time.time_ns()
        s.launches = COUNTS["launches"] - s.launches
        if _OPEN:
            _OPEN.pop()
        return False


def span(name: str, **attrs):
    """A context that records a span while a profiler session is active,
    else the shared no-op (no clock read, no span)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Recording(Span(name, attrs))


def spans() -> List[Span]:
    """The spans recorded since the last ``trace()`` began (in the order
    they were entered)."""
    return list(_SPANS)


def _clear_spans() -> None:
    _SPANS.clear()
    _OPEN.clear()


def _write_spans(path) -> None:
    """Add the recorded spans to the Chrome trace ``path`` as complete
    events of category ``SPAN_CAT`` on a row of their own, on the trace's
    clock (``ts`` in us after ``baseTimeNanoseconds``), with their
    attributes, parent, request and launches in ``args``."""
    path = Path(path)
    data = json.loads(path.read_text())
    base = int(data.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    events = data["traceEvents"]
    events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": SPAN_TID,
                   "args": {"name": SPAN_CAT}})
    for i, s in enumerate(_SPANS):
        if s.end_ns is None:
            continue
        events.append({
            "ph": "X", "cat": SPAN_CAT, "name": s.name, "pid": pid, "tid": SPAN_TID,
            "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
            "args": {**s.attrs, "index": i, "parent": s.parent, "request": s.request,
                     "launches": s.launches},
        })
    path.write_text(json.dumps(data))


@contextlib.contextmanager
def trace(log_dir=None, device="cuda") -> Iterator[profile]:
    """Profile the enclosed work (the host and, on a CUDA ``device``, the
    card's kernels) and write ``trace.json`` into ``log_dir`` (default
    ``build/torch_trace``) when it ends, the port's spans of the enclosed
    work included; yields the profiler, whose ``key_averages()`` give the
    time per kernel."""
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir) if log_dir is not None else DEFAULT_TRACE_DIR
    out.mkdir(parents=True, exist_ok=True)
    _clear_spans()
    with profile(activities=activities) as prof:
        yield prof
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(str(out / "trace.json"))
    _write_spans(out / "trace.json")


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named region in the trace, around the enclosed launches."""
    with record_function(name):
        yield


def device_memory_stats(device="cuda") -> Optional[dict]:
    """The CUDA allocator's statistics of ``device`` (None without a card
    or for the CPU)."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    return torch.cuda.memory_stats(device)
