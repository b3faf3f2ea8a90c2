"""Device traces and named regions over ``torch.profiler``.

Counterpart of ``partitionedarrays_tpu/utils/profiling.py`` (``trace``,
``annotate``, ``device_memory_stats``), which wraps ``jax.profiler``: a
trace of the host and the card's kernels written as a Chrome trace (open it
in Perfetto or ``chrome://tracing``), regions that show around the
enclosed launches, and the card's allocator statistics.
"""
from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

# beside the package, in the directory git ignores (as the kernel builds)
DEFAULT_TRACE_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_trace"


@contextlib.contextmanager
def trace(log_dir=None, device="cuda") -> Iterator[profile]:
    """Profile the enclosed work (the host and, on a CUDA ``device``, the
    card's kernels) and write ``trace.json`` into ``log_dir`` (default
    ``build/torch_trace``) when it ends; yields the profiler, whose
    ``key_averages()`` give the time per kernel."""
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir) if log_dir is not None else DEFAULT_TRACE_DIR
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(str(out / "trace.json"))


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
