"""A timer of named sections (the reference's PTimer, src/p_timer.jl:24-176).

Counterpart of ``partitionedarrays_tpu/utils/ptimer.py``, with its names
(``current_time``, ``barrier``, ``PTimer.tic``/``toc``/``statistics``/
``gather_statistics``/``print_main``) and its report formats.  A section's
time is the host's wall clock between ``tic`` and ``toc`` in each process;
``gather_statistics`` all-gathers the processes' totals.  The port's kernels run asynchronously on the card, so
``barrier`` waits for every kernel queued on the timer's device
(``torch.cuda.synchronize``), and ``toc`` fences before it reads the clock:
a section's time includes the device work it queued.  The reference's
barrier waits on one live array only (``utils/ptimer.py:22-31``), which
leaves the others running; that is not copied.
"""
from __future__ import annotations

import time
from typing import Dict, List

import torch


def current_time() -> float:
    """Reference ``current_time`` (src/p_timer.jl:2-6)."""
    return time.perf_counter()


def barrier(device="cuda") -> None:
    """Wait for all the work queued on ``device`` (a CUDA device: every
    stream of it; the CPU has nothing queued) (reference ``barrier``,
    src/p_timer.jl:8)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class PTimer:
    """Wall-clock seconds of named sections; every call of a section is
    kept.  ``device``: where the timed work runs (the card by default);
    ``barrier_at_tic``: also fence at ``tic``, so that work queued before
    the section is not counted in it."""

    def __init__(self, barrier_at_tic: bool = False, device="cuda"):
        self.barrier_at_tic = barrier_at_tic
        self.device = torch.device(device)
        self.data: Dict[str, List[float]] = {}
        self._open: Dict[str, float] = {}

    def tic(self, name: str) -> None:
        """Reference ``tic!`` (src/p_timer.jl:98-103)."""
        if self.barrier_at_tic:
            barrier(self.device)
        self._open[name] = current_time()

    def toc(self, name: str) -> float:
        """Reference ``toc!`` (src/p_timer.jl:110-121): the section's
        seconds, the device fenced first."""
        barrier(self.device)
        dt = current_time() - self._open.pop(name)
        self.data.setdefault(name, []).append(dt)
        return dt

    def statistics(self) -> Dict[str, Dict[str, float]]:
        """min, max, avg and calls per section (reference ``statistics``,
        src/p_timer.jl:73-84)."""
        return {
            k: {"min": min(v), "max": max(v), "avg": sum(v) / len(v), "calls": len(v)}
            for k, v in self.data.items()
        }

    def gather_statistics(self, backend=None) -> Dict[str, Dict[str, float]]:
        """Each section's total, as min, max and avg across the processes
        of a multi-process backend (all-gathered; reference: the gather of
        per-rank times to MAIN, src/p_timer.jl:46-84), with ``procs`` the
        number of processes.  Every process must have timed the same
        sections (a mismatch raises).  In one process each is the
        section's total and ``procs`` is 1.  COLLECTIVE on several
        processes."""
        totals = {k: float(sum(v)) for k, v in self.data.items()}
        if backend is None or not getattr(backend, "is_multiprocess", False):
            return {k: {"min": totals[k], "max": totals[k], "avg": totals[k], "procs": 1}
                    for k in sorted(totals)}
        views = backend.allgather_object(totals)
        if any(sorted(v) != sorted(totals) for v in views):
            raise ValueError("gather_statistics: processes timed different sections")
        return {k: {"min": min(v[k] for v in views), "max": max(v[k] for v in views),
                    "avg": sum(v[k] for v in views) / len(views), "procs": len(views)}
                for k in sorted(totals)}

    def print_main(self, backend=None) -> None:
        """The statistics across processes, printed by the first process
        only (reference: the MAIN rank's printer, src/p_timer.jl:123-176).
        COLLECTIVE on several processes."""
        stats = self.gather_statistics(backend)
        if getattr(backend, "rank", 0) != 0:
            return
        lines = [f"{'section':<24}{'min (s)':>12}{'avg (s)':>12}{'max (s)':>12}"]
        for k, s in stats.items():
            lines.append(f"{k:<24}{s['min']:>12.3e}{s['avg']:>12.3e}{s['max']:>12.3e}")
        print("\n".join(lines))

    def __repr__(self):
        lines = [f"{'section':<24}{'calls':>6}{'avg (s)':>12}{'max (s)':>12}"]
        for k, s in self.statistics().items():
            lines.append(f"{k:<24}{s['calls']:>6}{s['avg']:>12.3e}{s['max']:>12.3e}")
        return "\n".join(lines)
