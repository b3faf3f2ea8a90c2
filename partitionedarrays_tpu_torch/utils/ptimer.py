"""A timer of named sections (the reference's PTimer, src/p_timer.jl:24-176).

Counterpart of ``partitionedarrays_tpu/utils/ptimer.py``, with its names
(``current_time``, ``barrier``, ``PTimer.tic``/``toc``/``statistics``/
``gather_statistics``/``print_main``) and its report formats.  All parts
run in one process, so a section's time is the host's wall clock between
``tic`` and ``toc``.  The port's kernels run asynchronously on the card, so
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
        """Each section's total over the processes, as min, max and avg
        across them (reference: the gather of per-rank times to MAIN,
        src/p_timer.jl:46-84).  The port runs one process (the serial
        backend), so each is the section's total and ``procs`` is 1."""
        if getattr(backend, "is_multiprocess", False):
            raise NotImplementedError(
                "gather_statistics across processes: multi-process is ROADMAP item 15")
        totals = {k: float(sum(v)) for k, v in self.data.items()}
        return {k: {"min": totals[k], "max": totals[k], "avg": totals[k], "procs": 1}
                for k in sorted(totals)}

    def print_main(self, backend=None) -> None:
        """The statistics across processes, printed (reference: the MAIN
        rank's printer, src/p_timer.jl:123-176)."""
        lines = [f"{'section':<24}{'min (s)':>12}{'avg (s)':>12}{'max (s)':>12}"]
        for k, s in self.gather_statistics(backend).items():
            lines.append(f"{k:<24}{s['min']:>12.3e}{s['avg']:>12.3e}{s['max']:>12.3e}")
        print("\n".join(lines))

    def __repr__(self):
        lines = [f"{'section':<24}{'calls':>6}{'avg (s)':>12}{'max (s)':>12}"]
        for k, s in self.statistics().items():
            lines.append(f"{k:<24}{s['calls']:>6}{s['avg']:>12.3e}{s['max']:>12.3e}")
        return "\n".join(lines)
