"""A profiler trace of a few steady units of work, and what the per-layer
metrics read from it.

``profile_units`` runs the units under ``torch.profiler`` inside one
annotation, with the device synchronised at both ends, and exports the
trace as Chrome JSON under ``build/portbench/``.  It records device
activity and the CUDA runtime calls only: recording every host operator
too slowed a host-bound solve by three quarters (48 ms traced against 27
ms), which the idle share would have read as the program's.
``Trace`` reads that JSON: the device operations (kernels, copies and
memsets) inside the annotation, the host operations beside them, the busy
time (the union of the device operations' intervals), the idle gaps, and
device time by kernel name.
"""
from __future__ import annotations

import bisect
import json
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

WINDOW = "portbench.traced_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")

Interval = Tuple[float, float, str]  # (start us, end us, name)


class Trace:
    """The events of one traced window (times in microseconds)."""

    def __init__(self, events: Iterable[dict], window: str = WINDOW):
        """The window is the ``window`` annotation where the trace has it
        on the host, else the span of the CUDA runtime calls (the first
        launch to the end of the closing synchronise)."""
        events = [e for e in events if e.get("ph") == "X" and "ts" in e]
        spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in events
                 if e.get("name") == window and e.get("cat") in ("user_annotation", "cpu_op")]
        if not spans:
            spans = [(min(float(e["ts"]) for e in events if e.get("cat") == "cuda_runtime"),
                      max(float(e["ts"]) + float(e.get("dur", 0.0)) for e in events
                          if e.get("cat") == "cuda_runtime"))] if any(
                e.get("cat") == "cuda_runtime" for e in events) else []
        if not spans:
            raise ValueError(f"trace has neither a {window!r} annotation nor runtime calls")
        self.t0, self.t1 = spans[0]
        self.device: List[Interval] = self._inside(events, DEVICE_CATS)
        self.host: List[Interval] = self._inside(events, HOST_CATS, exclude=window)
        self._host_starts = [a for a, _, _ in self.host]

    def _inside(self, events, cats, exclude=None) -> List[Interval]:
        out = []
        for e in events:
            if e.get("cat") not in cats or e.get("name") == exclude:
                continue
            s = float(e["ts"])
            t = s + float(e.get("dur", 0.0))
            if s >= self.t0 and s < self.t1:
                out.append((s, min(t, self.t1), str(e.get("name", ""))))
        out.sort()
        return out

    @classmethod
    def from_file(cls, path, window: str = WINDOW) -> "Trace":
        with open(path) as fh:
            data = json.load(fh)
        events = data["traceEvents"] if isinstance(data, dict) else data
        return cls(events, window)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def launches(self) -> int:
        """Device operations (kernels, copies, memsets) in the window."""
        return len(self.device)

    def busy_s(self) -> float:
        """Seconds in which some device operation ran (their union)."""
        return sum(b - a for a, b in _union(self.device)) / 1e6

    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def device_s(self, patterns: Sequence[str]) -> float:
        """Device seconds of the operations whose name holds a pattern."""
        return sum(b - a for a, b, n in self.device if any(p in n for p in patterns)) / 1e6

    def gaps(self) -> List[Tuple[float, float]]:
        """The idle intervals of the window (us)."""
        out, t = [], self.t0
        for a, b in _union(self.device):
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if t < self.t1:
            out.append((t, self.t1))
        return out

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time, and the idle time by
        what the host was doing: the innermost host operation at each
        gap's middle ("host idle" where none ran: Python between
        operations)."""
        by_op: Dict[str, float] = defaultdict(float)
        for a, b, n in self.device:
            by_op[_short(n)] += (b - a) / 1e6
        by_host: Dict[str, float] = defaultdict(float)
        for a, b in self.gaps():
            by_host[self._host_at((a + b) / 2)] += (b - a) / 1e6
        return {
            "device_ops": sorted(([k, v] for k, v in by_op.items()), key=lambda kv: -kv[1])[:top],
            "idle_gaps": sorted(([k, v] for k, v in by_host.items()), key=lambda kv: -kv[1])[:top],
        }

    def _host_at(self, t: float, reach: int = 64) -> str:
        """The host operation running at ``t`` that started last (the
        innermost, host operations being nested), looked for among the
        ``reach`` that started last before ``t``."""
        k = bisect.bisect_right(self._host_starts, t) - 1
        for a, b, n in self.host[max(k - reach + 1, 0):k + 1][::-1]:
            if b >= t:
                return _short(n)
        return "host idle"


def _union(intervals: Iterable[Interval]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b, *_ in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _short(name: str, n: int = 80) -> str:
    """A kernel's name without its return type, anonymous namespace and
    argument list."""
    name = name.strip().replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0][:n]


def profile_units(run_units: Callable[[], list], path: Path, sync: Callable[[], None],
                  attempts: int = 3) -> Tuple[Optional[Trace], list]:
    """Trace one call of ``run_units`` (device activity and runtime calls)
    inside the ``WINDOW`` annotation, device synchronised at both ends, and read the
    exported trace; returns it with what that call returned (the units it
    ran).  The profiler now and then keeps no device event: such a trace
    is taken again, up to ``attempts`` times (then None)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    path.parent.mkdir(parents=True, exist_ok=True)
    for _ in range(attempts):
        sync()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW):
                units = run_units()
                sync()
        prof.export_chrome_trace(str(path))
        trace = Trace.from_file(path)
        if trace.device:
            return trace, units
    return None, units
