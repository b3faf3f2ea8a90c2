"""The port's own spans laid on a traced window, for the span metrics.

A profiled run of the port records spans at its layer boundaries
(``partitionedarrays_tpu_torch/utils/profiling.py``: ``cg``,
``cg.converged``, ``amg.cycle``, ``amg.smooth``, ``hpcg.cg``, ``mg.level``)
with their start and end on ``time.time_ns()``, their parent and the port's
launches between enter and exit.  ``of(run)`` takes them from the program
(``profiling.spans()``), maps them onto the clock of the run's exported
trace (``build/portbench/trace_<cell>.json``: ``ts`` in us after its
``baseTimeNanoseconds``) and keeps those that overlap the traced window, so
the spans of an attempt the harness took again are dropped.  It then
attributes

- each idle gap of the window (``tracing.Trace.gaps``) to the innermost
  span covering it, cut at span edges (-1: no span);
- each device operation of the window to the innermost span around the
  runtime call that launched it, matched by ``args.correlation``.

A program without spans (one that predates them, or a run in which none
was recorded inside the window) gives None, and so does every metric that
reads them: nothing recorded reads null, never 0.  The first analysis of a
run prints two tables to standard error: idle ms per unit by span and
device ms per unit by span, both by name and level.
"""
from __future__ import annotations

import bisect
import json
import sys
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from portbench.tracing import DEVICE_CATS

BUILD = Path(__file__).resolve().parents[1] / "build" / "portbench"
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
NONE = -1  # the owner of time and work outside every span

_LAST: list = [None, None]  # (the Trace last analysed, its SpanTrace): one run at a time


class SpanTrace:
    """Spans (``(start us, end us, span)`` by index) over one window of
    ``events`` (Chrome trace events on the clock ``base_ns``), and what
    they own of its idle time and device work."""

    def __init__(self, spans: Dict[int, object], events: List[dict], base_ns: int,
                 t0: float, t1: float, gaps: List[Tuple[float, float]]):
        self.t0, self.t1 = t0, t1
        self.span = {}
        self.at = {}  # index -> (start us, end us)
        for i, s in spans.items():
            if s.end_ns is None:
                continue
            a, b = (s.start_ns - base_ns) / 1e3, (s.end_ns - base_ns) / 1e3
            if b >= t0 and a <= t1:
                self.span[i], self.at[i] = s, (a, b)
        self._times, self._owners = _innermost(self.at)
        self.idle_us: Dict[int, float] = defaultdict(float)
        for a, b in gaps:
            self._spread(a, b)
        runtime = {}
        for e in events:
            if e.get("cat") in RUNTIME_CATS and "correlation" in e.get("args", {}):
                runtime[e["args"]["correlation"]] = e
        self.device_us: Dict[int, float] = defaultdict(float)
        self.ops: Dict[int, int] = defaultdict(int)
        self.launch_calls_outside = 0  # runtime launches of the window under no span
        self.calls: Dict[int, Tuple[float, float]] = {}  # root span -> its runtime calls' reach
        for e in events:
            cat = e.get("cat")
            if e.get("ph") != "X" or "ts" not in e:
                continue
            ts = float(e["ts"])
            if not t0 <= ts < t1:
                continue
            if cat in RUNTIME_CATS:
                owner = self.owner(ts)
                if owner == NONE:
                    self.launch_calls_outside += "Launch" in str(e.get("name", ""))
                else:
                    root = self.span[owner].request
                    lo, hi = self.calls.get(root, (ts, ts))
                    self.calls[root] = (min(lo, ts), max(hi, ts + float(e.get("dur", 0.0))))
            if cat not in DEVICE_CATS:
                continue
            call = runtime.get(e.get("args", {}).get("correlation"))
            owner = NONE if call is None else self.owner(float(call["ts"]))
            self.device_us[owner] += min(ts + float(e.get("dur", 0.0)), t1) - ts
            self.ops[owner] += 1

    def owner(self, t: float) -> int:
        """The innermost span at ``t`` (us), NONE outside every span."""
        k = bisect.bisect_right(self._times, t) - 1
        return self._owners[k] if k >= 0 else NONE

    def _spread(self, a: float, b: float) -> None:
        """Give the idle interval [a, b) to the innermost spans over it."""
        times, owners = self._times, self._owners
        k = bisect.bisect_right(times, a) - 1  # -1: before every span edge
        t = a
        while t < b:
            end = min(times[k + 1] if k + 1 < len(times) else b, b)
            if end > t:
                self.idle_us[owners[k] if k >= 0 else NONE] += end - t
                t = end
            k += 1

    def named(self, name: str) -> List[int]:
        return [i for i, s in self.span.items() if s.name == name]

    def within(self, i: int, name: str) -> bool:
        """Whether span ``i`` or one of its ancestors is named ``name``."""
        while i != NONE and i in self.span:
            if self.span[i].name == name:
                return True
            i = self.span[i].parent
        return False

    def idle_within(self, name: str, outside: Optional[str] = None) -> float:
        """Idle us owned by spans inside a span ``name`` (and, with
        ``outside``, not inside one named so)."""
        return sum(us for i, us in self.idle_us.items()
                   if self.within(i, name) and not (outside and self.within(i, outside)))

    def host_us(self, name: str) -> float:
        """The summed duration of the spans named ``name``."""
        return sum(self.at[i][1] - self.at[i][0] for i in self.named(name))

    def label(self, i: int) -> str:
        if i == NONE:
            return "(no span)"
        s = self.span[i]
        return s.name + "".join(f" {k}={v}" for k, v in s.attrs.items())

    def tables(self, units: int, log=sys.stderr) -> None:
        """Idle ms and device ms per unit by span label."""
        for title, table in (("idle ms per unit by innermost span", self.idle_us),
                             ("device ms per unit by launching span", self.device_us)):
            by: Dict[str, float] = defaultdict(float)
            for i, us in table.items():
                by[self.label(i)] += us / 1e3 / units
            rows = sorted(by.items(), key=lambda kv: -kv[1])
            print(f"spans: {title} ({units} units): " + "; ".join(
                f"{k} {v:.4f}" for k, v in rows), file=log)
        leads = [lo - self.at[r][0] for r, (lo, hi) in self.calls.items() if r in self.at]
        trails = [self.at[r][1] - hi for r, (lo, hi) in self.calls.items() if r in self.at]
        print(f"spans: runtime launch calls of the window under no span: "
              f"{self.launch_calls_outside}; outermost spans' first call after their start "
              f"by at least {min(leads, default=float('nan')):.1f} us, last call's end before "
              f"their end by at least {min(trails, default=float('nan')):.1f} us", file=log)


def _innermost(at: Dict[int, Tuple[float, float]]) -> Tuple[List[float], List[int]]:
    """The times at which the innermost span changes, and the innermost
    span from each (spans nest, being entered and left by one stack)."""
    edges = []
    for i, (a, b) in at.items():
        if b > a:  # a span of no length owns nothing
            edges.append((a, 1, i))
            edges.append((b, 0, i))
    edges.sort()
    stack: List[int] = []
    times, owners = [], []
    for t, opening, i in edges:
        if opening:
            stack.append(i)
        elif stack and stack[-1] == i:
            stack.pop()
        elif i in stack:
            stack.remove(i)
        times.append(t)
        owners.append(stack[-1] if stack else NONE)
    return times, owners


def _program_spans() -> Optional[list]:
    try:
        from partitionedarrays_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    return None if read is None else read()


def of(run) -> Optional[SpanTrace]:
    """The spans of ``run``'s traced window (None without any)."""
    if run.trace is None or not run.traced_units:
        return None
    if _LAST[0] is run.trace:
        return _LAST[1]
    found = None
    recorded = _program_spans()
    if recorded:
        with open(BUILD / f"trace_{run.cell}.json") as fh:
            data = json.load(fh)
        events = data["traceEvents"] if isinstance(data, dict) else data
        base = int(data.get("baseTimeNanoseconds", 0)) if isinstance(data, dict) else 0
        found = SpanTrace(dict(enumerate(recorded)), events, base, run.trace.t0,
                          run.trace.t1, run.trace.gaps())
        if found.span:
            found.tables(len(run.traced_units))
        else:
            found = None
    _LAST[:] = [run.trace, found]
    return found

