"""K5's share of its roofline over the traced sets: the least time the
own-ghost products need on the card (``work_parts.py``: each ``ghost``
span's level, its block's entries, ghosts and rows from the geometry) over
the device time of the kernels named below launched inside ``ghost`` spans
(``solvers/smoothers.py::GaussSeidel.ghost_contrib``).  None where the
program recorded no such span or the trace no such kernel; a kernel
renamed in the program reads nothing here until a benchmark change points
this file at it."""
import json

from portbench import spans
from portbench.work_parts import k5_bound_s

KERNELS = ("ghost_spmv_kernel",)


def read(run):
    st = spans.of(run)
    if st is None or not st.named("ghost"):
        return None
    with open(spans.BUILD / f"trace_{run.cell}.json") as fh:
        data = json.load(fh)
    events = data["traceEvents"] if isinstance(data, dict) else data
    calls = {e["args"]["correlation"]: float(e["ts"]) for e in events
             if e.get("cat") in spans.RUNTIME_CATS and "correlation" in e.get("args", {})}
    device_us = 0.0
    for e in events:
        if e.get("cat") != "kernel" or e.get("ph") != "X" or not any(
                k in str(e.get("name", "")) for k in KERNELS):
            continue
        ts = float(e["ts"])
        call = calls.get(e.get("args", {}).get("correlation"))
        if not st.t0 <= ts < st.t1 or call is None:
            continue
        owner = st.owner(call)
        if owner != spans.NONE and st.within(owner, "ghost"):
            device_us += min(ts + float(e.get("dur", 0.0)), st.t1) - ts
    if device_us <= 0:
        return None
    levels = run.facts["ghost_levels"]
    bound_s = 0.0
    for i in st.named("ghost"):
        lev = levels[st.span[i].attrs["level"]]
        bound_s += k5_bound_s(lev, lev["value_bytes"], lev["vector_bytes"])
    return 100.0 * bound_s / (device_us / 1e6)
