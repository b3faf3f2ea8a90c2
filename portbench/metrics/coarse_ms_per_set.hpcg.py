"""Device ms per traced set of the operations launched inside the port's
``mg.level`` spans of the three coarser levels (``models/hpcg/mg.py``'s
V-cycle; the finest level is the highest ``level``): each operation goes
to the innermost span around its launching runtime call.  None where the
program recorded no such span."""
from portbench import spans


def read(run):
    st = spans.of(run)
    if st is None or not st.named("hpcg.cg"):
        return None
    levels = {i: st.span[i].attrs.get("level") for i in st.named("mg.level")}
    if not levels:
        return None
    finest = max(levels.values())
    us = sum(t for i, t in st.device_us.items() if i in levels and levels[i] < finest)
    return us / 1e3 / len(st.named("hpcg.cg"))
