"""Device-idle ms per traced solve inside the port's ``amg.cycle`` spans
(``solvers/amg.py::AMGPreconditioner._cycle``, every level, their
``amg.smooth`` children included): the host time of the V-cycle's Python
that a CUDA graph of the cycle would take away.  None where the program
recorded no such span."""
from portbench import spans


def read(run):
    st = spans.of(run)
    if st is None or not st.named("amg.cycle") or not st.named("cg"):
        return None
    return st.idle_within("amg.cycle") / 1e3 / len(st.named("cg"))
