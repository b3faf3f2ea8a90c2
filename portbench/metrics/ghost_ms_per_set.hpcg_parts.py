"""Device ms per traced set of the operations launched inside the port's
``ghost`` spans (``solvers/smoothers.py::GaussSeidel.ghost_contrib``: the
exchange, K5 and their glue), the whole cost of the ghost coupling, which a
set on one part does not have.  None where the program recorded no such
span."""
from portbench import spans


def read(run):
    st = spans.of(run)
    if st is None or not st.named("ghost") or not st.named("hpcg.cg"):
        return None
    us = sum(t for i, t in st.device_us.items() if i != spans.NONE and st.within(i, "ghost"))
    return us / 1e3 / len(st.named("hpcg.cg"))
