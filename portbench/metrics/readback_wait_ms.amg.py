"""Host ms per traced solve inside the port's ``cg.converged`` spans: the
convergence test ``bool(rnorm > tol)`` of ``solvers/krylov.py::cg``, once
an iteration, which waits for the device to finish the iteration.  None
where the program recorded no such span."""
from portbench import spans


def read(run):
    st = spans.of(run)
    if st is None or not st.named("cg.converged") or not st.named("cg"):
        return None
    return st.host_us("cg.converged") / 1e3 / len(st.named("cg"))
