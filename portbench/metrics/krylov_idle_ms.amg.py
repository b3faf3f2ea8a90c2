"""Device-idle ms per traced solve inside the port's ``cg`` spans
(``solvers/krylov.py::cg``) and outside its ``amg.cycle`` spans: the CG
loop's own Python (dots, axpys, the vector views) and its convergence
read-back.  None where the program recorded no such span."""
from portbench import spans


def read(run):
    st = spans.of(run)
    if st is None or not st.named("cg"):
        return None
    return st.idle_within("cg", outside="amg.cycle") / 1e3 / len(st.named("cg"))
