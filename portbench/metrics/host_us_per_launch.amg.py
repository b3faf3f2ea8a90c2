"""Host us per device operation of the solve loop: the host time of the
port's ``cg`` spans less their ``cg.converged`` spans (the read-back's
wait), over the device operations (kernels, copies, memsets) whose
runtime call the ``cg`` spans enclose.  None where the program recorded
no such span."""
from portbench import spans


def read(run):
    st = spans.of(run)
    if st is None or not st.named("cg"):
        return None
    ops = sum(n for i, n in st.ops.items() if st.within(i, "cg"))
    if ops == 0:
        return None
    return (st.host_us("cg") - st.host_us("cg.converged")) / ops
