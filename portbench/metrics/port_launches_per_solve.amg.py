"""The port's own kernel launches per traced solve: the launches of its C
entries (counted at ``_build.check``) that the ``cg`` spans saw between
their enter and exit.  An exact count, part of ``launches_per_solve.amg``
(the rest is torch's element-wise kernels, copies and memsets).  None
where the program recorded no such span."""
from portbench import spans


def read(run):
    st = spans.of(run)
    if st is None or not st.named("cg"):
        return None
    roots = st.named("cg")
    return sum(st.span[i].launches for i in roots) / len(roots)
