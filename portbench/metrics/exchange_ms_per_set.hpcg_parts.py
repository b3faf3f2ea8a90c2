"""Device ms per traced set of the operations launched inside the port's
``exchange`` spans (``parallel/exchange_plan.py::ExchangePlan.apply``: the
gather, the ``index_copy_`` and the copy of each ghost exchange): each
operation goes to the innermost span around its launching runtime call.
None where the program recorded no such span."""
from portbench import spans


def read(run):
    st = spans.of(run)
    if st is None or not st.named("exchange") or not st.named("hpcg.cg"):
        return None
    us = sum(t for i, t in st.device_us.items() if i != spans.NONE and st.within(i, "exchange"))
    return us / 1e3 / len(st.named("hpcg.cg"))
