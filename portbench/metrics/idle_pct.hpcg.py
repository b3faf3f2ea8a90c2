"""The share of the traced window in which no device operation runs (the
complement of the union of their intervals)."""


def read(run):
    return None if run.trace is None else run.trace.idle_pct()
