"""Device operations (kernels, copies, memsets) per solve in the trace of
a few steady solves: the launches of krylov.py's cg and the AMG cycle's
host loop."""


def read(run):
    if run.trace is None or not run.traced_units:
        return None
    return run.trace.launches() / len(run.traced_units)
