"""Device operations (kernels, copies, memsets) per set in the trace of a
few steady sets: the launches of cg.py's host loop and mg.py's V-cycle."""


def read(run):
    if run.trace is None or not run.traced_units:
        return None
    return run.trace.launches() / len(run.traced_units)
