"""The smoothers' share of their roofline over the traced solves (K3 on
the banded fine level, K6 on the tile levels): the least time the
sweeps' work needs on the card (``work.py``: every level's passes, values
at their stored width, vectors once a pass) over the device time of the
kernels named below.  A kernel renamed in the program reads nothing here
(None) until a benchmark change points this file at it."""
from portbench import work

KERNELS = ("gs_seq_grid_kernel", "tile_sweeps_kernel")


def read(run):
    if run.trace is None:
        return None
    device_s = run.trace.device_s(KERNELS)
    if device_s <= 0:
        return None
    nbytes, ops = work.smoother_work(run.facts["levels"])
    vcycles = sum(run.facts["vcycles"][i] for i in run.traced_units)
    bound = work.bound_s(nbytes * vcycles, ops * vcycles, run.facts["vector_bytes"])
    return 100.0 * bound / device_s
