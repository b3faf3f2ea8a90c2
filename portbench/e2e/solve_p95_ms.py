"""The 95th percentile of every solve's host seconds in the window, from
its call to its return with the device synchronised at both ends
(numpy's linear interpolation between order statistics)."""
import numpy as np


def value(run):
    return 1e3 * float(np.percentile(run.latencies, 95))
