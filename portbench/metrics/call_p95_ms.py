"""call_p95_ms: the 95th percentile of the wall of every call in the
window, in ms (numpy's linear interpolation). Host clock."""
import numpy as np


def read(run):
    return float(np.percentile(run["walls_s"], 95)) * 1e3
