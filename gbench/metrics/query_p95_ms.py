"""The 95th percentile of every call's latency in the window (numpy's
linear interpolation), on the host's clock, in milliseconds."""
import numpy as np


def read(run):
    if not run.calls:
        return None
    return float(np.percentile([c.latency_s for c in run.calls], 95)) * 1e3
