"""The 95th percentile, over every operation of the window, of the time from
the host starting to queue the operation to the card finishing it."""
import numpy as np


def read(run):
    if not run.records:
        return None
    lat = np.array([r.end - r.start for r in run.records]) * 1e3
    return float(np.percentile(lat, 95))
