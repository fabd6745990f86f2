"""95th percentile over every point of the window of the host-clock time from
the point's start to its NMSE on the host, in ms (linear interpolation
between order statistics)."""
import numpy as np


def read(record):
    if not record.points:
        return None
    return float(np.percentile([1e3 * p.seconds for p in record.points], 95))
