"""The 95th percentile of the latency of every query completed in the
window (linear interpolation between order statistics)."""

import numpy as np

UNIT, BETTER = "ms", "lower"


def read(run):
    if not run.latencies_s:
        return None
    return float(np.percentile(np.asarray(run.latencies_s, dtype=np.float64), 95)) * 1e3
