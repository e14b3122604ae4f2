"""The 95th percentile of every window query's latency, send to answer on
the host, failed queries included at the time they took to fail."""
import numpy as np


def read(run):
    if not run.window:
        return None
    return float(np.percentile([q.ms for q in run.window], 95))
