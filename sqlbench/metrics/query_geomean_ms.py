"""The geometric mean of every window query's latency (TPC-H's power
metric is a geometric mean: short templates weigh as much as long ones)."""
import numpy as np


def read(run):
    if not run.window:
        return None
    return float(np.exp(np.mean(np.log([q.ms for q in run.window]))))
