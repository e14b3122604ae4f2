"""The share of the traced stretch in which no operation ran on the card,
from the profiler's CUDA activity."""


def read(run):
    t = run.trace
    if not t or t["window_s"] <= 0 or t["events"] == 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
