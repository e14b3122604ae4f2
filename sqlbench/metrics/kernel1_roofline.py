"""Kernel 1's share of its roofline over the traced stretch: the least time
of its launches over their device time, launch by launch.

A launch's least time is its bytes over the card's HBM bandwidth
(``core/peaks.py``).  The bytes are the benchmark's own count, defined on
the query and its data and not on how the port lays out its limbs: the
rows that enter the query's final aggregate (the reference counts them for
each query), times 8 B for each distinct value column it sums, plus 4 B of
group code and 1 B of mask per row, plus 8 B per output value (each
aggregate and the count) per group.  Every kernel-1 launch that ran while
a query was in flight reads that query's inputs, whether it is a build's
warm-up run or the replay that answers, so each launch counts the query's
bytes once.  A query whose aggregate the reference does not describe is
left out, with its launches; so is a launch outside any query.
"""
from sqlbench.core.peaks import HBM_BYTES_PER_S


def read(run):
    t = run.trace
    if not t or not t["kernel1"] or run.facts_of is None:
        return None
    least = spent = 0.0
    for q, seconds in t["kernel1"]:
        facts = run.facts_of(q) if q is not None else None
        if not facts:
            continue
        rows, values, groups = (facts["agg_rows"], facts["agg_values"],
                                facts["groups"])
        n_bytes = rows * (8 * values + 4 + 1) + groups * 8 * (values + 1)
        least += n_bytes / HBM_BYTES_PER_S
        spent += seconds
    if spent <= 0 or least <= 0:
        return None
    return 100.0 * least / spent
