"""The median over the window's queries of the port's ``parse`` plus
``plan`` span times (its telemetry report of each ``Context.sql``)."""
import numpy as np


def read(run):
    vals = [q.facts["plan_ms"] for q in run.window if "plan_ms" in q.facts]
    return float(np.median(vals)) if vals else None
