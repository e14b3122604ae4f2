"""The traced stretch: the same closed loop under ``torch.profiler`` with
CUDA activity only, after the window, and what its device trace says.

The device's timeline is placed on the host clock by one marker: after a
synchronisation, the first device operation of the stretch is a one-element
fill launched at a known host time.  An idle gap is then named by the span
of the port that was open on the host at its middle (``parse``, ``plan``,
``queued``, ``execute``, ...), by ``fetch`` when the answer was being copied
to host arrays, or ``between queries``.
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import List, Optional, Tuple

import torch

from . import port
from .loop import Query, closed_loop

KERNEL1 = "segsum_fixedpoint"


def _device_events(prof) -> List[Tuple[float, float, str]]:
    """(start us, end us, name) of every operation the card ran."""
    out = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out.append((float(e.time_range.start), float(e.time_range.end),
                        e.name))
    out.sort()
    return out


def _union(events, lo: float, hi: float) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for s, e, _ in events:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _query_at(queries: List[Query], h: float) -> Optional[Query]:
    for q in queries:
        if q.t0 <= h < q.t1:
            return q
    return None


def host_activity(queries: List[Query], h: float) -> str:
    """What the host was doing at host time ``h``."""
    q = _query_at(queries, h)
    if q is None:
        return "between queries"
    best = None
    for name, depth, t0, t1 in q.spans:
        if t0 <= h < t1 and (best is None or depth >= best[0]):
            best = (depth, name)
    if best is None:
        return f"fetch ({q.tid})" if q.spans else f"outside spans ({q.tid})"
    return f"{best[1]} ({q.tid})"


def stretch(ctx, stream: List[Query], start: int, count: int,
            device: torch.device):
    """Runs ``count`` queries of the loop (one pass of the traffic's order:
    every template once) under the profiler; returns the queries and the
    trace's facts.  The port's background builds are drained before the
    profiler starts and before it stops (both would break a capture on a
    build's thread); the stretch ends on a synchronisation of the query
    stream, since a device-wide one would too, and the drain after it is
    left out of the stretch's length."""
    from torch.profiler import ProfilerActivity, profile

    port.wait_for_builds()
    torch.cuda.synchronize(device)
    marker = torch.zeros(1, device=device)
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t_mark = time.perf_counter()
        marker.fill_(1.0)
        queries, _ = closed_loop(ctx, stream, start, 0.0, keep_spans=True,
                                 count=count)
        torch.cuda.current_stream(device).synchronize()
        t_end = time.perf_counter()
        # the profiler's stop would break a capture on a build's thread
        port.wait_for_builds()
    events = _device_events(prof)
    return queries, summarize(events, queries, t_mark, t_end)


def summarize(events, queries: List[Query], t_mark: float, t_end: float
              ) -> dict:
    """Busy and idle time, the costliest operations, the longest gaps by
    host activity, and each kernel-1 launch with its query."""
    window_s = t_end - t_mark
    if not events:
        return {"window_s": window_s, "busy_s": 0.0, "device_ops": [],
                "idle_gaps": [], "idle_by_activity": [], "kernel1": [],
                "events": 0}
    lo = events[0][0]
    hi = lo + window_s * 1e6

    def host_time(us: float) -> float:
        return t_mark + (us - lo) / 1e6

    busy = _union(events, lo, hi)
    busy_s = sum(e - s for s, e in busy) / 1e6
    by_name = defaultdict(float)
    for s, e, name in events:
        by_name[name] += (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = []
    prev = lo
    for s, e in busy + [(hi, hi)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    idle_by = defaultdict(float)
    labelled = []
    for s, e in gaps:
        label = host_activity(queries, host_time((s + e) / 2))
        labelled.append([label, (e - s) / 1e6])
        idle_by[label.split(" (")[0]] += (e - s) / 1e6
    labelled.sort(key=lambda g: -g[1])
    kernel1 = []
    for s, e, name in events:
        if KERNEL1 in name:
            kernel1.append((_query_at(queries, host_time(s)), (e - s) / 1e6))
    return {"window_s": window_s, "busy_s": busy_s,
            "device_ops": [[n, t] for n, t in ops],
            "idle_gaps": labelled[:10],
            "idle_by_activity": sorted(([k, v] for k, v in idle_by.items()),
                                       key=lambda kv: -kv[1]),
            "kernel1": kernel1, "events": len(events)}
