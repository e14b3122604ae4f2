"""The closed loop: one client sends the next query when the last answer is
on the host, with no think time, for a fixed stretch of the host clock.

Each query is timed from send to answer.  The window ends with the first
answer that arrives after its length has passed, so every query sent in it
is answered and counted; its length is measured to that answer.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from . import port


@dataclass
class Query:
    tid: str
    sql: str
    values: dict
    t0: float = 0.0
    t1: float = 0.0
    ok: bool = False
    error: str = ""
    cols: Optional[list] = None
    facts: dict = field(default_factory=dict)
    spans: list = field(default_factory=list)

    @property
    def ms(self) -> float:
        return (self.t1 - self.t0) * 1e3


@dataclass
class Run:
    """What a run saw, for the metric readers."""
    setup: dict = field(default_factory=dict)
    window: List[Query] = field(default_factory=list)
    window_s: float = 0.0
    stretch: List[Query] = field(default_factory=list)
    trace: Optional[dict] = None
    facts_of: Optional[Callable] = None     # (Query) -> reference facts


def schedule(order: List[str], draws: dict, first: int) -> List[Query]:
    """The stream: the traffic's order repeated, each template's k-th
    arrival taking its value set ``first + k``."""
    per = min(len(v) for v in draws.values()) - first
    out = []
    for k in range(per):
        for tid in order:
            d = draws[tid][first + k]
            out.append(Query(tid, d["sql"], d["values"]))
    return out


def closed_loop(ctx, stream: List[Query], start: int, seconds: float,
                keep_spans: bool = False, count: Optional[int] = None):
    """Runs the stream from ``start`` for ``seconds`` (or for ``count``
    queries); returns the queries answered (fresh records) and the
    window's length in seconds."""
    done: List[Query] = []
    t_start = time.perf_counter()
    t_stop = t_start + seconds
    i = start
    while True:
        proto = stream[i % len(stream)]
        q = Query(proto.tid, proto.sql, proto.values)
        q.t0 = time.perf_counter()
        try:
            q.cols, _, report = port.query(ctx, q.sql)
            q.ok = True
        except Exception as e:  # noqa: BLE001 -- a failed query is counted
            report = None
            q.error = f"{type(e).__name__}: {str(e)[:300]}"
        q.t1 = time.perf_counter()
        q.facts = port.report_facts(report)
        if keep_spans:
            q.spans = port.spans(report)
        done.append(q)
        i += 1
        if (count is None and q.t1 >= t_stop) or len(done) == count:
            break
    return done, done[-1].t1 - t_start
