"""Query-lifecycle telemetry: counters, spans and a per-query report.

The counterpart of ``dask_sql_tpu/runtime/telemetry.py``, cut to what the
statistics module and ``Context.sql`` use:

- ``REGISTRY`` (a ``MetricsRegistry``): process-global thread-safe
  counters; ``inc`` bumps one, ``counters()`` snapshots them.  The
  adaptive dispatch counts each choice as ``operator_choice_<op>_<variant>``.
- Spans: ``trace_scope(sql)`` opens one trace per outermost query on this
  thread, ``span(name)`` nests a timed child under the current span,
  ``current_span`` returns it and ``annotate`` adds attributes to it.
- ``QueryReport``: built when the trace closes -- phase walls (parse,
  plan, execute, fetch), the counter deltas of the query (``planner_native``
  or ``planner_python`` among them), the operator choices recorded on its
  spans, rows and bytes out, and the span tree.  ``Context.sql`` keeps it
  as ``context.last_report``; ``last_report()`` returns the last one closed
  on this thread.
- ``record_nodes``: EXPLAIN ANALYZE's per-plan-node (wall, rows, calls),
  fed by the eager executor.
- ``CounterAlias``: the dict-shaped view of the registry behind
  ``physical.compiled.stats``; ``exec_profile``: this thread's scratchpad
  for the compiled tier's device/materialize split.
- Threads: ``current_trace`` and ``scoped`` re-enter a query's trace on a
  worker thread (the compiled tier's stage workers); a background compile
  runs in a ``QueryTrace`` of its own, closed by
  ``close_background_trace`` without counting a query (its reports are
  kept in ``BACKGROUND_REPORTS``, the last 16).

The JAX package's environment-armed hooks (fleet, flight recorder, device
profiler, event bus, autopilot, chrome-trace export, slow-query log),
histograms, gauges, the Prometheus rendering and the report's text and
dict renderings are not part of the port.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from collections.abc import MutableMapping
from contextlib import contextmanager
from typing import Any, Dict, List, Optional


class MetricsRegistry:
    """Process-global thread-safe counters."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def get(self, name: str) -> Optional[int]:
        with self._lock:
            return self._counters.get(name)

    def set(self, name: str, value: int) -> None:
        with self._lock:
            self._counters[name] = int(value)

    def counters(self) -> Dict[str, int]:
        """A snapshot of every counter."""
        with self._lock:
            return dict(self._counters)


REGISTRY = MetricsRegistry()


def inc(name: str, n: int = 1) -> None:
    """Atomic increment of one counter of the global registry."""
    REGISTRY.inc(name, n)


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

class Span:
    """One timed node of a query's span tree."""

    __slots__ = ("name", "t0", "t1", "attrs", "children")

    def __init__(self, name: str, attrs: Optional[dict] = None):
        self.name = name
        self.t0 = time.perf_counter()
        self.t1: Optional[float] = None
        self.attrs: Dict[str, Any] = dict(attrs) if attrs else {}
        self.children: List["Span"] = []

    @property
    def wall_ms(self) -> float:
        end = self.t1 if self.t1 is not None else time.perf_counter()
        return (end - self.t0) * 1e3

    def walk(self):
        yield self
        for c in list(self.children):
            yield from c.walk()


class QueryTrace:
    """One query's span tree and the counters at its start."""

    __slots__ = ("query", "root", "lock", "counters0", "report")

    def __init__(self, query: str = ""):
        self.query = query
        self.root = Span("query")
        self.lock = threading.Lock()
        self.counters0 = REGISTRY.counters()
        self.report: Optional["QueryReport"] = None


class _Tls(threading.local):
    trace: Optional[QueryTrace] = None
    span: Optional[Span] = None
    node_recorder: Optional["NodeRecorder"] = None
    last_report: Optional["QueryReport"] = None
    exec_profile: Optional[Dict[str, float]] = None


_tls = _Tls()


def current_span() -> Optional[Span]:
    return _tls.span


def current_trace() -> Optional[QueryTrace]:
    return _tls.trace


@contextmanager
def scoped(trace: Optional[QueryTrace], parent: Optional[Span] = None):
    """Install an existing trace (and the span to nest under) in THIS
    thread: worker-pool re-entry, as ``resilience.scoped`` for deadlines."""
    prev_t, prev_s = _tls.trace, _tls.span
    _tls.trace = trace
    _tls.span = parent if parent is not None else (
        trace.root if trace is not None else None)
    try:
        yield
    finally:
        _tls.trace, _tls.span = prev_t, prev_s


@contextmanager
def span(name: str, **attrs):
    """Open a child span under the current one; no-op outside a trace.  An
    escaping exception stamps ``error=<type name>`` on the span."""
    trace = _tls.trace
    parent = _tls.span
    if trace is None or parent is None:
        yield None
        return
    s = Span(name, attrs)
    with trace.lock:
        parent.children.append(s)
    _tls.span = s
    try:
        yield s
    except BaseException as e:
        s.attrs["error"] = type(e).__name__
        raise
    finally:
        s.t1 = time.perf_counter()
        _tls.span = parent


def annotate(**attrs) -> None:
    """Attach attributes to the innermost open span (no-op outside)."""
    s = _tls.span
    if s is not None:
        s.attrs.update(attrs)


def exec_profile() -> Dict[str, float]:
    """This thread's device/materialize timing scratchpad (the compiled
    tier's ``DSQL_TIME_DEVICE`` split)."""
    p = _tls.exec_profile
    if p is None:
        p = _tls.exec_profile = {}
    return p


# ---------------------------------------------------------------------------
# per-node instrumentation (EXPLAIN ANALYZE)
# ---------------------------------------------------------------------------

class NodeRecorder:
    """Per-plan-node [wall ms, rows, calls], keyed by node id.  Walls
    include the node's children (the executor recurses through the same
    entry point); renderers subtract the children's for self time."""

    def __init__(self):
        self.records: Dict[int, List[float]] = {}

    def add(self, rel, ms: float, rows: int) -> None:
        rec = self.records.get(id(rel))
        if rec is None:
            self.records[id(rel)] = [ms, rows, 1]
        else:
            rec[0] += ms
            rec[1] += rows
            rec[2] += 1

    def get(self, rel):
        return self.records.get(id(rel))


def active_node_recorder() -> Optional[NodeRecorder]:
    return _tls.node_recorder


@contextmanager
def record_nodes():
    """Install a ``NodeRecorder`` on this thread for the block."""
    prev = _tls.node_recorder
    rec = NodeRecorder()
    _tls.node_recorder = rec
    try:
        yield rec
    finally:
        _tls.node_recorder = prev


# ---------------------------------------------------------------------------
# reports
# ---------------------------------------------------------------------------

#: span names that sum into the phase breakdown
_PHASE_SPANS = ("parse", "plan", "execute", "fetch")


class QueryReport:
    """What one ``Context.sql`` call did.

    ``phases``: wall ms per span name; ``counters``: registry deltas
    between the trace's open and close (exact when queries do not
    overlap); ``operators``: the adaptive dispatch choices recorded on the
    spans, in span order; ``rows_out`` / ``bytes_out``: the result's rows
    and device bytes; ``root``: the span tree."""

    __slots__ = ("query", "wall_ms", "phases", "counters", "root",
                 "rows_out", "bytes_out", "operators")

    def __init__(self, trace: QueryTrace):
        root = trace.root
        self.query = trace.query
        self.wall_ms = root.wall_ms
        self.root = root
        self.rows_out = int(root.attrs.get("rows_out", 0))
        self.bytes_out = int(root.attrs.get("bytes_out", 0))
        phases: Dict[str, float] = {}
        operators: List[str] = []
        for s in root.walk():
            if s is not root and s.name in _PHASE_SPANS:
                phases[s.name] = phases.get(s.name, 0.0) + s.wall_ms
            operators.extend(str(o) for o in s.attrs.get("operators", ()))
        self.phases = phases
        self.operators = operators
        now = REGISTRY.counters()
        self.counters = {k: now[k] - trace.counters0.get(k, 0)
                         for k in now if now[k] != trace.counters0.get(k, 0)}


#: reports of the last background (non-query) traces, newest last
BACKGROUND_REPORTS: "deque[QueryReport]" = deque(maxlen=16)


def close_background_trace(trace: QueryTrace) -> "QueryReport":
    """Close a trace that is not a query's (a background compile's): its
    report is built and kept in ``BACKGROUND_REPORTS``; no query is
    counted and no thread's ``last_report`` changes."""
    trace.root.t1 = time.perf_counter()
    report = QueryReport(trace)
    trace.report = report
    BACKGROUND_REPORTS.append(report)
    return report


def _close_trace(trace: QueryTrace, error: Optional[BaseException]) -> None:
    trace.root.t1 = time.perf_counter()
    if error is not None:
        trace.root.attrs["error"] = type(error).__name__
        REGISTRY.inc("query_errors")
    trace.report = QueryReport(trace)
    _tls.last_report = trace.report
    REGISTRY.inc("queries")


@contextmanager
def trace_scope(query: str = ""):
    """Open the per-query trace on this thread; yields the QueryTrace.

    A nested call (a query issued while another runs on this thread)
    yields None and rides the enclosing trace: one trace and one report
    per outermost ``Context.sql``."""
    if _tls.trace is not None:
        yield None
        return
    trace = QueryTrace(query)
    _tls.trace = trace
    _tls.span = trace.root
    err: Optional[BaseException] = None
    try:
        yield trace
    except BaseException as e:
        err = e
        raise
    finally:
        _tls.trace = None
        _tls.span = None
        _close_trace(trace, err)


def last_report() -> Optional[QueryReport]:
    """The report of the last trace closed on this thread."""
    return _tls.last_report


# ---------------------------------------------------------------------------
# the dict alias of the counters (physical.compiled.stats)
# ---------------------------------------------------------------------------

class CounterAlias(MutableMapping):
    """Dict-shaped read-through view of ``REGISTRY``'s counters, so that
    ``compiled.stats["compiles"]`` and ``dict(compiled.stats)`` read as in
    the JAX package.  Writes go to the registry; new code increments with
    ``inc``."""

    def __getitem__(self, key: str) -> int:
        v = REGISTRY.get(key)
        if v is None:
            raise KeyError(key)
        return v

    def __setitem__(self, key: str, value: int) -> None:
        REGISTRY.set(key, value)

    def __delitem__(self, key: str) -> None:
        raise TypeError("registry counters cannot be deleted")

    def __iter__(self):
        return iter(REGISTRY.counters())

    def __len__(self) -> int:
        return len(REGISTRY.counters())
