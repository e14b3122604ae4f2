"""Query-lifecycle telemetry: counters, gauges, histograms, spans and a
per-query report.

The counterpart of ``dask_sql_tpu/runtime/telemetry.py``:

- ``REGISTRY`` (a ``MetricsRegistry``): process-global thread-safe
  counters (``inc``), gauges (``set_gauge``: cache and spill tier bytes,
  queue depth, draining) and bounded histograms (``observe``: query,
  parse, plan, execute, compile and materialize walls).  The names in
  ``STABLE_COUNTERS``, ``STABLE_GAUGES`` and ``STABLE_HISTOGRAMS`` are the
  JAX package's public, append-only list; they exist at zero from the
  start.  ``render_prometheus`` is the server's ``GET /metrics`` text:
  counter ``k`` as ``dsql_<k>_total``, gauge ``g`` as ``dsql_<g>``,
  histogram ``h`` as ``dsql_<h>`` with ``_bucket`` / ``_sum`` /
  ``_count``.
- Spans: ``trace_scope(sql)`` opens one trace per outermost query on this
  thread, ``span(name)`` nests a timed child under the current span,
  ``current_span`` returns it and ``annotate`` adds attributes to it.
- ``QueryReport``: built when the trace closes -- phase walls (parse,
  plan, execute, fetch; queued, compile, materialize, stage, ... nested
  under them; ``device`` and ``materialize`` from ``device_ms`` /
  ``materialize_ms`` span attributes), the counter deltas of the query,
  the result cache's verdict (``cache``: hit, tier, stored, subplan hits,
  tier bytes), the execution tier, the admission priority, the operator
  choices, rows and bytes out, and the span tree; ``render``, ``to_dict``
  and ``to_chrome_trace`` present it.  ``Context.sql`` keeps it as
  ``context.last_report``; ``last_report()`` returns the last one closed
  on this thread (the server's per-query wire stats read it).
- ``DSQL_SLOW_QUERY_MS`` logs every query at least that slow (counter
  ``slow_queries``); ``DSQL_CHROME_TRACE_DIR`` writes each query's span
  tree there as chrome://tracing JSON.
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
- Hooks at trace open and close, each behind its variable, checked before
  the import (an unarmed query loads none of the modules): the flight
  recorder (``DSQL_HISTORY_FILE``: ``begin_query`` / ``end_query``,
  ``record_query``), the device profiler (``DSQL_PROFILE``:
  ``on_query_complete``) and the event bus (``DSQL_EVENTS``: the trace id
  stamped on the root, ``query.begin`` / ``query.done``) and the autopilot
  (``DSQL_AUTOPILOT``: ``on_query_complete``, its hints' verdicts); under
  ``DSQL_FLEET_DIR`` every report carries its ``replica``
  (``runtime/fleet.py``).
- ``note_devices`` / ``used_devices``: the devices this process's
  Contexts run on, the only ones the profiler reads memory of;
  ``device_memory_rows``: a device's allocator statistics, which the
  profiler and ``system.devices`` both read.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from collections.abc import MutableMapping
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

# ---------------------------------------------------------------------------
# stable metric names (see the module docstring's stability contract)
# ---------------------------------------------------------------------------

# compile/execute pipeline counters (the old physical.compiled.stats keys,
# meanings unchanged) + streaming + server counters
STABLE_COUNTERS: Tuple[str, ...] = (
    # compiled pipeline
    "compiles", "hits", "fallbacks", "unsupported", "recompiles",
    "compile_errors", "exiled", "split_hints",
    # stage-graph observability
    "stage_graphs", "stage_compiles", "stage_hits", "cross_query_hits",
    # resilience observability
    "retries", "degradations", "deadline_exceeded",
    "fault_compile", "fault_materialize", "fault_stage_exec",
    "fault_stage_replay", "fault_chunked_read", "fault_host_transfer",
    "fault_cache_populate", "fault_admission", "fault_drain",
    "fault_spill",
    # failure-domain recovery (stage replay + quarantine + watchdog):
    # stage_execs counts stage-execution ATTEMPTS; stage_replays counts
    # checkpointed re-executions of a single failed stage;
    # stage_replay_saved_stages counts the already-materialized stages a
    # replay did NOT have to re-run
    "stage_execs", "stage_replays", "stage_replay_saved_stages",
    "quarantine_skips", "quarantine_probes", "quarantine_marks",
    "watchdog_trips",
    # tiered execution (physical/compiled.py): queries answered on the
    # eager tier while their stage programs compiled in the background,
    # background compiles that landed / errored, and compile-worker
    # halvings under consecutive-compile-failure pressure
    "served_eager_while_compiling", "background_compiles_done",
    "background_compile_errors", "compile_backoffs",
    # persistent cross-process program store (runtime/program_store.py)
    "program_store_hits", "program_store_misses", "program_store_stores",
    "program_store_rejects", "program_store_evictions",
    "program_store_errors",
    # workload manager (runtime/scheduler.py): per-class admission
    # outcomes; for any submission mix, admitted + rejected + timeout
    # always sums to the queries that entered admission
    "sched_admitted_interactive", "sched_admitted_batch",
    "sched_admitted_background",
    "sched_rejected_interactive", "sched_rejected_batch",
    "sched_rejected_background",
    "sched_timeout_interactive", "sched_timeout_batch",
    "sched_timeout_background",
    # result & subplan cache (runtime/result_cache.py)
    "result_cache_hits", "result_cache_misses", "result_cache_stores",
    "result_cache_evictions", "result_cache_spills",
    "result_cache_invalidations", "result_cache_subplan_hits",
    # streaming (out-of-HBM) execution
    "stream_batches", "stream_batch_rows",
    # out-of-core spill store (runtime/spill.py): runs opened
    # (spill_partitions — the EXPLAIN ANALYZE "spilled" signal), chunks
    # written, tier movement (host->disk flushes, disk->host loads,
    # device->host demotions), monotonic bytes written per tier, and
    # typed spill-IO failures
    "spill_partitions", "spill_chunks", "spill_flushes", "spill_loads",
    "spill_demotions", "spill_bytes_host", "spill_bytes_disk",
    "spill_errors",
    # grace-hash morsel pipeline (physical/morsel.py): joins lowered to
    # the partitioned path, partition pairs actually joined on device,
    # and pairs whose padded capacity blew past the skew threshold
    "morsel_joins", "morsel_pairs", "morsel_skew_warnings",
    # query lifecycle
    "queries", "query_errors", "slow_queries",
    # server boundary
    "server_queries", "server_query_errors", "server_cancels",
    "server_throttled", "server_drain_rejects",
    # flight recorder (runtime/flight_recorder.py): persisted event-log
    # appends / ring truncations / swallowed recording failures, and the
    # memory-broker estimates served from MEASURED history instead of the
    # scan-bytes×multiplier heuristic (scheduler.estimate_working_set)
    "history_records", "history_truncations", "history_errors",
    "estimate_from_history",
    # SPMD multi-chip backend (parallel/spmd.py): queries/stages served
    # sharded, program compiles vs cross-process store hits, collective
    # traffic (hash-exchange rounds + bytes moved, partial-aggregate
    # trees, broadcast-vs-exchange join dispatch), and the two refusal
    # paths — static gate (unsupported) vs runtime safety flag (fallback)
    "spmd_queries", "spmd_stages", "spmd_compiles", "spmd_store_hits",
    "spmd_exchanges", "spmd_exchange_bytes", "spmd_partial_aggs",
    "spmd_broadcast_joins", "spmd_exchange_joins", "spmd_join_flips",
    "spmd_fallbacks", "spmd_unsupported",
    # collective bytes by kind (parallel/spmd.py via exchange.py static
    # estimators): spmd_exchange_bytes above is the all_to_all channel;
    # these split out the broadcast-join gathers and psum combine trees
    "spmd_all_gather_bytes", "spmd_psum_bytes",
    # device-level profiler (runtime/profiler.py, DSQL_PROFILE=1):
    # memory snapshots taken, cost-analysis captures (compile or
    # program-store load), and scheduler estimates served from the
    # captured cost model (the ladder's fourth rung)
    "profile_samples", "profile_cost_captures", "estimate_from_cost_model",
    # materialized views (runtime/matview.py): serves through the
    # resolve_table hook, O(delta) vs full refreshes (incremental + full
    # reconciles against the staleness events a soak drives), appended
    # batches logged on the delta seam, and the refresh chaos site
    "mv_serves", "mv_refresh_incremental", "mv_refresh_full",
    "mv_deltas_recorded", "fault_mv_refresh",
    # watchtower event bus + SLO monitor (runtime/events.py,
    # DSQL_EVENTS=1): events published to the bounded bus, publishes
    # that failed and were dropped (never the caller's problem), and
    # edge-triggered multi-window SLO burn-rate breaches
    "events_published", "events_dropped", "slo_breaches",
    # parameterized plan identity (plan/parameterize.py):
    # plans that had ≥1 literal hoisted, total literals hoisted, and
    # compiled-path program lookups for parameterized plans that hit
    # (in-memory cache or program store) vs compiled fresh;
    # prepared_executes counts EXECUTE statements served from the
    # per-context PREPARE registry
    "param_plans", "param_literals_hoisted",
    "param_plan_hits", "param_plan_misses",
    "prepared_executes",
    # result spooler (server/app.py): results larger than
    # DSQL_RESULT_PAGE_ROWS spool into the spill store and stream out
    # through nextUri pages; the reaper GCs abandoned results/futures
    # after DSQL_RESULT_TTL_S; fault_result_spool is the injection site
    # (a fired spool fault degrades to the unpaged response, never loses
    # the result)
    "result_spooled", "result_pages_spooled", "result_pages_served",
    "result_reaped", "fault_result_spool",
    # multi-tenancy (runtime/tenancy.py): admissions claimed under a
    # tenant, token-bucket/concurrency quota rejects, circuit-breaker
    # rejects/opens and half-open probes
    "tenant_queries", "tenant_quota_rejects", "tenant_circuit_rejects",
    "tenant_circuit_opens", "tenant_circuit_probes",
    # burn-driven load shedding (runtime/scheduler.py): background-class
    # admissions refused while a class burns its SLO error budget past
    # DSQL_SLO_BURN on both windows (each shed ALSO counts into
    # sched_rejected_background, so the admission reconciliation
    # invariant admitted + rejected + timeout == submitted still holds)
    "sched_shed_background",
    # fleet plane (runtime/fleet.py, DSQL_FLEET_DIR): heartbeat files
    # written / beat failures swallowed, and merged-ring reads served
    # (system.events fleet mode, /v1/events?fleet=1, /v1/fleet)
    "fleet_heartbeats", "fleet_heartbeat_errors", "fleet_merged_reads",
    # autopilot (runtime/autopilot.py, DSQL_AUTOPILOT=1): advisor ticks,
    # matview actuator actions (auto-create / drop / background refresh /
    # exact-repeat serves), and the re-planning loop's hint lifecycle
    # (recorded on a tripped threshold, applied to an execution, reverted
    # after two measured-slower strikes)
    "autopilot_ticks", "autopilot_mv_creates", "autopilot_mv_drops",
    "autopilot_mv_refreshes", "autopilot_mv_serves",
    "autopilot_hints_recorded", "autopilot_hints_applied",
    "autopilot_hints_reverted",
    # continuous ingestion (runtime/ingest.py): WAL-committed
    # batches/rows, micro-batch buffer traffic (buffered appends + flushes
    # that drained them), restart replay, memory-broker backpressure
    # rejects, torn WAL lines skipped on replay, /v1/ingest requests, the
    # fault_ingest injection site, and delta-log compactions that kept a
    # trickle of tiny appends on the incremental path (runtime/matview.py)
    "ingest_batches_committed", "ingest_rows_committed",
    "ingest_batches_buffered", "ingest_flushes",
    "ingest_replayed_batches", "ingest_replayed_rows",
    "ingest_backpressure_rejects", "ingest_wal_torn_lines",
    "server_ingest_requests", "fault_ingest",
    "mv_delta_compactions",
)

STABLE_HISTOGRAMS: Tuple[str, ...] = (
    "query_wall_ms", "parse_ms", "plan_ms", "execute_ms", "compile_ms",
    "materialize_ms",
)

# gauges (point-in-time values, may go down): same append-only contract
STABLE_GAUGES: Tuple[str, ...] = (
    "result_cache_bytes", "result_cache_host_bytes",
    # workload manager: live queue depth (incl. server seats), queries
    # currently executing, and device bytes reserved by admitted queries
    "sched_queue_depth", "sched_running", "sched_reserved_bytes",
    # 1 while the process is draining (SIGTERM/SIGINT received, in-flight
    # queries finishing, new admissions refused), else 0
    "server_draining",
    # spill-store tier occupancy (runtime/spill.py), point-in-time
    "spill_device_bytes", "spill_host_bytes", "spill_disk_bytes",
    # device-memory profiler (runtime/profiler.py): summed local-device
    # HBM truth from the latest memory_stats() sample (zeros on backends
    # without memory stats, e.g. CPU)
    "profile_hbm_bytes_in_use", "profile_hbm_peak_bytes",
    "profile_hbm_bytes_limit",
    # SLO monitor (runtime/events.py, DSQL_EVENTS=1): per-priority-class
    # lifetime attainment and multi-window burn rates (breach fraction
    # over the window / error budget; 1.0 = spending the budget exactly
    # at the sustainable pace)
    "slo_attainment_interactive", "slo_attainment_batch",
    "slo_attainment_background",
    "slo_burn_fast_interactive", "slo_burn_fast_batch",
    "slo_burn_fast_background",
    "slo_burn_slow_interactive", "slo_burn_slow_batch",
    "slo_burn_slow_background",
    # result spooler: live spooled pages + bytes awaiting collection
    "result_spool_pages", "result_spool_bytes",
    # 1 while burn-driven background shedding is active, else 0
    "slo_shedding",
    # tenants the registry has seen this process (runtime/tenancy.py)
    "tenants_known",
    # fleet plane (runtime/fleet.py): replicas within heartbeat TTL at
    # the last fleet snapshot, and the fleet-wide sum of every alive
    # replica's program_store_hits — the shared-warmth proof counter
    "fleet_replicas_alive", "fleet_warm_serves",
    # continuous ingestion (runtime/ingest.py): WAL bytes on disk, rows
    # sitting in un-flushed micro-batch buffers, and view staleness —
    # un-applied delta rows across all registered matview base tables +
    # age in seconds of the oldest pending delta (0 when fully fresh)
    "ingest_wal_bytes", "ingest_buffered_rows",
    "mv_pending_rows", "mv_staleness_s",
)

# exponential-ish bucket bounds in milliseconds; histograms are BOUNDED by
# construction (fixed bucket count + running sum/count, O(1) per observe)
_BUCKETS_MS: Tuple[float, ...] = (
    1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000, 10000, 30000,
    120000,
)


class _Histogram:
    __slots__ = ("counts", "total", "count")

    def __init__(self):
        self.counts = [0] * (len(_BUCKETS_MS) + 1)
        self.total = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        i = 0
        for i, b in enumerate(_BUCKETS_MS):
            if value <= b:
                break
        else:
            i = len(_BUCKETS_MS)
        self.counts[i] += 1
        self.total += value
        self.count += 1

    def snapshot(self) -> dict:
        return {"buckets": list(zip(_BUCKETS_MS, self.counts)),
                "overflow": self.counts[-1],
                "sum": self.total, "count": self.count}


class MetricsRegistry:
    """Process-global thread-safe counters + bounded histograms.

    ``inc`` is atomic; ``set`` exists for the dict-alias write path.
    Counter names in STABLE_COUNTERS pre-exist at zero so snapshot
    consumers never KeyError on a counter that has not fired.
    """

    def __init__(self, seed: Tuple[str, ...] = (),
                 gauge_seed: Tuple[str, ...] = ()):
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {k: 0 for k in seed}
        self._gauges: Dict[str, float] = {k: 0 for k in gauge_seed}
        self._hists: Dict[str, _Histogram] = {}

    # -- counters ----------------------------------------------------------
    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def set(self, name: str, value: int) -> None:
        with self._lock:
            self._counters[name] = int(value)

    def get(self, name: str, default: Optional[int] = None) -> Optional[int]:
        with self._lock:
            return self._counters.get(name, default)

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    # -- gauges ------------------------------------------------------------
    def set_gauge(self, name: str, value: float) -> None:
        """Point-in-time value (cache sizes, pool depths): unlike counters
        a gauge may go DOWN; prometheus renders it without ``_total``."""
        with self._lock:
            self._gauges[name] = value

    def get_gauge(self, name: str, default: float = 0.0) -> float:
        with self._lock:
            return self._gauges.get(name, default)

    def gauges(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._gauges)

    # -- histograms --------------------------------------------------------
    def observe(self, name: str, value_ms: float) -> None:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = _Histogram()
            h.observe(float(value_ms))

    def snapshot(self) -> dict:
        with self._lock:
            return {"counters": dict(self._counters),
                    "gauges": dict(self._gauges),
                    "histograms": {k: h.snapshot()
                                   for k, h in self._hists.items()}}

    def reset(self) -> None:
        """Zero everything (tests only; production counters are
        monotonic by contract)."""
        with self._lock:
            for k in self._counters:
                self._counters[k] = 0
            for k in self._gauges:
                self._gauges[k] = 0
            self._hists.clear()

    # -- prometheus --------------------------------------------------------
    def render_prometheus(self,
                          labels: Optional[Dict[str, str]] = None) -> str:
        """Prometheus text exposition (text/plain; version=0.0.4).

        Counter ``k`` -> ``dsql_<k>_total``; histogram ``h`` ->
        ``dsql_<h>`` with le-bucketed ``_bucket`` series + ``_sum`` +
        ``_count``.  Names are sanitized to the prometheus charset.
        ``labels`` (e.g. ``{"replica": "r1"}`` when a fleet dir is
        armed) are stamped on EVERY series; with none the exposition is
        byte-identical to the label-free historical format.
        """
        def clean(name: str) -> str:
            return "".join(c if (c.isalnum() or c == "_") else "_"
                           for c in name)

        base = ""
        if labels:
            base = ",".join(f'{clean(k)}="{v}"'
                            for k, v in sorted(labels.items()))

        def series(m: str, extra: str = "") -> str:
            parts = ",".join(p for p in (base, extra) if p)
            return f"{m}{{{parts}}}" if parts else m

        snap = self.snapshot()
        out: List[str] = []
        for k in sorted(snap["counters"]):
            m = f"dsql_{clean(k)}_total"
            out.append(f"# TYPE {m} counter")
            out.append(f"{series(m)} {snap['counters'][k]}")
        for k in sorted(snap.get("gauges", ())):
            m = f"dsql_{clean(k)}"
            out.append(f"# TYPE {m} gauge")
            out.append(f"{series(m)} {snap['gauges'][k]:g}")
        for k in sorted(snap["histograms"]):
            h = snap["histograms"][k]
            m = f"dsql_{clean(k)}"
            out.append(f"# TYPE {m} histogram")
            acc = 0
            for bound, c in h["buckets"]:
                acc += c
                le = 'le="%g"' % bound
                out.append(f"{series(m + '_bucket', le)} {acc}")
            acc += h["overflow"]
            inf = 'le="+Inf"'
            out.append(f"{series(m + '_bucket', inf)} {acc}")
            out.append(f"{series(m + '_sum')} {h['sum']:.6g}")
            out.append(f"{series(m + '_count')} {h['count']}")
        return "\n".join(out) + "\n"


REGISTRY = MetricsRegistry(seed=STABLE_COUNTERS, gauge_seed=STABLE_GAUGES)


def inc(name: str, n: int = 1) -> None:
    """Atomic increment of one counter of the global registry."""
    REGISTRY.inc(name, n)


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

class Span:
    """One timed node of a query's span tree."""

    __slots__ = ("name", "t0", "t1", "attrs", "children", "tid")

    def __init__(self, name: str, attrs: Optional[dict] = None):
        self.name = name
        self.t0 = time.perf_counter()
        self.t1: Optional[float] = None
        self.attrs: Dict[str, Any] = dict(attrs) if attrs else {}
        self.children: List["Span"] = []
        self.tid = threading.get_ident()

    @property
    def wall_ms(self) -> float:
        end = self.t1 if self.t1 is not None else time.perf_counter()
        return (end - self.t0) * 1e3

    def walk(self):
        yield self
        for c in list(self.children):
            yield from c.walk()

    def to_dict(self) -> dict:
        return {"name": self.name, "wall_ms": round(self.wall_ms, 3),
                "attrs": dict(self.attrs),
                "children": [c.to_dict() for c in self.children]}


class QueryTrace:
    """One query's span tree and the counters at its start."""

    __slots__ = ("query", "root", "lock", "counters0", "report",
                 "started_unix")

    def __init__(self, query: str = ""):
        self.query = query
        self.root = Span("query")
        self.lock = threading.Lock()
        self.counters0 = REGISTRY.counters()
        self.report: Optional["QueryReport"] = None
        self.started_unix = time.time()


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

#: span names that sum into the phase breakdown; ``device`` and
#: ``materialize`` also arrive as span attributes (``device_ms``,
#: ``materialize_ms``) when ``DSQL_TIME_DEVICE`` splits a run
_PHASE_SPANS = ("parse", "plan", "execute", "fetch", "compile",
                "materialize", "stage", "stage_graph", "stream_batch",
                "queued", "retry_backoff", "drain")


def _fleet_replica() -> Optional[str]:
    """This replica's id under ``DSQL_FLEET_DIR`` (read before the
    import), else None."""
    if not os.environ.get("DSQL_FLEET_DIR"):
        return None
    try:
        from . import fleet as _fleet
        return _fleet.replica_id()
    except Exception:
        return None


class QueryReport:
    """What one ``Context.sql`` call did.

    ``phases``: wall ms per span name (parse, plan, execute and fetch
    partition the wall; the others nest under execute); ``counters``:
    registry deltas between the trace's open and close (exact when queries
    do not overlap, an upper bound under concurrency); ``cache``: the
    result cache's verdict from the span attributes; ``tier``: the
    execution tier (``compiled``, ``eager`` or ``eager-compiling``);
    ``priority``: the admission class from the ``queued`` span;
    ``operators``: the adaptive dispatch choices in span order;
    ``rows_out`` / ``bytes_out``: the result's rows and device bytes;
    ``root``: the span tree."""

    __slots__ = ("query", "wall_ms", "phases", "counters", "root",
                 "rows_out", "bytes_out", "started_unix", "cache", "tier",
                 "priority", "operators", "spilled", "skew_ratio",
                 "collective_bytes", "cost_err", "trace_id", "tenant",
                 "replica")

    def __init__(self, trace: QueryTrace):
        root = trace.root
        self.query = trace.query
        self.started_unix = trace.started_unix
        self.wall_ms = root.wall_ms
        self.root = root
        # the end-to-end trace id (runtime/events.py stamps it on the root
        # at trace open when DSQL_EVENTS is armed); consumers emit the
        # field only when present
        tid = root.attrs.get("trace_id")
        self.trace_id = str(tid) if tid else None
        ten = root.attrs.get("tenant")
        self.tenant = str(ten) if ten else None
        # the fleet replica's id, only under DSQL_FLEET_DIR (read before
        # the import): an unarmed report keeps its keys
        self.replica = _fleet_replica()
        self.rows_out = int(root.attrs.get("rows_out", 0))
        self.bytes_out = int(root.attrs.get("bytes_out", 0))
        phases: Dict[str, float] = {}
        hit = stored = False
        tier: Optional[str] = None
        subplan_hits = 0
        exec_tier: Optional[str] = None
        priority: Optional[str] = None
        operators: List[str] = []
        for s in root.walk():
            if s is not root and s.name in _PHASE_SPANS:
                phases[s.name] = phases.get(s.name, 0.0) + s.wall_ms
            for k in ("device_ms", "materialize_ms"):
                v = s.attrs.get(k)
                if v is not None and s is not root:
                    phases[k[:-3]] = phases.get(k[:-3], 0.0) + float(v)
            rc = s.attrs.get("result_cache")
            if rc == "hit":
                hit = True
                tier = s.attrs.get("result_cache_tier", tier)
            elif rc == "store":
                stored = True
            if s.attrs.get("subplan_cache") == "hit":
                subplan_hits += 1
            t = s.attrs.get("tier")
            if t is not None and exec_tier is None:
                exec_tier = str(t)
            if s.name == "queued" and priority is None:
                p = s.attrs.get("priority")
                priority = str(p) if p is not None else None
            operators.extend(str(o) for o in s.attrs.get("operators", ()))
        self.phases = phases
        self.tier = exec_tier
        self.priority = priority
        self.operators = operators
        now = REGISTRY.counters()
        self.counters = {k: now[k] - trace.counters0.get(k, 0)
                         for k in now if now[k] != trace.counters0.get(k, 0)}
        self.spilled = (self.counters.get("spill_partitions", 0) > 0
                        or any(s.attrs.get("spilled") for s in root.walk()))
        self.cache = {"hit": hit, "tier": tier, "stored": stored,
                      "subplan_hits": subplan_hits,
                      "bytes": int(REGISTRY.get_gauge("result_cache_bytes")),
                      "host_bytes":
                          int(REGISTRY.get_gauge("result_cache_host_bytes"))}
        # the device-level profile: worst shard/partition skew (SPMD
        # stages and grace-hash joins annotate ``skew_ratio``), collective
        # bytes by kind, and the counted cost's error against the measured
        # bytes (the result plus every materialized stage boundary, the
        # flight recorder's definition); None when nothing annotated them
        skew: Optional[float] = None
        coll: Dict[str, int] = {}
        cost_bytes = 0.0
        measured = 0
        for s in root.walk():
            r = s.attrs.get("skew_ratio")
            if r is not None:
                skew = max(float(r), skew) if skew is not None else float(r)
            for attr, kind in (("spmd_exchange_bytes", "all_to_all"),
                               ("spmd_all_gather_bytes", "all_gather"),
                               ("spmd_psum_bytes", "psum")):
                v = s.attrs.get(attr)
                if v:
                    coll[kind] = coll.get(kind, 0) + int(v)
            cb = s.attrs.get("cost_bytes")
            if cb:
                cost_bytes += float(cb)
            sb = s.attrs.get("stage_bytes")
            if sb:
                measured += int(sb)
        self.skew_ratio = round(skew, 3) if skew is not None else None
        self.collective_bytes = coll or None
        measured += self.bytes_out
        self.cost_err = (round(abs(cost_bytes - measured) / measured, 4)
                         if cost_bytes and measured else None)

    def span_count(self, name: str) -> int:
        return sum(1 for s in self.root.walk() if s.name == name)

    def to_dict(self) -> dict:
        out = {"query": self.query, "wall_ms": round(self.wall_ms, 3),
                "trace_id": self.trace_id, "tenant": self.tenant,
                "phases": {k: round(v, 3) for k, v in self.phases.items()},
                "counters": dict(self.counters),
                "cache": dict(self.cache), "tier": self.tier,
                "priority": self.priority,
                "operators": list(self.operators),
                "spilled": self.spilled,
                "skew_ratio": self.skew_ratio,
                "collective_bytes": self.collective_bytes,
                "cost_err": self.cost_err,
                "rows_out": self.rows_out, "bytes_out": self.bytes_out,
                "spans": self.root.to_dict()}
        if self.replica:
            out["replica"] = self.replica
        return out

    def render(self) -> str:
        """Human-readable report: header + indented span tree."""
        lines = [f"query: {self.query.strip()[:200]}",
                 f"wall: {self.wall_ms:.2f} ms  rows_out: {self.rows_out}"
                 f"  bytes_out: {self.bytes_out}"]
        if self.phases:
            lines.append("phases: " + "  ".join(
                f"{k}={v:.2f}ms" for k, v in sorted(self.phases.items())))
        if self.counters:
            lines.append("counters: " + "  ".join(
                f"{k}=+{v}" for k, v in sorted(self.counters.items())))
        if self.operators:
            lines.append("operators: " + "; ".join(self.operators))
        if self.spilled:
            lines.append("spilled: true")
        if self.skew_ratio is not None:
            lines.append(f"skew_ratio: {self.skew_ratio}")
        if self.collective_bytes:
            lines.append("collective_bytes: " + "  ".join(
                f"{k}={v}" for k, v in sorted(self.collective_bytes.items())))
        if self.cost_err is not None:
            lines.append(f"cost_err: {self.cost_err}")

        def walk(s: Span, depth: int):
            attrs = "".join(f" {k}={v}" for k, v in sorted(s.attrs.items()))
            lines.append(f"{'  ' * depth}{s.name}: {s.wall_ms:.2f} ms"
                         + attrs)
            for c in s.children:
                walk(c, depth + 1)

        walk(self.root, 0)
        return "\n".join(lines)

    def to_chrome_trace(self) -> dict:
        """chrome://tracing ("Trace Event Format") JSON of the span tree:
        complete ("X") events in microseconds relative to the root."""
        t0 = self.root.t0
        events = []
        for s in self.root.walk():
            end = s.t1 if s.t1 is not None else time.perf_counter()
            events.append({
                "name": s.name, "ph": "X", "pid": os.getpid(),
                "tid": s.tid,
                "ts": round((s.t0 - t0) * 1e6, 1),
                "dur": round((end - s.t0) * 1e6, 1),
                "args": {k: (v if isinstance(v, (int, float, str, bool))
                             else repr(v))
                         for k, v in s.attrs.items()},
            })
        other = {"query": self.query[:500]}
        if self.trace_id:
            other["trace_id"] = self.trace_id
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": other}


def _env_float(name: str) -> Optional[float]:
    raw = os.environ.get(name, "")
    try:
        return float(raw) if raw else None
    except ValueError:
        return None


_chrome_counter = [0]
_chrome_lock = threading.Lock()


def _export_chrome_trace(report: QueryReport) -> None:
    """Write the span tree as chrome://tracing JSON when
    ``DSQL_CHROME_TRACE_DIR`` is set (one file per trace)."""
    trace_dir = os.environ.get("DSQL_CHROME_TRACE_DIR")
    if not trace_dir:
        return
    try:
        os.makedirs(trace_dir, exist_ok=True)
        with _chrome_lock:
            _chrome_counter[0] += 1
            n = _chrome_counter[0]
        path = os.path.join(
            trace_dir, f"query_{os.getpid()}_{n:05d}.trace.json")
        with open(path, "w") as f:
            json.dump(report.to_chrome_trace(), f)
    except OSError as e:  # telemetry must never fail the query
        logger.debug("chrome trace export failed: %s", e)


#: reports of the last background (non-query) traces, newest last
BACKGROUND_REPORTS: "deque[QueryReport]" = deque(maxlen=16)


def close_background_trace(trace: QueryTrace) -> "QueryReport":
    """Close a trace that is not a query's (a background compile's): its
    report is built, exported and kept in ``BACKGROUND_REPORTS``; no query
    is counted and no thread's ``last_report`` changes."""
    trace.root.t1 = time.perf_counter()
    report = QueryReport(trace)
    trace.report = report
    BACKGROUND_REPORTS.append(report)
    _export_chrome_trace(report)
    return report


def _close_trace(trace: QueryTrace, error: Optional[BaseException]) -> None:
    trace.root.t1 = time.perf_counter()
    if error is not None:
        trace.root.attrs["error"] = type(error).__name__
        REGISTRY.inc("query_errors")
    report = QueryReport(trace)
    trace.report = report
    _tls.last_report = report
    REGISTRY.inc("queries")
    REGISTRY.observe("query_wall_ms", report.wall_ms)
    for name in ("parse", "plan", "execute", "compile", "materialize"):
        v = report.phases.get(name)
        if v is not None:
            REGISTRY.observe(f"{name}_ms", v)
    slow_ms = _env_float("DSQL_SLOW_QUERY_MS")
    if slow_ms is not None and report.wall_ms >= slow_ms:
        REGISTRY.inc("slow_queries")
        logger.warning(
            "slow query (%.0f ms >= DSQL_SLOW_QUERY_MS=%.0f): %s | tier: %s "
            "| cacheHit: %s | priority: %s | skew: %s | collectives: %s "
            "| costErr: %s | phases: %s | counters: %s%s%s",
            report.wall_ms, slow_ms, report.query.strip()[:500],
            report.tier or "eager", bool(report.cache.get("hit")),
            report.priority or "-",
            report.skew_ratio if report.skew_ratio is not None else "-",
            report.collective_bytes or "-",
            report.cost_err if report.cost_err is not None else "-",
            {k: round(v, 1) for k, v in sorted(report.phases.items())},
            dict(sorted(report.counters.items())),
            f" | trace: {report.trace_id}" if report.trace_id else "",
            f" | tenant: {report.tenant}" if report.tenant else "")
    _export_chrome_trace(report)

    # the armed subsystems, each variable checked before its import
    from . import gates
    if gates.history_on():
        try:
            from . import flight_recorder as _fr
            _fr.record_query(report, error)
        except Exception:
            REGISTRY.inc("history_errors")
            logger.debug("flight recorder append failed", exc_info=True)
    if gates.profile_on():
        try:
            from . import profiler as _prof
            _prof.on_query_complete(report)
        except Exception:
            logger.debug("profiler query hook failed", exc_info=True)
    if gates.events_on():
        try:
            from . import events as _ev
            _ev.on_query_complete(report, error)
        except Exception:
            logger.debug("event hook failed", exc_info=True)
    # the autopilot's feedback: a hinted run's verdict, or a new hint
    if gates.armed("DSQL_AUTOPILOT"):
        try:
            from . import autopilot as _ap
            _ap.on_query_complete(report, error)
        except Exception:
            logger.debug("autopilot hook failed", exc_info=True)


@contextmanager
def trace_scope(query: str = ""):
    """Open the per-query trace on this thread; yields the QueryTrace.

    A nested call (a query issued while another runs on this thread)
    yields None and rides the enclosing trace: one trace and one report
    per outermost ``Context.sql``.  The flight recorder registers the open
    trace and the event bus stamps its trace id when their variables arm
    them."""
    if _tls.trace is not None:
        yield None
        return
    from . import gates
    trace = QueryTrace(query)
    _tls.trace = trace
    _tls.span = trace.root
    _tls.exec_profile = {}
    # the live-query registry of GET /v1/engine
    registered = False
    if gates.history_on():
        try:
            from . import flight_recorder as _fr
            registered = _fr.begin_query(trace)
        except Exception:
            logger.debug("flight recorder begin failed", exc_info=True)
    # ingress: the end-to-end trace id on the root, and query.begin
    if gates.events_on():
        try:
            from . import events as _ev
            _ev.on_trace_open(trace)
        except Exception:
            logger.debug("event trace-open hook failed", exc_info=True)
    err: Optional[BaseException] = None
    try:
        yield trace
    except BaseException as e:
        err = e
        raise
    finally:
        _tls.trace = None
        _tls.span = None
        try:
            _close_trace(trace, err)
        except Exception:  # never mask the query's result
            logger.exception("telemetry close failed")
        if registered:
            _fr.end_query(trace)


def last_report() -> Optional[QueryReport]:
    """The report of the last trace closed on this thread."""
    return _tls.last_report


# ---------------------------------------------------------------------------
# the devices in use (the profiler's memory rows read only these)
# ---------------------------------------------------------------------------

_devices_lock = threading.Lock()
_USED_DEVICES: Dict[str, Any] = {}


def note_devices(*devices) -> None:
    """Record devices this process runs on (each Context notes its device
    and its mesh's, in order of first use)."""
    import torch

    with _devices_lock:
        for d in devices:
            d = torch.device(d)
            _USED_DEVICES.setdefault(str(d), d)


def used_devices() -> list:
    with _devices_lock:
        return list(_USED_DEVICES.values())


#: a card's total memory by index, read once (``device_memory_rows``)
CARD_LIMITS: Dict[int, int] = {}


def _card_limit(index: int) -> int:
    lim = CARD_LIMITS.get(index)
    if lim is None:
        import torch
        lim = CARD_LIMITS[index] = int(
            torch.cuda.get_device_properties(index).total_memory)
    return lim


def device_memory_rows(devices) -> List[Dict[str, Any]]:
    """One row per device of ``devices``, each once: a card's from the
    caching allocator's host-side statistics (``memory_stats``: bytes
    allocated now and at the peak; its total memory as the limit), which
    take no synchronisation; a CPU device's zeros.  A card whose
    statistics cannot be read raises: a row never shows a made-up zero
    for a card.  The profiler's samples and ``system.devices`` both read
    here, so that the system table needs no profiler."""
    import torch

    rows: List[Dict[str, Any]] = []
    for dev in dict.fromkeys(torch.device(d) for d in devices):
        if dev.type == "cuda":
            index = dev.index if dev.index is not None else \
                torch.cuda.current_device()
            mem = torch.cuda.memory_stats(index)
            rows.append({
                "id": int(index),
                "platform": "gpu",
                "kind": torch.cuda.get_device_name(index),
                "bytes_in_use": int(mem.get("allocated_bytes.all.current",
                                            0)),
                "peak_bytes_in_use": int(mem.get("allocated_bytes.all.peak",
                                                 0)),
                "bytes_limit": _card_limit(index),
            })
        else:
            rows.append({"id": int(dev.index or 0), "platform": dev.type,
                         "kind": dev.type, "bytes_in_use": 0,
                         "peak_bytes_in_use": 0, "bytes_limit": 0})
    return rows


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
