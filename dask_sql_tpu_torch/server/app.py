"""The Presto-wire HTTP server on the port.

The counterpart of ``dask_sql_tpu/server/app.py``, on the standard
library's ``http.server`` as there: ``POST /v1/statement`` submits SQL
(headers ``X-DSQL-Priority`` and ``X-DSQL-Tenant``; a JSON body
``{"sql": ..., "params": [...]}`` binds ``?`` markers),
``GET /v1/status/{id}`` polls, ``GET /v1/result/{id}/{page}`` pages a
large result, ``DELETE /v1/cancel/{id}`` cancels, ``GET /v1/empty`` is an
empty result, ``GET /v1/engine`` is one snapshot of the engine (queries,
the workload manager, the ledger, the result cache, the spill store,
quarantine, background builds, tenants, the card's memory) and
``GET /metrics`` the telemetry registry in Prometheus text.

- **Admission.**  Each POST claims the tenant's quota
  (``runtime/tenancy.py``) and a seat in the workload manager
  (``runtime/scheduler.py``) before the query enters the worker pool
  (``DSQL_SERVER_WORKERS``, default the manager's limit): a saturated
  engine answers 429 + ``Retry-After`` at once.  ``ERROR_WIRE_MATRIX``
  maps every typed verdict to its submit-time status, ``errorType`` and
  ``errorName``; a verdict raised after submission rides a FAILED payload
  with HTTP 200, as in Presto.
- **Paging.**  A result over ``DSQL_RESULT_PAGE_ROWS`` rows (default
  10,000; 0 turns paging off) is spooled into pages in the spill store
  (``runtime/spill.py``): page 0 answers the status poll, the rest page
  through ``nextUri`` and free as fetched.  A reaper forgets
  never-collected results after ``DSQL_RESULT_TTL_S`` (default 600).
- **Drain.**  SIGTERM/SIGINT (``run_server(blocking=True)``) or
  ``server.drain_async()`` makes new POSTs answer 503 + ``Retry-After``
  while queries in flight finish within ``DSQL_DRAIN_TIMEOUT_S``; then
  stragglers are cancelled and the listener closes.

- **Ingest.**  With ``DSQL_INGEST_DIR`` armed (``runtime/ingest.py``),
  ``POST /v1/ingest`` appends one batch per request through
  ``Context.append_rows`` and the write-ahead log: 200 ``COMMITTED`` or
  ``BUFFERED``, 400 on a ``SchemaMismatch``, 429 with ``Retry-After`` on
  backpressure or a tenant's quota, 503 while draining; ``/v1/engine``
  gains an ``ingest`` section, and a drain commits the buffered rows.
  Unarmed, the route answers 404.

- The event bus (``DSQL_EVENTS``, ``runtime/events.py``): every response
  to a statement carries ``X-DSQL-Trace`` (the client's id when valid,
  else a minted one; the final stats add ``traceId``), the query's span
  tree, history envelope and events carry the same id, ``GET
  /v1/events?cursor=&limit=&timeout_ms=`` long-polls the bus as JSON lines
  (the next cursor in ``X-DSQL-Cursor``), and rejections, cancels and a
  drain publish ``server.rejected`` / ``server.cancel`` /
  ``server.drain``.  Unarmed, no header is sent and ``/v1/events``
  answers 404.
- ``GET /v1/engine``'s ``active`` and ``history`` sections read the flight
  recorder (``DSQL_HISTORY_FILE``), ``profile`` the device profiler
  (``DSQL_PROFILE``) and ``slo`` the event bus; each reads as disabled
  while its variable is unset, and its module stays unloaded.

- The fleet plane (``DSQL_FLEET_DIR``, ``runtime/fleet.py``):
  ``run_server`` arms it before serving; ``GET /v1/fleet`` is the fleet's
  snapshot (every replica's heartbeat, sums over the live ones, SLOs over
  the union of their envelopes), ``GET /v1/events?fleet=1`` long-polls
  every replica's ring merged, with a composite ``replica:seq;...`` cursor,
  every ``/metrics`` series carries a ``replica`` label, and
  ``/v1/engine`` gains a ``fleet`` section.  Unarmed, ``/v1/fleet``
  answers 404 and no label is written.  ``DSQL_AUTOPILOT`` adds the
  ``autopilot`` section (``runtime/autopilot.py``).

Rows travel as ``Table.to_pylist`` values, without pandas (the card's
machine has none).  With ``DSQL_PROGRAM_STORE`` set, ``run_server``
serves over the program store like any other context (a query's
``programStoreHits`` in its stats), and ``/v1/engine``'s
``programStore`` section gives the store's entries and bytes.
"""
from __future__ import annotations

import json
import logging
import math
import os
import threading
import time
import uuid as uuid_mod
from concurrent.futures import Future, ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

from ..runtime import (faults as _faults, ingest as _ing,
                       resilience as _res, scheduler as _sched,
                       telemetry as _tel)
from ..runtime.gates import (armed as _armed, events_on as _events_on,
                             history_on as _history_on,
                             profile_on as _profile_on,
                             tenancy_on as _tenancy_on)

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# taxonomy -> wire mapping.  The submit-time status is what POST
# /v1/statement answers when the verdict is known before a query id exists
# (admission, drain); verdicts raised later ride the Presto convention:
# HTTP 200 with a FAILED payload carrying errorType/errorName/errorCode.
# ---------------------------------------------------------------------------

ERROR_WIRE_MATRIX = {
    # class name: (submit-time HTTP status, errorType, errorName)
    "UserError": (200, "USER_ERROR", "GENERIC_USER_ERROR"),
    "QueryCancelled": (200, "USER_ERROR", "USER_CANCELED"),
    "TransientError": (200, "INTERNAL_ERROR", "TRANSIENT_ERROR"),
    "FatalError": (200, "INTERNAL_ERROR", "GENERIC_INTERNAL_ERROR"),
    "FaultInjected": (200, "INTERNAL_ERROR", "FAULT_INJECTED"),
    "FatalFaultInjected": (200, "INTERNAL_ERROR", "FAULT_INJECTED"),
    "DeadlineExceeded": (200, "INSUFFICIENT_RESOURCES",
                         "EXCEEDED_TIME_LIMIT"),
    "AdmissionRejected": (429, "INSUFFICIENT_RESOURCES", "QUERY_QUEUE_FULL"),
    "AdmissionTimeout": (429, "INSUFFICIENT_RESOURCES",
                         "QUERY_QUEUE_TIMEOUT"),
    "TenantQuotaExceeded": (429, "INSUFFICIENT_RESOURCES",
                            "TENANT_QUOTA_EXCEEDED"),
    "TenantCircuitOpen": (429, "INSUFFICIENT_RESOURCES",
                          "TENANT_CIRCUIT_OPEN"),
    "LoadShedRejected": (429, "INSUFFICIENT_RESOURCES", "SLO_LOAD_SHED"),
    "IngestBackpressure": (429, "INSUFFICIENT_RESOURCES",
                           "INGEST_BACKPRESSURE"),
    "SchemaMismatch": (400, "USER_ERROR", "SCHEMA_MISMATCH"),
    "ServerDraining": (503, "INSUFFICIENT_RESOURCES",
                       "SERVER_SHUTTING_DOWN"),
    "SpillError": (200, "INTERNAL_ERROR", "SPILL_ERROR"),
    "SpillCorrupt": (200, "INTERNAL_ERROR", "SPILL_CORRUPT"),
    # the port's own: a sticky CUDA error (runtime/resilience.py)
    "DeviceLost": (200, "INTERNAL_ERROR", "DEVICE_LOST"),
}


def _page_rows() -> int:
    """Result-paging threshold (``DSQL_RESULT_PAGE_ROWS``): results with
    more rows spool into spill-store pages of this many rows; 0 serves
    every result in one payload."""
    try:
        return max(int(os.environ.get("DSQL_RESULT_PAGE_ROWS", "")
                       or 10_000), 0)
    except ValueError:
        return 10_000


def _result_ttl_s() -> float:
    """Reaper TTL (``DSQL_RESULT_TTL_S``): finished-but-never-collected
    queries and abandoned spools are forgotten this many seconds after
    their last touch (0: never)."""
    try:
        return max(float(os.environ.get("DSQL_RESULT_TTL_S", "") or 600.0),
                   0.0)
    except ValueError:
        return 600.0


def submit_status(exc: Exception) -> int:
    """HTTP status for a verdict raised at the POST boundary: 503 while
    draining, 429 on saturation, 400 for a schema mismatch, 200 otherwise
    (the error then travels in the Presto payload)."""
    if isinstance(exc, _res.ServerDraining):
        return 503
    if isinstance(exc, _res.AdmissionRejected):
        return 429
    if isinstance(exc, _res.SchemaMismatch):
        return 400
    return 200


# ---------------------------------------------------------------------------
# presto wire responses
# ---------------------------------------------------------------------------

def _stats(state: str, info: Optional["_QueryInfo"] = None) -> dict:
    """The Presto stats object, filled from the query's own execution:
    times, rows, bytes, the card's peak memory, program-cache and
    result-cache verdicts, the tier, the operator choices and the phase
    walls of its QueryReport; the queue columns read the workload
    manager."""
    out = {
        "state": state, "queued": state == "QUEUED", "scheduled": True,
        "nodes": 1, "totalSplits": 1, "queuedSplits": int(state == "QUEUED"),
        "runningSplits": int(state == "RUNNING"),
        "completedSplits": int(state == "FINISHED"),
        "cpuTimeMillis": 0, "wallTimeMillis": 0,
        "queuedTimeMillis": 0, "elapsedTimeMillis": 0, "processedRows": 0,
        "processedBytes": 0, "peakMemoryBytes": 0,
    }
    mgr = _sched.get_manager()
    if mgr.enabled():
        out["queuedSplits"] = mgr.queue_depth()
        out["runningSplits"] = mgr.running_count()
    if info is not None:
        now = time.monotonic()
        started = info.started or now
        finished = info.finished or now
        if info.queued_ms is not None:
            # the scheduler's own timestamps: seat claim at POST ->
            # admission grant (pool wait + admission-queue wait)
            out["queuedTimeMillis"] = int(info.queued_ms)
        else:
            out["queuedTimeMillis"] = int(1000 * (started - info.submitted))
        out["wallTimeMillis"] = int(1000 * max(finished - started, 0))
        out["elapsedTimeMillis"] = int(1000 * (finished - info.submitted))
        out["cpuTimeMillis"] = int(1000 * info.cpu_sec)
        out["processedRows"] = info.rows
        out["processedBytes"] = info.bytes
        out["peakMemoryBytes"] = info.peak_memory
        out["compiledPrograms"] = info.compiles
        out["programCacheHits"] = info.cache_hits
        out["cacheHit"] = bool(info.cache_hit)
        if info.cache_tier:
            out["cacheTier"] = info.cache_tier
        if info.subplan_cache_hits:
            out["subplanCacheHits"] = info.subplan_cache_hits
        if info.tier:
            out["tier"] = info.tier
        # the program-store records this query was built from
        if info.program_store_hits:
            out["programStoreHits"] = info.program_store_hits
        if info.operators:
            out["operatorChoices"] = list(info.operators)
        if info.phases:
            out["phaseMillis"] = {k: round(v, 3)
                                  for k, v in info.phases.items()}
        # the end-to-end trace id (DSQL_EVENTS), as X-DSQL-Trace carries it
        if info.trace_id:
            out["traceId"] = info.trace_id
    return out


class _QueryInfo:
    __slots__ = ("submitted", "started", "finished", "cpu_sec", "rows",
                 "bytes", "peak_memory", "compiles", "cache_hits", "phases",
                 "cache_hit", "cache_tier", "subplan_cache_hits",
                 "queued_ms", "tier", "program_store_hits", "operators",
                 "trace_id")

    def __init__(self):
        self.submitted = time.monotonic()
        self.started = None
        self.finished = None
        self.cpu_sec = 0.0
        self.rows = 0
        self.bytes = 0
        self.peak_memory = 0
        self.compiles = 0
        self.cache_hits = 0
        self.phases = {}
        self.cache_hit = False
        self.cache_tier = None
        self.subplan_cache_hits = 0
        self.queued_ms = None
        self.tier = None
        self.program_store_hits = 0
        self.operators = []
        self.trace_id = None


def _peak_memory(context) -> int:
    """The card's peak allocated bytes (``torch.cuda.memory_stats``); 0 on
    the CPU.  Under a mesh the peaks of its distinct cards add up: the
    query's working set is sharded, and one card alone understates it."""
    import torch

    device = getattr(context, "device", None)
    mesh = getattr(context, "mesh", None)
    devices = [device] if mesh is None else mesh.distinct_devices()
    peak = 0
    for d in devices:
        if d is None or d.type != "cuda":
            continue
        try:
            stats = torch.cuda.memory_stats(d)
        except Exception as e:  # telemetry only; never fail the query
            logger.debug("memory_stats unavailable: %s", e)
            continue
        peak += int(stats.get("allocated_bytes.all.peak", 0) or 0)
    return peak


def _run_tracked(context, sql: str, info: _QueryInfo,
                 cancel: Optional[threading.Event] = None,
                 seat: Optional[_sched.Seat] = None,
                 params: Optional[list] = None,
                 grant=None, trace_id: Optional[str] = None):
    from contextlib import nullcontext

    from ..physical import compiled

    # the ingress trace id rides into the worker thread, where
    # trace_scope's hook stamps it on the span tree (only ever set while
    # DSQL_EVENTS is armed)
    if trace_id:
        from ..runtime import events as _ev
        tid_scope = _ev.trace_id_scope(trace_id)
    else:
        tid_scope = nullcontext()

    # the POST-time tenant pre-claim rides into the worker thread;
    # tenancy's admission (around the plan's execution) consumes it once
    if grant is not None:
        from ..runtime import tenancy as _ten
        g_scope = _ten.grant_scope(grant)
    else:
        g_scope = nullcontext()

    info.started = time.monotonic()
    c0 = dict(compiled.stats)
    # thread_time: concurrent pool queries must not inflate each other's
    cpu0 = time.thread_time()
    _sched.clear_thread_queued_ms()
    table = None
    try:
        # the cancel token joins the query's supervision scope: DELETE
        # /v1/cancel sets it and the layers stop at their next checkpoint;
        # seat_scope hands the POST-time admission seat to the manager
        with tid_scope, g_scope, _sched.seat_scope(seat), \
                _res.query_scope(cancel=cancel):
            table = context.sql(sql, params=params)
    finally:
        if grant is not None:
            # a grant no plan consumed (DDL, a failure before planning)
            # still holds a concurrency slot: give it back (idempotent)
            from ..runtime import tenancy as _ten
            _ten.get_registry().release(grant)
        info.cpu_sec = time.thread_time() - cpu0
        info.finished = time.monotonic()
        info.compiles = (compiled.stats.get("compiles", 0)
                         - c0.get("compiles", 0))
        info.cache_hits = compiled.stats.get("hits", 0) - c0.get("hits", 0)
        info.queued_ms = _sched.thread_queued_ms()
        _sched.get_manager().release_seat(seat)
        # the report of the trace that just closed on THIS thread: the
        # per-query split that concurrent queries cannot clobber
        report = _tel.last_report()
        if report is not None:
            info.phases = dict(report.phases)
            cache = report.cache or {}
            info.cache_hit = bool(cache.get("hit"))
            info.cache_tier = cache.get("tier")
            info.subplan_cache_hits = int(cache.get("subplan_hits", 0))
            info.tier = report.tier
            info.program_store_hits = int(
                (report.counters or {}).get("program_store_hits", 0))
            info.operators = list(report.operators or ())
    if table is not None and getattr(table, "num_columns", 0):
        info.rows = table.num_rows
        info.bytes = sum(int(c.data.nbytes) for c in table.columns)
    info.peak_memory = _peak_memory(context)
    return table


_TYPE_MAP = {
    "BOOLEAN": "boolean", "TINYINT": "tinyint", "SMALLINT": "smallint",
    "INTEGER": "integer", "BIGINT": "bigint", "FLOAT": "real",
    "DOUBLE": "double", "DECIMAL": "decimal", "VARCHAR": "varchar",
    "CHAR": "char", "DATE": "date", "TIMESTAMP": "timestamp",
    "TIME": "time", "INTERVAL_DAY_TIME": "interval day to second",
    "INTERVAL_YEAR_MONTH": "interval year to month", "NULL": "unknown",
}


def _columns_payload(table) -> list:
    cols = []
    for name, col in zip(table.names, table.columns):
        t = _TYPE_MAP.get(col.stype.name, "varchar")
        cols.append({
            "name": name, "type": t,
            "typeSignature": {"rawType": t, "arguments": []},
        })
    return cols


def _data_payload(table) -> list:
    rows = []
    for row in table.to_pylist():
        out = []
        for v in row:
            if hasattr(v, "isoformat"):
                v = v.isoformat(sep=" ") if hasattr(v, "date") else v.isoformat()
            elif hasattr(v, "item"):
                v = v.item()
            out.append(v)
        rows.append(out)
    return rows


# ---------------------------------------------------------------------------
# result spooling: a large finished result pages through the spill store
# instead of riding one /v1/status payload
# ---------------------------------------------------------------------------

#: one spill-store run per page: the store frees whole runs, so pages free
#: as they are fetched
_RESULT_RUN_FMT = "__result__{uid}__p{page}"


class _Spool:
    """One spooled result.  Page 0 goes out with the final ``/v1/status``
    response; pages ``1..n-1`` live in the spill store as JSON bytes (the
    bytes ``_data_payload`` would have sent), flushable to disk under the
    store's host budget.  ``next_page`` is the lowest page not yet freed:
    fetching page ``p`` frees every page below it, and the terminal page
    ``n`` carries no data and no ``nextUri`` and drops the spool."""

    __slots__ = ("uid", "columns", "pages", "page_bytes", "next_page",
                 "created", "last_access", "trace_id")

    def __init__(self, uid: str, columns: list, pages: int,
                 page_bytes: Dict[int, int], trace_id: Optional[str] = None):
        self.uid = uid
        self.trace_id = trace_id        # the query's, for X-DSQL-Trace
        self.columns = columns
        self.pages = pages              # data pages (page 0 included)
        self.page_bytes = page_bytes    # stored page -> payload bytes
        self.next_page = 1              # page 0 served inline
        self.created = time.monotonic()
        self.last_access = self.created

    def live_bytes(self) -> int:
        return sum(v for p, v in self.page_bytes.items()
                   if p >= self.next_page)

    def live_pages(self) -> int:
        return max(self.pages - self.next_page, 0)


def _spool_result(state: "_AppState", uid: str, table,
                  info: Optional[_QueryInfo] = None):
    """Spool ``table`` into pages; returns ``(spool, page0_rows)``, or
    None when the result is small, paging is off, or the spool faulted:
    the caller then serves the single payload."""
    pr = _page_rows()
    if (pr <= 0 or table is None or not getattr(table, "num_columns", 0)
            or int(table.num_rows) <= pr):
        return None
    import numpy as np

    from ..runtime import spill as _spill
    store = _spill.get_store()
    stored = []
    try:
        _faults.maybe_fail("result_spool")
        data = _data_payload(table)
        n_pages = (len(data) + pr - 1) // pr
        page_bytes: Dict[int, int] = {}
        for p in range(1, n_pages):
            chunk = data[p * pr:(p + 1) * pr]
            body = json.dumps(chunk, separators=(",", ":"),
                              default=str).encode()
            run = _RESULT_RUN_FMT.format(uid=uid, page=p)
            store.put_host(run, ["body"],
                           [(np.frombuffer(body, dtype=np.uint8).copy(),
                             None, "bytes", None)], rows=len(chunk))
            stored.append(run)
            page_bytes[p] = len(body)
    except Exception as e:
        for run in stored:
            store.free_run(run)
        logger.warning("result spool failed for %s (%s); serving the "
                       "unpaged response", uid, e)
        return None
    spool = _Spool(uid, _columns_payload(table), n_pages, page_bytes,
                   trace_id=getattr(info, "trace_id", None))
    with state.lock:
        state.spools[uid] = spool
    _tel.inc("result_spooled")
    _tel.inc("result_pages_spooled", len(stored))
    state.publish_spool_gauges()
    return spool, data[:pr]


# ---------------------------------------------------------------------------
# GET /v1/engine
# ---------------------------------------------------------------------------

def _program_store_section() -> dict:
    """``/v1/engine``'s ``programStore``: the store's entries and bytes
    while ``DSQL_PROGRAM_STORE`` is set (the store imported only then)."""
    if not _armed("DSQL_PROGRAM_STORE"):
        return {"enabled": False, "entries": 0, "bytes": 0}
    from ..runtime import program_store as _pstore
    store = _pstore.get_store()
    return {"enabled": True, "entries": len(store.entries()),
            "bytes": store.total_bytes()}


def _spill_section(counters: dict) -> dict:
    from ..runtime import spill as _spill

    stats = _spill.get_store().stats()
    return {
        "enabled": stats["enabled"],
        "runs": stats["runs"],
        "chunks": stats["chunks"],
        "deviceBytes": stats["device_bytes"],
        "hostBytes": stats["host_bytes"],
        "diskBytes": stats["disk_bytes"],
        "peakDeviceBytes": stats["peak_device_bytes"],
        "partitions": int(counters.get("spill_partitions", 0)),
        "flushes": int(counters.get("spill_flushes", 0)),
        "morselJoins": int(counters.get("morsel_joins", 0)),
    }


def _engine_snapshot(state: "_AppState") -> dict:
    """One poll of the whole engine: the queries in flight (the flight
    recorder's live registry), server queries, the workload manager, the
    ledger, cache and spill tiers, quarantine, background builds, the
    history ring, the cards, the profiler, the SLO monitor and tenants.
    Each armed subsystem's module is imported only when its variable is
    set; unarmed, its section reads as disabled (the fleet's and the
    autopilot's are absent).  The program store's section gives its
    entries and bytes while ``DSQL_PROGRAM_STORE`` is set."""
    from ..physical import compiled as _compiled
    from ..runtime import quarantine as _quar
    from ..runtime import result_cache as _rc

    mgr = _sched.get_manager()
    counters = _tel.REGISTRY.counters()
    with state.lock:
        server_queries = [
            {"id": uid,
             "state": ("FINISHED" if fut.done() else
                       "QUEUED" if (state.query_info.get(uid) is not None
                                    and state.query_info[uid].started is None)
                       else "RUNNING")}
            for uid, fut in state.future_list.items()]
    qstore = _quar.get_store()
    history = _history_on()
    if history:
        from ..runtime import flight_recorder as _fr
    out = {
        "pid": os.getpid(),
        "active": _fr.active_snapshot() if history else [],
        "serverQueries": server_queries,
        "scheduler": {
            "enabled": mgr.enabled(),
            "limit": mgr.limit(),
            "queueDepth": mgr.queue_depth(),
            "running": mgr.running_count(),
            "waiting": mgr.waiting_snapshot(),
            "draining": mgr.draining(),
        },
        "memory": {
            "budgetBytes": mgr.ledger.budget(),
            "reservedBytes": mgr.ledger.reserved_bytes(),
        },
        "cache": _rc.get_cache().stats(),
        "spill": _spill_section(counters),
        "quarantine": {
            "enabled": qstore.enabled(),
            "entries": len(qstore.entries()) if qstore.enabled() else 0,
        },
        "programStore": _program_store_section(),
        "backgroundCompiles": {
            "inflight": len(_compiled.inflight_background_compiles()),
            "done": int(counters.get("background_compiles_done", 0)),
            "errors": int(counters.get("background_compile_errors", 0)),
        },
        "history": {"enabled": history,
                    "file": _fr.history_path() if history else "",
                    "records": int(counters.get("history_records", 0))},
        "devices": _devices_section(),
        "profile": _profile_section(),
        "slo": _slo_section(),
    }
    if _page_rows() > 0 or state.spools:
        out["results"] = state.spools_snapshot()
    if _tenancy_on():
        from ..runtime import tenancy as _ten
        out["tenants"] = _ten.get_registry().snapshot()
    if _ing.enabled():
        out["ingest"] = _ing.engine_section(state.context)
    if _armed("DSQL_FLEET_DIR"):
        from ..runtime import fleet as _fleet
        out["fleet"] = {"replica": _fleet.replica_id(),
                        "dir": _fleet.fleet_dir() or ""}
    if _armed("DSQL_AUTOPILOT"):
        try:
            from ..runtime import autopilot as _ap
            out["autopilot"] = _ap.engine_section()
        except Exception:
            logger.debug("autopilot engine section failed", exc_info=True)
    return out


def _profile_section() -> dict:
    """The device profiler's own section, its module imported only when
    ``DSQL_PROFILE`` arms it."""
    if not _profile_on():
        return {"enabled": False}
    from ..runtime import profiler as _prof
    return _prof.engine_section()


def _slo_section() -> dict:
    """Per-class SLO burn rates and anomaly flags (``runtime/events.py``),
    imported only when ``DSQL_EVENTS`` arms the bus."""
    if not _events_on():
        return {"enabled": False}
    from ..runtime import events as _ev
    return _ev.engine_section()


def _devices_section() -> list:
    """One row per visible card: its name and memory, from
    ``torch.cuda.get_device_properties``, ``memory_stats`` and
    ``mem_get_info`` (empty without CUDA)."""
    import torch

    rows = []
    if not torch.cuda.is_available():
        return rows
    for i in range(torch.cuda.device_count()):
        try:
            props = torch.cuda.get_device_properties(i)
            mem = torch.cuda.memory_stats(i)
            free, total = torch.cuda.mem_get_info(i)
        except Exception as e:
            logger.debug("device %d memory unavailable: %s", i, e)
            continue
        rows.append({
            "id": i,
            "platform": "gpu",
            "kind": str(props.name),
            "bytesInUse": int(mem.get("allocated_bytes.all.current", 0)),
            "peakBytesInUse": int(mem.get("allocated_bytes.all.peak", 0)),
            "bytesLimit": int(total),
            "bytesReserved": int(mem.get("reserved_bytes.all.current", 0)),
            "bytesFree": int(free),
        })
    return rows


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------

def _server_workers() -> int:
    """Worker threads: ``DSQL_SERVER_WORKERS``, else the workload
    manager's concurrency limit (4 with the manager off)."""
    raw = os.environ.get("DSQL_SERVER_WORKERS", "")
    try:
        if raw and int(raw) > 0:
            return int(raw)
    except ValueError:
        pass
    mgr = _sched.get_manager()
    return mgr.limit() if mgr.enabled() else 4


class _AppState:
    def __init__(self, context):
        self.context = context
        self.pool = ThreadPoolExecutor(max_workers=_server_workers())
        self.future_list: Dict[str, Future] = {}
        self.query_info: Dict[str, _QueryInfo] = {}
        self.cancel_events: Dict[str, threading.Event] = {}
        self.seats: Dict[str, _sched.Seat] = {}
        self.spools: Dict[str, _Spool] = {}
        self.lock = threading.Lock()
        self.drained = threading.Event()     # set when a drain completed
        # the reaper forgets never-collected results and abandoned spools
        # after DSQL_RESULT_TTL_S
        self._reaper = threading.Thread(target=self._reap_loop,
                                        name="dsql-result-reaper",
                                        daemon=True)
        self._reaper.start()

    def forget(self, uid: str) -> tuple:
        """The one cleanup of a query's registry entries (status
        collection, cancel, reaper): hands an unconsumed seat back and
        returns ``(future, info, cancel_event)``, all None when the uid
        was already forgotten."""
        with self.lock:
            fut = self.future_list.pop(uid, None)
            info = self.query_info.pop(uid, None)
            cancel = self.cancel_events.pop(uid, None)
            seat = self.seats.pop(uid, None)
        _sched.get_manager().release_seat(seat)
        return fut, info, cancel

    # -- spool bookkeeping --------------------------------------------------
    def publish_spool_gauges(self) -> None:
        with self.lock:
            pages = sum(s.live_pages() for s in self.spools.values())
            nbytes = sum(s.live_bytes() for s in self.spools.values())
        _tel.REGISTRY.set_gauge("result_spool_pages", pages)
        _tel.REGISTRY.set_gauge("result_spool_bytes", nbytes)

    def advance_spool(self, uid: str, page: int) -> None:
        """The client fetched ``page``: free the runs of the pages below."""
        with self.lock:
            spool = self.spools.get(uid)
            if spool is None:
                return
            lo = spool.next_page
            spool.next_page = max(spool.next_page, page)
        if lo < page:
            from ..runtime import spill as _spill
            store = _spill.get_store()
            for p in range(max(lo, 1), page):
                store.free_run(_RESULT_RUN_FMT.format(uid=uid, page=p))
        self.publish_spool_gauges()

    def drop_spool(self, uid: str) -> bool:
        """Free a spool and every page it still holds."""
        with self.lock:
            spool = self.spools.pop(uid, None)
        if spool is None:
            return False
        from ..runtime import spill as _spill
        store = _spill.get_store()
        for p in range(max(spool.next_page, 1), spool.pages):
            store.free_run(_RESULT_RUN_FMT.format(uid=uid, page=p))
        self.publish_spool_gauges()
        return True

    def spools_snapshot(self) -> dict:
        with self.lock:
            return {
                "enabled": _page_rows() > 0,
                "pageRows": _page_rows(),
                "ttlS": _result_ttl_s(),
                "spools": len(self.spools),
                "livePages": sum(s.live_pages()
                                 for s in self.spools.values()),
                "liveBytes": sum(s.live_bytes()
                                 for s in self.spools.values()),
            }

    # -- reaper -------------------------------------------------------------
    def _reap_loop(self) -> None:
        while not self.drained.wait(0.25):
            try:
                self.reap_once()
            except Exception:
                logger.exception("result reaper tick failed")

    def reap_once(self, now: Optional[float] = None) -> int:
        """One reaper tick; returns how many entries were reaped."""
        ttl = _result_ttl_s()
        if ttl <= 0:
            return 0
        now = time.monotonic() if now is None else now
        with self.lock:
            dead_spools = [uid for uid, s in self.spools.items()
                           if now - s.last_access > ttl]
            dead_queries = []
            for uid, fut in self.future_list.items():
                if not fut.done():
                    continue
                info = self.query_info.get(uid)
                done_at = getattr(info, "finished", None) or \
                    getattr(info, "submitted", None) or now
                if now - done_at > ttl:
                    dead_queries.append(uid)
        reaped = 0
        for uid in dead_queries:
            fut, _info, _cancel = self.forget(uid)
            if fut is not None:
                # consume the outcome: an abandoned failure must not warn
                # at interpreter shutdown
                try:
                    fut.exception(timeout=0)
                except Exception:
                    pass
                reaped += 1
                logger.info("reaped never-collected query %s", uid)
        for uid in dead_spools:
            if self.drop_spool(uid):
                reaped += 1
                logger.info("reaped abandoned result spool %s", uid)
        if reaped:
            _tel.inc("result_reaped", reaped)
        return reaped


# ---------------------------------------------------------------------------
# graceful drain (SIGTERM/SIGINT)
# ---------------------------------------------------------------------------

def _drain_and_shutdown(server, state: _AppState,
                        reason: str = "drain") -> None:
    """Drain this server, then stop it.  New admissions are refused the
    moment the workload manager drains (POST answers 503); queries in
    flight finish, and their results stay fetchable, within
    ``DSQL_DRAIN_TIMEOUT_S``; stragglers are then cancelled typed
    (``QueryCancelled``).  The procedure runs under a ``drain`` span and
    is itself the ``drain`` fault site: a fired fault is logged, and the
    shutdown goes on."""
    mgr = _sched.get_manager()
    timeout = _sched.drain_timeout_s()
    mgr.begin_drain()
    logger.warning("%s: draining server (timeout %.0f s, %d in flight)",
                   reason, timeout, len(state.future_list))
    if _events_on():
        from ..runtime import events as _ev
        _ev.publish("server.drain", reason=reason,
                    in_flight=len(state.future_list), timeout_s=timeout)
    try:
        with _tel.trace_scope(f"<drain:{reason}>"):
            with _tel.span("drain", reason=reason, timeout_s=timeout):
                try:
                    _faults.maybe_fail("drain")
                except Exception as e:
                    logger.warning(
                        "injected drain fault (%s); continuing shutdown", e)
                deadline = time.monotonic() + timeout
                while state.future_list and time.monotonic() < deadline:
                    time.sleep(0.05)
                stragglers = list(state.future_list.keys())
                if stragglers:
                    _tel.annotate(cancelled=len(stragglers))
                    logger.warning(
                        "drain timeout: typed-cancelling %d in-flight "
                        "quer%s", len(stragglers),
                        "y" if len(stragglers) == 1 else "ies")
                    for ev in list(state.cancel_events.values()):
                        ev.set()
                    grace = time.monotonic() + 2.0
                    while (any(not f.done()
                               for f in list(state.future_list.values()))
                           and time.monotonic() < grace):
                        time.sleep(0.05)
    finally:
        if _ing.enabled():
            # rows acknowledged as buffered are not in the WAL yet: the
            # drain commits them before the process goes
            try:
                log = _ing.get_log(state.context)
                if log is not None:
                    log.flush_all()
            except Exception:
                logger.exception("ingest flush during drain failed")
        try:
            server.shutdown()
            server.server_close()
        except Exception:
            logger.exception("server shutdown failed during drain")
        state.pool.shutdown(wait=False, cancel_futures=True)
        # the manager is process-global: in production the process exits
        # now; an embedder's next server must start undrained
        mgr.end_drain()
        state.drained.set()
        logger.warning("drain complete; server stopped")


def install_drain_handlers(server) -> dict:
    """SIGTERM/SIGINT handlers that drain ``server``; only from the main
    thread (a ``signal`` rule).  Returns the previous handlers, or ``{}``
    when installing was not possible.  A handler only starts the drain
    thread: a signal handler must not block."""
    import signal

    state = server.app_state

    def handler(signum, frame):
        threading.Thread(
            target=_drain_and_shutdown,
            args=(server, state, signal.Signals(signum).name),
            daemon=True).start()

    prev: dict = {}
    try:
        for sig in (signal.SIGTERM, signal.SIGINT):
            prev[sig] = signal.signal(sig, handler)
    except ValueError:
        logger.debug("not the main thread; drain signal handlers not "
                     "installed (use server.drain_async())")
        return {}
    return prev


def _make_handler(state: _AppState, base_url: str):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            logger.debug("server: " + fmt, *args)

        def _send(self, code: int, payload: Optional[dict],
                  headers: Optional[dict] = None):
            body = json.dumps(payload or {}).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _req_trace(self) -> Optional[str]:
            """The client's ``X-DSQL-Trace``, sanitized, or None (always
            None with the event bus unarmed, and nothing imported)."""
            if not _events_on():
                return None
            from ..runtime import events as _ev
            return _ev.sanitize_trace_id(self.headers.get("X-DSQL-Trace"))

        def _trace_headers(self, info: Optional[_QueryInfo] = None,
                           tid: Optional[str] = None) -> Optional[dict]:
            """``X-DSQL-Trace`` for every response to a statement, success
            and error alike: the query's id when known, else the
            client's echoed; None (no header) with the bus unarmed."""
            if not _events_on():
                return None
            tid = tid or (getattr(info, "trace_id", None)
                          if info is not None else None) \
                or self._req_trace()
            return {"X-DSQL-Trace": tid} if tid else None

        def _serve_events(self):
            """GET /v1/events?cursor=N&timeout_ms=M&limit=K: JSON lines of
            the events with ``seq > cursor``, waiting up to ``timeout_ms``
            (at most 30 s; none while draining) for the first; the next
            cursor goes in ``X-DSQL-Cursor``.  ``fleet=1`` under an armed
            fleet reads every replica's ring, merged in timestamp order,
            with the composite cursor ``replica:seq;...``."""
            from urllib.parse import parse_qs, urlparse

            from ..runtime import events as _ev

            q = parse_qs(urlparse(self.path).query)

            def qint(name: str, default: int) -> int:
                try:
                    return int(q.get(name, [default])[0])
                except (ValueError, TypeError, IndexError):
                    return default

            limit = min(max(qint("limit", 500), 1), 5000)
            timeout_s = min(max(qint("timeout_ms", 0), 0) / 1e3, 30.0)
            if _sched.get_manager().draining():
                timeout_s = 0.0
            if q.get("fleet", ["0"])[0] not in ("", "0") \
                    and _armed("DSQL_FLEET_DIR"):
                # every replica's ring, merged, under a composite cursor
                from ..runtime import fleet as _fleet
                evs, nxt = _fleet.read_merged_since(
                    q.get("cursor", [""])[0], limit=limit,
                    timeout_s=timeout_s)
            else:
                cursor = max(qint("cursor", 0), 0)
                evs, nxt = _ev.read_since(cursor, limit=limit,
                                          timeout_s=timeout_s)
            body = b"".join(
                json.dumps(e, separators=(",", ":"), default=str).encode()
                + b"\n" for e in evs)
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Content-Length", str(len(body)))
            self.send_header("X-DSQL-Cursor", str(nxt))
            self.end_headers()
            self.wfile.write(body)

        # GET /metrics | /v1/engine | /v1/fleet and /v1/events (armed) |
        # /v1/empty | /v1/status/{id} | /v1/result/{id}/{page}
        def do_GET(self):
            route = self.path.rstrip("/").split("?")[0]
            if route == "/metrics":
                # under an armed fleet every series carries this
                # replica's label, so a scraper summing replicas never
                # mixes series
                labels = None
                if _armed("DSQL_FLEET_DIR"):
                    from ..runtime import fleet as _fleet
                    labels = {"replica": _fleet.replica_id()}
                body = _tel.REGISTRY.render_prometheus(labels).encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if route == "/v1/engine":
                try:
                    payload = _engine_snapshot(state)
                except Exception:
                    logger.exception("/v1/engine snapshot failed")
                    self._send(500, {"error": "snapshot failed"})
                    return
                self._send(200, payload)
                return
            if route == "/v1/fleet" and _armed("DSQL_FLEET_DIR"):
                try:
                    from ..runtime import fleet as _fleet
                    payload = _fleet.snapshot()
                except Exception:
                    logger.exception("/v1/fleet snapshot failed")
                    self._send(500, {"error": "fleet snapshot failed"})
                    return
                self._send(200, payload)
                return
            if route == "/v1/events" and _events_on():
                self._serve_events()
                return
            if self.path.rstrip("/") == "/v1/empty":
                self._send(200, {
                    "id": "empty", "infoUri": base_url,
                    "columns": [], "data": [], "stats": _stats("FINISHED"),
                })
                return
            if self.path.startswith("/v1/status/"):
                self._serve_status(self.path[len("/v1/status/"):].strip("/"))
                return
            if self.path.startswith("/v1/result/"):
                parts = self.path[len("/v1/result/"):].strip("/").split("/")
                page = -1
                if len(parts) == 2:
                    try:
                        page = int(parts[1])
                    except ValueError:
                        page = -1
                if page < 0:
                    self._send(404, {"error": "not found"})
                    return
                self._serve_result_page(parts[0], page)
                return
            self._send(404, {"error": "not found"})

        def _serve_status(self, uid: str):
            fut = state.future_list.get(uid)
            if fut is None:
                # a spooled result already sent its page 0: a re-poll
                # answers FINISHED with the columns and the lowest
                # uncollected page's nextUri (rows travel once each)
                with state.lock:
                    spool = state.spools.get(uid)
                if spool is not None:
                    spool.last_access = time.monotonic()
                    self._send(200, {
                        "id": uid, "infoUri": base_url,
                        "nextUri": (f"{base_url}/v1/result/{uid}/"
                                    f"{spool.next_page}"),
                        "columns": spool.columns,
                        "stats": _stats("FINISHED"),
                    }, headers=self._trace_headers(tid=spool.trace_id))
                    return
                self._send(404, _error_payload("Unknown query id", uid),
                           headers=self._trace_headers())
                return
            info = state.query_info.get(uid)
            if not fut.done():
                self._send(200, {
                    "id": uid, "infoUri": base_url,
                    "nextUri": f"{base_url}/v1/status/{uid}",
                    "partialCancelUri": f"{base_url}/v1/cancel/{uid}",
                    "stats": _stats("RUNNING", info),
                }, headers=self._trace_headers(info))
                return
            try:
                table = fut.result()
            except Exception as e:
                state.forget(uid)
                _tel.inc("server_query_errors")
                self._send(200, _error_payload(str(e), uid, exc=e),
                           headers=self._trace_headers(info))
                return
            spooled = _spool_result(state, uid, table, info)
            state.forget(uid)
            if spooled is not None:
                # page 0 inline and a nextUri: the rest pages through
                # GET /v1/result/{uid}/{page}
                spool, page0 = spooled
                self._send(200, {
                    "id": uid, "infoUri": base_url,
                    "nextUri": f"{base_url}/v1/result/{uid}/1",
                    "columns": spool.columns,
                    "data": page0,
                    "stats": _stats("FINISHED", info),
                }, headers=self._trace_headers(info))
                return
            payload = {
                "id": uid, "infoUri": base_url,
                "stats": _stats("FINISHED", info),
            }
            if table is not None and table.num_columns:
                payload["columns"] = _columns_payload(table)
                payload["data"] = _data_payload(table)
            self._send(200, payload, headers=self._trace_headers(info))

        def _serve_result_page(self, uid: str, page: int):
            """One spooled page, in order: fetching page p frees every
            page below it, a page below ``next_page`` is 410 Gone, and the
            terminal page (the page count) answers no data and no nextUri
            and drops the spool."""
            with state.lock:
                spool = state.spools.get(uid)
            if spool is None:
                self._send(404, _error_payload(
                    "Unknown or expired result id", uid),
                    headers=self._trace_headers())
                return
            spool.last_access = time.monotonic()
            hdrs = self._trace_headers(tid=spool.trace_id)
            if page < spool.next_page or page > spool.pages:
                self._send(410, _error_payload(
                    f"result page {page} of {uid} already collected "
                    f"(pages free as fetched; next is "
                    f"{spool.next_page})", uid), headers=hdrs)
                return
            if page == spool.pages:
                state.drop_spool(uid)
                _tel.inc("result_pages_served")
                self._send(200, {
                    "id": uid, "infoUri": base_url,
                    "columns": spool.columns, "data": [],
                    "stats": _stats("FINISHED"),
                }, headers=hdrs)
                return
            from ..runtime import spill as _spill
            try:
                _names, cols = _spill.get_store().get_host_cols(
                    _RESULT_RUN_FMT.format(uid=uid, page=page), 0)
                rows = json.loads(cols[0][0].tobytes().decode())
            except Exception as e:
                logger.exception("result page fetch failed: %s/%d",
                                 uid, page)
                self._send(500, _error_payload(
                    f"result page fetch failed: {e}", uid, exc=e),
                    headers=hdrs)
                return
            state.advance_spool(uid, page)
            _tel.inc("result_pages_served")
            self._send(200, {
                "id": uid, "infoUri": base_url,
                "nextUri": f"{base_url}/v1/result/{uid}/{page + 1}",
                "columns": spool.columns, "data": rows,
                "stats": _stats("FINISHED"),
            }, headers=hdrs)

        # POST /v1/statement | POST /v1/ingest (armed)
        def do_POST(self):
            if self.path.rstrip("/") == "/v1/ingest" and _ing.enabled():
                self._do_ingest()
                return
            if self.path.rstrip("/") != "/v1/statement":
                self._send(404, {"error": "not found"})
                return
            length = int(self.headers.get("Content-Length", 0))
            sql = self.rfile.read(length).decode()
            _tel.inc("server_queries")
            uid = str(uuid_mod.uuid4())
            # a JSON envelope binds ?/$n markers: {"sql": ..., "params":
            # [...]} with Content-Type application/json; a plain body is
            # the SQL text
            params = None
            ctype = (self.headers.get("Content-Type") or "")
            if ctype.split(";")[0].strip().lower() == "application/json":
                try:
                    payload = json.loads(sql)
                    sql = payload["sql"]
                    params = payload.get("params")
                except (ValueError, TypeError, KeyError):
                    _tel.inc("server_query_errors")
                    self._send(400, _error_payload(
                        'Invalid JSON statement body (expected '
                        '{"sql": "...", "params": [...]})', uid),
                        headers=self._trace_headers())
                    return
                if params is not None and not isinstance(params, list):
                    _tel.inc("server_query_errors")
                    self._send(400, _error_payload(
                        '"params" must be a JSON array', uid),
                        headers=self._trace_headers())
                    return
            mgr = _sched.get_manager()
            # the trace id at ingress, before any verdict, so that success
            # and every rejection answer with the same id (None unarmed)
            tid = None
            if _events_on():
                from ..runtime import events as _ev
                tid = self._req_trace() or _ev.mint_trace_id()

            def reject(e: _res.AdmissionRejected) -> None:
                hdrs = {"Retry-After":
                        str(max(int(math.ceil(e.retry_after_s)), 1))}
                hdrs.update(self._trace_headers(tid=tid) or {})
                if tid:
                    from ..runtime import events as _ev
                    _ev.publish("server.rejected", trace=tid,
                                error=type(e).__name__,
                                retry_after_s=round(e.retry_after_s, 3))
                self._send(submit_status(e),
                           _error_payload(str(e), uid, exc=e), headers=hdrs)

            # the drain gate first, whether or not the manager is on: a
            # draining process refuses new work with 503 while GET and
            # DELETE keep serving the queries in flight
            if mgr.draining():
                _tel.inc("server_drain_rejects")
                reject(mgr._drain_verdict())
                return
            # the tenant's claim before a seat: a tenant over quota gets
            # its 429 before it takes a scheduler seat
            grant = None
            if _tenancy_on():
                from ..runtime import tenancy as _ten
                try:
                    grant = _ten.get_registry().claim(
                        self.headers.get("X-DSQL-Tenant"))
                except _res.AdmissionRejected as e:
                    _tel.inc("server_throttled")
                    reject(e)
                    return
            # the seat at POST time: with every slot and queue place taken
            # the client gets 429 now, not a place in the pool's backlog
            priority = _sched.normalize_priority(
                self.headers.get("X-DSQL-Priority"))
            try:
                seat = mgr.claim_seat(priority)
            except _res.AdmissionRejected as e:
                if grant is not None:
                    from ..runtime import tenancy as _ten
                    _ten.get_registry().release(grant)
                _tel.inc("server_drain_rejects"
                         if isinstance(e, _res.ServerDraining)
                         else "server_throttled")
                reject(e)
                return
            info = _QueryInfo()
            info.trace_id = tid
            cancel = threading.Event()
            state.query_info[uid] = info
            state.cancel_events[uid] = cancel
            if seat is not None:
                state.seats[uid] = seat
            fut = state.pool.submit(_run_tracked, state.context, sql, info,
                                    cancel, seat, params, grant, tid)
            state.future_list[uid] = fut
            self._send(200, {
                "id": uid, "infoUri": base_url,
                "nextUri": f"{base_url}/v1/status/{uid}",
                "partialCancelUri": f"{base_url}/v1/cancel/{uid}",
                "stats": _stats("QUEUED", info),
            }, headers=self._trace_headers(tid=tid))

        def _do_ingest(self):
            """POST /v1/ingest: one WAL-committed append per request.
            Body ``{"table": "t", "rows": [[...], ...] | {"col": [...]},
            "schema": "root"?}``.  Tenant-tagged (``X-DSQL-Tenant``) and
            governed by the tenant's quota like a statement; 429 with
            ``Retry-After`` on quota or backpressure, 400 on a schema
            mismatch, 503 while draining."""
            _tel.inc("server_ingest_requests")
            uid = str(uuid_mod.uuid4())
            tid = None
            if _events_on():
                from ..runtime import events as _ev
                tid = self._req_trace() or _ev.mint_trace_id()

            def reject(e: _res.AdmissionRejected) -> None:
                hdrs = {"Retry-After":
                        str(max(int(math.ceil(e.retry_after_s)), 1))}
                hdrs.update(self._trace_headers(tid=tid) or {})
                if tid:
                    from ..runtime import events as _ev
                    _ev.publish("server.rejected", trace=tid,
                                error=type(e).__name__,
                                retry_after_s=round(e.retry_after_s, 3))
                self._send(submit_status(e),
                           _error_payload(str(e), uid, exc=e), headers=hdrs)

            mgr = _sched.get_manager()
            if mgr.draining():
                _tel.inc("server_drain_rejects")
                reject(mgr._drain_verdict())
                return
            length = int(self.headers.get("Content-Length", 0))
            try:
                payload = json.loads(self.rfile.read(length).decode())
                table = payload["table"]
                rows = payload["rows"]
                schema_name = payload.get("schema") or None
                if not isinstance(rows, (list, dict)):
                    raise TypeError("rows must be a list or dict")
            except Exception:
                self._send(400, _error_payload(
                    'Invalid ingest body (expected {"table": "...", '
                    '"rows": [[...], ...] | {"col": [...]}, '
                    '"schema": "..."?})', uid))
                return
            grant = None
            if _tenancy_on():
                from ..runtime import tenancy as _ten
                try:
                    grant = _ten.get_registry().claim(
                        self.headers.get("X-DSQL-Tenant"))
                except _res.AdmissionRejected as e:
                    _tel.inc("server_throttled")
                    reject(e)
                    return
            outcome = None   # a refusal feeds neither breaker nor counts
            try:
                if isinstance(rows, list):
                    rows = [tuple(r) if isinstance(r, list) else r
                            for r in rows]
                n = state.context.append_rows(table, rows,
                                              schema_name=schema_name)
                outcome = "ok"
                self._send(200, {
                    "id": uid,
                    "table": table,
                    "state": "COMMITTED" if n else "BUFFERED",
                    "rows": int(n),
                    "epoch": state.context.table_epoch(
                        schema_name or state.context.schema_name,
                        str(table)),
                })
            except _res.AdmissionRejected as e:
                _tel.inc("server_throttled")
                reject(e)
            except Exception as e:
                outcome = "error"
                err = _res.classify(e, default=_res.UserError)
                if err is None:
                    raise
                self._send(submit_status(err),
                           _error_payload(str(err), uid, exc=err))
            finally:
                if grant is not None:
                    from ..runtime import tenancy as _ten
                    _ten.get_registry().release(grant, outcome=outcome)

        # DELETE /v1/cancel/{id}
        def do_DELETE(self):
            if not self.path.startswith("/v1/cancel/"):
                self._send(404, {"error": "not found"})
                return
            uid = self.path[len("/v1/cancel/"):].strip("/")
            # forget() hands an unconsumed seat back (a query cancelled
            # in the pool's backlog never reaches _run_tracked)
            fut, info, cancel = state.forget(uid)
            # a cancel can also target a spooled result mid-page
            dropped = state.drop_spool(uid)
            if fut is None and not dropped:
                self._send(404, _error_payload("Unknown query id", uid),
                           headers=self._trace_headers())
                return
            tid = None
            if fut is not None:
                # the cancel token stops a running query at its next
                # checkpoint; fut.cancel() only stops one not yet started
                if cancel is not None:
                    cancel.set()
                fut.cancel()
                tid = getattr(info, "trace_id", None)
                if tid and _events_on():
                    from ..runtime import events as _ev
                    _ev.publish("server.cancel", trace=tid, id=uid)
            _tel.inc("server_cancels")
            self._send(200, None, headers=self._trace_headers(tid=tid))

    return Handler


def _error_payload(message: str, uid: str, exc: Exception = None) -> dict:
    """The Presto error shape: ``errorType`` is USER_ERROR /
    INTERNAL_ERROR / INSUFFICIENT_RESOURCES and ``errorCode`` /
    ``errorName`` carry the classified verdict (EXCEEDED_TIME_LIMIT,
    USER_CANCELED, ...); an unrecognized exception escaping
    ``Context.sql`` is a user error named ``str(type(exc))``.  A parse
    error's 1-based (line, col) fills ``errorLocation``."""
    line = getattr(exc, "line", None)
    col = getattr(exc, "col", None)
    error_type, error_code = "USER_ERROR", 0
    error_name = str(type(exc)) if exc is not None else "GENERIC_ERROR"
    if exc is not None:
        err = _res.classify(exc, default=_res.UserError)
        if isinstance(err, _res.ResilienceError):
            error_type = err.error_type
            error_code = err.error_code
            if (isinstance(err, (_res.TransientError, _res.FatalError,
                                 _res.DeadlineExceeded, _res.QueryCancelled))
                    or err is exc):
                # engine verdicts use the taxonomy name; wrapped user
                # exceptions keep their own class name
                error_name = err.error_name
    return {
        "id": uid, "infoUri": "", "stats": _stats("FAILED"),
        "error": {
            "message": message, "errorCode": error_code,
            "errorName": error_name,
            "errorType": error_type,
            "errorLocation": {
                "lineNumber": line if isinstance(line, int) else 1,
                "columnNumber": col if isinstance(col, int) else 1,
            },
        },
    }


def run_server(context=None, host: str = "0.0.0.0", port: int = 8080,
               startup: bool = False, log_level=None, blocking: bool = True):
    """Start the server on ``context`` (a new ``Context()`` on the card
    when None).  ``blocking=False`` returns the started server, with
    ``drain_async`` and ``drained_event``; ``blocking=True`` serves until
    SIGTERM/SIGINT drains it."""
    if log_level:
        logging.basicConfig(level=log_level)
    from ..context import Context

    # the fleet plane, armed before serving so that this replica's
    # heartbeat registers before its first request (idempotent)
    if _armed("DSQL_FLEET_DIR"):
        from ..runtime import fleet as _fleet
        _fleet.ensure_armed()
    context = context or Context()
    mesh = getattr(context, "mesh", None)
    if mesh is not None and mesh.spans_processes:
        # the other ranks would wait at the first collective of a query
        # that only this rank received
        raise NotImplementedError(
            "run_server: a context on a mesh across processes cannot serve "
            "alone; a front end that sends every request to every rank in "
            "one order is not ported yet")
    # the ingest log on the serving context before the first request
    # (idempotent with the Context's own arming)
    if _ing.enabled():
        _ing.ensure_armed(context)
    if startup:
        context.sql("SELECT 1 + 1")

    state = _AppState(context)
    # bind first so port=0 (ephemeral) yields correct nextUri links
    server = ThreadingHTTPServer((host, port), _make_handler(state, ""))
    base_url = f"http://{host}:{server.server_port}"
    server.RequestHandlerClass = _make_handler(state, base_url)
    server.app_state = state
    server.drain_async = lambda reason="drain": threading.Thread(
        target=_drain_and_shutdown, args=(server, state, reason),
        daemon=True).start()
    server.drained_event = state.drained
    context.server = server
    if not blocking:
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        return server
    install_drain_handlers(server)
    try:
        logger.info("dask-sql-tpu-torch server listening on %s", base_url)
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    return server


def main():  # pragma: no cover - console entry
    import argparse

    parser = argparse.ArgumentParser(
        description="dask-sql-tpu-torch presto server")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--startup", action="store_true")
    parser.add_argument("--log-level", default=None)
    parser.add_argument("--device", default=None,
                        help="the Context's device (default: cuda)")
    args = parser.parse_args()
    from ..context import Context

    run_server(context=Context(device=args.device), host=args.host,
               port=args.port, startup=args.startup,
               log_level=args.log_level)


if __name__ == "__main__":  # pragma: no cover
    main()
