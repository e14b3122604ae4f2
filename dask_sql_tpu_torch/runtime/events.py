"""The event bus: trace ids, structured events, SLO burn rates.

The counterpart of ``dask_sql_tpu/runtime/events.py``, armed by
``DSQL_EVENTS`` (every caller checks the variable before it imports this
module, so an unarmed query never loads it):

**Trace ids.**  :func:`mint_trace_id` mints a 16-hex-character id at
ingress; the server takes and returns ``X-DSQL-Trace`` (a client's id is
kept when it matches ``[A-Za-z0-9_-]{1,64}``) and installs it for the
worker with :func:`trace_id_scope`.  ``telemetry.trace_scope`` stamps it
on the span tree's root (``trace_id``), from where it reaches the query
report, the slow-query log, the chrome trace and the flight recorder's
envelope.  A child process inherits one through ``DSQL_TRACE_ID``;
:func:`current_trace_id` resolves thread scope, then the open trace,
then the variable.

**The bus.**  :func:`publish` appends ``{seq, unix, pid, trace, type,
...fields}`` to a bounded ring (``DSQL_EVENTS_RING``, 2048) with a
monotonic cursor and a condition variable for the long poll of ``GET
/v1/events`` (:func:`read_since`).  ``DSQL_EVENTS_FILE`` also appends
every record to a JSONL ring (one ``O_APPEND`` write per line, the newest
half kept past ``DSQL_EVENTS_MB``, 4, through tmp + ``os.replace``), in
the JAX package's format, so either package reads the other's file.  A
failed publish counts ``events_dropped`` and never fails its caller.

**SLO monitor.**  Per-class latency objectives
(``DSQL_SLO_INTERACTIVE_MS`` / ``_BATCH_MS`` / ``_BACKGROUND_MS``: 1000,
10000, 60000) against ``DSQL_SLO_TARGET`` (0.99).  Each completed query
folds into its class's samples; a window's burn rate is its breach
fraction over the error budget (1 - target), over a fast
(``DSQL_SLO_FAST_S``, 300) and a slow (``DSQL_SLO_SLOW_S``, 3600) window;
both above ``DSQL_SLO_BURN`` (2.0) is a breach (``slo_breaches`` and one
``slo.breach`` event per edge).  The workload manager sheds background
admissions while a class burns (``scheduler._check_shed``).  Surfaced as
``slo_*`` gauges and the ``slo`` section of ``GET /v1/engine`` with
:func:`anomalies`.

Under the fleet plane (``DSQL_FLEET_DIR``, ``runtime/fleet.py``) every
event carries its replica's id, as in the JAX package, and the ring is
the replica's own file in the fleet directory.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
import uuid
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

from . import telemetry as _tel

logger = logging.getLogger(__name__)

_TRACE_CHARS = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_-")


def enabled() -> bool:
    """True when the watchtower is armed (``DSQL_EVENTS`` set, not 0)."""
    return os.environ.get("DSQL_EVENTS", "0").strip() not in ("", "0")


def _env_float(name: str, default: float) -> float:
    try:
        raw = os.environ.get(name, "")
        return float(raw) if raw else default
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        raw = os.environ.get(name, "")
        return int(raw) if raw else default
    except ValueError:
        return default


# ---------------------------------------------------------------------------
# trace IDs
# ---------------------------------------------------------------------------

class _Tls(threading.local):
    trace_id: Optional[str] = None


_tls = _Tls()


def mint_trace_id() -> str:
    """A fresh ingress trace ID: 16 hex chars, unique enough to join the
    three surfaces (wire, span tree, event/history rings) of one query."""
    return uuid.uuid4().hex[:16]


def sanitize_trace_id(raw: Any) -> Optional[str]:
    """A client-supplied ``X-DSQL-Trace`` value, validated — or None.
    IDs are reflected into headers, log lines and JSONL rings, so the
    charset is locked down and the length capped."""
    if not raw:
        return None
    s = str(raw).strip()
    if not s or len(s) > 64 or not all(c in _TRACE_CHARS for c in s):
        return None
    return s


def current_trace_id() -> Optional[str]:
    """The trace ID in effect on THIS thread: explicit scope first
    (server worker), then the open trace's stamped root attr (stage
    workers re-entering via ``telemetry.scoped``), then the
    ``DSQL_TRACE_ID`` env fallback (child processes)."""
    tid = _tls.trace_id
    if tid:
        return tid
    t = _tel.current_trace()
    if t is not None:
        tid = t.root.attrs.get("trace_id")
        if tid:
            return str(tid)
    return sanitize_trace_id(os.environ.get("DSQL_TRACE_ID"))


@contextmanager
def trace_id_scope(tid: Optional[str]):
    """Install a trace ID on this thread for the duration (the server
    wraps each worker's ``context.sql`` in one)."""
    prev = _tls.trace_id
    _tls.trace_id = sanitize_trace_id(tid)
    try:
        yield _tls.trace_id
    finally:
        _tls.trace_id = prev


# ---------------------------------------------------------------------------
# the event bus
# ---------------------------------------------------------------------------

def ring_len() -> int:
    return max(_env_int("DSQL_EVENTS_RING", 2048), 16)


def events_file() -> Optional[str]:
    """The cross-process JSONL ring path, or None (in-memory only)."""
    return os.environ.get("DSQL_EVENTS_FILE") or None


def file_limit_bytes() -> int:
    return max(int(_env_float("DSQL_EVENTS_MB", 4.0) * 2**20), 4096)


class EventBus:
    """Bounded in-memory event ring with a monotonic seq cursor.

    ``publish`` appends under the condition variable and notifies
    long-poll waiters; the deque's maxlen bounds memory, the seq keeps
    cursors valid across evictions (a reader slower than the ring simply
    skips what was evicted)."""

    def __init__(self):
        self._cond = threading.Condition()
        self._ring: deque = deque(maxlen=ring_len())
        self._seq = 0

    def append(self, rec: dict) -> dict:
        with self._cond:
            self._seq += 1
            rec["seq"] = self._seq
            self._ring.append(rec)
            self._cond.notify_all()
        return rec

    def last_seq(self) -> int:
        with self._cond:
            return self._seq

    def snapshot(self) -> List[dict]:
        with self._cond:
            return list(self._ring)

    def read_since(self, cursor: int, limit: int = 500,
                   timeout_s: float = 0.0) -> Tuple[List[dict], int]:
        """Events with ``seq > cursor`` (oldest first, capped at
        ``limit``) and the next cursor.  With ``timeout_s`` > 0 blocks
        until at least one event arrives or the deadline passes — the
        ``GET /v1/events`` long-poll."""
        deadline = time.monotonic() + max(timeout_s, 0.0)
        with self._cond:
            while True:
                evs = [e for e in self._ring if e["seq"] > cursor]
                if evs:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
            evs = evs[:max(int(limit), 1)]
            nxt = evs[-1]["seq"] if evs else max(int(cursor), 0)
            return evs, nxt


_BUS_LOCK = threading.Lock()
_BUS: Optional[EventBus] = None


def get_bus() -> EventBus:
    global _BUS
    with _BUS_LOCK:
        if _BUS is None:
            _BUS = EventBus()
        return _BUS


# serializes THIS process's file appends; cross-process interleaving is
# handled by O_APPEND single-write lines + atomic replace (flight-recorder
# concurrency model)
_FILE_LOCK = threading.Lock()


def _append_file(path: str, rec: dict) -> None:
    line = (json.dumps(rec, separators=(",", ":"), default=str) + "\n"
            ).encode()
    with _FILE_LOCK:
        fd = os.open(path, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
        try:
            os.write(fd, line)
            size = os.fstat(fd).st_size
        finally:
            os.close(fd)
    if size > file_limit_bytes():
        _truncate_file(path)


def _truncate_file(path: str) -> None:
    """Drop the oldest half via tmp + atomic replace; a writer racing the
    replace can lose a few lines (events are advisory), never corrupt."""
    limit = file_limit_bytes()
    with _FILE_LOCK:
        try:
            with open(path, "rb") as f:
                lines = f.readlines()
            kept: List[bytes] = []
            budget = limit // 2
            total = 0
            for raw in reversed(lines):
                total += len(raw)
                if total > budget:
                    break
                kept.append(raw)
            kept.reverse()
            tmp = f"{path}.tmp{os.getpid()}.{threading.get_ident()}"
            with open(tmp, "wb") as f:
                f.writelines(kept)
            os.replace(tmp, path)
        except OSError:
            logger.debug("event ring truncation failed", exc_info=True)


def _read_file(path: str) -> List[dict]:
    try:
        with open(path, "rb") as f:
            lines = f.readlines()
    except OSError:
        return []
    out: List[dict] = []
    for raw in lines:
        try:
            rec = json.loads(raw)
        except ValueError:
            continue
        if isinstance(rec, dict):
            out.append(rec)
    return out


_CORE_FIELDS = ("seq", "unix", "pid", "trace", "type", "replica")


def _fleet_replica() -> Optional[str]:
    """This replica's id under ``DSQL_FLEET_DIR`` (read before the
    import), else None: unarmed events carry no ``replica`` field."""
    if not os.environ.get("DSQL_FLEET_DIR"):
        return None
    from . import fleet as _fleet
    return _fleet.replica_id()


def publish(etype: str, **fields) -> Optional[dict]:
    """Publish one structured event; never raises (a failed publish
    counts ``events_dropped`` and the caller proceeds).  ``trace`` may be
    passed explicitly; otherwise the thread's current trace ID rides
    along.  Callers gate on ``DSQL_EVENTS`` before importing."""
    try:
        tid = fields.pop("trace", None) or current_trace_id()
        rec: Dict[str, Any] = {"unix": round(time.time(), 3),
                               "pid": os.getpid(),
                               "trace": str(tid) if tid else "",
                               "type": str(etype)}
        rid = _fleet_replica()
        if rid:
            rec["replica"] = rid
        for k, v in fields.items():
            if v is not None and k not in _CORE_FIELDS:
                rec[k] = v
        get_bus().append(rec)
        _tel.inc("events_published")
        path = events_file()
        if path:
            _append_file(path, rec)
        return rec
    except Exception:
        _tel.inc("events_dropped")
        logger.debug("event publish failed", exc_info=True)
        return None


def read_since(cursor: int, limit: int = 500,
               timeout_s: float = 0.0) -> Tuple[List[dict], int]:
    return get_bus().read_since(cursor, limit=limit, timeout_s=timeout_s)


def events_rows(limit: int = 2000) -> List[dict]:
    """Rows for ``system.events``: the cross-process file ring when
    armed (all processes' events, this one's included), else this
    process's in-memory ring.  Extra fields compact into ``detail``."""
    path = events_file()
    recs = _read_file(path) if path else get_bus().snapshot()
    rows: List[dict] = []
    for rec in recs[-max(int(limit), 1):]:
        extra = {k: v for k, v in rec.items() if k not in _CORE_FIELDS}
        row = {
            "seq": int(rec.get("seq", 0) or 0),
            "unix": float(rec.get("unix", 0.0) or 0.0),
            "pid": int(rec.get("pid", 0) or 0),
            "trace": str(rec.get("trace", "") or ""),
            "type": str(rec.get("type", "") or ""),
            "detail": (json.dumps(extra, separators=(",", ":"),
                                  default=str, sort_keys=True)
                       if extra else ""),
        }
        # stamped only when a fleet replica published it: unarmed rows
        # keep their keys
        if rec.get("replica"):
            row["replica"] = str(rec["replica"])
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# SLO monitor
# ---------------------------------------------------------------------------

SLO_CLASSES = ("interactive", "batch", "background")
_DEFAULT_OBJECTIVE_MS = {"interactive": 1000.0, "batch": 10000.0,
                         "background": 60000.0}
#: per-class sample window capacity; at 4096 completions per class the
#: oldest samples age out of BOTH time windows long before eviction
#: matters at any sustainable query rate
_SAMPLES_PER_CLASS = 4096


def objective_ms(cls: str) -> float:
    return max(_env_float(f"DSQL_SLO_{cls.upper()}_MS",
                          _DEFAULT_OBJECTIVE_MS.get(cls, 1000.0)), 1.0)


def slo_target() -> float:
    t = _env_float("DSQL_SLO_TARGET", 0.99)
    return min(max(t, 0.5), 0.9999)


def window_fast_s() -> float:
    return max(_env_float("DSQL_SLO_FAST_S", 300.0), 0.1)


def window_slow_s() -> float:
    return max(_env_float("DSQL_SLO_SLOW_S", 3600.0), window_fast_s())


def burn_threshold() -> float:
    return max(_env_float("DSQL_SLO_BURN", 2.0), 0.1)


class SloMonitor:
    """Per-priority-class latency objectives as multi-window burn rates.

    One (unix, ok) sample per completed query; burn rate over a window =
    breach_fraction / error_budget where error_budget = 1 - target.
    Gauges update on every observation so ``GET /metrics`` is always
    current without a sampler thread."""

    def __init__(self):
        self._lock = threading.Lock()
        self._samples: Dict[str, deque] = {
            c: deque(maxlen=_SAMPLES_PER_CLASS) for c in SLO_CLASSES}
        self._totals: Dict[str, List[int]] = {
            c: [0, 0] for c in SLO_CLASSES}          # [total, breaches]
        self._breached: Dict[str, bool] = {c: False for c in SLO_CLASSES}

    @staticmethod
    def _class(priority: Optional[str]) -> str:
        c = str(priority or "interactive").strip().lower()
        return c if c in SLO_CLASSES else "interactive"

    def observe(self, priority: Optional[str], wall_ms: float) -> None:
        cls = self._class(priority)
        obj = objective_ms(cls)
        ok = float(wall_ms) <= obj
        now = time.time()
        with self._lock:
            self._samples[cls].append((now, ok))
            tot = self._totals[cls]
            tot[0] += 1
            if not ok:
                tot[1] += 1
        burn_f, burn_s = self._burns(cls, now)
        att = self._attainment(cls)
        _tel.REGISTRY.set_gauge(f"slo_attainment_{cls}", round(att, 6))
        _tel.REGISTRY.set_gauge(f"slo_burn_fast_{cls}", round(burn_f, 6))
        _tel.REGISTRY.set_gauge(f"slo_burn_slow_{cls}", round(burn_s, 6))
        # edge-triggered multi-window breach: both windows burning past
        # the threshold fires ONE event until the condition clears
        thresh = burn_threshold()
        breach = burn_f > thresh and burn_s > thresh
        with self._lock:
            fire = breach and not self._breached[cls]
            self._breached[cls] = breach
        if fire:
            _tel.inc("slo_breaches")
            publish("slo.breach", cls=cls, objective_ms=obj,
                    burn_fast=round(burn_f, 3), burn_slow=round(burn_s, 3))

    def _burns(self, cls: str, now: float) -> Tuple[float, float]:
        budget = max(1.0 - slo_target(), 1e-6)
        with self._lock:
            samples = list(self._samples[cls])
        out = []
        for win in (window_fast_s(), window_slow_s()):
            inwin = [ok for (t, ok) in samples if now - t <= win]
            if not inwin:
                out.append(0.0)
                continue
            frac = sum(1 for ok in inwin if not ok) / len(inwin)
            out.append(frac / budget)
        return out[0], out[1]

    def _attainment(self, cls: str) -> float:
        with self._lock:
            total, breaches = self._totals[cls]
        if total <= 0:
            return 1.0
        return (total - breaches) / total

    def breached_classes(self) -> List[str]:
        with self._lock:
            return [c for c in SLO_CLASSES if self._breached[c]]

    def burning_classes(self) -> List[str]:
        """Classes whose fast AND slow burns exceed the threshold RIGHT
        NOW, recomputed from the sample windows.  The ``_breached`` flags
        only update when a query of that class completes — a class that
        stops completing queries would stay flagged forever — so the
        load shedder (runtime/scheduler.py) must use this live view: as
        the breaching samples age out of the windows the burns fall and
        shedding lifts on its own."""
        now = time.time()
        thresh = burn_threshold()
        out = []
        for cls in SLO_CLASSES:
            burn_f, burn_s = self._burns(cls, now)
            if burn_f > thresh and burn_s > thresh:
                out.append(cls)
        return out

    def rows(self) -> List[dict]:
        """One row per class for ``system.slo`` / the engine section."""
        now = time.time()
        rows = []
        for cls in SLO_CLASSES:
            burn_f, burn_s = self._burns(cls, now)
            with self._lock:
                total, breaches = self._totals[cls]
                breached = self._breached[cls]
            rows.append({
                "class": cls,
                "objective_ms": objective_ms(cls),
                "target": slo_target(),
                "window_fast_s": window_fast_s(),
                "window_slow_s": window_slow_s(),
                "total": total,
                "breaches": breaches,
                "attainment": round(self._attainment(cls), 6),
                "burn_fast": round(burn_f, 6),
                "burn_slow": round(burn_s, 6),
                "breach": breached,
            })
        return rows


_MONITOR_LOCK = threading.Lock()
_MONITOR: Optional[SloMonitor] = None


def get_monitor() -> SloMonitor:
    global _MONITOR
    with _MONITOR_LOCK:
        if _MONITOR is None:
            _MONITOR = SloMonitor()
        return _MONITOR


def slo_rows() -> List[dict]:
    return get_monitor().rows()


# ---------------------------------------------------------------------------
# anomaly flags
# ---------------------------------------------------------------------------

#: (unix, compile_errors, spill_churn) counter samples — one per query
#: completion — so compile-error/spill deltas over the fast window need
#: no sampler thread; bounded like the profiler's snapshot ring
_counter_ring: deque = deque(maxlen=512)
_counter_lock = threading.Lock()


def _sample_counters(now: float) -> None:
    c = _tel.REGISTRY.counters()
    with _counter_lock:
        _counter_ring.append((now,
                              int(c.get("compile_errors", 0)),
                              int(c.get("spill_demotions", 0))
                              + int(c.get("spill_loads", 0))))


def _window_delta(idx: int, now: float) -> int:
    """Delta of counter-sample column ``idx`` over the fast window."""
    win = window_fast_s()
    with _counter_lock:
        samples = [s for s in _counter_ring if now - s[0] <= win]
    if len(samples) < 2:
        return 0
    return samples[-1][idx] - samples[0][idx]


def anomalies() -> List[dict]:
    """Live anomaly flags for ``GET /v1/engine``; empty list = healthy.
    Each flag names its evidence so an operator can act without a
    follow-up query."""
    out: List[dict] = []
    now = time.time()
    _sample_counters(now)
    for cls in get_monitor().breached_classes():
        out.append({"kind": "burn_rate_breach", "cls": cls,
                    "detail": f"{cls} burning error budget past "
                              f"{burn_threshold():g}x on both windows"})
    try:
        from . import scheduler as _sched
        mgr = _sched.get_manager()
        if mgr.enabled():
            depth = int(mgr.queue_depth())
            cap = int(mgr.limit()) + int(mgr.depth())
            if cap > 0 and depth >= max(int(0.8 * cap), 1):
                out.append({"kind": "queue_depth_runaway", "depth": depth,
                            "capacity": cap,
                            "detail": f"admission queue at {depth}/{cap}"})
    except Exception:
        logger.debug("queue anomaly probe failed", exc_info=True)
    spike = _window_delta(1, now)
    if spike >= _env_int("DSQL_EVENTS_COMPILE_SPIKE", 3):
        out.append({"kind": "compile_error_spike", "errors": spike,
                    "detail": f"{spike} compile errors within "
                              f"{window_fast_s():g}s"})
    thrash = _window_delta(2, now)
    if thrash >= _env_int("DSQL_EVENTS_SPILL_THRASH", 32):
        out.append({"kind": "spill_thrash", "moves": thrash,
                    "detail": f"{thrash} spill tier moves within "
                              f"{window_fast_s():g}s"})
    return out


def engine_section() -> dict:
    """The ``slo`` section of ``GET /v1/engine`` (imported only when
    ``DSQL_EVENTS`` is armed, mirroring the profiler's section)."""
    return {
        "enabled": True,
        "classes": slo_rows(),
        "anomalies": anomalies(),
        "bus": {"seq": get_bus().last_seq(),
                "ring": ring_len(),
                "file": events_file() or ""},
    }


# ---------------------------------------------------------------------------
# telemetry hooks (trace_scope / _close_trace call these after the gate)
# ---------------------------------------------------------------------------

def on_trace_open(trace) -> None:
    """Stamp the ingress trace ID on a freshly opened trace root and
    publish ``query.begin``.  The ID resolves scope > env > fresh mint,
    so a server-minted or child-process-propagated ID wins over a new
    one and a bare ``Context.sql`` still gets correlated."""
    tid = current_trace_id() or mint_trace_id()
    trace.root.attrs["trace_id"] = tid
    publish("query.begin", trace=tid, query=trace.query.strip()[:200])


#: per-tenant [total, within-objective] completion counts — feeds the
#: ``slo_attainment_tenant_<name>`` gauges; tenant names are pre-sanitized to the trace-ID charset
#: (runtime/tenancy.py), so they are safe as gauge-name suffixes
_tenant_slo: Dict[str, List[int]] = {}
_tenant_slo_lock = threading.Lock()


def max_tenant_gauges() -> int:
    """``DSQL_MAX_TENANT_GAUGES`` (default 64): distinct per-tenant SLO
    gauges before overflow tenants fold into one ``_other`` series — a
    hostile/bursty tenant-id space can no longer grow ``/metrics``
    without bound."""
    return max(_env_int("DSQL_MAX_TENANT_GAUGES", 64), 1)


def observe_tenant(tenant: str, priority: Optional[str],
                   wall_ms: float) -> None:
    """Fold one completed query into the tenant's SLO attainment gauge,
    judged against the query's own class objective.  Cardinality is
    bounded: once ``max_tenant_gauges()`` distinct tenants have a
    series, every NEW tenant folds into the shared ``_other`` series
    (existing tenants keep their own)."""
    cls = SloMonitor._class(priority)
    ok = float(wall_ms) <= objective_ms(cls)
    key = str(tenant)
    with _tenant_slo_lock:
        if key not in _tenant_slo and len(_tenant_slo) >= max_tenant_gauges():
            key = "_other"
        tot = _tenant_slo.setdefault(key, [0, 0])
        tot[0] += 1
        if ok:
            tot[1] += 1
        total, good = tot
    _tel.REGISTRY.set_gauge(f"slo_attainment_tenant_{key}",
                            round(good / total, 6))


def on_query_complete(report, error: Optional[BaseException]) -> None:
    """Fold one completed query into the SLO monitor and publish
    ``query.done``; called from ``telemetry._close_trace`` after the
    ``DSQL_EVENTS`` gate."""
    get_monitor().observe(getattr(report, "priority", None), report.wall_ms)
    tenant = getattr(report, "tenant", None)
    if tenant:
        observe_tenant(tenant, getattr(report, "priority", None),
                       report.wall_ms)
    publish("query.done",
            trace=getattr(report, "trace_id", None),
            outcome="error" if error is not None else "ok",
            error=type(error).__name__ if error is not None else None,
            wall_ms=round(report.wall_ms, 3),
            tier=getattr(report, "tier", None),
            priority=getattr(report, "priority", None),
            tenant=tenant,
            cache_hit=bool((getattr(report, "cache", None) or {})
                           .get("hit")),
            rows_out=int(getattr(report, "rows_out", 0)))


def _reset_for_tests() -> None:
    """Fresh bus + monitor + counter ring (unit tests only)."""
    global _BUS, _MONITOR
    with _BUS_LOCK:
        _BUS = None
    with _MONITOR_LOCK:
        _MONITOR = None
    with _counter_lock:
        _counter_ring.clear()
    with _tenant_slo_lock:
        _tenant_slo.clear()
