"""Workload manager: admission control, priority scheduling, memory broker.

The counterpart of ``dask_sql_tpu/runtime/scheduler.py``.  Every plan a
``Context`` executes -- a query, a CTAS, an EXECUTE, a server request --
passes the process-global :class:`WorkloadManager` before it touches the
card (``Context._execute_query_plan``):

**Admission.**  At most ``DSQL_MAX_CONCURRENT_QUERIES`` (default 4; 0
turns the manager off) plans run at once; the rest wait in a queue
``DSQL_QUEUE_DEPTH`` deep (default 32).  A full queue, or a deadline that
would expire before a slot could free (judged by an EWMA of slot-hold
times), raises ``resilience.AdmissionRejected`` at once (429 +
``Retry-After`` at the server); a wait past ``DSQL_QUEUE_TIMEOUT_MS``
(default 30,000) raises ``AdmissionTimeout``.  Queue time counts against
the query's deadline, and a queued query can be cancelled.

**Priorities.**  ``interactive`` > ``batch`` > ``background`` (weights 8,
3, 1), set by ``Context.sql(priority=)`` or ``X-DSQL-Priority``.  A freed
slot goes by deficit-weighted round robin: each waiting class gains its
weight, the winner pays the round, and waiting adds one credit per
``DSQL_QUEUE_AGING_MS`` (default 2,000), so no class starves.
``DSQL_TENANT_WEIGHTS`` splits the classes per tenant.

**Memory broker.**  Admission reserves an estimated working set against
a device-bytes ledger of ``DSQL_DEVICE_BUDGET_MB`` (default 4,096; 0 turns
the broker off).  The estimate takes the JAX package's rungs in order:
the flight recorder's measured history (``DSQL_HISTORY_FILE``), chunked
sources, the table statistics (``statistics.estimate_plan_bytes_stats``),
the device profiler's counted cost (``DSQL_PROFILE``), and the shape heuristic
(scanned bytes times per-operator multipliers).  The result cache and the
spill store are the ledger's tenants: a reservation that does not fit
spills the cache's device tier, then the store's, before the query waits;
an estimate over the whole budget is clamped so the query runs alone.

**Load shed.**  With the event bus armed (``DSQL_EVENTS``) a background
admission is refused (``LoadShedRejected``, 429) while an SLO class burns
its error budget past ``DSQL_SLO_BURN`` on both windows
(``DSQL_SLO_SHED=0`` turns it off); ``slo.shed`` marks each edge, and
``sched.admitted`` / ``sched.rejected`` each admission.

**Drain.**  ``begin_drain()`` (the server's SIGTERM/SIGINT) refuses every
new admission with ``ServerDraining`` (503) while running queries keep
their slots for ``DSQL_DRAIN_TIMEOUT_S``.

**Nesting.**  A thread that holds a slot passes straight through a second
admission (a CTAS's query, an EXECUTE's plan), so nothing deadlocks under
a limit of 1; the compiled tier's background builds run outside any
admission.

Telemetry: gauges ``sched_queue_depth`` / ``sched_running`` /
``sched_reserved_bytes`` / ``server_draining``; per-class counters
``sched_admitted_*`` / ``sched_rejected_*`` / ``sched_timeout_*``
(admitted + rejected + timeout equals the queries submitted); a
``queued`` span in each admitted query's report.  The ``admission`` fault
site fires at the top of ``acquire``.

Lock order: manager condition > ledger > result cache.  The cache never
takes the manager's or the ledger's lock: its tenancy reads
(``cache_allowance``) take none.
"""
from __future__ import annotations

import logging
import math
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

from . import faults as _faults, telemetry as _tel
from . import resilience as _res
from .gates import (events_on as _events_on, history_on as _history_on,
                    profile_on as _profile_on)
from .resilience import (AdmissionRejected, AdmissionTimeout,
                         LoadShedRejected, ServerDraining, _env_int)

logger = logging.getLogger(__name__)


def _shed_on() -> bool:
    # burn-driven load shedding (needs the SLO monitor, so it is inert
    # unless the event bus is also armed); DSQL_SLO_SHED=0 disables
    return os.environ.get("DSQL_SLO_SHED", "1").strip() not in ("", "0")


_SHED_RETRY_AFTER_S = 5.0   # shed lifts as breaching samples age out of
                            # the fast window; 5 s is a sane re-poll pace




PRIORITIES = ("interactive", "batch", "background")

# DWRR weights: long-run slot share under sustained mixed load.  interactive
# wins ~8 of every 12 contended slots, batch ~3, background ~1 — but the
# deficit carry + aging boost guarantee every class is eventually served.
WEIGHTS: Dict[str, float] = {"interactive": 8.0, "batch": 3.0,
                             "background": 1.0}

DEFAULT_MAX_CONCURRENT = 4      # matches the server's historical pool width
DEFAULT_QUEUE_DEPTH = 32
DEFAULT_QUEUE_TIMEOUT_MS = 30_000
DEFAULT_AGING_MS = 2_000
DEFAULT_DEVICE_BUDGET_MB = 4_096
DEFAULT_DRAIN_TIMEOUT_S = 30


def drain_timeout_s() -> float:
    """How long a draining process waits for in-flight queries before
    typed cancellation (``DSQL_DRAIN_TIMEOUT_S``)."""
    return float(max(_env_int("DSQL_DRAIN_TIMEOUT_S",
                              DEFAULT_DRAIN_TIMEOUT_S), 1))

# deficit clamp: bounds the catch-up burst a long-unserved (or long-empty)
# class can accumulate, so one stale credit pile cannot monopolize a window
_DEFICIT_CAP = 8.0 * sum(WEIGHTS.values())


def tenant_weights() -> Dict[str, float]:
    """``DSQL_TENANT_WEIGHTS="gold:8,default:1"`` parsed to a weight map;
    empty when unset (fairness classes stay priority-only).  Weights clamp
    to a small positive floor — a zero weight would starve the class
    forever, which is what the deficit scheduler exists to prevent."""
    raw = os.environ.get("DSQL_TENANT_WEIGHTS", "").strip()
    if not raw:
        return {}
    out: Dict[str, float] = {}
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, w = part.partition(":")
        try:
            out[name.strip().lower()] = max(float(w), 0.01)
        except ValueError:
            continue
    return out


def _fairness_tenant() -> Optional[str]:
    """The fairness-class tenant of THIS thread's query, or None when
    ``DSQL_TENANT_WEIGHTS`` is unset (scheduling stays priority-keyed,
    bit-for-bit the pre-weights behavior).  Untenanted queries fall into
    the "default" class so a weighted tenant contends against SOMETHING."""
    if not tenant_weights():
        return None
    try:
        from . import tenancy as _ten
        return (_ten.current_tenant() or "default").lower()
    except Exception:  # pragma: no cover - tenancy is optional
        return "default"

# estimator: per-operator working-set multipliers over scanned input bytes.
# Joins/windows buffer both sides plus outputs; aggregates/sorts roughly
# double; unlisted operators pass input bytes through.
_OP_MULTIPLIERS = {
    "LogicalJoin": 3.0,
    "LogicalWindow": 3.0,
    "LogicalAggregate": 2.0,
    "LogicalSort": 2.0,
    "LogicalUnion": 1.5,
    "LogicalIntersect": 1.5,
    "LogicalExcept": 1.5,
}
_MULTIPLIER_CAP = 16.0
_MIN_ESTIMATE = 1 << 20         # every query reserves at least 1 MiB


def normalize_priority(raw: Optional[str]) -> str:
    """Map user/header input to a priority class; unknown values fall back
    to the default instead of failing the query at the wire boundary."""
    if raw:
        p = str(raw).strip().lower()
        if p in PRIORITIES:
            return p
    return default_priority()


def default_priority() -> str:
    import os

    p = os.environ.get("DSQL_DEFAULT_PRIORITY", "").strip().lower()
    return p if p in PRIORITIES else "interactive"


# ---------------------------------------------------------------------------
# working-set estimator
# ---------------------------------------------------------------------------

def _entry_bytes(entry) -> int:
    """Resident bytes of one catalog entry; chunked (out-of-HBM) sources
    estimate from their BATCH size, not their total row count — the
    streaming executor keeps exactly one padded batch resident at a
    time, so a chunked plan's device working set is O(batch_rows).
    (Estimating from n_rows made every SF10 chunked query reserve the
    whole budget and serialized the morsel pipelines the broker is
    supposed to run concurrently.)"""
    chunked = getattr(entry, "chunked", None)
    table = getattr(entry, "table", None)
    if chunked is not None:
        n_rows = int(getattr(chunked, "n_rows", 0))
        batch_rows = int(getattr(chunked, "batch_rows", 0)) or n_rows
        n_cols = len(getattr(table, "columns", ())) or 1
        return min(n_rows, batch_rows) * n_cols * 8
    total = 0
    for c in getattr(table, "columns", ()):
        total += int(getattr(c.data, "nbytes", 0))
        if getattr(c, "mask", None) is not None:
            total += int(getattr(c.mask, "nbytes", 0))
    rank_rows = getattr(entry, "rank_rows", None)
    if rank_rows is not None and table.num_rows:
        # this rank's rows of a mesh across processes: the whole table's
        # bytes, as the JAX package's global arrays count them
        total = total * rank_rows.padded // table.num_rows
    return total


def estimate_plan_bytes(plan, context) -> int:
    """Estimated device working set of an optimized plan: the bytes of every
    scanned table times the product of per-operator multipliers (capped).
    A shape heuristic, not an oracle — the broker clamps it to the budget,
    so an overestimate delays a query rather than wedging it."""
    scan_bytes = 0
    mult = 1.0
    stack = [plan]
    while stack:
        rel = stack.pop()
        t = type(rel).__name__
        if t == "LogicalTableScan":
            schema = context.schema.get(rel.schema_name)
            entry = (schema.tables.get(rel.table_name)
                     if schema is not None else None)
            if entry is not None:
                scan_bytes += _entry_bytes(entry)
        else:
            mult *= _OP_MULTIPLIERS.get(t, 1.0)
        stack.extend(getattr(rel, "inputs", ()) or ())
    return int(scan_bytes * min(mult, _MULTIPLIER_CAP)) + _MIN_ESTIMATE


def estimate_working_set(plan, context) -> "Tuple[int, str]":
    """(bytes, source) for the admission reservation, by the first rung
    that answers: ``history`` (the flight recorder's measured bytes of
    earlier runs of this plan shape, times ``DSQL_HISTORY_HEADROOM``;
    counter ``estimate_from_history``), ``chunked`` (out-of-core sources,
    estimated by batch), ``stats`` (the table statistics, counter
    ``estimate_from_stats``), ``cost_model`` (the device profiler's counted
    bytes of this plan's programs, counter ``estimate_from_cost_model``)
    and ``heuristic``.  The recorder and the profiler are imported only
    when their variables arm them."""
    from . import statistics as _stats

    if _history_on():
        from . import flight_recorder as _fr
        hist = _fr.plan_history_bytes(plan, context)
        if hist is not None:
            _tel.inc("estimate_from_history")
            return max(int(hist), _MIN_ESTIMATE), "history"
    from ..physical.streaming import plan_references_chunked
    if plan_references_chunked(plan, context):
        # chunked plans stream one batch at a time: the heuristic's scan
        # bytes are batch-bounded already (``_entry_bytes``)
        return estimate_plan_bytes(plan, context), "chunked"
    est = _stats.estimate_plan_bytes_stats(plan, context)
    if est is not None:
        _tel.inc("estimate_from_stats")
        return max(int(est), _MIN_ESTIMATE), "stats"
    if _profile_on():
        from . import profiler as _prof
        est = _prof.plan_cost_bytes(plan, context)
        if est is not None:
            _tel.inc("estimate_from_cost_model")
            return max(int(est), _MIN_ESTIMATE), "cost_model"
    return estimate_plan_bytes(plan, context), "heuristic"


# ---------------------------------------------------------------------------
# memory broker
# ---------------------------------------------------------------------------

class MemoryLedger:
    """Shared device-bytes ledger: query reservations + the result cache's
    device tier must fit ``DSQL_DEVICE_BUDGET_MB`` together.

    ``reserve`` may be called with the manager lock held; it takes the
    ledger lock and may nest the result-cache lock (via
    ``shrink_device_to``) — never the other way around.  ``reserved_bytes``
    is a lock-free read so the cache's tenancy check can call it from under
    the cache's own lock without inverting the order.
    """

    def __init__(self, cache_fn=None):
        self._lock = threading.Lock()
        self._reserved = 0
        self._cache_fn = cache_fn

    def _cache(self):
        if self._cache_fn is not None:
            return self._cache_fn()
        from . import result_cache as _rc
        return _rc.get_cache()

    @staticmethod
    def _spill():
        """The spill store's device tier is the ledger's SECOND tenant
        (after the result cache); absent/disabled stores count zero."""
        from . import spill as _spill
        if not _spill.enabled():
            return None
        return _spill.get_store()

    def budget(self) -> int:
        mb = _env_int("DSQL_DEVICE_BUDGET_MB", DEFAULT_DEVICE_BUDGET_MB)
        return max(mb, 0) * 2**20

    def reserved_bytes(self) -> int:
        return self._reserved        # lock-free: GIL-atomic int read

    def reserve(self, nbytes: int) -> Optional[int]:
        """Reserve ``nbytes`` (clamped to the budget) against the ledger.

        Returns the bytes actually reserved (0 when the broker is off), or
        None when the reservation cannot fit even after shrinking the cache
        tenant — the caller keeps the query queued.
        """
        budget = self.budget()
        if budget <= 0:
            return 0                 # broker disabled: admission-only mode
        n = min(max(int(nbytes), 0), budget)
        with self._lock:
            cache = self._cache()
            spill = self._spill()
            spill_dev = int(spill.device_bytes) if spill is not None else 0
            free = (budget - self._reserved - int(cache.device_bytes)
                    - spill_dev)
            if free < n:
                # pressure-driven tenant shrink: spill/evict the cache's
                # device tier down to what this reservation leaves over,
                # then demote the spill store's device chunks to host
                target = max(budget - self._reserved - n, 0)
                cache.shrink_device_to(target)
                if spill is not None:
                    spill.shrink_device_to(
                        max(target - int(cache.device_bytes), 0))
                    spill_dev = int(spill.device_bytes)
                free = (budget - self._reserved - int(cache.device_bytes)
                        - spill_dev)
            if free < n:
                return None
            self._reserved += n
            return n

    def release(self, nbytes: int) -> None:
        if nbytes <= 0:
            return
        with self._lock:
            self._reserved = max(self._reserved - int(nbytes), 0)


# ---------------------------------------------------------------------------
# tickets / seats
# ---------------------------------------------------------------------------

class Ticket:
    """One query's passage through admission: enqueue -> admit -> release."""

    __slots__ = ("priority", "est_bytes", "reserved_bytes", "enqueued_at",
                 "admitted_at", "queued_ms", "admitted", "released",
                 "backoff_s", "tenant")

    def __init__(self, priority: str, est_bytes: int, enqueued_at: float,
                 tenant: Optional[str] = None):
        self.priority = priority
        # fairness-class tenant (None unless DSQL_TENANT_WEIGHTS is set):
        # the ticket queues under "priority@tenant" instead of "priority"
        self.tenant = tenant
        self.est_bytes = est_bytes
        self.reserved_bytes = 0
        self.enqueued_at = enqueued_at
        self.admitted_at: Optional[float] = None
        self.queued_ms: Optional[float] = None
        self.admitted = False
        self.released = False
        # retry-backoff sleep accrued while holding the slot (filled at
        # release from QueryRuntime.backoff_s): subtracted from the
        # hold-time EWMA so in-rung retries cannot inflate the admission
        # queue-wait estimate
        self.backoff_s = 0.0


class Seat:
    """A server-side pre-claim made at POST time, before a worker thread
    picks the query up.  Counts toward the queue bound (so saturation 429s
    immediately instead of hiding in the thread pool's unbounded backlog)
    and carries the true enqueue timestamp, so ``queuedTimeMillis`` covers
    pool wait + scheduler wait."""

    __slots__ = ("priority", "enqueued_at", "consumed")

    def __init__(self, priority: str, enqueued_at: float):
        self.priority = priority
        self.enqueued_at = enqueued_at
        self.consumed = False


class _Tls(threading.local):
    ticket: Optional[Ticket] = None
    seat: Optional[Seat] = None
    priority: Optional[str] = None
    last_queued_ms: Optional[float] = None


_tls = _Tls()


@contextmanager
def priority_scope(priority: Optional[str]):
    """Install the explicit ``Context.sql(priority=...)`` choice for this
    thread; admission resolves explicit > seat > DSQL_DEFAULT_PRIORITY."""
    if priority is not None and priority not in PRIORITIES:
        raise ValueError(
            f"unknown priority {priority!r} (expected one of {PRIORITIES})")
    prev = _tls.priority
    _tls.priority = priority
    try:
        yield
    finally:
        _tls.priority = prev


@contextmanager
def seat_scope(seat: Optional[Seat]):
    """Install a server-claimed seat for this worker thread; the next
    admission consumes it (timestamp + priority)."""
    prev = _tls.seat
    _tls.seat = seat
    try:
        yield
    finally:
        _tls.seat = prev


def clear_thread_queued_ms() -> None:
    _tls.last_queued_ms = None


def thread_queued_ms() -> Optional[float]:
    """Measured queue time of the last admission on THIS thread (from the
    seat/enqueue timestamp to the admit timestamp) — race-free per-query
    attribution for the server's wire stats."""
    return _tls.last_queued_ms


# ---------------------------------------------------------------------------
# the workload manager
# ---------------------------------------------------------------------------

class WorkloadManager:
    """Process-global admission controller + priority scheduler + broker."""

    def __init__(self, cache_fn=None):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._running = 0
        self._seats = 0
        self._shedding = False          # edge-trigger state for slo.shed
        # fairness classes: keyed by priority alone until
        # DSQL_TENANT_WEIGHTS arms, then "priority@tenant" keys appear on
        # demand (bounded: one per priority x tenant ever seen); with the
        # knob unset the keys ARE exactly PRIORITIES and every code path
        # below reduces to the pre-weights behavior bit-for-bit
        self._waiting: Dict[str, "deque[Ticket]"] = {
            p: deque() for p in PRIORITIES}
        self._deficit: Dict[str, float] = {p: 0.0 for p in PRIORITIES}
        self._run_ewma_s: Optional[float] = None
        self._drain = threading.Event()
        self.ledger = MemoryLedger(cache_fn)

    # -- drain (SIGTERM/SIGINT graceful shutdown) ---------------------------
    def begin_drain(self) -> None:
        """Flip into draining: in-flight queries keep their slots and run
        to completion, but every NEW admission (seat claim or acquire)
        raises the typed ServerDraining verdict — the server surfaces it
        as HTTP 503 + Retry-After.  Independent of ``enabled()``: a
        process on its way out refuses new work even with the scheduler
        subsystem off."""
        self._drain.set()
        _tel.REGISTRY.set_gauge("server_draining", 1)

    def end_drain(self) -> None:
        self._drain.clear()
        _tel.REGISTRY.set_gauge("server_draining", 0)

    def draining(self) -> bool:
        return self._drain.is_set()

    def _drain_verdict(self) -> ServerDraining:
        return ServerDraining(
            "server is draining (shutdown in progress); retry against "
            "another instance", retry_after_s=drain_timeout_s())

    # -- config (env-read per call, like the result cache, so tests and
    # -- operators can flip knobs without a restart) ------------------------
    def limit(self) -> int:
        return max(_env_int("DSQL_MAX_CONCURRENT_QUERIES",
                            DEFAULT_MAX_CONCURRENT), 0)

    def depth(self) -> int:
        return max(_env_int("DSQL_QUEUE_DEPTH", DEFAULT_QUEUE_DEPTH), 0)

    def queue_timeout_s(self) -> float:
        return max(_env_int("DSQL_QUEUE_TIMEOUT_MS",
                            DEFAULT_QUEUE_TIMEOUT_MS), 0) / 1e3

    def aging_ms(self) -> float:
        return float(max(_env_int("DSQL_QUEUE_AGING_MS", DEFAULT_AGING_MS),
                         0))

    def enabled(self) -> bool:
        return self.limit() > 0

    def cache_allowance(self) -> Optional[int]:
        """Device bytes the result cache may hold right now under ledger
        tenancy, or None when the subsystem/broker is off.  Lock-free —
        called from under the cache's own lock."""
        if not self.enabled():
            return None
        budget = self.ledger.budget()
        if budget <= 0:
            return None
        return max(budget - self.ledger.reserved_bytes(), 0)

    def spill_allowance(self) -> int:
        """Device bytes the spill store's device tier may hold right now
        under ledger tenancy (runtime/spill.py put_table consults this
        before pinning a join output on device).  Lock-free, like
        cache_allowance; an unlimited broker answers a large sentinel so
        the static DSQL_SPILL_DEVICE_MB cap still governs."""
        if not self.enabled():
            return 1 << 62
        budget = self.ledger.budget()
        if budget <= 0:
            return 1 << 62
        return max(budget - self.ledger.reserved_bytes(), 0)

    # -- live introspection (server wire stats) -----------------------------
    def queue_depth(self) -> int:
        with self._lock:
            return self._waiting_count_locked() + self._seats

    def running_count(self) -> int:
        with self._lock:
            return self._running

    def waiting_snapshot(self) -> "List[dict]":
        """Per-ticket view of the admission queue (GET /v1/engine): priority class, time waited, requested bytes
        (plus the fairness tenant when weighted classes are armed)."""
        now = time.monotonic()
        out: List[dict] = []
        with self._lock:
            for q in self._waiting.values():
                for t in q:
                    row = {"priority": t.priority,
                           "waitedMillis": round(
                               (now - t.enqueued_at) * 1e3, 1),
                           "estBytes": int(t.est_bytes)}
                    if t.tenant:
                        row["tenant"] = t.tenant
                    out.append(row)
        return out

    # -- burn-driven load shedding ------------------------------------------
    def _check_shed(self, priority: str) -> None:
        """Refuse a background admission with ``LoadShedRejected`` while
        an SLO class burns its error budget past ``DSQL_SLO_BURN`` on both
        windows (``events.SloMonitor.burning_classes``, recomputed live,
        so the shed lifts by itself as the breaching samples age out).
        Interactive and batch admissions are never shed.  Inert unless
        ``DSQL_EVENTS`` arms the bus; ``DSQL_SLO_SHED=0`` turns it off."""
        if priority != "background" or not _shed_on() or not _events_on():
            return
        from . import events as _ev
        burning = _ev.get_monitor().burning_classes()
        shedding = bool(burning)
        fire = False
        with self._cv:
            if shedding != self._shedding:
                self._shedding = shedding
                fire = True
        _tel.REGISTRY.set_gauge("slo_shedding", 1 if shedding else 0)
        if fire:
            _ev.publish("slo.shed", active=shedding,
                        burning=sorted(burning))
        if not shedding:
            return
        _tel.inc("sched_shed_background")
        # counted rejected too: admitted + rejected + timeout == submitted
        _tel.inc("sched_rejected_background")
        raise LoadShedRejected(
            f"background admissions shed: class(es) "
            f"{', '.join(sorted(burning))} burning SLO error budget past "
            f"{_ev.burn_threshold():g}x on both windows",
            retry_after_s=_SHED_RETRY_AFTER_S)

    # -- seats (server POST-time pre-claims) --------------------------------
    def claim_seat(self, priority: str) -> Optional[Seat]:
        """Claim a place in line at submit time; raises AdmissionRejected
        (HTTP 429 at the server) when running + queued + seats already fill
        every slot and queue position."""
        if self.draining():
            _tel.inc(f"sched_rejected_{normalize_priority(priority)}")
            raise self._drain_verdict()
        if not self.enabled():
            return None
        priority = normalize_priority(priority)
        self._check_shed(priority)
        with self._cv:
            limit, depth = self.limit(), self.depth()
            outstanding = (self._running + self._waiting_count_locked()
                           + self._seats)
            if outstanding >= limit + depth:
                _tel.inc(f"sched_rejected_{priority}")
                raise AdmissionRejected(
                    f"admission queue full ({outstanding} queries "
                    f"outstanding >= {limit} slots + {depth} queued)",
                    retry_after_s=self._retry_after_locked())
            self._seats += 1
            self._publish_locked()
        return Seat(priority, time.monotonic())

    def release_seat(self, seat: Optional[Seat]) -> None:
        """Return an unconsumed seat (query failed before admission, or was
        a DDL statement that never executes a plan)."""
        if seat is None or seat.consumed:
            return
        with self._cv:
            self._consume_seat_locked(seat)
            self._publish_locked()

    def _consume_seat_locked(self, seat: Seat) -> None:
        if not seat.consumed:
            seat.consumed = True
            self._seats = max(self._seats - 1, 0)

    # -- admission ----------------------------------------------------------
    def acquire(self, priority: str, est_bytes: int,
                seat: Optional[Seat] = None) -> Ticket:
        """Block until admitted; raises the typed verdict otherwise.

        The wait is deadline/cancellation-aware (``resilience.check`` runs
        every slice, so queue time counts against the query budget), aging-
        aware, and bounded by ``DSQL_QUEUE_TIMEOUT_MS``.  ``seat`` transfers
        a server pre-claim: its timestamp becomes the queue-time origin.
        """
        _faults.maybe_fail("admission")
        priority = normalize_priority(priority)
        # weighted tenant fairness (DSQL_TENANT_WEIGHTS): resolve the
        # fairness class once, and keep per-tenant books on THIS path so
        # submitted == admitted + rejected + timeout holds per tenant
        # (claim_seat rejections happen before acquire and are out of
        # these books by construction)
        ften = _fairness_tenant()
        if ften:
            _tel.inc(f"sched_submitted_tenant_{ften}")
        if self.draining():
            _tel.inc(f"sched_rejected_{priority}")
            if ften:
                _tel.inc(f"sched_rejected_tenant_{ften}")
            raise self._drain_verdict()
        if seat is None:
            # server-submitted queries were already shed-checked at seat
            # claim time; checking their pre-claimed seat again here would
            # double-count the reject counters for one submission
            try:
                self._check_shed(priority)
            except Exception:
                if ften:
                    _tel.inc(f"sched_rejected_tenant_{ften}")
                raise
        enqueued_at = seat.enqueued_at if seat is not None else \
            time.monotonic()
        ticket = Ticket(priority, int(est_bytes), enqueued_at, tenant=ften)
        with self._cv:
            if seat is not None:
                self._consume_seat_locked(seat)
            limit, depth = self.limit(), self.depth()
            n_wait = self._waiting_count_locked()
            if self._running >= limit and n_wait >= depth:
                _tel.inc(f"sched_rejected_{priority}")
                if ften:
                    _tel.inc(f"sched_rejected_tenant_{ften}")
                self._publish_locked()
                raise AdmissionRejected(
                    f"admission queue full ({n_wait} waiting >= depth "
                    f"{depth})", retry_after_s=self._retry_after_locked())
            # deadline-aware fast reject: do not enqueue a query whose
            # budget cannot plausibly survive the wait for a slot
            rt = _res.current()
            if rt is not None and self._running >= limit:
                rem = rt.remaining()
                expected = self._expected_wait_locked(n_wait)
                if (rem is not None and expected is not None
                        and rem < expected * 0.5):
                    _tel.inc(f"sched_rejected_{priority}")
                    if ften:
                        _tel.inc(f"sched_rejected_tenant_{ften}")
                    self._publish_locked()
                    raise AdmissionRejected(
                        f"deadline would expire while queued "
                        f"({rem * 1e3:.0f} ms left, ~{expected * 1e3:.0f} "
                        f"ms expected wait)",
                        retry_after_s=self._retry_after_locked())
            key = self._class_key(ticket)
            self._waiting.setdefault(key, deque())
            self._deficit.setdefault(key, 0.0)
            self._waiting[key].append(ticket)
            self._publish_locked()
            self._dispatch_locked()
            give_up = (time.monotonic() + self.queue_timeout_s()
                       if self.queue_timeout_s() > 0 else None)
            try:
                while not ticket.admitted:
                    _res.check("admission")
                    if give_up is not None and time.monotonic() >= give_up:
                        raise AdmissionTimeout(
                            f"queued {priority} query timed out after "
                            f"{self.queue_timeout_s() * 1e3:.0f} ms",
                            retry_after_s=self._retry_after_locked())
                    self._cv.wait(0.05)
            except BaseException:
                if ticket.admitted:
                    # admitted in the same instant the wait was abandoned:
                    # hand the slot straight back
                    self._release_locked(ticket)
                else:
                    self._abandon_locked(ticket)
                    # any abandoned wait — queue timeout, deadline expiry,
                    # cancellation — counts into the timeout family so
                    # admitted + rejected + timeout == submitted, always
                    _tel.inc(f"sched_timeout_{priority}")
                    if ften:
                        _tel.inc(f"sched_timeout_tenant_{ften}")
                self._publish_locked()
                raise
        _tls.last_queued_ms = ticket.queued_ms
        return ticket

    def release(self, ticket: Optional[Ticket]) -> None:
        if ticket is None:
            return
        with self._cv:
            self._release_locked(ticket)
            self._publish_locked()

    # -- internals (condition lock held) ------------------------------------
    @staticmethod
    def _class_key(ticket: Ticket) -> str:
        return (f"{ticket.priority}@{ticket.tenant}" if ticket.tenant
                else ticket.priority)

    @staticmethod
    def _weight_of(key: str) -> float:
        """DWRR weight of a fairness class: the priority weight alone for
        plain keys, x the tenant weight for "priority@tenant" keys (an
        unlisted tenant inherits the "default" entry, else 1.0)."""
        if "@" in key:
            p, _, t = key.partition("@")
            tw = tenant_weights()
            return WEIGHTS[p] * tw.get(t, tw.get("default", 1.0))
        return WEIGHTS[key]

    def _waiting_count_locked(self) -> int:
        return sum(len(q) for q in self._waiting.values())

    def _abandon_locked(self, ticket: Ticket) -> None:
        try:
            self._waiting[self._class_key(ticket)].remove(ticket)
        except (KeyError, ValueError):  # pragma: no cover - double abandon
            pass

    def _expected_wait_locked(self, n_ahead: int) -> Optional[float]:
        """Rough wait estimate: EWMA slot-hold time × queue position /
        slots.  None until at least one query has completed (no history —
        never reject on a guess)."""
        if self._run_ewma_s is None:
            return None
        return self._run_ewma_s * (n_ahead + 1) / max(self.limit(), 1)

    def _retry_after_locked(self) -> float:
        expected = self._expected_wait_locked(self._waiting_count_locked())
        if expected is None:
            return 1.0
        return min(max(math.ceil(expected), 1.0), 60.0)

    def _pick_locked(self) -> Optional[str]:
        """Deficit-weighted round-robin with aging: every non-empty class
        gains its weight; the winner (highest deficit + aging boost) pays
        the round's total, so service converges to the weight ratio and an
        unserved class accumulates credit until it must win.  With tenant
        weights armed the classes are "priority@tenant" and the weight is
        the product, so a noisy tenant's flood cannot starve a quiet
        tenant even inside one priority band; unarmed, the keys are
        exactly PRIORITIES and this is the pre-weights loop unchanged
        (the computed cap equals _DEFICIT_CAP)."""
        active = [k for k in self._waiting if self._waiting[k]]
        if not active:
            return None
        cap = 8.0 * sum(self._weight_of(k) for k in self._waiting)
        for k in active:
            self._deficit[k] = min(self._deficit[k] + self._weight_of(k),
                                   cap)
        aging = self.aging_ms()
        now = time.monotonic()

        def score(k: str) -> float:
            head = self._waiting[k][0]
            waited_ms = (now - head.enqueued_at) * 1e3
            boost = waited_ms / aging if aging > 0 else 0.0
            return self._deficit[k] + boost

        best = max(active, key=score)
        self._deficit[best] -= sum(self._weight_of(k) for k in active)
        return best

    def _dispatch_locked(self) -> None:
        limit = self.limit()
        while self._running < limit:
            k = self._pick_locked()
            if k is None:
                break
            ticket = self._waiting[k][0]
            reserved = self.ledger.reserve(ticket.est_bytes)
            if reserved is None:
                # over-reservation queues rather than crashes: refund the
                # round's deficit charge and retry at the next release
                self._deficit[k] += sum(
                    self._weight_of(q) for q in self._waiting
                    if self._waiting[q])
                break
            self._waiting[k].popleft()
            if not self._waiting[k]:
                self._deficit[k] = 0.0   # classic DRR: empty queue resets
            ticket.reserved_bytes = reserved
            ticket.admitted = True
            ticket.admitted_at = time.monotonic()
            ticket.queued_ms = (ticket.admitted_at
                                - ticket.enqueued_at) * 1e3
            self._running += 1
            # counters stay PRIORITY-keyed (admitted + rejected + timeout
            # sums over PRIORITIES), with per-tenant books added
            _tel.inc(f"sched_admitted_{ticket.priority}")
            if ticket.tenant:
                _tel.inc(f"sched_admitted_tenant_{ticket.tenant}")
            self._cv.notify_all()
        self._publish_locked()

    def _release_locked(self, ticket: Ticket) -> None:
        if ticket.released or not ticket.admitted:
            return
        ticket.released = True
        self._running = max(self._running - 1, 0)
        self.ledger.release(ticket.reserved_bytes)
        if ticket.admitted_at is not None:
            # hold time minus retry-backoff sleeps: the EWMA estimates how
            # long a slot stays BUSY, and a query asleep in backoff is not
            # representative work — counting it inflated queue-wait
            # estimates and triggered spurious deadline fast-rejects
            held = max(time.monotonic() - ticket.admitted_at
                       - max(ticket.backoff_s, 0.0), 0.0)
            self._run_ewma_s = (held if self._run_ewma_s is None
                                else 0.3 * held + 0.7 * self._run_ewma_s)
        self._dispatch_locked()
        self._cv.notify_all()

    def _publish_locked(self) -> None:
        _tel.REGISTRY.set_gauge("sched_queue_depth",
                                self._waiting_count_locked() + self._seats)
        _tel.REGISTRY.set_gauge("sched_running", self._running)
        _tel.REGISTRY.set_gauge("sched_reserved_bytes",
                                self.ledger.reserved_bytes())

    # -- the one call site: Context._execute_query_plan ---------------------
    @contextmanager
    def admission(self, plan=None, context=None,
                  priority: Optional[str] = None):
        """Admit one query plan for execution: resolve priority, estimate
        the working set, wait for a slot + memory under a ``queued`` span,
        and release both on exit.  Yields None (pass-through) when the
        subsystem is disabled or when this thread already holds a slot
        (nested plans — CREATE MODEL's training query, views — ride the
        outer admission instead of deadlocking on a second slot)."""
        if not self.enabled() or _tls.ticket is not None:
            yield None
            return
        seat, _tls.seat = _tls.seat, None      # consume the seat exactly once
        pr = priority or _tls.priority or \
            (seat.priority if seat is not None else None) or \
            default_priority()
        est = 0
        est_src = "none"
        if plan is not None and context is not None:
            try:
                est, est_src = estimate_working_set(plan, context)
            except Exception:      # estimator must never fail a query
                logger.debug("working-set estimate failed", exc_info=True)
                est, est_src = _MIN_ESTIMATE, "floor"
        with _tel.span("queued", priority=pr):
            try:
                ticket = self.acquire(pr, est, seat=seat)
            except Exception as e:
                if _events_on():
                    from . import events as _ev
                    _ev.publish("sched.rejected", priority=pr,
                                est_bytes=int(est),
                                error=type(e).__name__)
                raise
            _tel.annotate(queued_ms=round(ticket.queued_ms or 0.0, 3),
                          reserved_bytes=ticket.reserved_bytes,
                          est_bytes=int(est), est_source=est_src)
        if _events_on():
            from . import events as _ev
            _ev.publish("sched.admitted", priority=pr,
                        queued_ms=round(ticket.queued_ms or 0.0, 3),
                        est_bytes=int(est), est_source=est_src)
        rt = _res.current()
        backoff0 = rt.backoff_s if rt is not None else 0.0
        _tls.ticket = ticket
        try:
            yield ticket
        finally:
            _tls.ticket = None
            if rt is not None:
                # retry-backoff sleep accrued WHILE holding this slot;
                # _release_locked subtracts it from the hold-time EWMA
                ticket.backoff_s = max(rt.backoff_s - backoff0, 0.0)
            self.release(ticket)


_MANAGER = WorkloadManager()


def get_manager() -> WorkloadManager:
    """The process-global workload manager (like the result cache: one
    ledger and one queue per process, shared by every Context)."""
    return _MANAGER
