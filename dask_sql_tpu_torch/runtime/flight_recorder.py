"""The flight recorder: a persistent query history and measured statistics.

The counterpart of ``dask_sql_tpu/runtime/flight_recorder.py``, armed by
``DSQL_HISTORY_FILE`` (every caller checks the variable before it imports
this module, so an unarmed query never loads it).  The file formats are
the JAX package's, byte for byte, so either package reads the other's
history and statistics:

**The history ring.**  ``DSQL_HISTORY_FILE`` names a JSONL file holding one
``query`` envelope per completed query (outcome, tier, priority, the
result cache's verdict, the error's type, measured and estimated bytes,
the plan fingerprint, skew, collective bytes, the cost model's error) and
one ``stage`` record per executed stage of a stage graph (its digest,
rows against the padded capacity class, bytes, walls).  Each record is
one ``os.write`` of one line under ``O_APPEND``, so writers in several
processes never tear each other's lines; reading skips corrupt or torn
lines.  Past ``DSQL_HISTORY_MB`` (16) the file keeps its newest half,
written to a temporary file and moved over it with ``os.replace``.

**Statistics.**  Each record folds into an EWMA statistics file
(``<DSQL_HISTORY_FILE>.stats``, ``kvstore.MtimeCachedJsonFile``) keyed by
the plan's canonical fingerprint (:func:`plan_fingerprint`: the
parameterized plan's canonical text, no table uids, so it is stable
across restarts and reloads) or the stage's digest.  The workload
manager's estimate ladder reads it first (:func:`plan_history_bytes`,
``est_source="history"``), the join order reads measured rows from it
(``statistics.measured_rows``), and the profiler keeps its cost
predictions in the same entries (``cost_bytes`` / ``cost_flops``).
Truncation prunes entries older than ``DSQL_HISTORY_STATS_TTL_S`` (7
days) and keeps at most ``DSQL_HISTORY_STATS_MAX`` (4096).

**Live queries.**  Open traces register here (:func:`begin_query`), so
``GET /v1/engine``'s ``active`` section lists the queries in flight with
their phase, tier and stage progress.

Under the fleet plane (``DSQL_FLEET_DIR``, ``runtime/fleet.py``) every
record carries its replica's id, as in the JAX package, and the ring is
the replica's own file in the fleet directory.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional

from . import telemetry as _tel
from .kvstore import MtimeCachedJsonFile, digest_key

logger = logging.getLogger(__name__)

_DEFAULT_LIMIT_MB = 16.0
_EWMA_ALPHA = 0.3               # matches the scheduler's slot-hold EWMA
_DEFAULT_HEADROOM = 1.5         # reservation = measured EWMA × headroom

# serializes THIS process's appends + ring maintenance; cross-process
# interleaving is handled by O_APPEND single-write lines + atomic replace
_LOCK = threading.Lock()

# live traces: id(trace) -> QueryTrace.  Plain-dict ops only (GIL-atomic) —
# registration is gated on enabled(), removal is an unconditional cheap pop.
_ACTIVE: Dict[int, Any] = {}


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

def history_path() -> Optional[str]:
    """The JSONL ring path, or None when the recorder is disabled."""
    return os.environ.get("DSQL_HISTORY_FILE") or None


def enabled() -> bool:
    return bool(os.environ.get("DSQL_HISTORY_FILE"))


def history_limit_bytes() -> int:
    """``DSQL_HISTORY_MB`` (fractional accepted — tests use KB-scale
    rings) as bytes; never below 4 KiB so the ring keeps SOME history."""
    raw = os.environ.get("DSQL_HISTORY_MB", "")
    try:
        mb = float(raw) if raw else _DEFAULT_LIMIT_MB
    except ValueError:
        mb = _DEFAULT_LIMIT_MB
    return max(int(mb * 2**20), 4096)


def stats_path() -> Optional[str]:
    path = history_path()
    return f"{path}.stats" if path else None


def stats_ttl_s() -> float:
    """``DSQL_HISTORY_STATS_TTL_S``: fingerprints whose EWMA entry was
    not refreshed within this window are pruned at ring truncation
    (default 7 days — long enough to survive a weekend of idleness,
    short enough that one-off ad-hoc plans don't accrete forever)."""
    raw = os.environ.get("DSQL_HISTORY_STATS_TTL_S", "")
    try:
        ttl = float(raw) if raw else 7 * 86400.0
    except ValueError:
        ttl = 7 * 86400.0
    return max(ttl, 0.0)


def stats_max_entries() -> int:
    """``DSQL_HISTORY_STATS_MAX``: hard entry cap on the sidecar (newest
    ``updated`` wins) — the TTL alone cannot bound a fast churn of
    *recent* fingerprints."""
    raw = os.environ.get("DSQL_HISTORY_STATS_MAX", "")
    try:
        n = int(raw) if raw else 4096
    except ValueError:
        n = 4096
    return max(n, 16)


_STATS = MtimeCachedJsonFile(stats_path)


def _fleet_replica() -> Optional[str]:
    """This replica's id under ``DSQL_FLEET_DIR`` (read before the
    import), else None: unarmed records carry no ``replica`` field."""
    if not os.environ.get("DSQL_FLEET_DIR"):
        return None
    from . import fleet as _fleet
    return _fleet.replica_id()


# ---------------------------------------------------------------------------
# the JSONL ring
# ---------------------------------------------------------------------------

def _append(path: str, rec: dict) -> None:
    """One event → one line → one O_APPEND write (atomic cross-process),
    then bounded ring maintenance."""
    line = (json.dumps(rec, separators=(",", ":"), default=str) + "\n"
            ).encode()
    with _LOCK:
        fd = os.open(path, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
        try:
            os.write(fd, line)
            size = os.fstat(fd).st_size
        finally:
            os.close(fd)
    _tel.inc("history_records")
    if size > history_limit_bytes():
        _truncate_ring(path)


def _truncate_ring(path: str) -> None:
    """Drop the OLDEST half of the ring via tmp + atomic replace.

    Concurrency model matches kvstore: a writer racing the replace can lose
    a few lines (events are advisory history, never correctness state) but
    can never corrupt the file or block a query."""
    limit = history_limit_bytes()
    with _LOCK:
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
            _tel.inc("history_truncations")
        except OSError:
            logger.debug("history ring truncation failed", exc_info=True)
            _tel.inc("history_errors")
    # sidecar maintenance rides the ring's own cadence: the sidecar only
    # grows while envelopes are appended, and appends are what trigger
    # truncation — so pruning here bounds the .stats file under churn
    # without a timer thread
    _prune_stats()


def _prune_stats() -> None:
    """Bound the EWMA sidecar: drop fingerprints not observed within
    ``stats_ttl_s()``, then cap survivors to ``stats_max_entries()``
    newest-by-``updated``.  Read-filter-replace under kvstore discipline:
    a racing ``_observe_stat`` can resurrect one entry, never corrupt."""
    try:
        data = _STATS.read()
        if not data:
            return
        now = time.time()
        ttl = stats_ttl_s()
        keep = {fp: e for fp, e in data.items()
                if isinstance(e, dict)
                and now - float(e.get("updated", 0) or 0) <= ttl}
        cap = stats_max_entries()
        if len(keep) > cap:
            newest = sorted(keep.items(),
                            key=lambda kv: float(kv[1].get("updated", 0)
                                                 or 0),
                            reverse=True)[:cap]
            keep = dict(newest)
        if len(keep) != len(data):
            _STATS.write(keep)
    except Exception:
        logger.debug("stats sidecar prune failed", exc_info=True)


def read_events(kind: Optional[str] = None,
                limit: Optional[int] = None) -> List[dict]:
    """Read the ring back, newest LAST; corrupt/torn lines are skipped.
    Missing/unreadable file (or recorder disabled) reads as empty."""
    path = history_path()
    if not path:
        return []
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
        if not isinstance(rec, dict):
            continue
        if kind is not None and rec.get("kind") != kind:
            continue
        out.append(rec)
    if limit is not None and len(out) > limit:
        out = out[-limit:]
    return out


# ---------------------------------------------------------------------------
# EWMA operator-statistics history (cross-process, like caps/quarantine)
# ---------------------------------------------------------------------------

def _observe_stat(fp: str, nbytes: Optional[int] = None,
                  rows: Optional[int] = None,
                  ms: Optional[float] = None,
                  cost_bytes: Optional[float] = None,
                  cost_flops: Optional[float] = None) -> None:
    """Fold one measurement into the per-fingerprint EWMA entry.
    Read-merge-replace (kvstore discipline): a lost race costs one
    observation, never corruption.  ``cost_bytes``/``cost_flops`` are the
    profiler's cost predictions (runtime/profiler.py): the
    model-vs-measured ledger shares one entry with the measured EWMA so
    the scheduler's cost_model rung survives the process boundary."""
    data = _STATS.read()
    e = dict(data.get(fp) or {})
    for key, v in (("bytes", nbytes), ("rows", rows), ("ms", ms),
                   ("cost_bytes", cost_bytes), ("cost_flops", cost_flops)):
        if v is None:
            continue
        prev = e.get(key)
        e[key] = (float(v) if prev is None
                  else _EWMA_ALPHA * float(v)
                  + (1.0 - _EWMA_ALPHA) * float(prev))
    e["n"] = int(e.get("n", 0)) + 1
    e["updated"] = time.time()
    data[fp] = e
    _STATS.write(data)


def get_stats(fp: str) -> Optional[dict]:
    """The EWMA entry for one canonical plan/stage fingerprint, or None."""
    return _STATS.read().get(fp)


def plan_fingerprint(plan, context) -> Optional[str]:
    """Canonical fingerprint of an optimized plan: digest of
    result_cache.canonical_plan TEXT only — no epochs, no uids — so the
    same query shape keys the same history entry across restarts and table
    reloads.  None for volatile plans (their measurements would mix
    unrelated executions).

    The plan is parameterized first (plan/parameterize.py) and serialized
    in SHAPE mode, so every literal variant of a query shape shares one
    EWMA history entry: cost/working-set estimates learned from
    ``x > 10`` inform admission of ``x > 20``.  With DSQL_PARAM_PLANS=0
    the pass is the identity and fingerprints match the pre-param era
    bit-for-bit."""
    from . import result_cache as _rc
    from ..plan.parameterize import param_plans_enabled, parameterize_plan

    if param_plans_enabled():
        plan, _ = parameterize_plan(plan)
    text, volatile, _scans = _rc.canonical_plan(plan, context, shape=True)
    if volatile:
        return None
    return digest_key(text)


def plan_history_bytes(plan, context) -> Optional[int]:
    """Measured working-set reservation for this plan from history, with
    ``DSQL_HISTORY_HEADROOM`` (default 1.5×) on top — or None when the
    recorder is off / the plan was never measured.  The scheduler's
    estimate path (scheduler.estimate_working_set) calls this FIRST."""
    if not enabled():
        return None
    fp = plan_fingerprint(plan, context)
    if fp is None:
        return None
    entry = get_stats(fp)
    if not entry or "bytes" not in entry:
        return None
    try:
        headroom = float(os.environ.get("DSQL_HISTORY_HEADROOM", "") or
                         _DEFAULT_HEADROOM)
    except ValueError:
        headroom = _DEFAULT_HEADROOM
    return int(float(entry["bytes"]) * max(headroom, 1.0))


# ---------------------------------------------------------------------------
# recording hooks (telemetry._close_trace / compiled._record_stage_stats)
# ---------------------------------------------------------------------------

def record_query(report, error: Optional[BaseException] = None) -> None:
    """Append one envelope for a completed query and feed its plan-level
    EWMA entry.  Called from telemetry._close_trace AFTER the env gate —
    this function may assume the recorder is on (but re-checks cheaply so
    direct callers cannot crash)."""
    path = history_path()
    if not path:
        return
    plan_fp = None
    est_bytes = 0
    est_source = None
    queued_ms = None
    stage_bytes = 0
    for s in report.root.walk():
        if plan_fp is None and "plan_fp" in s.attrs:
            plan_fp = s.attrs.get("plan_fp")
        if s.name == "queued":
            est_bytes = int(s.attrs.get("est_bytes", est_bytes) or 0)
            est_source = s.attrs.get("est_source", est_source)
            queued_ms = s.attrs.get("queued_ms", queued_ms)
        stage_bytes += int(s.attrs.get("stage_bytes", 0) or 0)
    # measured working-set proxy: the result plus every materialized stage
    # boundary this query produced — all bytes the engine actually touched
    # and the broker would have had to host concurrently
    measured = int(report.bytes_out) + stage_bytes
    cache_hit = bool(report.cache.get("hit"))
    rec = {
        "kind": "query",
        "unix": round(report.started_unix, 3),
        "pid": os.getpid(),
        "query": report.query.strip()[:500],
        "outcome": ("error" if error is not None
                    else "cache_hit" if cache_hit else "ok"),
        "error": type(error).__name__ if error is not None else "",
        "wall_ms": round(report.wall_ms, 3),
        "tier": report.tier or "",
        "priority": report.priority or "",
        "cache_hit": cache_hit,
        "cache_tier": report.cache.get("tier") or "",
        "cache_stored": bool(report.cache.get("stored")),
        "rows_out": int(report.rows_out),
        "bytes_out": int(report.bytes_out),
        "measured_bytes": measured,
        "est_bytes": est_bytes,
        "est_source": est_source or "",
        "queued_ms": float(queued_ms or 0.0),
        "plan_fp": plan_fp or "",
        "operators": list(getattr(report, "operators", ()) or ()),
        "phases": {k: round(v, 3) for k, v in report.phases.items()},
        # device-level profile fields: worst shard/partition skew,
        # collective bytes by kind, and the cost model's error against
        # the measured bytes.  Zeros when nothing annotated them.
        "skew_ratio": float(getattr(report, "skew_ratio", None) or 0.0),
        "collective_bytes": dict(getattr(report, "collective_bytes", None)
                                 or {}),
        "cost_err": (float(report.cost_err)
                     if getattr(report, "cost_err", None) is not None
                     else -1.0),
    }
    # end-to-end trace ID (runtime/events.py, DSQL_EVENTS=1): present
    # only when one was minted
    tid = getattr(report, "trace_id", None)
    if tid:
        rec["trace"] = str(tid)
    # tenant identity (runtime/tenancy.py): same conditional-field
    # discipline — only an explicitly-tenanted query carries it, so
    # default-tenant envelopes stay byte-identical
    ten = getattr(report, "tenant", None)
    if ten:
        rec["tenant"] = str(ten)
    rid = _fleet_replica()
    if rid:
        rec["replica"] = rid
    _append(path, rec)
    if plan_fp and error is None:
        if cache_hit:
            # a cache hit bypassed execution: bump the hit count ONLY, so
            # hot queries keep accruing rank in the view candidates
            # without folding a near-zero wall into the recompute-cost
            # EWMA (which would crater score = n × ewma_ms)
            _observe_stat(plan_fp)
        elif measured > 0:
            _observe_stat(plan_fp, nbytes=measured, rows=report.rows_out,
                          ms=report.wall_ms)


def record_stage(digest: str, rows_in: int, rows_out: int, capacity: int,
                 nbytes: int, wall_ms: float,
                 device_ms: Optional[float] = None,
                 query_fp: str = "") -> None:
    """Append one stats record for an executed stage and feed the
    stage-fingerprint EWMA entry.  Callers gate on DSQL_HISTORY_FILE."""
    path = history_path()
    if not path:
        return
    rec = {
        "kind": "stage",
        "unix": round(time.time(), 3),
        "pid": os.getpid(),
        "digest": digest,
        "query_fp": query_fp,
        "rows_in": int(rows_in),
        "rows_out": int(rows_out),
        "capacity": int(capacity),
        "bytes": int(nbytes),
        "wall_ms": round(float(wall_ms), 3),
        "device_ms": round(float(device_ms), 3) if device_ms else 0.0,
    }
    rid = _fleet_replica()
    if rid:
        rec["replica"] = rid
    _append(path, rec)
    _observe_stat(digest, nbytes=nbytes, rows=rows_out, ms=wall_ms)


# ---------------------------------------------------------------------------
# live-query registry (GET /v1/engine)
# ---------------------------------------------------------------------------

def begin_query(trace) -> bool:
    """Register an opening trace; True when registered (the caller then
    owes an end_query).  No-op (False) when the recorder is off."""
    if not enabled():
        return False
    _ACTIVE[id(trace)] = trace
    return True


def end_query(trace) -> None:
    _ACTIVE.pop(id(trace), None)


def active_snapshot() -> List[dict]:
    """Live in-flight queries of THIS process: phase (deepest open span),
    tier, priority, elapsed, and per-stage progress."""
    out: List[dict] = []
    now = time.time()
    for trace in list(_ACTIVE.values()):
        root = trace.root
        phase = root.name
        tier = None
        priority = None
        stages_total = 0
        stages_done = 0
        for s in root.walk():
            if s.t1 is None:
                phase = s.name
            t = s.attrs.get("tier")
            if tier is None and t is not None:
                tier = str(t)
            if s.name == "queued" and priority is None:
                priority = s.attrs.get("priority")
            if s.name == "stage_graph":
                stages_total += int(s.attrs.get("stages", 0) or 0)
            elif s.name == "stage" and s.t1 is not None:
                stages_done += 1
        out.append({
            "query": trace.query.strip()[:500],
            "phase": phase,
            "tier": tier or "",
            "priority": priority or "",
            "elapsedMillis": round(max(now - trace.started_unix, 0.0) * 1e3,
                                   1),
            "stagesTotal": stages_total,
            "stagesDone": stages_done,
            "pid": os.getpid(),
        })
    return out
