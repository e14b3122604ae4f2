"""Autopilot: the engine acting on its own telemetry, as in the JAX
package's ``runtime/autopilot.py``.

It reads sensors that already exist (the profile's ``skew_ratio`` and
``cost_err``, the flight recorder's EWMA history, the ranked
``system.view_candidates``) and acts through two loops.

**Materialized views.**  A daemon (and the synchronous :func:`tick` that
tests and ``chip_smoke.py`` drive) ranks the view candidates and creates
the top unmaterialized one as ``auto_mv_<fp[:12]>`` under a byte budget
(``DSQL_AUTOPILOT_MV_MB``, 64), refreshes stale managed views on the tick
(the delta's cost paid off the user's path) and drops a view whose serve
count has not moved for ``DSQL_AUTOPILOT_COLD_S`` (300 s; a dropped
fingerprint then cools down as long).  A candidate needs
``DSQL_AUTOPILOT_MIN_HITS`` (3) hits, and its example SQL must be under
500 characters: the history cuts a query's text at 500, and a cut text is
another query, so a longer text never materializes (in both packages).
Volatile, system-scan and unparseable candidates are blacklisted.  An
exact repeat of a managed view's query (the value-mode digest of its
canonical plan: a shape match with other literals never serves) is
answered from the view by :func:`try_serve`, refreshed first when its
bases moved.

**Re-planning.**  A completed query whose ``skew_ratio`` reaches
``DSQL_AUTOPILOT_SKEW`` (2.0) or whose ``cost_err`` reaches
``DSQL_AUTOPILOT_COST_ERR`` (1.0) records a hint for its plan
fingerprint in a file shared across processes (``DSQL_AUTOPILOT_FILE``,
by default ``<DSQL_HISTORY_FILE>.hints``; the JAX package's format) that
flips what that run chose: the SPMD join's broadcast / exchange
(``parallel/spmd.py``), the eager GROUP BY's hash / sorted
(``statistics.groupby_decision``) and the grace join's partitions, doubled
(``physical/morsel.py``).  Each hinted run is judged against the
recorded wall: two consecutive runs over 1.1x the baseline revert the
hint for good.  Defaults are the JAX package's.

Where the port captures CUDA graphs, a hinted decision is a capture of
its own, never a replay of the unhinted graph: the SPMD stage program's
key holds the join hint (its decisions are recorded once per key), the
grace join's partition count sets the pair tables' capacities, which key
the pair's program, and the GROUP BY hint acts on the eager executor
only, which captures nothing.

The daemon (``DSQL_AUTOPILOT_INTERVAL_S``, 5 s; 0 or less: explicit
ticks only) refreshes views on its own thread.  Its device work waits
only on its own stream (as every query path of the port does), so it
never invalidates a CUDA graph that tiering's background build or a
stage worker captures on another thread; a device-wide
``torch.cuda.synchronize()`` elsewhere would (``physical/graphs.py``).

Every action lands in a bounded journal (``system.autopilot``,
``GET /v1/engine``'s ``autopilot`` section), an ``autopilot.<action>``
event when the bus is armed and a ``kind: "autopilot"`` history record
when the history is.

``DSQL_AUTOPILOT`` is read before this module is imported everywhere:
unset (or ``0``), it stays unloaded and every path is the baseline.  The
``autopilot`` fault site (``runtime/faults.py``) turns a tick into a
journaled no-op: the advisor may stall, never break a query.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
import weakref
from collections import deque
from typing import Any, Dict, List, Optional

from . import gates
from . import telemetry as _tel
from .kvstore import MtimeCachedJsonFile

logger = logging.getLogger(__name__)

_EWMA_ALPHA = 0.3         # matches the flight recorder / scheduler EWMAs
_SLOWER_MARGIN = 1.1      # hinted run must stay under baseline x margin
_MAX_STRIKES = 2          # two measured-slower runs revert the hint
_JOURNAL_CAP = 256


# ---------------------------------------------------------------------------
# configuration (env-read per call so tests/operators flip without restart)
# ---------------------------------------------------------------------------

def enabled() -> bool:
    return os.environ.get("DSQL_AUTOPILOT", "0").strip() not in ("", "0")


def _env_float(name: str, default: float) -> float:
    try:
        raw = os.environ.get(name, "")
        return float(raw) if raw else default
    except ValueError:
        return default


def mv_budget_bytes() -> int:
    """Total state bytes autopilot-created views may hold
    (``DSQL_AUTOPILOT_MV_MB``, default 64)."""
    return int(_env_float("DSQL_AUTOPILOT_MV_MB", 64.0) * 2**20)


def skew_threshold() -> float:
    """Measured ``skew_ratio`` at/above which a re-plan hint records
    (``DSQL_AUTOPILOT_SKEW``, default 2.0 — max/mean partition rows)."""
    return _env_float("DSQL_AUTOPILOT_SKEW", 2.0)


def cost_err_threshold() -> float:
    """Measured ``cost_err`` at/above which a re-plan hint records
    (``DSQL_AUTOPILOT_COST_ERR``, default 1.0 — the cost model was off
    by 100%)."""
    return _env_float("DSQL_AUTOPILOT_COST_ERR", 1.0)


def cold_after_s() -> float:
    """Seconds without a new serve before a managed view is dropped
    (``DSQL_AUTOPILOT_COLD_S``, default 300)."""
    return _env_float("DSQL_AUTOPILOT_COLD_S", 300.0)


def interval_s() -> float:
    """Daemon tick cadence (``DSQL_AUTOPILOT_INTERVAL_S``, default 5;
    <= 0 disables the background thread — ticks are then explicit)."""
    return _env_float("DSQL_AUTOPILOT_INTERVAL_S", 5.0)


def min_hits() -> int:
    """Candidate hit floor before auto-materialization
    (``DSQL_AUTOPILOT_MIN_HITS``, default 3)."""
    return max(int(_env_float("DSQL_AUTOPILOT_MIN_HITS", 3)), 1)


# ---------------------------------------------------------------------------
# the cross-process hint store (kvstore discipline, like quarantine/caps)
# ---------------------------------------------------------------------------

def hints_path() -> Optional[str]:
    p = os.environ.get("DSQL_AUTOPILOT_FILE")
    if p:
        return p
    h = os.environ.get("DSQL_HISTORY_FILE")
    return f"{h}.hints" if h else None


_HINTS = MtimeCachedJsonFile(hints_path)
# fallback store when neither path env is set: hints still work within
# the process
_MEM_HINTS: Dict[str, dict] = {}
_MEM_LOCK = threading.Lock()


def _read_hints() -> Dict[str, dict]:
    if hints_path():
        data = _HINTS.read()
        return data if isinstance(data, dict) else {}
    with _MEM_LOCK:
        return {k: dict(v) for k, v in _MEM_HINTS.items()}


def get_hint(fp: str) -> Optional[dict]:
    e = _read_hints().get(fp)
    return dict(e) if isinstance(e, dict) else None


def _write_hint(fp: str, entry: dict) -> None:
    if hints_path():
        data = _HINTS.read()
        data[fp] = entry
        _HINTS.write(data)
    else:
        with _MEM_LOCK:
            _MEM_HINTS[fp] = dict(entry)


# ---------------------------------------------------------------------------
# the action journal (system.autopilot / GET /v1/engine)
# ---------------------------------------------------------------------------

_JOURNAL: "deque[dict]" = deque(maxlen=_JOURNAL_CAP)
_J_LOCK = threading.Lock()


def _journal(action: str, *, trigger: str = "", fingerprint: str = "",
             verdict: str = "", nbytes: int = 0, **detail: Any) -> None:
    rec = {
        "unix": round(time.time(), 3),
        "action": action,
        "trigger": str(trigger)[:200],
        "fingerprint": str(fingerprint or ""),
        "verdict": str(verdict)[:200],
        "bytes": int(nbytes),
        "detail": (json.dumps(detail, sort_keys=True, default=str)[:300]
                   if detail else ""),
    }
    with _J_LOCK:
        _JOURNAL.append(rec)
    if gates.events_on():
        try:
            from . import events as _ev
            _ev.publish(f"autopilot.{action}", trigger=rec["trigger"],
                        fingerprint=rec["fingerprint"],
                        verdict=rec["verdict"], bytes=rec["bytes"])
        except Exception:  # pragma: no cover - the bus is advisory
            logger.debug("autopilot event publish failed", exc_info=True)
    if gates.history_on():
        try:
            from . import flight_recorder as _fr
            path = _fr.history_path()
            if path:
                _fr._append(path, {"kind": "autopilot", **rec})
        except Exception:  # pragma: no cover - history is advisory
            logger.debug("autopilot history append failed", exc_info=True)


def journal_rows() -> List[dict]:
    """Newest-last action rows for ``system.autopilot``."""
    with _J_LOCK:
        return [dict(r) for r in _JOURNAL]


# ---------------------------------------------------------------------------
# per-query hint scope (context._run_query_plan brackets executions)
# ---------------------------------------------------------------------------

class _Tls(threading.local):
    fp: Optional[str] = None
    hints: Optional[Dict[str, Any]] = None


_tls = _Tls()
_CTX_REF: Optional["weakref.ref"] = None   # daemon's tick target


def begin_query(fp: Optional[str], context) -> None:
    """Install this execution's active hints (thread-local) and remember
    the context for the daemon.  ``fp`` is the SHAPE-mode plan
    fingerprint the caller already computed (hints compose across
    literal variants)."""
    global _CTX_REF
    try:
        _CTX_REF = weakref.ref(context)
    except TypeError:  # pragma: no cover - contexts are weakrefable
        pass
    _ensure_daemon()
    _tls.fp = fp
    _tls.hints = None
    if not fp:
        return
    entry = get_hint(fp)
    if (entry and entry.get("state") == "active"
            and isinstance(entry.get("hints"), dict)):
        _tls.hints = dict(entry["hints"])
        # the feedback hook keys its measured-vs-baseline verdict on this
        # annotation: only executions that actually ran hinted are judged
        _tel.annotate(autopilot_hinted=1)
        _tel.inc("autopilot_hints_applied")


def end_query() -> None:
    _tls.fp = None
    _tls.hints = None


def current_hint(op: str) -> Optional[Any]:
    """The active hint for one decision seam ("join" / "groupby" /
    "partitions") of the query executing on THIS thread, or None."""
    h = _tls.hints
    return h.get(op) if h else None


# ---------------------------------------------------------------------------
# matview serving: exact-repeat queries answer from the maintained view
# ---------------------------------------------------------------------------

# autopilot-created views: name -> bookkeeping.  In-process state (the
# views themselves live in the context's registry); _M_LOCK guards it
# against daemon/test tick races.
_MANAGED: Dict[str, dict] = {}
_BLACKLIST: set = set()     # fingerprints that can never materialize
# cold-dropped shape fps -> drop time: the candidate's hit history stays
# hot in the flight recorder, so without a cooldown the very next tick
# would re-create the view it just dropped (create/drop thrash)
_COOLDOWN: Dict[str, float] = {}
_M_LOCK = threading.RLock()


def try_serve(plan, context):
    """Serve an exact repeat of a managed view's defining query from the
    maintained state (refresh-if-stale first).  Exactness is the
    VALUE-mode canonical digest — a shape match with different literals
    must never serve another literal's rows.  None -> execute normally."""
    with _M_LOCK:
        managed = {n: dict(m) for n, m in _MANAGED.items()}
    if not managed:
        return None
    try:
        from . import matview as _mv
        from . import result_cache as _rc
        from .kvstore import digest_key
        reg = _mv.get_registry(context)
        if reg is None or not _mv.mv_enabled():
            return None
        text, volatile, _scans = _rc.canonical_plan(plan, context)
        if volatile:
            return None
        fpv = digest_key(text)
        for name, m in managed.items():
            if m.get("value_fp") != fpv:
                continue
            entry = context.schema.get(m["schema"])
            entry = entry.tables.get(name) if entry is not None else None
            if entry is None:
                continue
            served = reg.maybe_serve(context, m["schema"], name, entry)
            if served is None or served.table is None:
                return None
            _tel.inc("autopilot_mv_serves")
            _tel.annotate(autopilot="mv_serve")
            return served.table
    except Exception:
        # serving is an optimization: any failure degrades to execution
        logger.debug("autopilot serve failed", exc_info=True)
    return None


def _table_bytes(table) -> int:
    try:
        total = 0
        for col in getattr(table, "columns", ()) or ():
            data = getattr(col, "data", None)
            nb = getattr(data, "nbytes", None)
            if nb is None:
                nb = getattr(col, "nbytes", None)
            total += int(nb or 0)
        if total:
            return total
        rows = int(getattr(table, "num_rows", 0) or 0)
        cols = len(getattr(table, "columns", ()) or ())
        return rows * max(cols, 1) * 8
    except Exception:  # pragma: no cover - sizing is best-effort
        return 0


# ---------------------------------------------------------------------------
# the tick: rank candidates, create/refresh under budget, drop cold views
# ---------------------------------------------------------------------------

def tick(context=None, now: Optional[float] = None) -> dict:
    """One synchronous autopilot pass.  Public: the tests and
    ``chip_smoke.py`` drive it directly; the daemon calls it on its own
    cadence.  Never raises — the ``autopilot`` fault site (and any
    internal failure) degrades the whole pass to a journaled no-op."""
    if not enabled():
        return {}
    ctx = context if context is not None else (_CTX_REF() if _CTX_REF
                                               else None)
    if ctx is None:
        return {}
    if now is None:
        now = time.time()
    from . import faults as _faults
    try:
        _faults.maybe_fail("autopilot")
    except Exception as e:
        _journal("tick_fault", verdict=type(e).__name__)
        return {"faulted": True}
    _tel.inc("autopilot_ticks")
    out = {"created": 0, "refreshed": 0, "dropped": 0}
    try:
        out.update(_mv_tick(ctx, now))
    except Exception:
        logger.debug("autopilot mv tick failed", exc_info=True)
    return out


def _mv_tick(ctx, now: float) -> dict:
    from . import matview as _mv
    out = {"created": 0, "refreshed": 0, "dropped": 0}
    if not _mv.mv_enabled():
        return out
    with _M_LOCK:
        reg = _mv.get_registry(ctx)
        views = reg.views if reg is not None else {}
        # reconcile: a managed view dropped behind our back (DROP TABLE,
        # schema drop) leaves the books, freeing its budget share
        for name in list(_MANAGED):
            if (_MANAGED[name]["schema"], name) not in views:
                _MANAGED.pop(name)
        # 1) cold-drop: a view nobody served within the window goes away
        for name, m in list(_MANAGED.items()):
            mv = views.get((m["schema"], name))
            if mv is None:
                continue
            if mv.serves > m["serves_seen"]:
                m["serves_seen"] = mv.serves
                m["last_advance"] = now
            elif now - m["last_advance"] >= cold_after_s():
                try:
                    _mv.drop_matview(ctx, [m["schema"], name],
                                     if_exists=True)
                except Exception:
                    logger.debug("autopilot drop failed", exc_info=True)
                    continue
                freed = int(m["bytes"])
                _MANAGED.pop(name)
                _COOLDOWN[m["shape_fp"]] = now
                _tel.inc("autopilot_mv_drops")
                _journal("mv_drop",
                         trigger=f"cold>{cold_after_s():g}s",
                         fingerprint=m["shape_fp"], nbytes=freed,
                         view=name)
                out["dropped"] += 1
        # 2) refresh stale managed views on the tick, so maintenance is
        # paid here (idle/background) instead of on the next user read
        for name, m in list(_MANAGED.items()):
            mv = views.get((m["schema"], name))
            if mv is None:
                continue
            try:
                with reg.lock:
                    kind, _info = reg._staleness(ctx, mv)
            except Exception:
                continue
            if kind == "fresh":
                continue
            try:
                _mv.refresh_matview(ctx, [m["schema"], name])
            except Exception:
                logger.debug("autopilot refresh failed", exc_info=True)
                continue
            _tel.inc("autopilot_mv_refreshes")
            _journal("mv_refresh", trigger=kind,
                     fingerprint=m["shape_fp"], view=name)
            out["refreshed"] += 1
            entry = ctx.schema[m["schema"]].tables.get(name)
            if entry is not None and entry.table is not None:
                m["bytes"] = _table_bytes(entry.table)
        # 3) create the top unmaterialized candidate under the budget
        out["created"] = _maybe_create(ctx, now)
    return out


def _maybe_create(ctx, now: float) -> int:
    """Materialize the best-ranked eligible candidate; at most ONE per
    tick (a gentle actuator — convergence over thrash)."""
    from . import matview as _mv
    if not gates.history_on():
        return 0            # candidates come from the flight recorder
    try:
        from . import flight_recorder as _fr
        candidates = _mv.view_candidate_rows(ctx)
    except Exception:
        logger.debug("autopilot candidate scan failed", exc_info=True)
        return 0
    budget = mv_budget_bytes()
    used = sum(int(m["bytes"]) for m in _MANAGED.values())
    floor = min_hits()
    # candidates carry the SHAPE-mode fingerprint while mv.fingerprint is
    # value-mode, so the `materialized` flag misses literal-bearing shapes
    # we already acted on — track our own shape fps too
    managed_fps = {m["shape_fp"] for m in _MANAGED.values()}
    for cand in candidates:
        fp = cand.get("fingerprint") or ""
        if (not fp or cand.get("materialized") or fp in _BLACKLIST
                or fp in managed_fps):
            continue
        if now - _COOLDOWN.get(fp, float("-inf")) < cold_after_s():
            continue        # just cold-dropped: don't thrash it back
        if int(cand.get("hits", 0)) < floor:
            continue
        sql = (cand.get("example_sql") or "").strip()
        # the history ring truncates envelopes at 500 chars: a cut-off
        # SQL text would parse to a DIFFERENT query — never act on it
        if not sql or len(sql) >= 500:
            continue
        est = int(float((_fr.get_stats(fp) or {}).get("bytes", 0) or 0))
        if used + max(est, 0) > budget:
            _journal("mv_skip", trigger="budget", fingerprint=fp,
                     nbytes=est)
            continue
        name = f"auto_mv_{fp[:12]}"
        try:
            from ..sql.parser import parse_sql
            stmts = parse_sql(sql)
            query = getattr(stmts[0], "query", None) if len(stmts) == 1 \
                else None
            if query is None:
                raise ValueError("example SQL is not a single SELECT")
            _mv.create_matview(ctx, [name], query, sql,
                               if_not_exists=True, or_replace=False)
        except Exception as e:
            # volatile / system-scan / unparseable / failed: one strike
            # and the fingerprint can never materialize
            _BLACKLIST.add(fp)
            _journal("mv_reject", trigger=type(e).__name__,
                     fingerprint=fp, error=str(e)[:160])
            continue
        schema_name, lname = ctx.fqn([name])
        entry = ctx.schema[schema_name].tables.get(lname)
        actual = (_table_bytes(entry.table)
                  if entry is not None and entry.table is not None else est)
        if used + actual > budget and actual > est:
            # the materialized state blew the estimate past the budget:
            # undo, and never retry this fingerprint
            try:
                _mv.drop_matview(ctx, [schema_name, lname], if_exists=True)
            except Exception:
                logger.debug("autopilot undo-drop failed", exc_info=True)
            _BLACKLIST.add(fp)
            _journal("mv_reject", trigger="over_budget", fingerprint=fp,
                     nbytes=actual)
            continue
        reg = _mv.get_registry(ctx)
        mvobj = reg.views.get((schema_name, lname)) if reg else None
        _MANAGED[lname] = {
            "schema": schema_name,
            "shape_fp": fp,
            # value-mode digest: the exact-match serving key
            "value_fp": mvobj.fingerprint if mvobj is not None else "",
            "bytes": int(actual),
            "serves_seen": 0,
            "last_advance": now,
            "created": now,
        }
        _tel.inc("autopilot_mv_creates")
        _journal("mv_create",
                 trigger=(f"score={float(cand.get('score', 0)):.0f} "
                          f"hits={int(cand.get('hits', 0))}"),
                 fingerprint=fp, nbytes=int(actual), view=lname)
        return 1
    return 0


# ---------------------------------------------------------------------------
# feedback: telemetry._close_trace hook (armed callers only)
# ---------------------------------------------------------------------------

def on_query_complete(report, error: Optional[BaseException] = None) -> None:
    """Judge a hinted execution against its baseline, or record a new
    hint when a threshold tripped.  Joins the _close_trace hook chain —
    never raises."""
    try:
        _feedback(report, error)
    except Exception:
        logger.debug("autopilot feedback failed", exc_info=True)


def _feedback(report, error: Optional[BaseException]) -> None:
    root = getattr(report, "root", None)
    if root is None:
        return
    fp = None
    hinted = False
    for s in root.walk():
        # autopilot_fp is the streaming tier's fingerprint attr (chunked
        # plans carry it instead of plan_fp so they stay out of the
        # flight recorder's candidate stats); either keys the hint store
        if fp is None and "plan_fp" in s.attrs:
            fp = s.attrs.get("plan_fp")
        if fp is None and "autopilot_fp" in s.attrs:
            fp = s.attrs.get("autopilot_fp")
        if s.attrs.get("autopilot_hinted"):
            hinted = True
        if s.attrs.get("autopilot") == "mv_serve":
            return          # served from a view: not an execution sample
    if not fp or error is not None or report.cache.get("hit"):
        return
    wall = float(report.wall_ms)
    entry = get_hint(fp)
    if hinted and entry is not None and entry.get("state") == "active":
        baseline = float(entry.get("baseline_ms") or 0.0)
        if baseline <= 0.0:
            entry["baseline_ms"] = wall
            entry["updated"] = time.time()
            _write_hint(fp, entry)
            return
        if wall > baseline * _SLOWER_MARGIN:
            entry["strikes"] = int(entry.get("strikes", 0)) + 1
            entry["verdict"] = "slower"
            verdict = (f"slower {wall:.1f}ms vs {baseline:.1f}ms baseline "
                       f"(strike {entry['strikes']}/{_MAX_STRIKES})")
            if entry["strikes"] >= _MAX_STRIKES:
                entry["state"] = "reverted"
                _tel.inc("autopilot_hints_reverted")
                _journal("hint_revert", trigger=entry.get("trigger", ""),
                         fingerprint=fp, verdict=verdict)
            else:
                _journal("hint_strike", trigger=entry.get("trigger", ""),
                         fingerprint=fp, verdict=verdict)
        else:
            entry["strikes"] = 0
            entry["verdict"] = "faster"
            prev = entry.get("hinted_ms")
            entry["hinted_ms"] = (wall if prev is None
                                  else _EWMA_ALPHA * wall
                                  + (1.0 - _EWMA_ALPHA) * float(prev))
            _journal("hint_verdict", trigger=entry.get("trigger", ""),
                     fingerprint=fp,
                     verdict=(f"faster {wall:.1f}ms vs {baseline:.1f}ms "
                              "baseline"))
        entry["updated"] = time.time()
        _write_hint(fp, entry)
        return
    if entry is not None:
        # recorded-but-not-yet-applied, or permanently reverted: leave it
        return
    skew = getattr(report, "skew_ratio", None)
    cerr = getattr(report, "cost_err", None)
    trigger = None
    if skew is not None and float(skew) >= skew_threshold():
        trigger = f"skew_ratio={float(skew):g}>={skew_threshold():g}"
    elif cerr is not None and float(cerr) >= cost_err_threshold():
        trigger = f"cost_err={float(cerr):g}>={cost_err_threshold():g}"
    if trigger is None:
        return
    hints = _derive_hints(report)
    if not hints:
        return
    _write_hint(fp, {
        "hints": hints, "trigger": trigger, "baseline_ms": wall,
        "state": "active", "strikes": 0, "verdict": "",
        "hinted_ms": None, "created": time.time(),
        "updated": time.time(),
    })
    _tel.inc("autopilot_hints_recorded")
    _journal("hint_record", trigger=trigger, fingerprint=fp, hints=hints)


def _derive_hints(report) -> Dict[str, Any]:
    """Flip the decisions this execution actually took — parsed from the
    recorded operator-choice lines and span attributes, never guessed."""
    hints: Dict[str, Any] = {}
    join_cur = None
    gb_cur = None
    for line in getattr(report, "operators", ()) or ():
        head = str(line).split(" ", 1)[0]
        if "=" not in head:
            continue
        op, _, var = head.partition("=")
        if op == "spmd_join" and join_cur is None:
            join_cur = var
        elif op == "groupby" and gb_cur is None:
            gb_cur = var
    if join_cur == "broadcast":
        hints["join"] = "exchange"
    elif join_cur == "exchange":
        hints["join"] = "broadcast"
    # dense is a strict win when legal — only the hash<->sorted crossover
    # is worth second-guessing from measurements
    if gb_cur == "hash":
        hints["groupby"] = "sorted"
    elif gb_cur == "sorted":
        hints["groupby"] = "hash"
    root = getattr(report, "root", None)
    if root is not None:
        for s in root.walk():
            p = s.attrs.get("partitions")
            if s.name == "grace_join" and p:
                # a skewed grace join re-partitions finer next time
                hints["partitions"] = max(int(p) * 2, 2)
                break
    return hints


# ---------------------------------------------------------------------------
# the daemon (periodic + idle-accelerated ticks)
# ---------------------------------------------------------------------------

_DAEMON: Optional[threading.Thread] = None
_D_LOCK = threading.Lock()


def _ensure_daemon() -> None:
    if interval_s() <= 0:
        return
    global _DAEMON
    with _D_LOCK:
        if _DAEMON is not None and _DAEMON.is_alive():
            return
        t = threading.Thread(target=_daemon_loop, name="dsql-autopilot",
                             daemon=True)
        _DAEMON = t
        t.start()


def _daemon_loop() -> None:
    global _DAEMON
    last = time.monotonic()
    while enabled() and interval_s() > 0:
        iv = max(interval_s(), 0.05)
        time.sleep(min(iv / 4.0, 0.5))
        now = time.monotonic()
        due = now - last >= iv
        if not due:
            # idle acceleration: an empty scheduler halves the wait —
            # maintenance runs when the engine has nothing better to do
            try:
                from . import scheduler as _sched
                mgr = _sched.get_manager()
                idle = (mgr.running_count() == 0
                        and mgr.queue_depth() == 0)
            except Exception:
                idle = False
            due = idle and (now - last) >= iv / 2.0
        if not due:
            continue
        last = now
        try:
            tick()
        except Exception:  # pragma: no cover - tick already swallows
            logger.debug("autopilot daemon tick failed", exc_info=True)
    # disarmed (kill switch flipped mid-run): exit; a later armed query
    # restarts the thread via begin_query
    with _D_LOCK:
        _DAEMON = None


# ---------------------------------------------------------------------------
# surfaces
# ---------------------------------------------------------------------------

def engine_section() -> dict:
    """The ``/v1/engine`` autopilot section (armed callers only)."""
    with _M_LOCK:
        used = sum(int(m["bytes"]) for m in _MANAGED.values())
        names = sorted(_MANAGED)
    hints = _read_hints()
    active = sum(1 for e in hints.values()
                 if isinstance(e, dict) and e.get("state") == "active")
    reverted = sum(1 for e in hints.values()
                   if isinstance(e, dict) and e.get("state") == "reverted")
    with _J_LOCK:
        n = len(_JOURNAL)
        last = dict(_JOURNAL[-1]) if _JOURNAL else None
    return {
        "enabled": True,
        "mvBudgetBytes": mv_budget_bytes(),
        "mvUsedBytes": used,
        "managedViews": names,
        "hintsActive": active,
        "hintsReverted": reverted,
        "actions": n,
        "lastAction": last,
    }


def _reset_for_tests() -> None:
    global _CTX_REF
    with _M_LOCK:
        _MANAGED.clear()
        _BLACKLIST.clear()
        _COOLDOWN.clear()
    with _J_LOCK:
        _JOURNAL.clear()
    with _MEM_LOCK:
        _MEM_HINTS.clear()
    _CTX_REF = None
    end_query()
