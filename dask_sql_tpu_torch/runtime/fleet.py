"""Fleet plane: the replica registry and the merged streams, as in the JAX
package's ``runtime/fleet.py``.

Several server processes (replicas) point ``DSQL_FLEET_DIR`` at one shared
directory.  Each publishes a heartbeat and writes its event and history
rings there, and any replica reads the fleet as a whole: who is alive, one
merged event stream, fleet-wide SLOs.  The files keep the JAX package's
formats, so a JAX replica and a port replica can share one directory.

**Arming.**  ``DSQL_FLEET_DIR`` is read before this module is imported
everywhere: unset, the module stays unloaded and every surface is
unchanged.  :func:`ensure_armed` (``Context.__init__`` and ``run_server``
call it) is idempotent: it points the event bus and the flight recorder
at per-replica rings inside the directory (``events-<replica>.jsonl``,
``history-<replica>.jsonl``) by setting ``DSQL_EVENTS``,
``DSQL_EVENTS_FILE``, ``DSQL_HISTORY_FILE`` and ``DSQL_REPLICA_ID`` with
``os.environ.setdefault`` (a value the operator set wins), writes the
first heartbeat and starts the heartbeater.  Those variables stay set for
the life of the process, so every later Context runs with the history and
the bus armed; tests restore the environment and call
:func:`_reset_for_tests`.

**Replica registry.**  Each replica writes ``replicas/<replica>.json``
(``kvstore.atomic_write_json``) every ``DSQL_FLEET_BEAT_S`` (2 s):
identity (replica id, pid, host, start), the workload manager's slots and
queue, the ledger, cache and spill bytes, the program store's section,
the SLO rows and anomaly flags.  :func:`read_replicas` skips corrupt and
torn files and marks a replica whose last beat is older than
``DSQL_FLEET_TTL_S`` (3 beats) ``alive=False``: a killed replica ages out
with nothing to clean up.

**Merged streams.**  Every event and envelope of an armed replica carries
its replica id; :func:`merged_events_rows` and :func:`merged_query_rows`
merge all replicas' rings in timestamp order, and
:func:`read_merged_since` long-polls the union with a composite cursor
(``replica:seq;replica:seq``): a k-way merge in per-replica seq order, so
each replica's delivery is monotonic and lossless while others append.

The heartbeat's ``programStore`` section is the JAX package's: the
store's entries, bytes, hits, misses and hit rate while
``DSQL_PROGRAM_STORE`` is set (``runtime/program_store.py``), and
``enabled: false`` with zeros, nothing imported, while it is not.
"""
from __future__ import annotations

import heapq
import json
import logging
import os
import socket
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from . import telemetry as _tel
from .kvstore import atomic_write_json

logger = logging.getLogger(__name__)

_ID_CHARS = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_-.")

_STARTED_UNIX = time.time()


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

def fleet_dir() -> Optional[str]:
    """The shared fleet directory, or None (fleet plane disabled)."""
    return os.environ.get("DSQL_FLEET_DIR") or None


def enabled() -> bool:
    return bool(fleet_dir())


def _env_float(name: str, default: float) -> float:
    try:
        raw = os.environ.get(name, "")
        return float(raw) if raw else default
    except ValueError:
        return default


def beat_interval_s() -> float:
    """``DSQL_FLEET_BEAT_S``: heartbeat refresh cadence (default 2 s;
    tests run sub-second beats)."""
    return max(_env_float("DSQL_FLEET_BEAT_S", 2.0), 0.05)


def ttl_s() -> float:
    """``DSQL_FLEET_TTL_S``: a replica whose last beat is older than
    this is expired (default 3x the beat interval, never below one
    beat) — the registry's only liveness mechanism, so a killed replica
    needs no cleanup."""
    return max(_env_float("DSQL_FLEET_TTL_S", 3.0 * beat_interval_s()),
               beat_interval_s())


def _sanitize_id(raw: Any) -> Optional[str]:
    if not raw:
        return None
    s = str(raw).strip()
    if not s or len(s) > 64 or not all(c in _ID_CHARS for c in s):
        return None
    return s


_RID_LOCK = threading.Lock()
_RID: Optional[str] = None


def replica_id() -> str:
    """This process's stable replica identity: ``DSQL_REPLICA_ID``
    (sanitized) when set — fleet children are usually launched with an
    explicit one — else ``<hostname>-<pid>``.  Cached after first use so
    every stamp this process writes agrees."""
    global _RID
    with _RID_LOCK:
        if _RID is None:
            rid = _sanitize_id(os.environ.get("DSQL_REPLICA_ID"))
            if rid is None:
                host = "".join(c if c in _ID_CHARS else "-"
                               for c in socket.gethostname())[:32] or "host"
                rid = f"{host}-{os.getpid()}"
            _RID = rid
        return _RID


def replicas_dir() -> str:
    return os.path.join(fleet_dir() or ".", "replicas")


def heartbeat_path(rid: Optional[str] = None) -> str:
    return os.path.join(replicas_dir(), f"{rid or replica_id()}.json")


def events_path(rid: Optional[str] = None) -> str:
    return os.path.join(fleet_dir() or ".",
                        f"events-{rid or replica_id()}.jsonl")


def history_path(rid: Optional[str] = None) -> str:
    return os.path.join(fleet_dir() or ".",
                        f"history-{rid or replica_id()}.jsonl")


# ---------------------------------------------------------------------------
# arming: env redirection + the heartbeater
# ---------------------------------------------------------------------------

_ARM_LOCK = threading.Lock()
_ARMED = False
_BEATER: Optional["_Heartbeater"] = None


class _Heartbeater(threading.Thread):
    """Daemon thread refreshing this replica's heartbeat file every
    ``beat_interval_s()``; a failed beat counts ``fleet_heartbeat_errors``
    and never propagates."""

    def __init__(self):
        super().__init__(name="dsql-fleet-heartbeat", daemon=True)
        self.stop = threading.Event()

    def run(self) -> None:
        while not self.stop.wait(beat_interval_s()):
            try:
                write_heartbeat_now()
            except Exception:
                _tel.inc("fleet_heartbeat_errors")
                logger.debug("fleet heartbeat failed", exc_info=True)


def ensure_armed() -> bool:
    """Idempotently arm the fleet plane for this process: create the
    shared dir, install the watchtower/recorder env redirection (every
    existing ``DSQL_EVENTS``/``DSQL_HISTORY_FILE`` gate then fires
    unchanged; explicit user-set values win via ``setdefault``), write
    the first heartbeat, and start the heartbeater.  Returns False —
    doing nothing — when ``DSQL_FLEET_DIR`` is unset."""
    global _ARMED, _BEATER
    d = fleet_dir()
    if not d:
        return False
    with _ARM_LOCK:
        if _ARMED:
            return True
        os.makedirs(replicas_dir(), exist_ok=True)
        rid = replica_id()
        # the redirection: per-replica rings inside the shared dir, and
        # a pinned replica id so worker children of THIS replica stamp
        # consistently.  setdefault — an operator pointing the rings
        # elsewhere explicitly keeps their paths.
        os.environ.setdefault("DSQL_REPLICA_ID", rid)
        os.environ.setdefault("DSQL_EVENTS", "1")
        os.environ.setdefault("DSQL_EVENTS_FILE", events_path(rid))
        os.environ.setdefault("DSQL_HISTORY_FILE", history_path(rid))
        try:
            write_heartbeat_now()
        except Exception:
            _tel.inc("fleet_heartbeat_errors")
            logger.debug("initial fleet heartbeat failed", exc_info=True)
        _BEATER = _Heartbeater()
        _BEATER.start()
        _ARMED = True
        return True


def _reset_for_tests() -> None:
    """Stop the heartbeater and forget cached identity (unit tests
    re-arm under fresh env)."""
    global _ARMED, _BEATER, _RID
    with _ARM_LOCK:
        if _BEATER is not None:
            _BEATER.stop.set()
            _BEATER = None
        _ARMED = False
    with _RID_LOCK:
        _RID = None


# ---------------------------------------------------------------------------
# heartbeats
# ---------------------------------------------------------------------------

def collect_heartbeat() -> dict:
    """This replica's heartbeat payload.  Every engine probe is wrapped:
    a minimal process (no scheduler, no store) still beats with zeros —
    liveness never depends on feature surface."""
    counters = _tel.REGISTRY.counters()
    gauges = _tel.REGISTRY.gauges()
    hb: Dict[str, Any] = {
        "replica": replica_id(),
        "pid": os.getpid(),
        "host": socket.gethostname(),
        "started": round(_STARTED_UNIX, 3),
        "beat": round(time.time(), 3),
        "beat_interval_s": beat_interval_s(),
        "counters": {k: int(counters.get(k, 0)) for k in (
            "queries", "query_errors", "server_queries", "compiles",
            "stage_compiles", "program_store_hits", "program_store_misses",
            "program_store_stores", "param_plan_hits", "param_plan_misses",
            "events_published", "history_records", "result_pages_served",
            "tenant_queries")},
    }
    try:
        from . import scheduler as _sched
        mgr = _sched.get_manager()
        hb["scheduler"] = {
            "enabled": mgr.enabled(),
            "limit": int(mgr.limit()),
            "queueDepth": int(mgr.queue_depth()),
            "running": int(mgr.running_count()),
            "draining": bool(mgr.draining()),
        }
        hb["memory"] = {"budgetBytes": int(mgr.ledger.budget()),
                        "reservedBytes": int(mgr.ledger.reserved_bytes())}
    except Exception:
        logger.debug("heartbeat scheduler probe failed", exc_info=True)
    hb["cache"] = {
        "bytes": int(gauges.get("result_cache_bytes", 0)),
        "hostBytes": int(gauges.get("result_cache_host_bytes", 0)),
    }
    hb["spill"] = {
        "deviceBytes": int(gauges.get("spill_device_bytes", 0)),
        "hostBytes": int(gauges.get("spill_host_bytes", 0)),
        "diskBytes": int(gauges.get("spill_disk_bytes", 0)),
    }
    hb["programStore"] = {"enabled": False, "entries": 0, "bytes": 0,
                          "hits": 0, "misses": 0, "hitRate": 0.0}
    try:
        from .gates import armed
        if armed("DSQL_PROGRAM_STORE"):
            from . import program_store as _pstore
            store = _pstore.get_store()
            hits = int(counters.get("program_store_hits", 0))
            misses = int(counters.get("program_store_misses", 0))
            hb["programStore"] = {
                "enabled": True, "entries": len(store.entries()),
                "bytes": store.total_bytes(), "hits": hits,
                "misses": misses,
                "hitRate": round(hits / (hits + misses), 6)
                if hits + misses else 0.0,
            }
    except Exception:
        logger.debug("heartbeat program-store probe failed", exc_info=True)
    # the SLO and anomaly sections ride the event bus (armed whenever the
    # fleet is: ensure_armed set DSQL_EVENTS); read before the import
    try:
        from .gates import events_on
        if events_on():
            from . import events as _ev
            hb["slo"] = _ev.slo_rows()
            hb["anomalies"] = _ev.anomalies()
    except Exception:
        logger.debug("heartbeat slo probe failed", exc_info=True)
    hb["tenant_slo"] = {
        k[len("slo_attainment_tenant_"):]: round(float(v), 6)
        for k, v in gauges.items()
        if k.startswith("slo_attainment_tenant_")}
    return hb


def write_heartbeat_now() -> dict:
    """Collect + atomically publish this replica's heartbeat (the
    heartbeater's tick, also called synchronously by ``GET /v1/fleet``
    so the serving replica's own row is never stale)."""
    hb = collect_heartbeat()
    os.makedirs(replicas_dir(), exist_ok=True)
    atomic_write_json(heartbeat_path(), hb)
    _tel.inc("fleet_heartbeats")
    return hb


def read_replicas() -> List[dict]:
    """Every registered replica's last heartbeat, corrupt files skipped,
    each row annotated with ``alive`` (beat within TTL) and ``age_s``.
    Sorted by replica id for stable output."""
    rows: List[dict] = []
    try:
        names = sorted(os.listdir(replicas_dir()))
    except OSError:
        return rows
    now = time.time()
    ttl = ttl_s()
    for name in names:
        if not name.endswith(".json"):
            continue
        # kvstore.read_json_dict filters scalar top-level values (it is
        # a {key: dict} reader); heartbeats are flat documents, so read
        # them with the same degrade-to-empty discipline directly
        try:
            with open(os.path.join(replicas_dir(), name)) as f:
                hb = json.load(f)
        except (OSError, ValueError):
            continue                      # corrupt/torn/vanished: skipped
        if not isinstance(hb, dict) or "replica" not in hb:
            continue                      # corrupt/torn/foreign: skipped
        try:
            beat = float(hb.get("beat", 0.0) or 0.0)
        except (TypeError, ValueError):
            continue
        hb["age_s"] = round(max(now - beat, 0.0), 3)
        hb["alive"] = (now - beat) <= ttl
        rows.append(hb)
    return rows


# ---------------------------------------------------------------------------
# merged event / envelope streams
# ---------------------------------------------------------------------------

def _read_jsonl(path: str) -> List[dict]:
    """Corrupt/torn-line-tolerant JSONL read (the ring discipline)."""
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


def _ring_files(prefix: str) -> List[Tuple[str, str]]:
    """(replica_id, path) for every per-replica ring of one kind in the
    shared dir, sorted by replica id."""
    d = fleet_dir()
    if not d:
        return []
    out: List[Tuple[str, str]] = []
    try:
        names = os.listdir(d)
    except OSError:
        return []
    for name in sorted(names):
        if name.startswith(prefix) and name.endswith(".jsonl"):
            rid = name[len(prefix):-len(".jsonl")]
            if rid:
                out.append((rid, os.path.join(d, name)))
    return out


def merged_events_rows(limit: int = 2000) -> List[dict]:
    """``system.events`` fleet mode: all replicas' event rings merged in
    timestamp order (ties broken by replica id then seq), newest
    ``limit`` kept.  One trace id spanning several replicas interleaves
    here — the cross-replica stitch."""
    merged: List[Tuple[float, str, int, dict]] = []
    for rid, path in _ring_files("events-"):
        for rec in _read_jsonl(path):
            merged.append((float(rec.get("unix", 0.0) or 0.0),
                           str(rec.get("replica", rid) or rid),
                           int(rec.get("seq", 0) or 0), rec))
    merged.sort(key=lambda t: (t[0], t[1], t[2]))
    _tel.inc("fleet_merged_reads")
    rows: List[dict] = []
    core = ("seq", "unix", "pid", "trace", "type", "replica")
    for unix, rid, seq, rec in merged[-max(int(limit), 1):]:
        extra = {k: v for k, v in rec.items() if k not in core}
        rows.append({
            "seq": seq,
            "unix": unix,
            "pid": int(rec.get("pid", 0) or 0),
            "trace": str(rec.get("trace", "") or ""),
            "type": str(rec.get("type", "") or ""),
            "replica": rid,
            "detail": (json.dumps(extra, separators=(",", ":"),
                                  default=str, sort_keys=True)
                       if extra else ""),
        })
    return rows


def merged_query_rows(limit: int = 2000) -> List[dict]:
    """``system.queries`` fleet mode: every replica's flight-recorder
    query envelopes merged in timestamp order, each stamped with the
    replica whose ring it came from."""
    merged: List[Tuple[float, str, dict]] = []
    for rid, path in _ring_files("history-"):
        for rec in _read_jsonl(path):
            if rec.get("kind") != "query":
                continue
            rec = dict(rec)
            rec.setdefault("replica", rid)
            merged.append((float(rec.get("unix", 0.0) or 0.0), rid, rec))
    merged.sort(key=lambda t: (t[0], t[1]))
    _tel.inc("fleet_merged_reads")
    return [rec for _, _, rec in merged[-max(int(limit), 1):]]


# -- composite cursor --------------------------------------------------------

def encode_cursor(cur: Dict[str, int]) -> str:
    """``replica:seq;replica:seq`` with replicas sorted — the
    ``X-DSQL-Cursor`` value of ``GET /v1/events?fleet=1``."""
    return ";".join(f"{rid}:{seq}" for rid, seq in sorted(cur.items())
                    if seq > 0)


def parse_cursor(raw: Optional[str]) -> Dict[str, int]:
    """Tolerant composite-cursor parse: malformed segments are dropped
    (the reader simply re-reads from that replica's start — the merged
    stream is advisory, like the rings)."""
    cur: Dict[str, int] = {}
    for part in (raw or "").split(";"):
        if ":" not in part:
            continue
        rid, _, seq = part.rpartition(":")
        rid = _sanitize_id(rid) or ""
        try:
            n = int(seq)
        except ValueError:
            continue
        if rid and n > 0:
            cur[rid] = n
    return cur


def read_merged_since(cursor: Optional[str], limit: int = 500,
                      timeout_s: float = 0.0,
                      poll_s: float = 0.1) -> Tuple[List[dict], str]:
    """The fleet long-poll: events with per-replica ``seq`` beyond the
    composite cursor, k-way-merged by (unix, replica, seq), capped at
    ``limit``; blocks (re-reading the rings every ``poll_s``) until at
    least one event arrives or ``timeout_s`` passes.

    Per-replica streams are consumed in seq order via the heap merge, so
    for any returned batch each replica's events are a contiguous
    seq-prefix of its pending set — the composite cursor advances
    monotonically and never skips an event that a later read could still
    deliver."""
    cur = parse_cursor(cursor)
    deadline = time.monotonic() + max(timeout_s, 0.0)
    limit = max(int(limit), 1)
    while True:
        streams: List[List[dict]] = []
        for rid, path in _ring_files("events-"):
            floor = cur.get(rid, 0)
            pend = [r for r in _read_jsonl(path)
                    if int(r.get("seq", 0) or 0) > floor]
            if pend:
                pend.sort(key=lambda r: int(r.get("seq", 0) or 0))
                for r in pend:
                    r.setdefault("replica", rid)
                streams.append(pend)
        if streams:
            break
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            break
        time.sleep(min(max(poll_s, 0.01), remaining))
    heads = []
    for i, pend in enumerate(streams):
        r = pend[0]
        heads.append(((float(r.get("unix", 0.0) or 0.0),
                       str(r.get("replica", "")),
                       int(r.get("seq", 0) or 0)), i, 0))
    heapq.heapify(heads)
    out: List[dict] = []
    while heads and len(out) < limit:
        _, i, j = heapq.heappop(heads)
        rec = streams[i][j]
        out.append(rec)
        rid = str(rec.get("replica", ""))
        cur[rid] = max(cur.get(rid, 0), int(rec.get("seq", 0) or 0))
        if j + 1 < len(streams[i]):
            r = streams[i][j + 1]
            heapq.heappush(heads,
                           ((float(r.get("unix", 0.0) or 0.0),
                             str(r.get("replica", "")),
                             int(r.get("seq", 0) or 0)), i, j + 1))
    _tel.inc("fleet_merged_reads")
    return out, encode_cursor(cur)


# ---------------------------------------------------------------------------
# merged SLO over the union of envelopes
# ---------------------------------------------------------------------------

def merged_slo() -> dict:
    """Per-class attainment and multi-window burn computed over the
    UNION of all replicas' query envelopes (not an average of per-replica
    gauges — a replica serving 10x the traffic weighs 10x), plus
    per-tenant attainment over the same union."""
    from . import events as _ev

    now = time.time()
    budget = max(1.0 - _ev.slo_target(), 1e-6)
    win_f, win_s = _ev.window_fast_s(), _ev.window_slow_s()
    per_class: Dict[str, List[Tuple[float, bool]]] = {
        c: [] for c in _ev.SLO_CLASSES}
    tenants: Dict[str, List[int]] = {}
    for rec in merged_query_rows(limit=100_000):
        cls = _ev.SloMonitor._class(rec.get("priority") or None)
        try:
            wall = float(rec.get("wall_ms", 0.0) or 0.0)
            unix = float(rec.get("unix", 0.0) or 0.0)
        except (TypeError, ValueError):
            continue
        ok = wall <= _ev.objective_ms(cls)
        per_class[cls].append((unix, ok))
        ten = rec.get("tenant")
        if ten:
            tot = tenants.setdefault(str(ten), [0, 0])
            tot[0] += 1
            if ok:
                tot[1] += 1
    classes = []
    for cls in _ev.SLO_CLASSES:
        samples = per_class[cls]
        total = len(samples)
        good = sum(1 for _, ok in samples if ok)
        burns = []
        for win in (win_f, win_s):
            inwin = [ok for (t, ok) in samples if now - t <= win]
            if not inwin:
                burns.append(0.0)
                continue
            frac = sum(1 for ok in inwin if not ok) / len(inwin)
            burns.append(frac / budget)
        classes.append({
            "class": cls,
            "objective_ms": _ev.objective_ms(cls),
            "total": total,
            "attainment": round(good / total, 6) if total else 1.0,
            "burn_fast": round(burns[0], 6),
            "burn_slow": round(burns[1], 6),
        })
    return {
        "target": _ev.slo_target(),
        "classes": classes,
        "tenants": {t: round(good / total, 6)
                    for t, (total, good) in sorted(tenants.items())
                    if total},
    }


# ---------------------------------------------------------------------------
# the fleet snapshot (GET /v1/fleet)
# ---------------------------------------------------------------------------

def snapshot() -> dict:
    """The aggregated fleet view: per-replica heartbeat rows, fleet-wide
    sums over the ALIVE replicas, merged SLO over the union of
    envelopes, and every replica's anomaly flags promoted with its id.
    Also refreshes this replica's own heartbeat first (when armed) so
    the serving replica is never its own stale row, and publishes the
    ``fleet_replicas_alive``/``fleet_warm_serves`` gauges."""
    if _ARMED:
        try:
            write_heartbeat_now()
        except Exception:
            logger.debug("snapshot heartbeat refresh failed", exc_info=True)
    replicas = read_replicas()
    alive = [r for r in replicas if r.get("alive")]
    totals = {
        "replicas": len(replicas),
        "alive": len(alive),
        "running": 0, "queueDepth": 0, "slots": 0,
        "queries": 0, "serverQueries": 0,
        "cacheBytes": 0, "spillBytes": 0, "reservedBytes": 0,
        "warmServes": 0, "compiles": 0,
        "programStoreEntries": 0, "programStoreBytes": 0,
    }
    anomalies: List[dict] = []
    for r in alive:
        sched = r.get("scheduler") or {}
        mem = r.get("memory") or {}
        cache = r.get("cache") or {}
        spill = r.get("spill") or {}
        ps = r.get("programStore") or {}
        cnt = r.get("counters") or {}
        totals["running"] += int(sched.get("running", 0) or 0)
        totals["queueDepth"] += int(sched.get("queueDepth", 0) or 0)
        totals["slots"] += int(sched.get("limit", 0) or 0)
        totals["queries"] += int(cnt.get("queries", 0) or 0)
        totals["serverQueries"] += int(cnt.get("server_queries", 0) or 0)
        totals["cacheBytes"] += (int(cache.get("bytes", 0) or 0)
                                 + int(cache.get("hostBytes", 0) or 0))
        totals["spillBytes"] += (int(spill.get("deviceBytes", 0) or 0)
                                 + int(spill.get("hostBytes", 0) or 0)
                                 + int(spill.get("diskBytes", 0) or 0))
        totals["reservedBytes"] += int(mem.get("reservedBytes", 0) or 0)
        totals["warmServes"] += int(ps.get("hits", 0) or 0)
        totals["compiles"] += int(cnt.get("compiles", 0) or 0)
        # replicas share ONE store — entries/bytes are the max observed,
        # not a sum that would double-count the shared index
        totals["programStoreEntries"] = max(
            totals["programStoreEntries"], int(ps.get("entries", 0) or 0))
        totals["programStoreBytes"] = max(
            totals["programStoreBytes"], int(ps.get("bytes", 0) or 0))
        for a in r.get("anomalies") or []:
            if isinstance(a, dict):
                anomalies.append({**a, "replica": r.get("replica", "")})
    _tel.REGISTRY.set_gauge("fleet_replicas_alive", len(alive))
    _tel.REGISTRY.set_gauge("fleet_warm_serves", totals["warmServes"])
    try:
        slo = merged_slo()
    except Exception:
        logger.debug("merged slo failed", exc_info=True)
        slo = {"classes": [], "tenants": {}}
    return {
        "dir": fleet_dir() or "",
        "replica": replica_id(),
        "beatIntervalS": beat_interval_s(),
        "ttlS": ttl_s(),
        "replicas": replicas,
        "totals": totals,
        "slo": slo,
        "anomalies": anomalies,
    }


def replica_rows() -> List[dict]:
    """Flat per-replica rows for ``system.replicas``."""
    rows: List[dict] = []
    for r in read_replicas():
        sched = r.get("scheduler") or {}
        mem = r.get("memory") or {}
        cache = r.get("cache") or {}
        spill = r.get("spill") or {}
        ps = r.get("programStore") or {}
        cnt = r.get("counters") or {}
        rows.append({
            "replica": str(r.get("replica", "")),
            "pid": int(r.get("pid", 0) or 0),
            "host": str(r.get("host", "")),
            "alive": bool(r.get("alive")),
            "started": float(r.get("started", 0.0) or 0.0),
            "beat": float(r.get("beat", 0.0) or 0.0),
            "age_s": float(r.get("age_s", 0.0) or 0.0),
            "running": int(sched.get("running", 0) or 0),
            "queue_depth": int(sched.get("queueDepth", 0) or 0),
            "slots": int(sched.get("limit", 0) or 0),
            "queries": int(cnt.get("queries", 0) or 0),
            "cache_bytes": (int(cache.get("bytes", 0) or 0)
                            + int(cache.get("hostBytes", 0) or 0)),
            "spill_bytes": (int(spill.get("deviceBytes", 0) or 0)
                            + int(spill.get("hostBytes", 0) or 0)
                            + int(spill.get("diskBytes", 0) or 0)),
            "reserved_bytes": int(mem.get("reservedBytes", 0) or 0),
            "program_entries": int(ps.get("entries", 0) or 0),
            "program_hits": int(ps.get("hits", 0) or 0),
            "program_misses": int(ps.get("misses", 0) or 0),
            "program_hit_rate": float(ps.get("hitRate", 0.0) or 0.0),
            "compiles": int(cnt.get("compiles", 0) or 0),
        })
    return rows
