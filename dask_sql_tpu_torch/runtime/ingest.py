"""Continuous ingestion: a crash-tolerant write-ahead log of appended
batches per table, with snapshot-isolated reads.

The counterpart of ``dask_sql_tpu/runtime/ingest.py``.
``DSQL_INGEST_DIR`` arms it (``Context.__init__``, ``create_table`` and
``run_server`` check ``enabled()``); ``DSQL_INGEST=0`` turns it off with
the directory still set.

The write path (``Context.append_rows``, which INSERT INTO and ``POST
/v1/ingest`` lower to) becomes::

    coerce -> fault site -> backpressure -> [buffer] -> WAL -> apply

* **WAL**: one newline-terminated JSON envelope per committed batch,
  written with a single ``os.write`` on an ``O_APPEND`` descriptor and
  fsynced: the commit point, so an acknowledged batch survives a crash of
  the machine, not only of the process (``DSQL_INGEST_FSYNC=0`` trades
  that down to process crashes, for throughput).  A crash mid-write
  leaves a torn tail that fails its CRC or JSON check and is skipped on
  replay: a batch is committed exactly when its line is whole.  Segments
  rotate per table at ``DSQL_INGEST_SEGMENT_MB`` (default 64), and a
  table's segments are removed when it is dropped or registered again
  from its source, which then holds the rows.
* **The envelope** is the JAX package's: ``{"rows", "cols": [{"n", "d",
  "v"}]}``, with ``d`` a numpy dtype name, ``"str"`` or
  ``"datetime64[ns]"`` (nanoseconds).  It is written and read with numpy
  alone (the card's machine has no pandas); a log of numeric and
  timestamp columns written by either package replays here.
* **Replay**: arming loads the log; batches of registered tables apply at
  once, the others when ``create_table`` registers their base
  (``maybe_replay``).  A new process recovers every committed batch.
* **Micro-batching**: ``DSQL_INGEST_BATCH_ROWS`` > 1 buffers appends per
  table and commits them as one WAL line, one catalog swap and one
  matview delta once the buffer fills or outlives ``DSQL_INGEST_BATCH_MS``
  (a daemon flusher commits aged buffers).  The default (1) is
  synchronous.
* **Backpressure**: each batch reserves its bytes on the workload
  manager's ledger (``MemoryLedger.reserve``); a batch that does not fit
  raises ``IngestBackpressure`` (HTTP 429 with ``Retry-After``).
* **Snapshot isolation**: ``pin_scope`` captures the ``TableEntry`` and
  the epoch of every table a plan scans at admission;
  ``Context.catalog_entry`` and ``table_epoch`` read the thread's pin, so
  one query reads one committed prefix of every table while a writer
  appends.
"""
from __future__ import annotations

import glob as _glob
import json
import logging
import os
import threading
import time
import zlib
from contextlib import contextmanager

import numpy as np

from . import faults as _faults
from . import resilience as _res
from . import telemetry as _tel
from .gates import armed

logger = logging.getLogger(__name__)

WAL_SUBDIR = "wal"
WAL_VERSION = 1


# ---------------------------------------------------------------------------
# variables (read per call)
# ---------------------------------------------------------------------------

def ingest_dir():
    return os.environ.get("DSQL_INGEST_DIR") or None


def enabled() -> bool:
    """Armed (the directory set) and not turned off (``DSQL_INGEST=0``):
    ``gates.armed``'s rule."""
    return armed("DSQL_INGEST_DIR")


def batch_rows() -> int:
    try:
        return max(int(os.environ.get("DSQL_INGEST_BATCH_ROWS", "") or 1), 1)
    except ValueError:
        return 1


def batch_ms() -> float:
    try:
        return max(float(os.environ.get("DSQL_INGEST_BATCH_MS", "") or 25.0),
                   0.0)
    except ValueError:
        return 25.0


def _fsync_on() -> bool:
    return os.environ.get("DSQL_INGEST_FSYNC", "1").strip() \
        not in ("0", "false")


def _segment_bytes() -> int:
    try:
        mb = float(os.environ.get("DSQL_INGEST_SEGMENT_MB", "") or 64.0)
    except ValueError:
        mb = 64.0
    return max(int(mb * 2**20), 1 << 16)


# ---------------------------------------------------------------------------
# batch <-> JSON (the WAL line's payload)
# ---------------------------------------------------------------------------

_NS_PER_US = 1000
_NS_PER_DAY = 86_400 * 10**9


def _encode_table(t) -> dict:
    """Columnar JSON of a coerced batch: the values on the host, NULLs as
    JSON null, timestamps and dates in nanoseconds.  Replay coerces the
    columns against the live table again, so a type drift is a cast."""
    cols = []
    for name, col in zip(t.names, t.columns):
        st = col.stype
        data = col.data.cpu().numpy()
        valid = (np.ones(len(data), dtype=bool) if col.mask is None
                 else col.mask.cpu().numpy())
        if st.is_string:
            d = col.dictionary
            vals = [str(d[c]) if ok else None
                    for c, ok in zip(data.tolist(), valid.tolist())]
            cols.append({"n": str(name), "d": "str", "v": vals})
            continue
        if st.name in ("TIMESTAMP", "TIMESTAMP_WITH_LOCAL_TIME_ZONE", "DATE"):
            scale = _NS_PER_DAY if st.name == "DATE" else _NS_PER_US
            vals = (data.astype(np.int64) * scale).tolist()
            dtag = "datetime64[ns]"
        elif st.name == "INTERVAL_DAY_TIME":
            vals, dtag = data.astype(np.int64).tolist(), "timedelta64[ms]"
        elif st.name == "TIME":
            vals = [str(v) for v in col.to_pylist()]
            cols.append({"n": str(name), "d": "str",
                         "v": [v if ok else None
                               for v, ok in zip(vals, valid.tolist())]})
            continue
        else:
            vals, dtag = data.tolist(), str(data.dtype)
        if not valid.all():
            vals = [v if ok else None for v, ok in zip(vals, valid.tolist())]
        cols.append({"n": str(name), "d": dtag, "v": vals})
    return {"rows": int(t.num_rows), "cols": cols}


def _decode_table(data: dict) -> dict:
    """The inverse of ``_encode_table`` (and of the JAX package's
    encoder): {name: host column} for ``Context._apply_delta``, which
    coerces it against the live table."""
    out = {}
    for c in data["cols"]:
        vals, dtag = c["v"], c["d"]
        if dtag.startswith("datetime64"):
            out[c["n"]] = np.array(
                [np.datetime64("NaT") if v is None else int(v)
                 for v in vals], dtype=dtag)
        elif dtag.startswith("timedelta64"):
            out[c["n"]] = np.array(
                [np.timedelta64("NaT") if v is None else int(v)
                 for v in vals], dtype=dtag)
        elif dtag in ("str", "object"):
            out[c["n"]] = np.array(
                [None if v is None else str(v) for v in vals], dtype=object)
        elif any(v is None for v in vals):
            out[c["n"]] = list(vals)   # NULLs: the masked list path
        else:
            try:
                out[c["n"]] = np.asarray(vals, dtype=np.dtype(dtag.lower()))
            except (TypeError, ValueError):
                out[c["n"]] = np.asarray(vals)
    return out


def _table_nbytes(t) -> int:
    total = 0
    for col in t.columns:
        total += col.data.numel() * col.data.element_size()
        if col.mask is not None:
            total += col.mask.numel()
    return total or t.num_rows * 8 * max(t.num_columns, 1)


# ---------------------------------------------------------------------------
# the per-context log
# ---------------------------------------------------------------------------

class _Buffer:
    __slots__ = ("tables", "rows", "born", "grants")

    def __init__(self):
        self.tables = []
        self.rows = 0
        self.born = time.monotonic()
        # (ledger, grant) per buffered batch: the reservation lives until
        # the flush applies the rows, so buffered rows stay priced
        self.grants = []

    def release_grants(self) -> None:
        grants, self.grants = self.grants, []
        for ledger, grant in grants:
            ledger.release(grant)


class _Flusher(threading.Thread):
    def __init__(self, log, interval_s: float):
        super().__init__(name="dsql-ingest-flush", daemon=True)
        self.log = log
        self.interval_s = interval_s
        self.stop = threading.Event()

    def run(self):
        while not self.stop.wait(self.interval_s):
            try:
                self.log.flush_aged()
            except Exception:
                logger.warning("ingest: flush failed", exc_info=True)


class IngestLog:
    """WAL, buffers and replay state of one Context."""

    def __init__(self, context, root: str):
        self.context = context
        self.wal_dir = os.path.join(root, WAL_SUBDIR)
        os.makedirs(self.wal_dir, exist_ok=True)
        self.lock = threading.RLock()
        self._fds = {}        # (schema, table) -> (fd, path, seq)
        self._buffers = {}    # (schema, table) -> _Buffer
        self._stats = {}      # (schema, table) -> dict (engine_section)
        self._replay = {}     # (schema, table) -> [payload dicts]
        self._wal_bytes = 0
        self._flusher = None
        self._load_replay()
        _ALL_LOGS.append(self)

    # -- WAL segments ------------------------------------------------------
    def _seg_glob(self, key):
        return os.path.join(self.wal_dir, f"{key[0]}.{key[1]}.*.log")

    def _open_segment(self, key, seq: int):
        path = os.path.join(self.wal_dir, f"{key[0]}.{key[1]}.{seq:05d}.log")
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        return fd, path, seq

    def _fd_for(self, key):
        ent = self._fds.get(key)
        if ent is None:
            segs = sorted(_glob.glob(self._seg_glob(key)))
            seq = int(segs[-1].rsplit(".", 2)[-2]) if segs else 1
            ent = self._fds[key] = self._open_segment(key, seq)
        fd, _path, seq = ent
        if os.fstat(fd).st_size >= _segment_bytes():
            os.close(fd)
            ent = self._fds[key] = self._open_segment(key, seq + 1)
        return ent[0]

    def _wal_write(self, key, delta) -> None:
        """The commit point: one line, one write, one fsync.  A crash
        that truncates the line leaves a tail replay skips."""
        payload = json.dumps(
            {"s": key[0], "t": key[1], "d": _encode_table(delta)},
            separators=(",", ":"))
        line = (json.dumps(
            {"v": WAL_VERSION, "crc": zlib.crc32(payload.encode()),
             "p": payload}, separators=(",", ":")) + "\n").encode()
        fd = self._fd_for(key)
        os.write(fd, line)
        if _fsync_on():
            os.fsync(fd)
        self._wal_bytes += len(line)
        _tel.REGISTRY.set_gauge("ingest_wal_bytes", self._wal_bytes)

    # -- replay ------------------------------------------------------------
    def _load_replay(self) -> None:
        torn = 0
        for seg in sorted(_glob.glob(os.path.join(self.wal_dir, "*.log"))):
            with open(seg, "rb") as f:
                raw = f.read()
            self._wal_bytes += len(raw)
            for ln in raw.split(b"\n"):
                if not ln.strip():
                    continue
                try:
                    env = json.loads(ln)
                    p = env["p"]
                    if env.get("crc") != zlib.crc32(p.encode()):
                        raise ValueError("wal crc mismatch")
                    rec = json.loads(p)
                except (ValueError, TypeError, KeyError):
                    # a torn or garbled line was never acknowledged (the
                    # commit point is the whole line): nothing is lost
                    torn += 1
                    continue
                self._replay.setdefault((rec["s"], rec["t"]),
                                        []).append(rec["d"])
        if torn:
            _tel.inc("ingest_wal_torn_lines", torn)
            logger.warning("ingest: skipped %d torn WAL line(s) under %s",
                           torn, self.wal_dir)
        _tel.REGISTRY.set_gauge("ingest_wal_bytes", self._wal_bytes)

    def maybe_replay(self, schema_name: str, table_name: str) -> int:
        """Apply the logged batches of a table just registered (on arming
        and from ``create_table``: the restart path registers the bases
        first).  A batch that cannot be applied raises, and every batch
        stays pending: the log is not truncated, and registering the base
        again replays them all onto it.  The JAX package logs the failure
        and drops the acknowledged batch."""
        key = (schema_name, table_name)
        with self.lock:
            recs = self._replay.pop(key, None)
        if not recs:
            return 0
        rows = applied = 0
        try:
            for d in recs:
                rows += self.context._apply_delta(
                    schema_name, table_name, _decode_table(d))
                applied += 1
        except BaseException:
            with self.lock:
                self._replay.setdefault(key, [])[:0] = recs
            logger.error("ingest: WAL replay batch %d of %d for %s.%s "
                         "failed; the log keeps all of them", applied + 1,
                         len(recs), schema_name, table_name)
            raise
        finally:
            _tel.inc("ingest_replayed_batches", applied)
            _tel.inc("ingest_replayed_rows", rows)
            st = self._stats.setdefault(key, _new_stats())
            st["replayed_batches"] += applied
            st["replayed_rows"] += rows
        logger.info("ingest: replayed %d batch(es) / %d row(s) into %s.%s",
                    applied, rows, schema_name, table_name)
        return rows

    # -- the write path ----------------------------------------------------
    def commit(self, schema_name: str, table_name: str, delta) -> int:
        """WAL-then-apply (or buffer) one coerced batch.  Returns the rows
        applied now (0: buffered, flushed later by size or age)."""
        # before anything durable or visible: a failed append is refused
        # whole, never half-committed
        _faults.maybe_fail("ingest")
        key = (schema_name, table_name)
        nbytes = _table_nbytes(delta)
        from . import scheduler as _sched
        ledger = _sched.get_manager().ledger
        grant = ledger.reserve(nbytes)
        if grant is None:
            _tel.inc("ingest_backpressure_rejects")
            raise _res.IngestBackpressure(
                f"ingest batch of {delta.num_rows} rows ({nbytes} bytes) "
                "does not fit the device budget; back off and retry "
                "(DSQL_DEVICE_BUDGET_MB prices writers and readers from "
                "the same ledger)", retry_after_s=0.25)
        if batch_rows() > 1:
            handed_off = False
            try:
                with self.lock:
                    buf = self._buffers.setdefault(key, _Buffer())
                    buf.tables.append(delta)
                    buf.rows += delta.num_rows
                    # the buffer owns the reservation from here
                    buf.grants.append((ledger, grant))
                    handed_off = True
                    if buf.rows < batch_rows():
                        _tel.inc("ingest_batches_buffered")
                        st = self._stats.setdefault(key, _new_stats())
                        st["buffered_rows"] = buf.rows
                        _tel.REGISTRY.set_gauge(
                            "ingest_buffered_rows", self._buffered_rows())
                        return 0
            finally:
                if not handed_off:
                    ledger.release(grant)
            return self._flush(key)
        try:
            return self._commit_now(key, delta)
        finally:
            ledger.release(grant)

    def _commit_now(self, key, delta) -> int:
        # the table's append lock spans the WAL write and the apply: two
        # writers cannot interleave, and the log's order is the order
        # readers saw, which replay reproduces
        with self.context._append_lock(key[0], key[1]):
            with self.lock:
                self._wal_write(key, delta)
            rows = self.context._apply_delta_locked(key[0], key[1], delta)
        _tel.inc("ingest_batches_committed")
        _tel.inc("ingest_rows_committed", rows)
        st = self._stats.setdefault(key, _new_stats())
        st["batches"] += 1
        st["rows"] += rows
        return rows

    def _flush(self, key) -> int:
        from ..ops.join import concat_tables
        with self.lock:
            buf = self._buffers.pop(key, None)
            if buf is None or not buf.tables:
                if buf is not None:
                    buf.release_grants()
                return 0
            delta = (buf.tables[0] if len(buf.tables) == 1
                     else concat_tables(buf.tables))
            st = self._stats.setdefault(key, _new_stats())
            st["buffered_rows"] = 0
            _tel.REGISTRY.set_gauge("ingest_buffered_rows",
                                    self._buffered_rows())
        try:
            _tel.inc("ingest_flushes")
            return self._commit_now(key, delta)
        finally:
            buf.release_grants()

    def flush_aged(self) -> int:
        """The flusher's step: commit the buffers older than the batch
        window, so a trickle writer never strands rows."""
        limit_s = batch_ms() / 1000.0
        now = time.monotonic()
        with self.lock:
            aged = [k for k, b in self._buffers.items()
                    if now - b.born >= limit_s]
        return sum(self._flush(key) for key in aged)

    def flush_all(self) -> int:
        with self.lock:
            keys = list(self._buffers)
        return sum(self._flush(k) for k in keys)

    def _buffered_rows(self) -> int:
        return sum(b.rows for b in self._buffers.values())

    # -- lifecycle ---------------------------------------------------------
    def start_flusher(self) -> None:
        if self._flusher is None and batch_rows() > 1:
            interval = max(batch_ms() / 1000.0, 0.01)
            self._flusher = _Flusher(self, interval)
            self._flusher.start()

    def close(self) -> None:
        """Stop the flusher, commit the buffered rows (they were
        acknowledged as buffered, and a drain must not lose them), close
        the segments."""
        if self._flusher is not None:
            self._flusher.stop.set()
            self._flusher.join(timeout=5.0)
            self._flusher = None
        try:
            self.flush_all()
        except Exception:
            logger.warning("ingest: flush on close failed", exc_info=True)
        with self.lock:
            for fd, _path, _seq in self._fds.values():
                os.close(fd)
            self._fds.clear()

    def has_pending(self, schema_name: str, table_name: str) -> bool:
        """Whether logged batches wait for this table's registration."""
        with self.lock:
            return (schema_name, table_name) in self._replay

    def truncate(self, schema_name: str, table_name: str) -> None:
        """Drop a table's log: segments, buffers, pending replay.  Called
        when the table is dropped, or registered again from its source
        with nothing pending: the new base (or none) supersedes the log,
        and replaying it on a later restart would apply its rows twice or
        bring a dropped table's rows back.  Registering the persisted
        table again is how the log is checkpointed."""
        key = (schema_name, table_name)
        with self.lock:
            ent = self._fds.pop(key, None)
            if ent is not None:
                os.close(ent[0])
            buf = self._buffers.pop(key, None)
            if buf is not None:
                buf.release_grants()
            self._replay.pop(key, None)
            removed = 0
            for seg in _glob.glob(self._seg_glob(key)):
                removed += os.path.getsize(seg)
                os.remove(seg)
            if removed:
                self._wal_bytes = max(self._wal_bytes - removed, 0)
                _tel.REGISTRY.set_gauge("ingest_wal_bytes", self._wal_bytes)
                _tel.inc("ingest_wal_truncations")
                logger.info("ingest: truncated %d WAL byte(s) for %s.%s",
                            removed, schema_name, table_name)

    def tables_snapshot(self) -> dict:
        with self.lock:
            out = {}
            for key, st in sorted(self._stats.items()):
                out[f"{key[0]}.{key[1]}"] = dict(st)
            for key, buf in self._buffers.items():
                out.setdefault(f"{key[0]}.{key[1]}",
                               _new_stats())["buffered_rows"] = buf.rows
            return out


def _new_stats() -> dict:
    return {"batches": 0, "rows": 0, "buffered_rows": 0,
            "replayed_batches": 0, "replayed_rows": 0}


_ALL_LOGS: list = []


# ---------------------------------------------------------------------------
# arming (Context.__init__ and run_server; the caller checks the variable)
# ---------------------------------------------------------------------------

_ARM_LOCK = threading.Lock()


def get_log(context, create: bool = False):
    log = context.__dict__.get("_ingest_log")
    if log is None and create and enabled():
        with _ARM_LOCK:
            log = context.__dict__.get("_ingest_log")
            if log is None:
                log = IngestLog(context, ingest_dir())
                context._ingest_log = log
    return log


def ensure_armed(context) -> bool:
    """Idempotent arming of one context: open the WAL, replay the logged
    batches of the tables already registered, start the flusher."""
    if not enabled():
        return False
    log = get_log(context, create=True)
    for schema_name, sc in list(context.schema.items()):
        for table_name, entry in list(sc.tables.items()):
            if entry.table is not None and entry.chunked is None:
                log.maybe_replay(schema_name, table_name)
    log.start_flusher()
    return True


def _reset_for_tests() -> None:
    """Close every log and detach it from its context (a process
    death, for the tests of replay)."""
    while _ALL_LOGS:
        log = _ALL_LOGS.pop()
        log.close()
        log.context.__dict__.pop("_ingest_log", None)


# ---------------------------------------------------------------------------
# snapshot-isolated reads: the per-thread pin stack
# ---------------------------------------------------------------------------

_TLS = threading.local()


def _collect_scans(plan, out) -> None:
    from ..plan.nodes import LogicalTableScan, RexScalarSubquery

    def walk_rex(rex):
        if isinstance(rex, RexScalarSubquery) and rex.plan is not None:
            _collect_scans(rex.plan, out)
            return
        for op in getattr(rex, "operands", []) or []:
            walk_rex(op)

    if isinstance(plan, LogicalTableScan):
        out.append(plan)
        return
    for e in getattr(plan, "exprs", []) or []:
        walk_rex(e)
    cond = getattr(plan, "condition", None)
    if cond is not None:
        walk_rex(cond)
    for i in plan.inputs:
        _collect_scans(i, out)


@contextmanager
def pin_scope(context, plan):
    """Snapshot-isolate one query: capture (TableEntry, epoch) of every
    table ``plan`` scans at admission.  ``Context.catalog_entry`` and
    ``table_epoch`` read the top of this thread's stack while it runs, so
    its scans, its result-cache key and the compiled tier's keys see one
    committed prefix (tables are immutable and appends swap whole
    entries, so a pinned entry stays valid)."""
    pins = {}
    scans = []
    _collect_scans(plan, scans)
    outer = current_pins() or {}
    for scan in scans:
        key = (scan.schema_name, scan.table_name)
        if key in outer:
            # a plan nested in a pinned query reads the query's prefix
            pins[key] = outer[key]
            continue
        sc = context.schema.get(scan.schema_name)
        entry = sc.tables.get(scan.table_name) if sc is not None else None
        if entry is not None and entry.table is not None:
            pins[key] = (entry, context.table_epoch(scan.schema_name,
                                                    scan.table_name))
    with carried_pins(pins):
        yield


def current_pins():
    """The pins of this thread's innermost pinned query (None outside
    one), for the threads that work for the same query to carry."""
    stack = getattr(_TLS, "pins", None)
    return stack[-1] if stack else None


@contextmanager
def carried_pins(pins):
    """Re-enter a query's pins on another thread (a stage of its stage
    graph, its background build): that thread's catalog reads see the
    prefix the query was admitted on, so its scans agree with the keys
    and boundary names the query's own thread built.  ``None`` pins
    nothing."""
    if pins is None:
        yield
        return
    stack = getattr(_TLS, "pins", None)
    if stack is None:
        stack = _TLS.pins = []
    stack.append(pins)
    try:
        yield
    finally:
        stack.pop()


def pinned_entry(schema_name: str, table_name: str):
    stack = getattr(_TLS, "pins", None)
    if not stack:
        return None
    hit = stack[-1].get((schema_name, table_name))
    return None if hit is None else hit[0]


def pinned_epoch(schema_name: str, table_name: str):
    stack = getattr(_TLS, "pins", None)
    if not stack:
        return None
    hit = stack[-1].get((schema_name, table_name))
    return None if hit is None else hit[1]


# ---------------------------------------------------------------------------
# /v1/engine section
# ---------------------------------------------------------------------------

def engine_section(context) -> dict:
    counters = _tel.REGISTRY.counters()
    gauges = _tel.REGISTRY.gauges()
    log = get_log(context)
    out = {
        "armed": log is not None,
        "dir": ingest_dir() or "",
        "batchRows": batch_rows(),
        "batchMs": batch_ms(),
        "batchesCommitted": int(counters.get("ingest_batches_committed", 0)),
        "rowsCommitted": int(counters.get("ingest_rows_committed", 0)),
        "replayedBatches": int(counters.get("ingest_replayed_batches", 0)),
        "backpressureRejects": int(
            counters.get("ingest_backpressure_rejects", 0)),
        "tornWalLines": int(counters.get("ingest_wal_torn_lines", 0)),
        "walBytes": int(gauges.get("ingest_wal_bytes", 0)),
        "bufferedRows": int(gauges.get("ingest_buffered_rows", 0)),
        "mvPendingRows": int(gauges.get("mv_pending_rows", 0)),
        "mvStalenessS": float(gauges.get("mv_staleness_s", 0.0)),
    }
    if log is not None:
        out["tables"] = log.tables_snapshot()
    return out
