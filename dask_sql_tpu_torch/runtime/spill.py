"""Byte-accounted three-tier spill store.

The counterpart of ``dask_sql_tpu/runtime/spill.py``.  Named *runs* of
column chunks live in three tiers with strict byte accounting and LRU
movement between them:

- **device** -- torch ``Table`` chunks on the card, kept when small
  enough (``DSQL_SPILL_DEVICE_MB``, default 64).  The device tier is the
  second tenant of the workload manager's ledger
  (``runtime/scheduler.py`` ``MemoryLedger``): ``reserve`` counts
  ``device_bytes`` against the budget and calls ``shrink_device_to``
  under pressure, demoting LRU chunks to the host.
- **host** -- numpy ``(data, mask|None, stype, dictionary)`` columns,
  capped by ``DSQL_SPILL_MB`` (default 1024; **0 disables the store**).
  A device chunk comes to the host in one transfer
  (``table.tensors_to_host``).
- **disk** -- ``.npz`` files under ``DSQL_SPILL_DIR`` (default: a
  per-process directory in the temporary directory), named by
  ``kvstore.digest_key`` and written to a temporary file then
  ``os.replace``d; a file that does not load back raises the typed
  ``SpillCorrupt``.

Every disk write and read passes the ``spill`` fault site and runs under
``retry_transient``; a device chunk's copy to the host passes
``host_transfer``.  Counters ``spill_*`` and gauges
``spill_{device,host,disk}_bytes`` keep the JAX package's names.  Its
users are the server's result pages and, as in the JAX package, the
grace-hash join of two chunked tables (``physical/morsel.py``: partition
runs on the host tier, pair outputs on the device tier while they fit).

One RLock per store guards its runs and tiers; the byte totals are plain
ints read without it, so the ledger's admission arithmetic never waits on
spill I/O.  The spill lock never takes the ledger's or the manager's.
"""
from __future__ import annotations

import logging
import os
import tempfile
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import faults as _faults
from . import resilience as _res
from . import telemetry as _tel
from ..table import tensors_to_host
from .kvstore import digest_key

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def spill_budget_bytes() -> int:
    """Host-tier cap in bytes; 0 disables the store."""
    return max(_env_int("DSQL_SPILL_MB", 1024), 0) * (1 << 20)


def device_cap_bytes() -> int:
    """Device-tier cap (DSQL_SPILL_DEVICE_MB, default 64 MB) — a static
    ceiling; the broker's live allowance can only lower it further."""
    return max(_env_int("DSQL_SPILL_DEVICE_MB", 64), 0) * (1 << 20)


def enabled() -> bool:
    return spill_budget_bytes() > 0


def spill_dir() -> str:
    d = os.environ.get("DSQL_SPILL_DIR", "")
    if not d:
        d = os.path.join(tempfile.gettempdir(), f"dsql-spill-{os.getpid()}")
    return d


# ---------------------------------------------------------------------------
# typed errors
# ---------------------------------------------------------------------------

class SpillError(_res.FatalError):
    """A spill-store invariant broke (unknown run/chunk, impossible
    state).  Fatal: retrying the same attempt cannot help."""

    error_name = "SPILL_ERROR"


class SpillCorrupt(SpillError):
    """A disk chunk failed to load back (truncated / corrupt / vanished
    file).  The run's data is gone; the query must fail typed, not
    produce wrong rows."""

    error_name = "SPILL_CORRUPT"


# ---------------------------------------------------------------------------
# chunk records
# ---------------------------------------------------------------------------

#: host column layout: (data, mask or None, stype, dictionary) per column
HostCols = List[Tuple[np.ndarray, Optional[np.ndarray], object,
                      Optional[np.ndarray]]]


class _Chunk:
    __slots__ = ("run", "idx", "tier", "names", "stypes", "dicts",
                 "payload", "path", "nbytes", "rows")

    def __init__(self, run: str, idx: int, tier: str, names: List[str],
                 stypes: list, dicts: list, payload, nbytes: int,
                 rows: int):
        self.run = run
        self.idx = idx
        self.tier = tier            # "device" | "host" | "disk"
        self.names = names
        self.stypes = stypes        # per-column SqlType
        self.dicts = dicts          # per-column dictionary (or None)
        self.payload = payload      # device: Table; host: [(data, mask)]
        self.path: Optional[str] = None
        self.nbytes = nbytes
        self.rows = rows


def _host_cols_bytes(cols: HostCols) -> int:
    n = 0
    for data, mask, _stype, dictionary in cols:
        n += int(data.nbytes)
        if mask is not None:
            n += int(mask.nbytes)
        if dictionary is not None:
            n += int(getattr(dictionary, "nbytes", 0))
    return n


def _table_bytes(table) -> int:
    n = 0
    for col in table.columns:
        n += int(getattr(col.data, "nbytes", 0))
        if col.mask is not None:
            n += int(getattr(col.mask, "nbytes", 0))
    return n


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

class SpillStore:
    """Named runs of column chunks across device/host/disk tiers."""

    def __init__(self):
        self._lock = threading.RLock()
        self._runs: Dict[str, List[_Chunk]] = {}
        # LRU order within the movable tiers (front = coldest)
        self._device_lru: "OrderedDict[Tuple[str, int], _Chunk]" = \
            OrderedDict()
        self._host_lru: "OrderedDict[Tuple[str, int], _Chunk]" = \
            OrderedDict()
        # plain-int byte totals: lock-free reads for the ledger
        self.device_bytes = 0
        self.host_bytes = 0
        self.disk_bytes = 0
        self.peak_device_bytes = 0
        self._dir_ready = False
        self._seq = 0

    # -- writes ------------------------------------------------------------

    def put_host(self, run: str, names: List[str], cols: HostCols,
                 rows: Optional[int] = None) -> int:
        """Append one host-layout chunk to ``run``; returns its index.
        May flush LRU host chunks to disk to stay under DSQL_SPILL_MB."""
        if rows is None:
            rows = int(len(cols[0][0])) if cols else 0
        nbytes = _host_cols_bytes(cols)
        with self._lock:
            chunks = self._new_or_existing_run(run)
            idx = len(chunks)
            chunk = _Chunk(run, idx, "host", list(names),
                           [c[2] for c in cols], [c[3] for c in cols],
                           [(c[0], c[1]) for c in cols], nbytes, rows)
            chunks.append(chunk)
            self._host_lru[(run, idx)] = chunk
            self.host_bytes += nbytes
            _tel.inc("spill_chunks")
            _tel.inc("spill_bytes_host", nbytes)
            self._enforce_host_budget_locked()
            self._publish_gauges_locked()
        return idx

    def put_table(self, run: str, table) -> int:
        """Append a device Table chunk.  Stays on the device when it fits
        both the static cap and the broker's live allowance; otherwise it
        is demoted to host layout at once (counted as a demotion)."""
        nbytes = _table_bytes(table)
        if self._device_room_for(nbytes):
            with self._lock:
                if self._device_room_for(nbytes):
                    chunks = self._new_or_existing_run(run)
                    idx = len(chunks)
                    chunk = _Chunk(run, idx, "device", list(table.names),
                                   [c.stype for c in table.columns],
                                   [c.dictionary for c in table.columns],
                                   table, nbytes, int(table.num_rows))
                    chunks.append(chunk)
                    self._device_lru[(run, idx)] = chunk
                    self.device_bytes += nbytes
                    self.peak_device_bytes = max(self.peak_device_bytes,
                                                 self.device_bytes)
                    _tel.inc("spill_chunks")
                    self._publish_gauges_locked()
                    return idx
        _tel.inc("spill_demotions")
        return self.put_host(run, list(table.names),
                             self._table_to_host(table))

    # -- reads -------------------------------------------------------------

    def get_chunk(self, run: str, idx: int):
        """Fetch chunk ``idx`` of ``run`` as
        ``("device", names, Table)`` or ``("host", names, HostCols)``.
        Disk chunks load back to the host tier (a ``spill_loads``);
        either movable tier is touched to LRU-hot."""
        with self._lock:
            chunk = self._chunk_locked(run, idx)
            if chunk.tier == "device":
                self._device_lru.move_to_end((run, idx))
                return ("device", list(chunk.names), chunk.payload)
            if chunk.tier == "disk":
                self._load_locked(chunk)
            else:
                self._host_lru.move_to_end((run, idx))
            cols: HostCols = [
                (data, mask, chunk.stypes[ci], chunk.dicts[ci])
                for ci, (data, mask) in enumerate(chunk.payload)]
            return ("host", list(chunk.names), cols)

    def get_host_cols(self, run: str, idx: int) -> Tuple[List[str],
                                                         HostCols]:
        """Like get_chunk but always in host layout (device chunks are
        converted on the fly without changing their tier)."""
        tier, names, payload = self.get_chunk(run, idx)
        if tier == "device":
            return names, self._table_to_host(payload)
        return names, payload

    def chunk_meta(self, run: str, idx: int):
        """(names, stypes, dicts, rows) of one chunk WITHOUT touching its
        payload — disk chunks stay on disk (metadata lives in memory)."""
        with self._lock:
            chunk = self._chunk_locked(run, idx)
            return (list(chunk.names), list(chunk.stypes),
                    list(chunk.dicts), chunk.rows)

    def n_chunks(self, run: str) -> int:
        with self._lock:
            return len(self._runs.get(run, ()))

    def run_rows(self, run: str) -> int:
        with self._lock:
            return sum(c.rows for c in self._runs.get(run, ()))

    def run_bytes(self, run: str) -> int:
        with self._lock:
            return sum(c.nbytes for c in self._runs.get(run, ()))

    def has_run(self, run: str) -> bool:
        with self._lock:
            return run in self._runs

    # -- lifecycle ---------------------------------------------------------

    def free_run(self, run: str) -> None:
        """Drop a run and every chunk of it, across all tiers."""
        with self._lock:
            chunks = self._runs.pop(run, None)
            if not chunks:
                return
            for chunk in chunks:
                self._drop_chunk_locked(chunk)
            self._publish_gauges_locked()

    def clear(self) -> None:
        with self._lock:
            for run in list(self._runs):
                self.free_run(run)
            self.peak_device_bytes = 0

    def shrink_device_to(self, target: int) -> None:
        """Ledger pressure hook: demote LRU device chunks to host until
        the device tier occupies at most ``target`` bytes (mirrors
        result_cache.shrink_device_to)."""
        with self._lock:
            while self.device_bytes > max(target, 0) and self._device_lru:
                _key, chunk = next(iter(self._device_lru.items()))
                self._demote_locked(chunk)
            self._enforce_host_budget_locked()
            self._publish_gauges_locked()

    # -- introspection -----------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {
                "enabled": enabled(),
                "runs": len(self._runs),
                "chunks": sum(len(c) for c in self._runs.values()),
                "device_bytes": self.device_bytes,
                "host_bytes": self.host_bytes,
                "disk_bytes": self.disk_bytes,
                "peak_device_bytes": self.peak_device_bytes,
                "host_budget": spill_budget_bytes(),
                "device_cap": device_cap_bytes(),
                "dir": spill_dir(),
            }

    def runs_snapshot(self) -> List[dict]:
        with self._lock:
            rows = []
            for run in sorted(self._runs):
                chunks = self._runs[run]
                tiers = {}
                for c in chunks:
                    tiers[c.tier] = tiers.get(c.tier, 0) + 1
                rows.append({
                    "run": run,
                    "chunks": len(chunks),
                    "rows": sum(c.rows for c in chunks),
                    "nbytes": sum(c.nbytes for c in chunks),
                    "device_chunks": tiers.get("device", 0),
                    "host_chunks": tiers.get("host", 0),
                    "disk_chunks": tiers.get("disk", 0),
                })
            return rows

    # -- internals ---------------------------------------------------------

    def _new_or_existing_run(self, run: str) -> List[_Chunk]:
        chunks = self._runs.get(run)
        if chunks is None:
            chunks = self._runs[run] = []
            _tel.inc("spill_partitions")
        return chunks

    def _chunk_locked(self, run: str, idx: int) -> _Chunk:
        chunks = self._runs.get(run)
        if chunks is None or not 0 <= idx < len(chunks):
            raise SpillError(f"spill: unknown chunk {run!r}[{idx}]")
        return chunks[idx]

    def _device_room_for(self, nbytes: int) -> bool:
        cap = device_cap_bytes()
        from . import scheduler as _sched
        cap = min(cap, _sched.get_manager().spill_allowance())
        return self.device_bytes + nbytes <= cap

    @staticmethod
    def _table_to_host(table) -> HostCols:
        def fetch():
            _faults.maybe_fail("host_transfer")
            bufs = []
            for col in table.columns:
                bufs.append(col.data)
                if col.mask is not None:
                    bufs.append(col.mask)
            fetched = iter(tensors_to_host(bufs))
            out: HostCols = []
            for col in table.columns:
                data = next(fetched)
                mask = next(fetched) if col.mask is not None else None
                out.append((data, mask, col.stype, col.dictionary))
            return out
        return _res.retry_transient(fetch, site="spill_fetch")

    def _demote_locked(self, chunk: _Chunk) -> None:
        """device -> host, in place."""
        cols = self._table_to_host(chunk.payload)
        self._device_lru.pop((chunk.run, chunk.idx), None)
        self.device_bytes -= chunk.nbytes
        chunk.tier = "host"
        chunk.payload = [(c[0], c[1]) for c in cols]
        chunk.stypes = [c[2] for c in cols]
        chunk.dicts = [c[3] for c in cols]
        chunk.nbytes = _host_cols_bytes(cols)
        self._host_lru[(chunk.run, chunk.idx)] = chunk
        self.host_bytes += chunk.nbytes
        _tel.inc("spill_demotions")
        _tel.inc("spill_bytes_host", chunk.nbytes)

    def _enforce_host_budget_locked(self, keep=None) -> None:
        """Flush coldest host chunks until under budget.  ``keep`` pins one
        (run, idx) — the chunk a caller is about to hand out — so a load
        that itself overflows the budget evicts OTHERS but never flushes
        the payload back out from under its reader."""
        budget = spill_budget_bytes()
        while self.host_bytes > budget and self._host_lru:
            key, chunk = next(iter(self._host_lru.items()))
            if key == keep:
                break
            self._flush_locked(chunk)

    def _ensure_dir(self) -> str:
        d = spill_dir()
        if not self._dir_ready:
            os.makedirs(d, exist_ok=True)
            self._dir_ready = True
        return d

    def _flush_locked(self, chunk: _Chunk) -> None:
        """host -> disk: atomic npz write on the kvstore discipline."""
        d = self._ensure_dir()
        self._seq += 1
        name = digest_key((chunk.run, chunk.idx, os.getpid(), self._seq))
        path = os.path.join(d, f"{name}.npz")
        arrays = {}
        for ci, (data, mask) in enumerate(chunk.payload):
            arrays[f"d{ci}"] = data
            if mask is not None:
                arrays[f"m{ci}"] = mask

        def write():
            _faults.maybe_fail("spill")
            tmp = f"{path}.tmp{os.getpid()}.{threading.get_ident()}"
            try:
                with open(tmp, "wb") as f:
                    np.savez(f, **arrays)
                os.replace(tmp, path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise

        try:
            _res.retry_transient(write, site="spill_write")
        except _res.TransientError:
            _tel.inc("spill_errors")
            raise
        nbytes = os.path.getsize(path)
        self._host_lru.pop((chunk.run, chunk.idx), None)
        self.host_bytes -= chunk.nbytes
        chunk.tier = "disk"
        chunk.payload = [(None, mask is not None)
                         for _data, mask in chunk.payload]
        chunk.path = path
        chunk.nbytes = nbytes
        self.disk_bytes += nbytes
        _tel.inc("spill_flushes")
        _tel.inc("spill_bytes_disk", nbytes)

    def _load_locked(self, chunk: _Chunk) -> None:
        """disk -> host; corrupt/vanished files surface as SpillCorrupt."""
        path = chunk.path

        def read():
            _faults.maybe_fail("spill")
            with open(path, "rb") as f:
                with np.load(f, allow_pickle=False) as z:
                    cols = []
                    for ci, (_none, has_mask) in enumerate(chunk.payload):
                        data = z[f"d{ci}"]
                        mask = z[f"m{ci}"] if has_mask else None
                        cols.append((data, mask))
                    return cols

        try:
            # passthrough: a raw decode error must reach the except arm
            # below AS ITSELF (the classifier would wrap ValueError into
            # FatalError first and the SpillCorrupt conversion would miss)
            cols = _res.retry_transient(
                read, site="spill_read",
                passthrough=(OSError, ValueError, KeyError, EOFError))
        except _res.TransientError:
            _tel.inc("spill_errors")
            raise
        except (OSError, ValueError, KeyError, EOFError) as exc:
            _tel.inc("spill_errors")
            raise SpillCorrupt(
                f"spill: chunk {chunk.run!r}[{chunk.idx}] unreadable "
                f"at {path}: {exc}") from exc
        self.disk_bytes -= chunk.nbytes
        try:
            os.unlink(path)
        except OSError:
            pass
        chunk.tier = "host"
        chunk.payload = cols
        chunk.path = None
        chunk.nbytes = _host_cols_bytes(
            [(d, m, chunk.stypes[ci], chunk.dicts[ci])
             for ci, (d, m) in enumerate(cols)])
        self.host_bytes += chunk.nbytes
        self._host_lru[(chunk.run, chunk.idx)] = chunk
        _tel.inc("spill_loads")
        _tel.inc("spill_bytes_host", chunk.nbytes)
        # the load may push the host tier over budget; evict OTHERS — the
        # pinned key guarantees this chunk's payload survives the sweep
        # even when it alone exceeds the budget
        self._host_lru.move_to_end((chunk.run, chunk.idx))
        self._enforce_host_budget_locked(keep=(chunk.run, chunk.idx))

    def _drop_chunk_locked(self, chunk: _Chunk) -> None:
        if chunk.tier == "device":
            self._device_lru.pop((chunk.run, chunk.idx), None)
            self.device_bytes -= chunk.nbytes
        elif chunk.tier == "host":
            self._host_lru.pop((chunk.run, chunk.idx), None)
            self.host_bytes -= chunk.nbytes
        else:
            self.disk_bytes -= chunk.nbytes
            if chunk.path:
                try:
                    os.unlink(chunk.path)
                except OSError:
                    pass
        chunk.payload = None

    def _publish_gauges_locked(self) -> None:
        _tel.REGISTRY.set_gauge("spill_device_bytes", self.device_bytes)
        _tel.REGISTRY.set_gauge("spill_host_bytes", self.host_bytes)
        _tel.REGISTRY.set_gauge("spill_disk_bytes", self.disk_bytes)


# ---------------------------------------------------------------------------
# process-global store
# ---------------------------------------------------------------------------

_STORE: Optional[SpillStore] = None
_STORE_LOCK = threading.Lock()


def get_store() -> SpillStore:
    global _STORE
    if _STORE is None:
        with _STORE_LOCK:
            if _STORE is None:
                _STORE = SpillStore()
    return _STORE


def reset_store() -> None:
    """Testing hook: drop every run and forget the singleton."""
    global _STORE
    with _STORE_LOCK:
        if _STORE is not None:
            _STORE.clear()
        _STORE = None
