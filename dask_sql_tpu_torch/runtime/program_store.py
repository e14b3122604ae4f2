"""Persistent cross-process program store: build records on disk.

The counterpart of ``dask_sql_tpu/runtime/program_store.py``, with the same
variables (``DSQL_PROGRAM_STORE``, ``DSQL_PROGRAM_STORE_MB``), layout
(``<dir>/<digest>.prog`` and ``<dir>/index.json``) and counters
(``program_store_hits`` / ``_misses`` / ``_stores`` / ``_rejects`` /
``_evictions`` / ``_errors``; ``spmd_store_hits`` in ``parallel/spmd.py``).
Only the callers that see the variable set import this module.

What an entry holds.  The JAX package pickles the serialized XLA
executable of a compiled program, so that a fresh process runs it without
compiling.  The port's programs are CUDA graphs (``physical/graphs.py``),
and a CUDA graph cannot be serialized: its kernels, pointers and memory
pool belong to the process that captured it.  An entry here is a **build
record**, what a build learned:

- ``caps``: the final capacities and hash rounds, after every escalation
  (a record is rewritten after each build, so the last one wins);
- ``meta``: the trace's output spec (names, types, masks, the group and
  hash sites), without the dictionaries, which the input layout fixes;
- ``n_args`` and ``n_outs``;
- ``consts``: the host-to-device copies the program makes, as numpy arrays
  keyed by the content digest of ``graphs._Consts`` with their counts,
  the cached uploads it reads (kernel 1's layouts, string byte matrices)
  included, so that a process whose caches are cold finds them too;
- ``pool_bytes`` (the capture's memory pool) and ``kernels`` (the hand
  kernels it launches, whose libraries are loaded before a capture);
- ``cost``, where ``DSQL_PROFILE`` counted one (``GraphProgram.cost``).

A hit builds the program with the stored caps and captures it straight
from the recorded constants, with no warm-up; the capture's replay answers
the first call.  It is counted ``program_store_hits`` and
``graph_captures``, never ``compiles``: in the port a compile is a build
that learned its program (its caps, its constants, its warm-up), and a
hit learns nothing.  On the CPU nothing is captured, so a hit there skips
the learning only.

Staleness.  A record is replayed through this process's tracer, not loaded
as a self-contained executable, so the digest folds in
``runtime_fingerprint()``: the card (``quarantine.device_fingerprint``:
name, compute capability, count, torch and CUDA versions), the torch
version, the format version and a digest of the tracer's own sources
(``physical/``, ``ops/``, ``csrc/``).  The entry carries the fingerprint
again and is checked at load; a mismatch is ``program_store_rejects`` and
the build runs normally.  A corrupt or unreadable entry is
``program_store_errors`` and is dropped; so is one whose constants do not
match their digests, whose arity differs, or whose capture fails (a
constant the record lacks, a host read): the caller then builds as if the
entry were absent, and never answers from it.

Writes are atomic (tmp + rename); the index rides
``kvstore.MtimeCachedJsonFile`` with read-merge-replace, so concurrent
processes can lose an index race but never corrupt it.
``DSQL_PROGRAM_STORE_MB`` (default 512) bounds the entries' bytes with a
least-recently-used eviction over the index's ``used_at`` stamps
(``program_store_evictions``).
"""
from __future__ import annotations

import hashlib
import logging
import os
import pickle
import threading
import time
from pathlib import Path
from typing import Dict, Optional

from . import kvstore as _kv
from . import telemetry as _tel

logger = logging.getLogger(__name__)

DEFAULT_BUDGET_MB = 512.0

_FORMAT_VERSION = 1
_INDEX_NAME = "index.json"
#: the sources a record is replayed through: a change to any of them may
#: change what a build learns
_TRACER_DIRS = ("physical", "ops", "csrc")

_tracer_digest_cache: Optional[str] = None


def _env_float(name: str, default: float) -> float:
    try:
        raw = os.environ.get(name, "")
        return float(raw) if raw else default
    except ValueError:
        return default


def tracer_digest() -> str:
    """A digest of the port's tracer sources (``physical/``, ``ops/``,
    ``csrc/``: paths and contents), computed once per process."""
    global _tracer_digest_cache
    if _tracer_digest_cache is None:
        root = Path(__file__).resolve().parents[1]
        h = hashlib.blake2b(digest_size=16)
        for sub in _TRACER_DIRS:
            for path in sorted((root / sub).rglob("*")):
                if path.suffix not in (".py", ".cu", ".h", ".cuh"):
                    continue
                h.update(str(path.relative_to(root)).encode())
                h.update(path.read_bytes())
        _tracer_digest_cache = h.hexdigest()
    return _tracer_digest_cache


def runtime_fingerprint() -> Dict[str, str]:
    """The runtime a build record is valid for: the card (or ``cpu``),
    the torch version, the tracer's sources and the record format."""
    import torch

    from . import quarantine as _quar

    return {"device": _quar.device_fingerprint(), "torch": torch.__version__,
            "tracer": tracer_digest(), "format": str(_FORMAT_VERSION)}


class ProgramStore:
    """Directory of build records and a JSON metadata index.

    Layout: ``<dir>/<digest>.prog`` (a pickled record dict) and
    ``<dir>/index.json`` ({digest: {bytes, used_at, stored_at}}, and
    ``cost_flops`` / ``cost_bytes`` where a cost rode along).  One entry
    per program digest; a rebuild after an escalation overwrites it.
    """

    def __init__(self, path: Optional[str] = None):
        self._path_override = path
        self._lock = threading.Lock()
        self._index = _kv.MtimeCachedJsonFile(self._index_path)

    # -- configuration (read on every call) ----------------------------------
    def path(self) -> Optional[str]:
        return self._path_override or os.environ.get("DSQL_PROGRAM_STORE")

    def enabled(self) -> bool:
        return bool(self.path())

    def budget_bytes(self) -> int:
        return int(max(_env_float("DSQL_PROGRAM_STORE_MB",
                                  DEFAULT_BUDGET_MB), 0.0) * (1 << 20))

    def _index_path(self) -> Optional[str]:
        p = self.path()
        return os.path.join(p, _INDEX_NAME) if p else None

    def _entry_path(self, digest: str) -> str:
        return os.path.join(self.path(), f"{digest}.prog")

    def digest(self, store_key) -> str:
        """The address of a program: its canonical identity folded with the
        runtime fingerprint."""
        return _kv.digest_key((store_key,
                               tuple(sorted(runtime_fingerprint().items()))))

    # -- lookup ---------------------------------------------------------------
    def contains(self, digest: str) -> bool:
        """Presence by the index alone (the tier decision's probe)."""
        if not self.enabled():
            return False
        return digest in self._index.read()

    def load(self, digest: str) -> Optional[dict]:
        """The stored record, or None: a miss, a corrupt entry (dropped) or
        a fingerprint mismatch, each of which the caller answers with a
        normal build."""
        if not self.enabled():
            return None
        path = self._entry_path(digest)
        try:
            with open(path, "rb") as f:
                entry = pickle.load(f)
        except FileNotFoundError:
            _tel.inc("program_store_misses")
            return None
        except Exception as e:   # corrupt, truncated or unpicklable
            _tel.inc("program_store_errors")
            logger.warning("program store entry %s unreadable (%s); "
                           "dropping it", digest[:12], type(e).__name__)
            self._drop(digest)
            return None
        if not isinstance(entry, dict) \
                or entry.get("fingerprint") != runtime_fingerprint():
            _tel.inc("program_store_rejects")
            logger.warning("program store entry %s rejected: runtime "
                           "fingerprint mismatch", digest[:12])
            return None
        self._touch(digest)
        return entry

    # -- mutation -------------------------------------------------------------
    def store(self, digest: str, entry: dict) -> bool:
        """Persist ``entry`` (atomic write), update the index and keep the
        byte budget.  Best-effort: False on any failure."""
        if not self.enabled():
            return False
        entry = dict(entry)
        entry["fingerprint"] = runtime_fingerprint()
        try:
            os.makedirs(self.path(), exist_ok=True)
            blob = pickle.dumps(entry, protocol=pickle.HIGHEST_PROTOCOL)
        except Exception as e:
            _tel.inc("program_store_errors")
            logger.warning("program store serialize failed: %s", e)
            return False
        path = self._entry_path(digest)
        tmp = f"{path}.tmp{os.getpid()}.{threading.get_ident()}"
        try:
            with open(tmp, "wb") as f:
                f.write(blob)
            os.replace(tmp, path)
        except OSError as e:
            logger.debug("program store %s not writable: %s", path, e)
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return False
        now = time.time()
        rec = {"bytes": len(blob), "used_at": now, "stored_at": now}
        cost = entry.get("cost")
        if isinstance(cost, dict):
            # the profiler's counted cost rides the index, so that
            # system.programs reads it without unpickling a record
            rec["cost_flops"] = float(cost.get("flops", 0.0) or 0.0)
            rec["cost_bytes"] = float(cost.get("bytes", 0.0) or 0.0)
        with self._lock:
            index = self._index.read()
            index[digest] = rec
            index = self._evict_locked(index, keep=digest)
            self._index.write(index)
        _tel.inc("program_store_stores")
        return True

    def _touch(self, digest: str) -> None:
        """The LRU recency stamp of a hit (best-effort)."""
        with self._lock:
            index = self._index.read()
            e = index.get(digest)
            if e is not None:
                e["used_at"] = time.time()
                index[digest] = e
                self._index.write(index)

    def _drop(self, digest: str) -> None:
        try:
            os.unlink(self._entry_path(digest))
        except OSError:
            pass
        with self._lock:
            index = self._index.read()
            if digest in index:
                del index[digest]
                self._index.write(index)

    def _evict_locked(self, index: Dict[str, dict], keep: str
                      ) -> Dict[str, dict]:
        """Drop least-recently-used entries until the bytes fit the budget
        (the newest entry is never its own victim)."""
        budget = self.budget_bytes()
        total = sum(int(e.get("bytes", 0)) for e in index.values())
        if total <= budget:
            return index
        order = sorted((d for d in index if d != keep),
                       key=lambda d: float(index[d].get("used_at", 0)))
        for d in order:
            if total <= budget:
                break
            total -= int(index[d].get("bytes", 0))
            del index[d]
            try:
                os.unlink(self._entry_path(d))
            except OSError:
                pass
            _tel.inc("program_store_evictions")
        return index

    # -- introspection --------------------------------------------------------
    def entries(self) -> Dict[str, dict]:
        return self._index.read()

    def total_bytes(self) -> int:
        return sum(int(e.get("bytes", 0)) for e in self._index.read().values())


_store = ProgramStore()


def get_store() -> ProgramStore:
    """The process-wide program store (configured by the environment)."""
    return _store
