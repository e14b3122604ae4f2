"""Cross-process failure quarantine and the compile watchdog.

The counterpart of ``dask_sql_tpu/runtime/quarantine.py``.  A program
whose trace or capture fails fatally is exiled in memory
(``physical/compiled.py``: ``_cache[key] = _UNSUPPORTED``), and that
verdict dies with the process: every new process would pay the doomed
build again.

**Quarantine store.**  A JSON file (``DSQL_QUARANTINE_FILE``; unset =
off) of crash and hang verdicts keyed by a digest of the program's base
key (plan fingerprint, input layout, strategy, device) folded with
``device_fingerprint``.  A fatal verdict or a watchdog mark lives for
``DSQL_QUARANTINE_TTL_S`` (default 3600 s); while it lives, every process
sharing the file serves the plan eager without a build.  After expiry the
store is half-open: one caller gets ``"probe"`` (the expiry moves
``DSQL_QUARANTINE_PROBE_S`` out, so the others keep skipping); a
successful build clears the entry, a failed one re-arms it.  A corrupt or
unreadable file reads as empty.

**Compile watchdog.**  ``DSQL_COMPILE_WATCHDOG_S`` arms a monitor thread
over every build-and-first-call section (trace, warm-up, capture).  A
section past the budget counts ``watchdog_trips`` and is marked
``"hang"`` in the store, so a process that never returns still warns the
next one; a section that then finishes lifts its own mark.

Counters: ``quarantine_skips`` / ``quarantine_probes`` /
``quarantine_marks`` / ``watchdog_trips``.
"""
from __future__ import annotations

import hashlib
import logging
import os
import threading
import time
from contextlib import contextmanager
from typing import Dict, Optional

from . import kvstore as _kv
from . import telemetry as _tel

logger = logging.getLogger(__name__)

DEFAULT_TTL_S = 3600.0
DEFAULT_PROBE_S = 60.0

VERDICTS = ("fatal", "hang")


def _env_float(name: str, default: float) -> float:
    try:
        raw = os.environ.get(name, "")
        return float(raw) if raw else default
    except ValueError:
        return default


_device_fp_cache: Optional[str] = None


def device_fingerprint() -> str:
    """The device class this process builds programs for, so that a
    verdict earned on one device never gates another: the card's name,
    compute capability and count with the torch and CUDA versions, or
    ``cpu``."""
    global _device_fp_cache
    if _device_fp_cache is None:
        import torch
        if torch.cuda.is_available():
            major, minor = torch.cuda.get_device_capability(0)
            _device_fp_cache = (
                f"cuda:{torch.cuda.get_device_name(0)}:sm{major}{minor}"
                f":{torch.cuda.device_count()}:torch{torch.__version__}"
                f":cuda{torch.version.cuda}")
        else:
            _device_fp_cache = "cpu"
    return _device_fp_cache


def program_key(base_key) -> str:
    """Content digest of a compiled program's identity: the executor's
    base key (plan fingerprint, input-layout fingerprint, strategy,
    device) folded with the device fingerprint."""
    h = hashlib.blake2b(repr(base_key).encode(), digest_size=16)
    h.update(b"|" + device_fingerprint().encode())
    return h.hexdigest()


class QuarantineStore:
    """JSON-file store of crash/hang verdicts with expiry + half-open
    probes.  Disk plumbing rides runtime/kvstore.py: reads are
    mtime-cached and corrupt-tolerant; writes are read-merge-replace with
    an atomic rename, so concurrent writers can lose a race (one re-mark)
    but never corrupt."""

    def __init__(self, path: Optional[str] = None):
        self._path_override = path
        self._file = _kv.MtimeCachedJsonFile(self.path)

    # -- config (env-read per call so tests/operators flip without restart)
    def path(self) -> Optional[str]:
        return self._path_override or os.environ.get("DSQL_QUARANTINE_FILE")

    def enabled(self) -> bool:
        return bool(self.path())

    def ttl_s(self) -> float:
        return max(_env_float("DSQL_QUARANTINE_TTL_S", DEFAULT_TTL_S), 0.0)

    def probe_ttl_s(self) -> float:
        return max(_env_float("DSQL_QUARANTINE_PROBE_S", DEFAULT_PROBE_S),
                   0.001)

    # -- disk (runtime/kvstore.py: mtime-cached tolerant reads, atomic
    # tmp+rename writes — a broken quarantine file must degrade to 'no
    # quarantine', never fail a query) ------------------------------------
    def _read(self) -> Dict[str, dict]:
        return self._file.read()

    def _write(self, data: Dict[str, dict]) -> None:
        self._file.write(data)

    # -- verdicts -----------------------------------------------------------
    def check(self, key: str) -> Optional[str]:
        """``"quarantined"`` (skip the compile), ``"probe"`` (half-open:
        THIS caller re-attempts while everyone else keeps skipping), or
        None (no verdict on record)."""
        if not self.enabled():
            return None
        data = self._read()
        entry = data.get(key)
        if entry is None:
            return None
        now = time.time()
        if now < float(entry.get("expires_at", 0)):
            return "quarantined"
        # expired: half-open.  Push the expiry out by the probe window and
        # persist BEFORE returning, so concurrent checkers (and other
        # processes) see a live entry and skip while this probe runs.
        entry["expires_at"] = now + self.probe_ttl_s()
        entry["probing"] = True
        data[key] = entry
        self._write(data)
        return "probe"

    def mark(self, key: str, verdict: str, reason: str = "") -> None:
        """Record (or re-arm after a failed probe) a crash/hang verdict."""
        if not self.enabled():
            return
        data = self._read()
        prev = data.get(key) or {}
        now = time.time()
        data[key] = {
            "verdict": verdict,
            "reason": str(reason)[:200],
            "at": now,
            "expires_at": now + self.ttl_s(),
            "strikes": int(prev.get("strikes", 0)) + 1,
        }
        self._write(data)
        _tel.inc("quarantine_marks")
        logger.warning("quarantined program %s (%s): %s",
                       key[:12], verdict, str(reason)[:120])

    def clear(self, key: str) -> None:
        """Lift a verdict (successful probe, or a watched section that
        finished after its watchdog trip)."""
        if not self.enabled():
            return
        data = self._read()
        if key not in data:
            return
        del data[key]
        self._write(data)
        logger.info("quarantine lifted for program %s", key[:12])

    def entries(self) -> Dict[str, dict]:
        return self._read()


_store = QuarantineStore()


def get_store() -> QuarantineStore:
    """The process-global quarantine store (env-configured)."""
    return _store


# ---------------------------------------------------------------------------
# compile watchdog
# ---------------------------------------------------------------------------

class CompileWatchdog:
    """Monitor thread over build/first-call sections.

    A build wedged inside native code (a capture, a kernel, nvcc) never
    reaches a cooperative ``resilience.check``; this thread still observes
    wall time.  It cannot unwedge the worker; it persists the hang verdict
    so that the cost is paid at most once per process lineage."""

    _POLL_S = 0.1

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[int, list] = {}  # token -> [deadline, key, label, fired]
        self._next_token = 0
        self._thread: Optional[threading.Thread] = None

    def budget_s(self) -> float:
        return max(_env_float("DSQL_COMPILE_WATCHDOG_S", 0.0), 0.0)

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._loop, name="dsql-compile-watchdog", daemon=True)
            self._thread.start()

    def _loop(self) -> None:
        while True:
            time.sleep(self._POLL_S)
            now = time.monotonic()
            fired: list = []
            with self._lock:
                for entry in self._entries.values():
                    if not entry[3] and now >= entry[0]:
                        entry[3] = True
                        fired.append(entry)
            for deadline, key, label, _ in fired:
                _tel.inc("watchdog_trips")
                budget = self.budget_s()
                logger.error(
                    "compile watchdog: %s exceeded the %.1f s wall budget "
                    "(still wedged); marking fingerprint suspect", label
                    or key[:12], budget)
                get_store().mark(
                    key, "hang",
                    reason=f"exceeded DSQL_COMPILE_WATCHDOG_S={budget:g}"
                           f" at {label or 'compile'}")

    @contextmanager
    def watch(self, key: str, label: str = ""):
        """Supervise the enclosed compile/first-call section.  No-op when
        ``DSQL_COMPILE_WATCHDOG_S`` is unset/0.  A section that trips the
        watchdog but then finishes CLEANLY lifts its own suspect mark —
        the persisted verdict means 'wedged', not 'slow'."""
        budget = self.budget_s()
        if budget <= 0:
            yield
            return
        entry = [time.monotonic() + budget, key, label, False]
        with self._lock:
            token = self._next_token
            self._next_token += 1
            self._entries[token] = entry
            self._ensure_thread()
        ok = False
        try:
            yield
            ok = True
        finally:
            with self._lock:
                self._entries.pop(token, None)
            if ok and entry[3]:
                logger.warning(
                    "compile watchdog: %s finished after tripping; lifting "
                    "the suspect mark", label or key[:12])
                get_store().clear(key)


_watchdog = CompileWatchdog()


def get_watchdog() -> CompileWatchdog:
    return _watchdog
