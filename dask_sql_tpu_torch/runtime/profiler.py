"""The device profiler: memory sampling, program cost counts, the ledger.

The counterpart of ``dask_sql_tpu/runtime/profiler.py``, armed by
``DSQL_PROFILE=1``: every caller checks the variable before it imports
this module, so an unprofiled query never loads it.  Three concerns:

1. **Device memory.**  :func:`device_memory_rows` reads the caching
   allocator's host-side statistics (``torch.cuda.memory_stats``:
   ``allocated_bytes.all.current`` / ``.peak``) and the card's total
   memory (read once per card) for a Context's devices (EXPLAIN PROFILE)
   or all the process uses (``telemetry.note_devices``: each Context's
   device and its mesh's; the sampler), never for another card, and never through a call that synchronises
   the device: tiering's background builds capture CUDA graphs on other
   threads.  A CPU device reports zeros, as a JAX CPU device does.  The
   rows fold into the ``profile_hbm_*`` gauges and a bounded ring of
   snapshots; a daemon sampler ticks every ``DSQL_PROFILE_SAMPLE_MS``
   (500), and every query completion samples once.

2. **Program cost.**  XLA's ``cost_analysis()`` has no counterpart for a
   CUDA graph, so the compiled tier counts a program's work itself during
   its warm-up (``physical/graphs.py``, ``_CostCount``): the bytes each op
   reads and writes, an op's output elements as its flops (``2mnk`` for a
   product) and the output elements of exp/log/pow/trigonometric ops as
   transcendentals.  A hand kernel reports its function's work as one
   record (``gpu_kernels.kernel_work``), on the card and on the CPU alike.
   The count is per op, not after fusion as XLA's, so its values differ
   from the JAX package's; :func:`cost_summary` normalises it.

3. **The model-vs-measured ledger.**  Predicted bytes/flops per (query
   fingerprint, program digest); measured bytes/ms from stage records.
   The workload manager's estimate ladder reads :func:`plan_cost_bytes`
   as its ``cost_model`` rung, and with ``DSQL_HISTORY_FILE`` armed the
   prediction also folds into the flight recorder's statistics
   (``cost_bytes`` / ``cost_flops``), so it survives the process.
"""
from __future__ import annotations

import logging
import math
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from . import telemetry as _tel

logger = logging.getLogger(__name__)

#: bounded snapshot ring: at the default 500 ms cadence this holds the
#: last minute of device-memory readings
RING_LEN = 120


def enabled() -> bool:
    """True when profiling is armed (``DSQL_PROFILE`` set and not 0)."""
    return os.environ.get("DSQL_PROFILE", "0").strip() not in ("", "0")


def sample_interval_ms() -> float:
    try:
        ms = float(os.environ.get("DSQL_PROFILE_SAMPLE_MS", "500") or 500)
    except ValueError:
        ms = 500.0
    return max(ms, 10.0)


_lock = threading.Lock()
_ring: deque = deque(maxlen=RING_LEN)
_sampler_started = False

# model-vs-measured ledger: query fingerprint -> program digest ->
# predicted {"flops","bytes","transcendentals"}; and per-digest measured
# fold-ins.  Keyed per digest so repeat executions overwrite instead of
# double-counting.
_ledger: Dict[str, Dict[str, Dict[str, float]]] = {}
_measured: Dict[str, Dict[str, float]] = {}
# card index -> total memory, read once (``get_device_properties``;
# the cache is telemetry's, which ``system.devices`` reads through too)
_limits: Dict[int, int] = _tel.CARD_LIMITS


def _fp_key(query_fp: Optional[str]) -> Optional[str]:
    """The ledger key of compiled.py's ``query_fp`` (the root plan's
    canonical program text).  Writers (record_program_cost) and the reader
    (plan_cost_bytes, which recomputes the text via ``_fp_plan``) both go
    through here."""
    if not query_fp:
        return None
    from .kvstore import digest_key
    return digest_key(("cost", str(query_fp)))


# ---------------------------------------------------------------------------
# device memory sampling
# ---------------------------------------------------------------------------

def device_memory_rows(devices=None) -> List[Dict[str, Any]]:
    """One row per device of ``devices`` (EXPLAIN PROFILE: its Context's
    device and mesh), by default per device this process uses
    (``telemetry.used_devices``; the CPU when no Context noted one), each
    once, as ``telemetry.device_memory_rows`` reads them: a card's from
    the allocator's host-side statistics, which take no synchronisation,
    a CPU device's zeros.  A card whose statistics cannot be read raises:
    a profile never shows a made-up zero for a card."""
    import torch

    if devices is None:
        devices = _tel.used_devices() or [torch.device("cpu")]
    return _tel.device_memory_rows(devices)


def sample() -> List[Dict[str, Any]]:
    """One snapshot: per-device rows into the ring + summed gauges."""
    rows = device_memory_rows()
    _tel.REGISTRY.set_gauge("profile_hbm_bytes_in_use",
                            sum(r["bytes_in_use"] for r in rows))
    _tel.REGISTRY.set_gauge("profile_hbm_peak_bytes",
                            sum(r["peak_bytes_in_use"] for r in rows))
    _tel.REGISTRY.set_gauge("profile_hbm_bytes_limit",
                            sum(r["bytes_limit"] for r in rows))
    _tel.inc("profile_samples")
    with _lock:
        _ring.append({"unix": time.time(), "devices": rows})
    return rows


def snapshots() -> List[Dict[str, Any]]:
    with _lock:
        return list(_ring)


def ensure_sampler() -> None:
    """Start the daemon sampling thread once (no-op when disabled)."""
    global _sampler_started
    if not enabled():
        return
    with _lock:
        if _sampler_started:
            return
        _sampler_started = True
    threading.Thread(target=_sample_loop, name="dsql-profiler",
                     daemon=True).start()


def _sample_loop() -> None:
    global _sampler_started
    try:
        while enabled():
            try:
                sample()
            except Exception:  # sampling must never hurt the engine
                logger.debug("profiler sample failed", exc_info=True)
            time.sleep(sample_interval_ms() / 1e3)
    finally:
        # disarmed: a later armed query starts a new sampler
        with _lock:
            _sampler_started = False


# ---------------------------------------------------------------------------
# program cost
# ---------------------------------------------------------------------------

def cost_summary(program) -> Optional[Dict[str, float]]:
    """A program's counted cost (``program.cost``: ``flops`` / ``bytes`` /
    ``transcendentals``) as a small plain dict, or None when it has none
    (not counted, non-finite or all zero): the ``n/a`` of every consumer."""
    cost = getattr(program, "cost", None)
    if not isinstance(cost, dict):
        return None

    def num(key: str) -> float:
        try:
            v = float(cost.get(key, 0.0) or 0.0)
        except (TypeError, ValueError):
            return 0.0
        return v if math.isfinite(v) and v > 0 else 0.0

    out = {"flops": num("flops"), "bytes": num("bytes"),
           "transcendentals": num("transcendentals")}
    if not (out["flops"] or out["bytes"]):
        return None
    return out


# ---------------------------------------------------------------------------
# the model-vs-measured ledger
# ---------------------------------------------------------------------------

def record_program_cost(query_fp: Optional[str], digest: str,
                        cost: Optional[Dict[str, float]]) -> None:
    """Register one program's predicted cost under a query fingerprint
    (at build time).  None cost = no-op."""
    key = _fp_key(query_fp)
    if key is None or not cost:
        return
    with _lock:
        _ledger.setdefault(key, {})[str(digest)] = dict(cost)
    _tel.inc("profile_cost_captures")
    if os.environ.get("DSQL_HISTORY_FILE"):
        # fold into the flight-recorder EWMA so the cost estimate
        # survives the process (the scheduler rung's warm-read path)
        try:
            from . import flight_recorder as _fr
            _fr._observe_stat(key,
                              cost_bytes=float(cost.get("bytes", 0.0)),
                              cost_flops=float(cost.get("flops", 0.0)))
        except Exception:
            logger.debug("cost EWMA fold failed", exc_info=True)


def record_measured(digest: str, nbytes: Optional[int] = None,
                    wall_ms: Optional[float] = None,
                    device_ms: Optional[float] = None) -> None:
    """Fold one stage's measured truth into the ledger's measured side."""
    with _lock:
        ent = _measured.setdefault(str(digest), {})
        if nbytes is not None:
            ent["bytes"] = float(nbytes)
        if wall_ms is not None:
            ent["ms"] = float(wall_ms)
        if device_ms is not None:
            ent["device_ms"] = float(device_ms)


def program_costs(query_fp: Optional[str]) -> Dict[str, Dict[str, float]]:
    """Predicted costs per program digest for one query fingerprint
    (each dict also carries the measured fold-ins when present)."""
    key = _fp_key(query_fp)
    if key is None:
        return {}
    with _lock:
        out = {}
        for digest, cost in _ledger.get(key, {}).items():
            row = dict(cost)
            row.update({f"measured_{k}": v
                        for k, v in _measured.get(digest, {}).items()})
            out[digest] = row
        return out


def plan_cost_bytes(plan, context) -> Optional[int]:
    """The scheduler's ``cost_model`` rung: predicted working-set bytes =
    the counted bytes summed over the plan's programs.  The key is
    recomputed from the plan the way the compiled tier fingerprints its
    root (``_fp_plan``; a plan outside the subset never produced an entry,
    so its Unsupported is just None).  Falls back to the flight recorder's
    persisted cost EWMA when this process has not built the plan.  None:
    nothing counted, the caller keeps the shape heuristic."""
    try:
        from ..physical.compiled import _fp_plan
        key = _fp_key(_fp_plan(plan, context, []))
    except Exception:
        return None
    if key is None:
        return None
    with _lock:
        costs = _ledger.get(key)
        total = (sum(c.get("bytes", 0.0) for c in costs.values())
                 if costs else 0.0)
    if total <= 0 and os.environ.get("DSQL_HISTORY_FILE"):
        try:
            from . import flight_recorder as _fr
            total = float((_fr.get_stats(key) or {}).get("cost_bytes", 0.0)
                          or 0.0)
        except Exception:
            total = 0.0
    return int(total) if total > 0 else None


def cost_error(predicted_bytes: Optional[float],
               measured_bytes: Optional[float]) -> Optional[float]:
    """Relative model error |predicted - measured| / measured."""
    if not predicted_bytes or not measured_bytes or measured_bytes <= 0:
        return None
    return abs(float(predicted_bytes) - float(measured_bytes)) \
        / float(measured_bytes)


def on_query_complete(report) -> None:
    """Per-query hook from telemetry._close_trace (profile-gated there):
    keep the sampler alive and take one completion-time snapshot."""
    ensure_sampler()
    sample()


def engine_section() -> Dict[str, Any]:
    """The ``profile`` section of ``GET /v1/engine``."""
    with _lock:
        plans = len(_ledger)
        programs = sum(len(v) for v in _ledger.values())
        last = _ring[-1] if _ring else None
    return {
        "enabled": True,
        "sampleMs": sample_interval_ms(),
        "samples": int(_tel.REGISTRY.get("profile_samples")),
        "costCaptures": int(_tel.REGISTRY.get("profile_cost_captures")),
        "costPlans": plans,
        "costPrograms": programs,
        "lastSnapshot": last,
    }


def reset() -> None:
    """Test hook: drop ledger + ring (the sampler flag survives)."""
    with _lock:
        _ledger.clear()
        _measured.clear()
        _ring.clear()
