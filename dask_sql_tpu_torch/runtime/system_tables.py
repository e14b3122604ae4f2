"""The read-only ``system`` schema: the engine introspected through its own
SQL, as in the JAX package's ``runtime/system_tables.py``.

Eighteen virtual tables (``TABLE_NAMES``), each built fresh at name
resolution (``Context._resolve_system_table``) from live process state,
the flight recorder's ring and the other runtime services; never kept in
the catalog and never cached (``result_cache._canon_rel`` marks
``system`` scans volatile).  Every table has the JAX package's column
names and SQL types, and a fixed schema at zero rows, so an empty engine
binds and runs ``SELECT * FROM system.queries``.

Each subsystem's variable is read before its module is imported, as in
the JAX package: ``system.events`` and ``system.slo`` stay empty without
``DSQL_EVENTS``, ``system.replicas`` without ``DSQL_FLEET_DIR`` (which
also makes ``queries`` and ``events`` read every replica's ring),
``system.autopilot`` without ``DSQL_AUTOPILOT`` and ``system.tenants``
under ``DSQL_TENANCY=0``, and their modules stay unloaded.

Where the JAX package reads JAX's devices, the port reads torch's:

- ``system.devices``: one row per visible card, from the caching
  allocator's statistics (``telemetry.device_memory_rows``: bytes
  allocated now and at the peak, the card's total as the limit), which
  the profiler's samples read too; the table never imports
  ``runtime/profiler.py``.  A host without CUDA reports one ``cpu`` row of
  zeros; a card whose statistics cannot be read raises.
- ``system.mesh``: one row per visible card (and the CPU, where the
  context runs there or no card is visible), with the context's
  ``parallel.mesh.Mesh`` placement by device index: a mesh of one card
  repeated marks that card; ``mesh_axes`` is ``<axis>:<size>``.
- ``system.programs``: the program store's index, one row per stored
  build record (``runtime/program_store.py``), with the JAX package's
  schema.  Unarmed (``DSQL_PROGRAM_STORE`` unset) the table has its fixed
  empty schema and the store is not imported.

Tables are built on the resolving context's device (the CPU without one).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..table import Table
from . import gates

TABLE_NAMES = ("queries", "active", "metrics", "cache", "quarantine",
               "programs", "table_stats", "mesh", "spill", "devices",
               "matviews", "view_candidates", "events", "slo", "prepared",
               "tenants", "replicas", "autopilot")


def _fleet_on() -> bool:
    """``DSQL_FLEET_DIR`` arms ``runtime/fleet.py``; read before its
    import, so an unset variable keeps the module unloaded and the fleet
    tables empty."""
    return bool(os.environ.get("DSQL_FLEET_DIR"))


def _col(rows: List[dict], key: str, dtype, default):
    vals = []
    for r in rows:
        v = r.get(key)
        vals.append(default if v is None else v)
    if dtype is object:
        if not vals:
            # an empty unicode array types as VARCHAR, as a full one does
            return np.array([], dtype="U1")
        return np.array([str(v) for v in vals], dtype=object)
    return np.array(vals, dtype=dtype)


def _queries() -> dict:
    if _fleet_on():
        # every replica's envelope ring, merged in timestamp order, each
        # row stamped with its replica
        from . import fleet as _fleet

        rows = _fleet.merged_query_rows()
    elif gates.history_on():
        from . import flight_recorder as _fr

        rows = _fr.read_events(kind="query")
    else:
        rows = []
    return {
        "replica": _col(rows, "replica", object, ""),
        "unix": _col(rows, "unix", np.float64, 0.0),
        "pid": _col(rows, "pid", np.int64, 0),
        "query": _col(rows, "query", object, ""),
        "outcome": _col(rows, "outcome", object, ""),
        "error": _col(rows, "error", object, ""),
        "wall_ms": _col(rows, "wall_ms", np.float64, 0.0),
        "tier": _col(rows, "tier", object, ""),
        "priority": _col(rows, "priority", object, ""),
        "cache_hit": _col(rows, "cache_hit", np.bool_, False),
        "tenant": _col(rows, "tenant", object, ""),
        "rows_out": _col(rows, "rows_out", np.int64, 0),
        "bytes_out": _col(rows, "bytes_out", np.int64, 0),
        "measured_bytes": _col(rows, "measured_bytes", np.int64, 0),
        "est_bytes": _col(rows, "est_bytes", np.int64, 0),
        "est_source": _col(rows, "est_source", object, ""),
        "queued_ms": _col(rows, "queued_ms", np.float64, 0.0),
        "plan_fp": _col(rows, "plan_fp", object, ""),
        # the adaptive dispatch choices, "; "-joined
        "operators": _col([{"operators": "; ".join(r.get("operators")
                                                   or [])}
                           for r in rows], "operators", object, ""),
        # the device profile's fields (-1: not profiled)
        "skew_ratio": _col(rows, "skew_ratio", np.float64, 0.0),
        "all_to_all_bytes": _col(
            [{"v": (r.get("collective_bytes") or {}).get("all_to_all", 0)}
             for r in rows], "v", np.int64, 0),
        "all_gather_bytes": _col(
            [{"v": (r.get("collective_bytes") or {}).get("all_gather", 0)}
             for r in rows], "v", np.int64, 0),
        "psum_bytes": _col(
            [{"v": (r.get("collective_bytes") or {}).get("psum", 0)}
             for r in rows], "v", np.int64, 0),
        "cost_err": _col(rows, "cost_err", np.float64, -1.0),
    }


def _active() -> dict:
    from ..physical import compiled as _compiled
    from . import scheduler as _sched

    rows: List[dict] = []
    if gates.history_on():
        from . import flight_recorder as _fr

        for a in _fr.active_snapshot():
            rows.append({"state": "running", "query": a["query"],
                         "phase": a["phase"], "tier": a["tier"],
                         "priority": a["priority"],
                         "elapsed_ms": a["elapsedMillis"], "est_bytes": 0,
                         "stages_done": a["stagesDone"],
                         "stages_total": a["stagesTotal"], "pid": a["pid"]})
    for w in _sched.get_manager().waiting_snapshot():
        rows.append({"state": "queued", "query": "", "phase": "queued",
                     "tier": "", "priority": w["priority"],
                     "elapsed_ms": w["waitedMillis"],
                     "est_bytes": w["estBytes"], "stages_done": 0,
                     "stages_total": 0, "pid": os.getpid()})
    for fp in _compiled.inflight_background_compiles():
        rows.append({"state": "bg-compile",
                     "query": f"<background-compile:{fp[:32]}>",
                     "phase": "compile", "tier": "background",
                     "priority": "", "elapsed_ms": 0.0, "est_bytes": 0,
                     "stages_done": 0, "stages_total": 0,
                     "pid": os.getpid()})
    return {
        "state": _col(rows, "state", object, ""),
        "query": _col(rows, "query", object, ""),
        "phase": _col(rows, "phase", object, ""),
        "tier": _col(rows, "tier", object, ""),
        "priority": _col(rows, "priority", object, ""),
        "elapsed_ms": _col(rows, "elapsed_ms", np.float64, 0.0),
        "est_bytes": _col(rows, "est_bytes", np.int64, 0),
        "stages_done": _col(rows, "stages_done", np.int64, 0),
        "stages_total": _col(rows, "stages_total", np.int64, 0),
        "pid": _col(rows, "pid", np.int64, 0),
    }


def _metrics() -> dict:
    from . import telemetry as _tel

    snap = _tel.REGISTRY.snapshot()
    rows = [{"name": k, "kind": "counter", "value": float(v)}
            for k, v in sorted(snap["counters"].items())]
    rows += [{"name": k, "kind": "gauge", "value": float(v)}
             for k, v in sorted(snap["gauges"].items())]
    return {
        "name": _col(rows, "name", object, ""),
        "kind": _col(rows, "kind", object, ""),
        "value": _col(rows, "value", np.float64, 0.0),
    }


def _cache() -> dict:
    from . import result_cache as _rc

    rows = _rc.get_cache().entries_snapshot()
    return {
        "key": _col(rows, "key", object, ""),
        "tier": _col(rows, "tier", object, ""),
        "nbytes": _col(rows, "nbytes", np.int64, 0),
        "hits": _col(rows, "hits", np.int64, 0),
        "tables": _col(rows, "tables", object, ""),
    }


def _quarantine() -> dict:
    from . import quarantine as _quar

    rows = [{"key": k, **(e if isinstance(e, dict) else {})}
            for k, e in sorted(_quar.get_store().entries().items())]
    return {
        "key": _col(rows, "key", object, ""),
        "verdict": _col(rows, "verdict", object, ""),
        "reason": _col(rows, "reason", object, ""),
        "strikes": _col(rows, "strikes", np.int64, 0),
        "at": _col(rows, "at", np.float64, 0.0),
        "expires_at": _col(rows, "expires_at", np.float64, 0.0),
    }


def _programs() -> dict:
    """The program store's index (empty, and the store not imported, while
    it is unarmed)."""
    rows: List[dict] = []
    if gates.armed("DSQL_PROGRAM_STORE"):
        from . import program_store as _pstore
        rows = [{"digest": d, **(e if isinstance(e, dict) else {})}
                for d, e in sorted(_pstore.get_store().entries().items())]
    return {
        "digest": _col(rows, "digest", object, ""),
        "nbytes": _col(rows, "bytes", np.int64, 0),
        "used_at": _col(rows, "used_at", np.float64, 0.0),
        "stored_at": _col(rows, "stored_at", np.float64, 0.0),
        "cost_flops": _col(rows, "cost_flops", np.float64, 0.0),
        "cost_bytes": _col(rows, "cost_bytes", np.float64, 0.0),
    }


def _table_stats(context=None) -> dict:
    """The ingest-time statistics (``runtime/statistics.py``) of every
    registered table: one row per column."""
    from . import statistics as _stats

    rows = _stats.system_rows(context) if context is not None else []
    return {
        "schema": _col(rows, "schema", object, ""),
        "table": _col(rows, "table", object, ""),
        "column": _col(rows, "column", object, ""),
        "rows": _col(rows, "rows", np.int64, 0),
        "ndv": _col(rows, "ndv", np.int64, -1),
        "min": _col(rows, "min", np.float64, float("nan")),
        "max": _col(rows, "max", np.float64, float("nan")),
        "null_frac": _col(rows, "null_frac", np.float64, 0.0),
        "is_int": _col(rows, "is_int", np.bool_, False),
        "dense": _col(rows, "dense", np.bool_, False),
        "domain": _col(rows, "domain", np.int64, -1),
        "collected_ms": _col(rows, "collected_ms", np.float64, 0.0),
    }


def _visible_devices(context=None) -> List[torch.device]:
    """Every visible card, and the CPU where no card is visible or the
    context runs there."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    devices = [torch.device("cuda", i) for i in range(n)]
    dev = getattr(context, "device", None)
    if not devices or (dev is not None and torch.device(dev).type == "cpu"):
        devices.append(torch.device("cpu"))
    return devices


def _mesh(context=None) -> dict:
    """One row per visible device, with the context's mesh placement and
    whether the SPMD stage executor would serve its queries
    (``parallel.spmd.spmd_enabled``)."""
    mesh = getattr(context, "mesh", None) if context is not None else None
    axis, mesh_size, enabled = "", 0, False
    placed: set = set()
    process = 0
    if mesh is not None:
        axis = "x".join(f"{n}:{mesh.size}" for n in mesh.axis_names)
        mesh_size = int(mesh.size)
        placed = {(d.type, d.index or 0) for d in mesh.devices}
        process = int(mesh.rank)
        from ..parallel.spmd import spmd_enabled
        enabled = spmd_enabled(context)
    rows = []
    for d in _visible_devices(context):
        rows.append({
            "device_id": int(d.index or 0),
            "platform": "gpu" if d.type == "cuda" else d.type,
            "kind": (torch.cuda.get_device_name(d.index)
                     if d.type == "cuda" else d.type),
            "process": process,
            "in_mesh": (d.type, d.index or 0) in placed,
            "mesh_axes": axis,
            "mesh_size": mesh_size,
            "spmd_enabled": enabled,
        })
    return {
        "device_id": _col(rows, "device_id", np.int64, 0),
        "platform": _col(rows, "platform", object, ""),
        "kind": _col(rows, "kind", object, ""),
        "process": _col(rows, "process", np.int64, 0),
        "in_mesh": _col(rows, "in_mesh", np.bool_, False),
        "mesh_axes": _col(rows, "mesh_axes", object, ""),
        "mesh_size": _col(rows, "mesh_size", np.int64, 0),
        "spmd_enabled": _col(rows, "spmd_enabled", np.bool_, False),
    }


def _devices() -> dict:
    """One row per visible card from the caching allocator's statistics
    (``telemetry.device_memory_rows``, which the profiler's samples read
    too): this table never imports ``runtime/profiler.py``.  Without a
    card, one ``cpu`` row of zeros."""
    from . import telemetry as _tel

    rows = [dict(r, device_id=r["id"])
            for r in _tel.device_memory_rows(_visible_devices())]
    return {
        "device_id": _col(rows, "device_id", np.int64, 0),
        "platform": _col(rows, "platform", object, ""),
        "kind": _col(rows, "kind", object, ""),
        "bytes_in_use": _col(rows, "bytes_in_use", np.int64, 0),
        "peak_bytes_in_use": _col(rows, "peak_bytes_in_use", np.int64, 0),
        "bytes_limit": _col(rows, "bytes_limit", np.int64, 0),
    }


def _spill() -> dict:
    """One row per live spill run (a grace-hash partition, an
    out-of-core join's output) with its tier placement."""
    from . import spill as _spill_mod

    rows = _spill_mod.get_store().runs_snapshot()
    return {
        "run": _col(rows, "run", object, ""),
        "chunks": _col(rows, "chunks", np.int64, 0),
        "rows": _col(rows, "rows", np.int64, 0),
        "nbytes": _col(rows, "nbytes", np.int64, 0),
        "device_chunks": _col(rows, "device_chunks", np.int64, 0),
        "host_chunks": _col(rows, "host_chunks", np.int64, 0),
        "disk_chunks": _col(rows, "disk_chunks", np.int64, 0),
    }


def _prepared(context=None) -> dict:
    """One row per PREPAREd statement of the resolving context."""
    reg = getattr(context, "_prepared", None) or {}
    rows = [{"name": name, "num_params": int(stmt.num_params),
             "statement": stmt.sql}
            for name, stmt in sorted(reg.items())]
    return {
        "name": _col(rows, "name", object, ""),
        "num_params": _col(rows, "num_params", np.int64, 0),
        "statement": _col(rows, "statement", object, ""),
    }


def _matviews(context=None) -> dict:
    """One row per materialized view (``runtime/matview.py``)."""
    from . import matview as _mv

    rows = _mv.matview_rows(context) if context is not None else []
    return {
        "schema": _col(rows, "schema", object, ""),
        "name": _col(rows, "name", object, ""),
        "rows": _col(rows, "rows", np.int64, 0),
        "maintainable": _col(rows, "maintainable", object, ""),
        "reason": _col(rows, "reason", object, ""),
        "base_tables": _col(rows, "base_tables", object, ""),
        "pending_deltas": _col(rows, "pending_deltas", np.int64, 0),
        "pending_rows": _col(rows, "pending_rows", np.int64, 0),
        "staleness_s": _col(rows, "staleness_s", np.float64, 0.0),
        "serves": _col(rows, "serves", np.int64, 0),
        "refresh_incremental": _col(rows, "refresh_incremental",
                                    np.int64, 0),
        "refresh_full": _col(rows, "refresh_full", np.int64, 0),
        "last_refresh": _col(rows, "last_refresh", object, ""),
        "fingerprint": _col(rows, "fingerprint", object, ""),
    }


def _view_candidates(context=None) -> dict:
    """The flight recorder's hot repeated plan fingerprints, ranked by
    hits x recompute cost (empty without ``DSQL_HISTORY_FILE``)."""
    from . import matview as _mv

    rows = _mv.view_candidate_rows(context) if context is not None else []
    return {
        "fingerprint": _col(rows, "fingerprint", object, ""),
        "hits": _col(rows, "hits", np.int64, 0),
        "ewma_ms": _col(rows, "ewma_ms", np.float64, 0.0),
        "score": _col(rows, "score", np.float64, 0.0),
        "materialized": _col(rows, "materialized", np.bool_, False),
        "example_sql": _col(rows, "example_sql", object, ""),
    }


def _events() -> dict:
    """The event bus's ring (``runtime/events.py``); every replica's,
    merged, under ``DSQL_FLEET_DIR``."""
    rows: List[dict] = []
    if _fleet_on():
        from . import fleet as _fleet

        rows = _fleet.merged_events_rows()
    elif gates.events_on():
        from . import events as _ev

        rows = _ev.events_rows()
    return {
        "seq": _col(rows, "seq", np.int64, 0),
        "unix": _col(rows, "unix", np.float64, 0.0),
        "pid": _col(rows, "pid", np.int64, 0),
        "trace": _col(rows, "trace", object, ""),
        "type": _col(rows, "type", object, ""),
        "replica": _col(rows, "replica", object, ""),
        "detail": _col(rows, "detail", object, ""),
    }


def _slo() -> dict:
    """Per-class latency objectives and burn rates (the event bus's SLO
    monitor)."""
    rows: List[dict] = []
    if gates.events_on():
        from . import events as _ev

        rows = _ev.slo_rows()
    return {
        "class": _col(rows, "class", object, ""),
        "objective_ms": _col(rows, "objective_ms", np.float64, 0.0),
        "target": _col(rows, "target", np.float64, 0.0),
        "window_fast_s": _col(rows, "window_fast_s", np.float64, 0.0),
        "window_slow_s": _col(rows, "window_slow_s", np.float64, 0.0),
        "total": _col(rows, "total", np.int64, 0),
        "breaches": _col(rows, "breaches", np.int64, 0),
        "attainment": _col(rows, "attainment", np.float64, 1.0),
        "burn_fast": _col(rows, "burn_fast", np.float64, 0.0),
        "burn_slow": _col(rows, "burn_slow", np.float64, 0.0),
        "breach": _col(rows, "breach", np.bool_, False),
    }


def _tenants() -> dict:
    """Per-tenant admission accounting and circuit state."""
    rows: List[dict] = []
    if gates.tenancy_on():
        from . import tenancy as _ten

        rows = _ten.tenant_rows()
    return {
        "tenant": _col(rows, "tenant", object, ""),
        "inflight": _col(rows, "inflight", np.int64, 0),
        "tokens": _col(rows, "tokens", np.float64, 0.0),
        "submitted": _col(rows, "submitted", np.int64, 0),
        "admitted": _col(rows, "admitted", np.int64, 0),
        "completed": _col(rows, "completed", np.int64, 0),
        "failed": _col(rows, "failed", np.int64, 0),
        "quota_rejects": _col(rows, "quota_rejects", np.int64, 0),
        "circuit_rejects": _col(rows, "circuit_rejects", np.int64, 0),
        "circuit_opens": _col(rows, "circuit_opens", np.int64, 0),
        "consecutive_failures": _col(rows, "consecutive_failures",
                                     np.int64, 0),
        "circuit": _col(rows, "circuit", object, ""),
    }


def _replicas() -> dict:
    """One row per fleet replica's heartbeat (``runtime/fleet.py``)."""
    rows: List[dict] = []
    if _fleet_on():
        from . import fleet as _fleet

        rows = _fleet.replica_rows()
    return {
        "replica": _col(rows, "replica", object, ""),
        "pid": _col(rows, "pid", np.int64, 0),
        "host": _col(rows, "host", object, ""),
        "alive": _col(rows, "alive", np.bool_, False),
        "started": _col(rows, "started", np.float64, 0.0),
        "beat": _col(rows, "beat", np.float64, 0.0),
        "age_s": _col(rows, "age_s", np.float64, 0.0),
        "running": _col(rows, "running", np.int64, 0),
        "queue_depth": _col(rows, "queue_depth", np.int64, 0),
        "slots": _col(rows, "slots", np.int64, 0),
        "queries": _col(rows, "queries", np.int64, 0),
        "cache_bytes": _col(rows, "cache_bytes", np.int64, 0),
        "spill_bytes": _col(rows, "spill_bytes", np.int64, 0),
        "reserved_bytes": _col(rows, "reserved_bytes", np.int64, 0),
        "program_entries": _col(rows, "program_entries", np.int64, 0),
        "program_hits": _col(rows, "program_hits", np.int64, 0),
        "program_misses": _col(rows, "program_misses", np.int64, 0),
        "program_hit_rate": _col(rows, "program_hit_rate", np.float64, 0.0),
        "compiles": _col(rows, "compiles", np.int64, 0),
    }


def _autopilot() -> dict:
    """The autopilot's action journal (``runtime/autopilot.py``), newest
    last."""
    rows: List[dict] = []
    if gates.armed("DSQL_AUTOPILOT"):
        from . import autopilot as _ap

        rows = _ap.journal_rows()
    return {
        "unix": _col(rows, "unix", np.float64, 0.0),
        "action": _col(rows, "action", object, ""),
        "trigger": _col(rows, "trigger", object, ""),
        "fingerprint": _col(rows, "fingerprint", object, ""),
        "verdict": _col(rows, "verdict", object, ""),
        "bytes": _col(rows, "bytes", np.int64, 0),
        "detail": _col(rows, "detail", object, ""),
    }


_BUILDERS: Dict[str, object] = {
    "queries": _queries,
    "active": _active,
    "metrics": _metrics,
    "cache": _cache,
    "quarantine": _quarantine,
    "programs": _programs,
    "table_stats": _table_stats,
    "mesh": _mesh,
    "spill": _spill,
    "devices": _devices,
    "matviews": _matviews,
    "view_candidates": _view_candidates,
    "events": _events,
    "slo": _slo,
    "prepared": _prepared,
    "tenants": _tenants,
    "replicas": _replicas,
    "autopilot": _autopilot,
}

#: builders that read the resolving context (its catalog, mesh, views)
_CONTEXT_BUILDERS = (_table_stats, _mesh, _matviews, _view_candidates,
                     _prepared)


def build(name: str, context=None) -> Optional[Table]:
    """A fresh snapshot Table for ``system.<name>`` on the context's
    device, or None for an unknown name (the binder then reports the
    table as undefined)."""
    builder = _BUILDERS.get(name.lower())
    if builder is None:
        return None
    if builder in _CONTEXT_BUILDERS:
        data = builder(context)  # type: ignore[operator]
    else:
        data = builder()  # type: ignore[operator]
    device = getattr(context, "device", None) or torch.device("cpu")
    return Table.from_pydict(data, device)
