"""Incremental materialized views: maintenance from each append's delta.

The counterpart of ``dask_sql_tpu/runtime/matview.py``.  ``CREATE
MATERIALIZED VIEW v AS <query>`` materializes the query once and registers
the result as an ordinary catalog entry.  Every resolution of ``v``
(``Context.resolve_table``) compares the base tables' catalog epochs with
the view's watermarks, and a view whose bases advanced refreshes before it
is served: a stale result is never visible.

Appends (``Context.append_rows``, INSERT INTO, ``POST /v1/ingest``) bump
the base epoch with a delta record (the appended batch) instead of the
bare tombstone every other mutation leaves, and a maintainable view
refreshes from its cached state and the deltas:

    shape                   plan
    ------------------      ------------------------------------------
    agg                     [Sort] [Project|Filter]* Aggregate
                            (Project|Filter)* Scan, every call SUM /
                            $SUM0 / COUNT / MIN / MAX / AVG without
                            DISTINCT; the delta's partial aggregate
                            merges into the cached partial state
    append                  (Project|Filter)+ Scan without ORDER BY or
                            LIMIT; the delta's rows are appended
    join, cdistinct         INNER join trees and the single COUNT
                            (DISTINCT col) (``runtime/delta.py``)
    full recompute          everything else, with the reason kept
                            (``matview_rows``) and logged

Overwrites (CREATE OR REPLACE, DROP, ALTER) tombstone: the table's delta
log clears and the next serve recomputes in full.

The partial state lives in the result cache under a ``("__mv__",
<view>)`` table key: it shares the memory ledger with other entries, and
an evicted state downgrades the next refresh to a full recompute.

Refresh plans over delta-sized inputs run on the eager executor
(``_execute_plan(eager=True)``): their temps under ``__matview__`` are new
tensors every round, so the compiled tier would warm up and capture a
CUDA graph again on each refresh.  On a Q1-shaped view each of those
aggregates is a static-domain GROUP BY, which launches kernel 1 on the
card.  A full refresh goes through the compiled tier.

``DSQL_MV=0`` turns the subsystem off: the statements raise a typed
``UserError``, appends record tombstones, and resolution never consults
the registry.  ``DSQL_MV_MAX_DELTAS`` (default 64) bounds a table's
unconsumed delta records before they are compacted, then tombstoned.
With ``DSQL_EVENTS`` armed each refresh publishes ``mv.refresh`` (its
mode, and a full refresh's reason) on the event bus, and with
``DSQL_HISTORY_FILE`` armed ``view_candidate_rows`` ranks the recorder's
hot plan shapes.
"""
from __future__ import annotations

import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..datacontainer import TableEntry
from ..plan.nodes import (
    Field, LogicalAggregate, LogicalFilter, LogicalProject, LogicalSort,
    LogicalTableScan, RelNode, RexCall, RexInputRef, RexScalarSubquery,
)
from ..table import Table
from ..types import BIGINT, DOUBLE
from .gates import events_on as _events_on, history_on as _history_on
from .kvstore import digest_key
from . import faults as _faults, resilience as _res, telemetry as _tel

logger = logging.getLogger(__name__)

MV_SCHEMA = "__matview__"

# ledger tenancy: maintained state keys under this pseudo-table so base
# bumps never invalidate it and DROP MATERIALIZED VIEW can drop it exactly
STATE_SCHEMA = "__mv__"

# delta-log bound: a table accumulating more un-applied appends than this
# converts to a tombstone (next refresh recomputes) instead of pinning
# unbounded delta batches on device
MAX_DELTAS = int(os.environ.get("DSQL_MV_MAX_DELTAS", "64"))


def mv_enabled() -> bool:
    return os.environ.get("DSQL_MV", "1").strip() not in ("0", "false")


class MatViewError(_res.UserError):
    """Materialized-view statement the subsystem rejects (disabled via
    DSQL_MV=0, volatile defining query, unknown view...).  A typed
    UserError: the message always names the remedy."""


def _require_enabled() -> None:
    if not mv_enabled():
        raise MatViewError(
            "materialized views are disabled (DSQL_MV=0); unset DSQL_MV "
            "to enable the subsystem")


# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------

@dataclass
class DeltaRecord:
    epoch: int          # the epoch this append advanced the table TO
    rows: int
    table: Table        # the appended batch, base-table column order
    ts: float = 0.0     # wall-clock record time (staleness accounting)


@dataclass
class _Shape:
    """Maintenance shape of a maintainable plan (see module docstring)."""
    kind: str                          # "agg" | "append" | "join" | "cdistinct"
    scan: LogicalTableScan = None
    below: RelNode = None              # agg: pipeline under the aggregate
    agg: Optional[LogicalAggregate] = None
    above: List[RelNode] = field(default_factory=list)  # root-first
    partial_aggs: list = field(default_factory=list)
    partial_schema: list = field(default_factory=list)
    merge_aggs: list = field(default_factory=list)
    merge_schema: list = field(default_factory=list)
    post_exprs: list = field(default_factory=list)
    needs_project: bool = False
    scans: list = field(default_factory=list)  # join: left-to-right leaves
    cd_arg: int = -1                   # cdistinct: DISTINCT arg in `below`


@dataclass
class MatView:
    name: str                          # lowercased
    schema_name: str
    sql: str                           # the CREATE statement text
    plan: RelNode                      # optimized defining plan
    fingerprint: str                   # canonical-plan digest
    base_tables: Tuple[Tuple[str, str], ...]
    base_epochs: Dict[Tuple[str, str], int] = field(default_factory=dict)
    maintainable: bool = False
    reason: str = ""                   # why not maintainable ("" when it is)
    shape: Optional[_Shape] = None
    serves: int = 0
    refresh_incremental: int = 0
    refresh_full: int = 0
    last_refresh_reason: str = "initial materialization"


# ---------------------------------------------------------------------------
# maintainability analysis
# ---------------------------------------------------------------------------

def _rex_has_subquery(rex) -> bool:
    if isinstance(rex, RexScalarSubquery):
        return True
    return any(_rex_has_subquery(o)
               for o in getattr(rex, "operands", []) or [])


def _analyze(plan: RelNode, context) -> Tuple[Optional[_Shape], str]:
    """(shape, reason): shape None means every refresh recomputes in full,
    and ``reason`` says why (``matview_rows``)."""
    from ..physical.streaming import StreamingUnsupported, \
        _partial_and_merge_aggs

    from ..plan.nodes import LogicalJoin

    chain: List[RelNode] = []
    cur = plan
    while not isinstance(cur, LogicalTableScan):
        if isinstance(cur, (LogicalProject, LogicalFilter, LogicalSort,
                            LogicalAggregate)):
            chain.append(cur)
            cur = cur.inputs[0]
            continue
        if isinstance(cur, LogicalJoin):
            from . import delta as _delta
            return _delta.analyze_join(plan, chain, cur, context)
        return None, (f"{cur.node_name()} requires full recompute (only "
                      "selection/projection pipelines, INNER join trees, "
                      "and single-level mergeable group-bys maintain "
                      "incrementally)")
    scan = cur
    schema = context.schema.get(scan.schema_name)
    entry = schema.tables.get(scan.table_name) if schema is not None else None
    if entry is None:
        return None, f"base table {scan.table_name} not resolvable"
    if entry.chunked is not None:
        return None, ("chunked base table streams from host; appends are "
                      "not delta-tracked")
    for node in chain:
        exprs = (node.exprs if isinstance(node, LogicalProject)
                 else [node.condition] if isinstance(node, LogicalFilter)
                 else [])
        if any(_rex_has_subquery(e) for e in exprs if e is not None):
            return None, "scalar subquery requires full recompute"

    aggs = [n for n in chain if isinstance(n, LogicalAggregate)]
    if len(aggs) > 1:
        return None, "nested aggregates do not merge incrementally"
    if not aggs:
        if any(isinstance(n, LogicalSort) for n in chain):
            return None, ("ORDER BY/LIMIT over a selection pipeline "
                          "requires full recompute (appended rows "
                          "interleave with the existing order)")
        return _Shape(kind="append", scan=scan, below=plan), ""

    agg = aggs[0]
    ai = chain.index(agg)
    above, below_chain = chain[:ai], chain[ai + 1:]
    if any(isinstance(n, (LogicalSort, LogicalAggregate))
           for n in below_chain):
        return None, "ORDER BY/LIMIT below the aggregate requires full " \
                     "recompute"
    if any(c.distinct for c in agg.aggs):
        # the streaming algebra refuses DISTINCT outright; the refcounted
        # state in runtime/delta.py maintains the COUNT(DISTINCT col) form
        from . import delta as _delta
        return _delta.analyze_distinct_agg(plan, scan, agg, above,
                                           below_chain)
    try:
        (partial_aggs, partial_fields, merge_aggs, post_exprs,
         needs_project) = _partial_and_merge_aggs(agg)
    except StreamingUnsupported as e:
        return None, str(e)
    gk = len(agg.group_keys)
    group_fields = list(agg.schema[:gk])
    return _Shape(
        kind="agg", scan=scan, below=agg.inputs[0], agg=agg, above=above,
        partial_aggs=partial_aggs,
        partial_schema=group_fields + partial_fields,
        merge_aggs=merge_aggs,
        merge_schema=group_fields + [Field(a.name, a.stype)
                                     for a in merge_aggs],
        post_exprs=post_exprs, needs_project=needs_project), ""


# ---------------------------------------------------------------------------
# plan execution plumbing (no admission, no result-cache lookup: refreshes
# run nested inside the outer query's binding)
# ---------------------------------------------------------------------------

_tmp_counter = [0]


def _register_temp(context, table: Table, fields) -> LogicalTableScan:
    """Register a temp under __matview__ (own schema: refreshes must not
    race the streaming executor's __stream__ lifecycle) and return its
    scan re-typed to ``fields``' stypes."""
    if MV_SCHEMA not in context.schema:
        context.create_schema(MV_SCHEMA)
    _tmp_counter[0] += 1
    name = f"t{_tmp_counter[0]}"
    names = [f"c{i}" for i in range(table.num_columns)]
    table = table.with_names(names)
    context.schema[MV_SCHEMA].tables[name] = TableEntry(table=table)
    return LogicalTableScan(
        schema_name=MV_SCHEMA, table_name=name,
        schema=[Field(n, f.stype) for n, f in zip(names, fields)])


def _cleanup_temps(context) -> None:
    context.schema.pop(MV_SCHEMA, None)


def _execute_plan(context, plan: RelNode, eager: bool = False) -> Table:
    """Compiled-else-eager execution; chunked bases stream as usual.

    ``eager=True`` skips the compiled tier: refresh temps are new tensors
    every round, so a compiled run would warm up and capture a CUDA graph
    again per refresh, which costs far more than the delta-sized work.
    The eager executor is the right tier for delta- and group-count-sized
    inputs.  On a mesh across processes the plan's rank-local tables are
    read whole (``Context._whole_tables``)."""
    with context._whole_tables(plan):
        if getattr(context, "_has_chunked", False):
            from ..physical.streaming import (execute_streaming,
                                              plan_references_chunked)
            if plan_references_chunked(plan, context):
                return execute_streaming(plan, context)
        if eager:
            from ..physical.rel.executor import RelExecutor
            return RelExecutor(context).execute(plan)
        from ..physical.streaming import _run_resident
        return _run_resident(plan, context)


def _replace(plan: RelNode, old: RelNode, new: RelNode) -> RelNode:
    if plan is old:
        return new
    if not plan.inputs:
        return plan
    return plan.with_inputs([_replace(i, old, new) for i in plan.inputs])


def _state_key(mv: MatView):
    from . import result_cache as _rc
    return _rc.CacheKey(
        f"mv-state:{mv.fingerprint}:{mv.schema_name}.{mv.name}",
        ((STATE_SCHEMA, f"{mv.schema_name}.{mv.name}"),))


class _StateMissing(Exception):
    """Maintained partial state not in the cache (evicted / never stored /
    cache disabled) — the refresh downgrades to a full recompute."""


# ---------------------------------------------------------------------------
# the registry (one per Context, created on first CREATE MATERIALIZED VIEW)
# ---------------------------------------------------------------------------

class MatViewRegistry:
    def __init__(self):
        self.views: Dict[Tuple[str, str], MatView] = {}
        self.deltas: Dict[Tuple[str, str], List[DeltaRecord]] = {}
        self.tombstones: Dict[Tuple[str, str], int] = {}
        self.lock = threading.RLock()

    # -- epoch seam (called from Context.bump_table_epoch) -----------------
    def record_delta(self, key: Tuple[str, str], epoch: int,
                     table: Table) -> None:
        with self.lock:
            if not mv_enabled():
                # kill switch: appends degrade to the pre-subsystem
                # tombstone so a later re-enable never serves from a gap
                self._tombstone_locked(key, epoch)
                return
            if not any(key in v.base_epochs for v in self.views.values()):
                return  # no dependent views: nothing to maintain
            log = self.deltas.setdefault(key, [])
            if len(log) >= MAX_DELTAS:
                # before giving up on incremental maintenance, coalesce
                # the unconsumed tail into one record: a steady trickle
                # of tiny appends then stays O(delta) instead of
                # tombstoning into a full recompute
                self._compact_locked(key, log)
            if len(log) >= MAX_DELTAS:
                logger.info("matview: delta log for %s.%s overflowed "
                            "(%d records); tombstoning", key[0], key[1],
                            len(log))
                self._tombstone_locked(key, epoch)
                return
            log.append(DeltaRecord(epoch=epoch, rows=table.num_rows,
                                   table=table, ts=time.time()))
            _tel.inc("mv_deltas_recorded")
            self._update_gauges_locked()

    def record_overwrite(self, key: Tuple[str, str], epoch: int) -> None:
        with self.lock:
            self._tombstone_locked(key, epoch)

    def _tombstone_locked(self, key, epoch: int) -> None:
        self.deltas.pop(key, None)
        self.tombstones[key] = epoch
        self._update_gauges_locked()

    def _compact_locked(self, key, log: List[DeltaRecord]) -> None:
        """Merge adjacent unconsumed records into one batch.  Only records
        strictly ABOVE every dependent view's watermark may merge — a
        record a view has partially consumed must keep its epoch so
        _staleness's hole detection stays exact."""
        from ..ops.join import concat_tables

        hi = max((v.base_epochs.get(key, 0) for v in self.views.values()
                  if key in v.base_epochs), default=0)
        tail = [r for r in log if r.epoch > hi]
        if len(tail) < 2:
            return
        merged = DeltaRecord(
            epoch=max(r.epoch for r in tail),
            rows=sum(r.rows for r in tail),
            table=concat_tables([r.table for r in tail]),
            ts=min(r.ts for r in tail))
        log[:] = [r for r in log if r.epoch <= hi] + [merged]
        _tel.inc("mv_delta_compactions")
        logger.info("matview: compacted %d delta record(s) for %s.%s into "
                    "one %d-row batch", len(tail), key[0], key[1],
                    merged.rows)

    def _update_gauges_locked(self) -> None:
        pending = sum(r.rows for recs in self.deltas.values() for r in recs)
        oldest = min((r.ts for recs in self.deltas.values()
                      for r in recs if r.ts), default=0.0)
        _tel.REGISTRY.set_gauge("mv_pending_rows", pending)
        _tel.REGISTRY.set_gauge(
            "mv_staleness_s", max(time.time() - oldest, 0.0)
            if oldest else 0.0)

    def discard_view(self, schema_name: str, name: str) -> None:
        """Registry-side cleanup when the catalog entry goes away through
        a non-MV path (DROP TABLE, DROP/ALTER SCHEMA, rename)."""
        with self.lock:
            mv = self.views.pop((schema_name, name.lower()), None)
            if mv is not None:
                from . import result_cache as _rc
                _rc.get_cache().invalidate_table(
                    STATE_SCHEMA, f"{mv.schema_name}.{mv.name}")
                self._prune_locked()

    def discard_schema(self, schema_name: str) -> None:
        with self.lock:
            for s, n in [k for k in self.views if k[0] == schema_name]:
                self.discard_view(s, n)

    # -- serving -----------------------------------------------------------
    def maybe_serve(self, context, schema_name: str, name: str,
                    entry: TableEntry) -> TableEntry:
        """resolve_table hook: refresh-if-stale, then serve the (possibly
        replaced) catalog entry.  Non-MV entries pass through untouched."""
        mv = self.views.get((schema_name, name))
        if mv is None or not mv_enabled():
            return entry
        with self.lock:
            self.ensure_fresh(context, mv)
            _tel.inc("mv_serves")
            mv.serves += 1
            return context.schema[schema_name].tables[name]

    # -- freshness ---------------------------------------------------------
    def _staleness(self, context, mv: MatView):
        """("fresh", None) | ("incremental", {base: [DeltaRecord...]})
        | ("full", reason)."""
        pending: Dict[Tuple[str, str], List[DeltaRecord]] = {}
        for key in mv.base_tables:
            # a base that is itself a materialized view refreshes first, so
            # its epoch reflects ITS bases before this view reads it
            inner = self.views.get(key)
            if inner is not None and inner is not mv:
                self.ensure_fresh(context, inner)
            cur = context.table_epoch(*key)
            last = mv.base_epochs.get(key, 0)
            if cur == last:
                continue
            if not mv.maintainable:
                return "full", mv.reason
            if self.tombstones.get(key, 0) > last:
                return "full", f"base table {key[0]}.{key[1]} overwritten"
            recs = [r for r in self.deltas.get(key, ()) if r.epoch > last]
            # every bump since `last` is either a logged delta or a
            # tombstone (checked above); the newest record must account
            # for the current epoch or the log has a hole
            if not recs or max(r.epoch for r in recs) != cur:
                return "full", (f"delta log for {key[0]}.{key[1]} does not "
                                "cover the epoch gap")
            pending[key] = recs
        if not pending:
            return "fresh", None
        return "incremental", pending

    def ensure_fresh(self, context, mv: MatView) -> None:
        """Refresh ``mv`` if its bases advanced.  Raises on failure (the
        caller's query fails rather than reading a stale view); the
        registry state only moves AFTER a successful materialization."""
        kind, info = self._staleness(context, mv)
        if kind == "fresh":
            return
        if kind == "incremental":
            try:
                # the chaos site: an injected fault abandons the
                # incremental path and recomputes in full — wrong-never
                _faults.maybe_fail("mv_refresh")
                self._refresh_incremental(context, mv, info)
                _tel.inc("mv_refresh_incremental")
                if _events_on():
                    from . import events as _ev
                    _ev.publish("mv.refresh", view=mv.name,
                                mode="incremental")
                mv.refresh_incremental += 1
                mv.last_refresh_reason = "incremental"
                self._prune_locked()
                return
            except _StateMissing as e:
                info = str(e)
            except _res.TransientError as e:
                logger.warning("matview %s.%s: incremental refresh failed "
                               "(%s); recomputing in full", mv.schema_name,
                               mv.name, e)
                info = f"incremental refresh failed: {e}"
        self._refresh_full(context, mv, reason=str(info))
        self._prune_locked()

    # -- refresh paths -----------------------------------------------------
    def _swap(self, context, mv: MatView, result: Table) -> None:
        """Install the refreshed result transactionally: new entry, MV
        epoch bump (stale cached queries OVER the view drop), base-epoch
        watermark advance."""
        # temp registration sanitized intermediate names to c0..cN; the
        # served view keeps the defining query's output names
        result = result.with_names([f.name for f in mv.plan.schema])
        context.schema[mv.schema_name].tables[mv.name] = \
            TableEntry(table=result)
        context.bump_table_epoch(mv.schema_name, mv.name)
        for key in mv.base_tables:
            mv.base_epochs[key] = context.table_epoch(*key)

    def _refresh_incremental(self, context, mv: MatView,
                             pending: Dict) -> None:
        from ..ops.join import concat_tables
        from . import result_cache as _rc

        shape = mv.shape
        if shape.kind == "join":
            from . import delta as _delta
            try:
                _delta.refresh_join(self, context, mv, pending)
            finally:
                _cleanup_temps(context)
            return
        (key,) = pending.keys()  # single-scan shapes have one base scan
        delta = concat_tables([r.table for r in pending[key]])
        # the scan may be column-pruned/reordered relative to the base
        # table layout the delta was recorded in — align by name
        lut = {n.lower(): col
               for n, col in zip(delta.names, delta.columns)}
        try:
            delta = Table([f.name for f in shape.scan.schema],
                          [lut[f.name.lower()] for f in shape.scan.schema])
        except KeyError as exc:
            raise _StateMissing(
                f"delta does not cover scanned column {exc}") from exc
        try:
            delta_scan = _register_temp(context, delta, shape.scan.schema)
            if shape.kind == "cdistinct":
                from . import delta as _delta
                _delta.refresh_cdistinct(self, context, mv, delta_scan)
                return
            if shape.kind == "append":
                new_rows = _execute_plan(
                    context, _replace(mv.plan, shape.scan, delta_scan),
                    eager=True)
                current = context.schema[mv.schema_name].tables[mv.name]
                result = concat_tables([current.table, new_rows])
                self._swap(context, mv, result)
                return
            # agg: partial over the delta pipeline, merge with cached state
            cache = _rc.get_cache()
            state = cache.get(_state_key(mv)) if cache.enabled() else None
            if state is None:
                raise _StateMissing("maintained state not in result cache")
            state_table, _tier = state
            agg = shape.agg
            partial = _execute_plan(context, LogicalAggregate(
                input=_replace(shape.below, shape.scan, delta_scan),
                group_keys=list(agg.group_keys), aggs=shape.partial_aggs,
                schema=list(shape.partial_schema)), eager=True)
            merged_in = _register_temp(
                context, concat_tables([state_table, partial]),
                shape.partial_schema)
            gk = len(agg.group_keys)
            new_state = _execute_plan(context, LogicalAggregate(
                input=merged_in, group_keys=list(range(gk)),
                aggs=list(shape.merge_aggs),
                schema=list(shape.merge_schema)), eager=True)
            result = self._finalize_agg(context, mv, new_state)
            self._swap(context, mv, result)
            cache.put(_state_key(mv), new_state)
        finally:
            _cleanup_temps(context)

    def _finalize_agg(self, context, mv: MatView, state: Table) -> Table:
        """State (merge layout) -> view output: AVG division + the nodes
        above the aggregate (HAVING / projections / ORDER BY), mirroring
        the streaming merge tail."""
        shape = mv.shape
        agg = shape.agg
        gk = len(agg.group_keys)
        node: RelNode = _register_temp(context, state, shape.merge_schema)
        if shape.needs_project:
            exprs = [RexInputRef(i, f.stype)
                     for i, f in enumerate(agg.schema[:gk])]
            for kind, i, j, f in shape.post_exprs:
                if kind == "ref":
                    exprs.append(RexInputRef(i, f.stype))
                else:
                    num = RexInputRef(i, shape.merge_schema[i].stype)
                    den = RexCall("CAST", [RexInputRef(j, BIGINT)], DOUBLE,
                                  info=DOUBLE)
                    exprs.append(RexCall("/", [num, den], f.stype))
            node = LogicalProject(input=node, exprs=exprs,
                                  schema=list(agg.schema))
        for outer in reversed(shape.above):
            node = outer.with_inputs([node])
        # group-count-sized input: the interpreter beats a fresh compile
        return _execute_plan(context, node, eager=True)

    def _refresh_full(self, context, mv: MatView, reason: str) -> None:
        from . import result_cache as _rc

        try:
            if mv.maintainable and mv.shape.kind == "agg":
                # one pass builds the partial state, a small merge derives
                # the output from it — so the NEXT refresh is O(delta)
                shape = mv.shape
                agg = shape.agg
                state = _execute_plan(context, LogicalAggregate(
                    input=shape.below, group_keys=list(agg.group_keys),
                    aggs=shape.partial_aggs,
                    schema=list(shape.partial_schema)))
                # partial layout == merge layout (the merge of one partial
                # is itself), so it finalizes directly
                result = self._finalize_agg(context, mv, state)
                self._swap(context, mv, result)
                cache = _rc.get_cache()
                if cache.enabled():
                    cache.put(_state_key(mv), state)
            elif mv.maintainable and mv.shape.kind == "cdistinct":
                # same seeding discipline, refcounted state
                from . import delta as _delta
                _delta.refresh_full_cdistinct(self, context, mv)
            else:
                result = _execute_plan(context, mv.plan)
                self._swap(context, mv, result)
            # consumed everything up to the new watermark
            for key in mv.base_tables:
                self.tombstones.pop(key, None)
            _tel.inc("mv_refresh_full")
            if _events_on():
                from . import events as _ev
                _ev.publish("mv.refresh", view=mv.name, mode="full",
                            reason=reason or None)
            mv.refresh_full += 1
            mv.last_refresh_reason = f"full ({reason})" if reason else "full"
            if reason:
                logger.info("matview %s.%s refreshed in full: %s",
                            mv.schema_name, mv.name, reason)
        finally:
            _cleanup_temps(context)

    def _prune_locked(self) -> None:
        """Drop delta records no live view still needs."""
        for key in list(self.deltas):
            needed = [v.base_epochs[key] for v in self.views.values()
                      if key in v.base_epochs]
            if not needed:
                del self.deltas[key]
                continue
            lo = min(needed)
            self.deltas[key] = [r for r in self.deltas[key] if r.epoch > lo]
            if not self.deltas[key]:
                del self.deltas[key]
        self._update_gauges_locked()


def get_registry(context, create: bool = False) -> Optional[MatViewRegistry]:
    reg = getattr(context, "_matview_registry", None)
    if reg is None and create:
        reg = MatViewRegistry()
        context._matview_registry = reg
    return reg


# ---------------------------------------------------------------------------
# statement entry points (physical/rel/custom.py handlers call these)
# ---------------------------------------------------------------------------

def create_matview(context, name_parts: List[str], query, sql: str,
                   if_not_exists: bool, or_replace: bool) -> None:
    from . import result_cache as _rc

    _require_enabled()
    schema_name, name = context.fqn(name_parts)
    if name in context.schema[schema_name].tables:
        if if_not_exists:
            return
        if not or_replace:
            raise MatViewError(
                f"A table with the name {name} is already present; use "
                "CREATE OR REPLACE MATERIALIZED VIEW to replace it.")
    plan = context._get_plan(query, sql)
    text, volatile, scans = _rc.canonical_plan(plan, context)
    if volatile:
        raise MatViewError(
            "CREATE MATERIALIZED VIEW rejects volatile queries "
            "(RAND/CURRENT_DATE/CURRENT_TIME/NOW, UDFs, system-table "
            "scans, unseeded TABLESAMPLE): the materialized result would "
            "freeze a value that must change per query. Materialize a "
            "deterministic query instead.")
    # the JAX package's keying (its flight recorder's plan fingerprint)
    fingerprint = digest_key(text)
    shape, reason = _analyze(plan, context)
    mv = MatView(
        name=name, schema_name=schema_name, sql=sql, plan=plan,
        fingerprint=fingerprint,
        base_tables=tuple(dict.fromkeys((s, t) for s, t in scans)),
        maintainable=shape is not None, reason=reason, shape=shape)
    reg = get_registry(context, create=True)
    with reg.lock:
        reg.discard_view(schema_name, name)  # OR REPLACE over an old view
        reg._refresh_full(context, mv, reason="")
        mv.last_refresh_reason = "initial materialization"
        reg.views[(schema_name, name)] = mv
    logger.info("matview %s.%s created: %s", schema_name, name,
                "maintainable (%s)" % mv.shape.kind if mv.maintainable
                else "full-recompute (%s)" % reason)


def drop_matview(context, name_parts: List[str], if_exists: bool) -> None:
    _require_enabled()
    schema_name, name = context.fqn(name_parts)
    reg = get_registry(context)
    mv = reg.views.get((schema_name, name)) if reg is not None else None
    if mv is None:
        if if_exists:
            return
        raise MatViewError(
            f"A materialized view with the name {name} is not present.")
    with reg.lock:
        reg.discard_view(schema_name, name)
        context.schema[schema_name].tables.pop(name, None)
        context.bump_table_epoch(schema_name, name)


def refresh_matview(context, name_parts: List[str]) -> None:
    _require_enabled()
    schema_name, name = context.fqn(name_parts)
    reg = get_registry(context)
    mv = reg.views.get((schema_name, name)) if reg is not None else None
    if mv is None:
        raise MatViewError(
            f"A materialized view with the name {name} is not present.")
    with reg.lock:
        reg.ensure_fresh(context, mv)


def matview_rows(context) -> List[dict]:
    """One row per registered view: ``system.matviews``' rows, as the JAX
    package's."""
    reg = get_registry(context)
    if reg is None:
        return []
    out = []
    with reg.lock:
        for (schema_name, name), mv in sorted(reg.views.items()):
            entry = context.schema.get(schema_name)
            entry = entry.tables.get(name) if entry is not None else None
            pending = [r for k in mv.base_tables
                       for r in reg.deltas.get(k, ())
                       if r.epoch > mv.base_epochs.get(k, 0)]
            ts = [r.ts for r in pending if r.ts]
            out.append({
                "schema": schema_name,
                "name": name,
                "rows": (entry.table.num_rows
                         if entry is not None and entry.table is not None
                         else 0),
                "maintainable": ("incremental:" + mv.shape.kind
                                 if mv.maintainable else "full"),
                "reason": mv.reason,
                "base_tables": ",".join(f"{s}.{t}"
                                        for s, t in mv.base_tables),
                "pending_deltas": len(pending),
                "pending_rows": sum(r.rows for r in pending),
                "staleness_s": (round(max(time.time() - min(ts), 0.0), 3)
                                if ts else 0.0),
                "serves": mv.serves,
                "refresh_incremental": mv.refresh_incremental,
                "refresh_full": mv.refresh_full,
                "last_refresh": mv.last_refresh_reason,
                "fingerprint": mv.fingerprint,
            })
    return out


def view_candidate_rows(context) -> List[dict]:
    """``system.view_candidates``' rows, as the JAX package's: hot
    repeated plan fingerprints from the flight recorder's EWMA
    statistics, ranked by hits times recompute cost, each with its last
    SQL.  Empty unless
    ``DSQL_HISTORY_FILE`` arms the recorder (checked before its import)."""
    if not _history_on():
        return []
    from . import flight_recorder as _fr

    stats = _fr._STATS.read()
    if not stats:
        return []
    examples: Dict[str, str] = {}
    for ev in _fr.read_events(kind="query"):
        fp = ev.get("plan_fp")
        if fp and ev.get("query"):
            examples[fp] = ev["query"]
    reg = get_registry(context)
    materialized = {mv.fingerprint for mv in reg.views.values()} \
        if reg is not None else set()
    rows = []
    for fp, e in stats.items():
        if not isinstance(e, dict):
            continue
        n = int(e.get("n", 0) or 0)
        ms = float(e.get("ms", 0.0) or 0.0)
        if n <= 0 or ms <= 0.0:
            continue
        rows.append({
            "fingerprint": fp,
            "hits": n,
            "ewma_ms": ms,
            "score": n * ms,
            "materialized": fp in materialized,
            "example_sql": examples.get(fp, ""),
        })
    rows.sort(key=lambda r: r["score"], reverse=True)
    return rows
