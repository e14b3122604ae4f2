"""Delta maintenance beyond single-scan aggregates: the algebra that lets
``matview.py`` refresh views with INNER joins or a COUNT(DISTINCT) from
the appended rows instead of recomputing them.  The counterpart of
``dask_sql_tpu/runtime/delta.py``.

**Delta-join.**  For an INNER join tree over append-only bases, the new
result is multilinear in the inputs::

    J(A+ΔA, B+ΔB) = J(A,B) ∪ J(ΔA,B) ∪ J(A,ΔB) ∪ J(ΔA,ΔB)

Generalized to N scans left-to-right, the delta is the sum of one term
per appended scan i: scan i replaced by its delta, scans left of i by
their CURRENT table (old+delta), scans right of i by their OLD prefix —
each pair (old, delta) then meets exactly once across the terms.  Every
term runs the defining plan with its scans swapped for temps, through
the executors' existing join operators, so selection and projection
pipelines below or above the join ride along unchanged; the old prefix
is a zero-copy ``Table.slice`` (a view of the tensors) because appends
only ever concatenate.
Self-joins fall out for free — each scan position gets its own term.

**COUNT(DISTINCT).**  Maintained via refcounted value state: the cached
partial is ``GROUP BY keys, value -> COUNT(*) AS $rc``.  An append
merges by summing refcounts ($SUM0 over the concatenated state+delta
partials) and the view finalizes as ``COUNT(value) GROUP BY keys`` over
the state — O(distinct values), never a rescan.  Plain
``SELECT DISTINCT`` needs none of this (the binder lowers it to a
group-by that the base "agg" shape already maintains); this covers the
aggregate-call form the streaming algebra refuses.

Both shapes degrade exactly like the base machinery: any condition the
algebra cannot prove (outer joins, validity-masked bases, a delta-log
hole) raises ``_StateMissing``/refuses at analysis, and the
refresh falls back to a full recompute — wrong-never, slower-ok.
"""
from __future__ import annotations

import logging

from ..plan.nodes import (
    AggCall, Field, LogicalAggregate, LogicalFilter, LogicalJoin,
    LogicalProject, LogicalSort, LogicalTableScan,
)
from ..table import Table
from ..types import BIGINT
from . import matview as _mv

logger = logging.getLogger(__name__)

RC = "$rc"   # refcount column of the COUNT(DISTINCT) state


# ---------------------------------------------------------------------------
# analysis (called from matview._analyze)
# ---------------------------------------------------------------------------

def analyze_join(plan, chain, join, context):
    """(shape, reason) for a plan whose pipeline bottoms out at a
    LogicalJoin.  ``chain`` holds the nodes above the join, root-first."""
    if any(isinstance(n, LogicalAggregate) for n in chain):
        return None, ("aggregates over joins require full recompute "
                      "(group state is not linear in the join inputs)")
    if any(isinstance(n, LogicalSort) for n in chain):
        return None, ("ORDER BY/LIMIT over a join requires full recompute "
                      "(appended join results interleave with the "
                      "existing order)")
    for node in chain:
        exprs = (node.exprs if isinstance(node, LogicalProject)
                 else [node.condition] if isinstance(node, LogicalFilter)
                 else [])
        if any(_mv._rex_has_subquery(e) for e in exprs if e is not None):
            return None, "scalar subquery requires full recompute"
    scans = []
    reason = _walk_join(join, scans, context)
    if reason:
        return None, reason
    if len({id(s) for s in scans}) != len(scans):
        return None, ("shared scan node below a join requires full "
                      "recompute")
    if getattr(context, "mesh", None) is not None:
        return None, ("mesh-sharded bases reshard on append; delta-join "
                      "requires stable row prefixes")
    return _mv._Shape(kind="join", scan=scans[0], below=plan,
                      scans=list(scans)), ""


def _walk_join(node, scans, context):
    """Collect scans left-to-right; non-empty return = refusal reason."""
    if isinstance(node, LogicalJoin):
        if node.join_type != "INNER":
            return (f"{node.join_type} join requires full recompute (only "
                    "INNER joins maintain incrementally: outer/semi/anti "
                    "deltas can retract previously-emitted rows)")
        if getattr(node, "null_aware", False):
            return "null-aware join requires full recompute"
        if node.condition is not None \
                and _mv._rex_has_subquery(node.condition):
            return "scalar subquery requires full recompute"
        for i in node.inputs:
            r = _walk_join(i, scans, context)
            if r:
                return r
        return ""
    if isinstance(node, (LogicalProject, LogicalFilter)):
        exprs = (node.exprs if isinstance(node, LogicalProject)
                 else [node.condition])
        if any(_mv._rex_has_subquery(e) for e in exprs if e is not None):
            return "scalar subquery requires full recompute"
        return _walk_join(node.inputs[0], scans, context)
    if isinstance(node, LogicalTableScan):
        schema = context.schema.get(node.schema_name)
        entry = (schema.tables.get(node.table_name)
                 if schema is not None else None)
        if entry is None:
            return f"base table {node.table_name} not resolvable"
        if entry.chunked is not None:
            return ("chunked base table streams from host; appends are "
                    "not delta-tracked")
        if entry.row_valid is not None:
            return ("validity-masked (mesh-padded) base requires full "
                    "recompute")
        scans.append(node)
        return ""
    return (f"{node.node_name()} below a join requires full recompute "
            "(only scan/filter/project pipelines feed delta-join terms)")


def analyze_distinct_agg(plan, scan, agg, above, below_chain):
    """(shape, reason) for an aggregate carrying DISTINCT calls.  Only
    the single unfiltered COUNT(DISTINCT col) form maintains (refcounted
    state); anything else stays a full recompute with a reason."""
    refuse = ("only a single unfiltered COUNT(DISTINCT col) maintains "
              "incrementally (refcounted value state); other DISTINCT "
              "aggregates require full recompute")
    if len(agg.aggs) != 1:
        return None, refuse
    call = agg.aggs[0]
    if (call.op != "COUNT" or not call.distinct or len(call.args) != 1
            or call.filter_arg is not None or call.udaf is not None):
        return None, refuse
    cd_arg = call.args[0]
    if cd_arg in agg.group_keys:
        return None, ("COUNT(DISTINCT) over a grouping column requires "
                      "full recompute")
    below = agg.inputs[0]
    gk = len(agg.group_keys)
    group_fields = [Field(f.name, f.stype) for f in agg.schema[:gk]]
    state_schema = group_fields + [Field("$v", below.schema[cd_arg].stype),
                                   Field(RC, BIGINT)]
    return _mv._Shape(kind="cdistinct", scan=scan, below=below, agg=agg,
                      above=list(above), partial_schema=state_schema,
                      cd_arg=cd_arg), ""


# ---------------------------------------------------------------------------
# shared plumbing
# ---------------------------------------------------------------------------

def _align(table: Table, scan: LogicalTableScan) -> Table:
    """Project a base-layout table onto the (possibly column-pruned,
    reordered) scan schema by name; a miss degrades to full recompute."""
    lut = {n.lower(): col for n, col in zip(table.names, table.columns)}
    try:
        return Table([f.name for f in scan.schema],
                     [lut[f.name.lower()] for f in scan.schema])
    except KeyError as exc:
        raise _mv._StateMissing(
            f"delta does not cover scanned column {exc}") from exc


# ---------------------------------------------------------------------------
# delta-join refresh
# ---------------------------------------------------------------------------

def refresh_join(reg, context, mv, pending) -> None:
    """current view ∪ one multilinear term per appended scan position.
    Runs under the registry lock (appends hold it while swapping the
    catalog, so every entry read here is one consistent snapshot)."""
    from ..ops.join import concat_tables

    shape = mv.shape
    cur = {}
    for key in mv.base_tables:
        schema = context.schema.get(key[0])
        entry = schema.tables.get(key[1]) if schema is not None else None
        if entry is None or entry.table is None:
            raise _mv._StateMissing(
                f"base table {key[0]}.{key[1]} not resident")
        if entry.row_valid is not None:
            raise _mv._StateMissing(
                f"base table {key[0]}.{key[1]} grew a validity mask")
        cur[key] = entry.table
    deltas, appended = {}, {}
    for key, recs in pending.items():
        deltas[key] = (recs[0].table if len(recs) == 1
                       else concat_tables([r.table for r in recs]))
        appended[key] = sum(r.rows for r in recs)
    terms = []
    for i, scan in enumerate(shape.scans):
        ki = (scan.schema_name, scan.table_name)
        if ki not in deltas or deltas[ki].num_rows == 0:
            continue
        plan = _mv._replace(
            mv.plan, scan,
            _mv._register_temp(context, _align(deltas[ki], scan),
                               scan.schema))
        for j, other in enumerate(shape.scans):
            if j == i:
                continue
            kj = (other.schema_name, other.table_name)
            t = cur[kj]
            if j > i:
                # scans right of the delta position see the OLD prefix
                # (pre-append rows): appends only concatenate, so old is
                # a prefix slice of the current table
                n_old = t.num_rows - appended.get(kj, 0)
                if n_old < 0:
                    raise _mv._StateMissing(
                        f"delta log for {kj[0]}.{kj[1]} exceeds the "
                        "table size")
                if n_old != t.num_rows:
                    t = t.slice(0, n_old)
            plan = _mv._replace(
                plan, other,
                _mv._register_temp(context, _align(t, other), other.schema))
        terms.append(_mv._execute_plan(context, plan, eager=True))
    current = context.schema[mv.schema_name].tables[mv.name]
    result = (concat_tables([current.table] + terms)
              if terms else current.table)
    reg._swap(context, mv, result)


# ---------------------------------------------------------------------------
# COUNT(DISTINCT) refresh (refcounted state)
# ---------------------------------------------------------------------------

def _partial_plan(shape, input_node) -> LogicalAggregate:
    """GROUP BY keys, value -> COUNT(value) AS $rc over ``input_node``."""
    agg = shape.agg
    return LogicalAggregate(
        input=input_node,
        group_keys=list(agg.group_keys) + [shape.cd_arg],
        aggs=[AggCall("COUNT", [shape.cd_arg], False, BIGINT, RC)],
        schema=list(shape.partial_schema))


def _finalize_cdistinct(context, mv, state: Table) -> Table:
    """State (keys, value, $rc) -> view output: COUNT(value) per key
    group (COUNT skips the NULL-value refcount row, matching
    COUNT(DISTINCT)'s NULL semantics), then the nodes above the agg."""
    shape = mv.shape
    agg = shape.agg
    gk = len(agg.group_keys)
    out_field = agg.schema[gk]
    node = _mv._register_temp(context, state, shape.partial_schema)
    node = LogicalAggregate(
        input=node, group_keys=list(range(gk)),
        aggs=[AggCall("COUNT", [gk], False, out_field.stype,
                      out_field.name)],
        schema=list(agg.schema))
    for outer in reversed(shape.above):
        node = outer.with_inputs([node])
    return _mv._execute_plan(context, node, eager=True)


def refresh_full_cdistinct(reg, context, mv) -> None:
    """Full pass that also SEEDS the refcounted state, so the next
    refresh is O(delta) — mirrors matview's agg-kind full refresh."""
    from . import result_cache as _rc

    state = _mv._execute_plan(context, _partial_plan(mv.shape,
                                                     mv.shape.below))
    result = _finalize_cdistinct(context, mv, state)
    reg._swap(context, mv, result)
    cache = _rc.get_cache()
    if cache.enabled():
        cache.put(_mv._state_key(mv), state)


def refresh_cdistinct(reg, context, mv, delta_scan) -> None:
    """cached state ⊕ refcount partial over the delta -> new state."""
    from ..ops.join import concat_tables
    from . import result_cache as _rc

    shape = mv.shape
    gk = len(shape.agg.group_keys)
    cache = _rc.get_cache()
    state = cache.get(_mv._state_key(mv)) if cache.enabled() else None
    if state is None:
        raise _mv._StateMissing("maintained state not in result cache")
    state_table, _tier = state
    partial = _mv._execute_plan(
        context,
        _partial_plan(shape, _mv._replace(shape.below, shape.scan,
                                          delta_scan)),
        eager=True)
    merged_in = _mv._register_temp(
        context, concat_tables([state_table, partial]),
        shape.partial_schema)
    new_state = _mv._execute_plan(context, LogicalAggregate(
        input=merged_in, group_keys=list(range(gk + 1)),
        aggs=[AggCall("$SUM0", [gk + 1], False, BIGINT, RC)],
        schema=list(shape.partial_schema)), eager=True)
    result = _finalize_cdistinct(context, mv, new_state)
    reg._swap(context, mv, result)
    cache.put(_mv._state_key(mv), new_state)
