"""Statement handlers: schemas, tables and views, SHOW / DESCRIBE, EXPLAIN
[ANALYZE], PREPARE / EXECUTE / DEALLOCATE.

The counterpart of ``dask_sql_tpu/physical/rel/custom.py``: one handler per
statement AST class, registered in ``StatementDispatcher``.  A handler takes
(statement, context, sql text) and returns a device ``Table`` of rows (SHOW,
DESCRIBE, EXPLAIN, EXECUTE) or None (DDL).

The statements whose machinery the port lacks raise ``NotImplementedError``
naming themselves and what they wait for (``_UNPORTED``): CREATE TABLE ...
WITH (location) (the file readers, ``io/inputs.py``), ANALYZE TABLE (a
host path without pandas), the materialized views (``runtime/matview.py``
and its delta log, ``runtime/delta.py``), INSERT INTO (the same delta log
and ``Context.append_rows``), the model statements (``models/``, with
``register_model``) and EXPLAIN PROFILE (``runtime/profiler.py``).
"""
from __future__ import annotations

import re
import time

import numpy as np

from ...datacontainer import TableEntry
from ...runtime import statistics as _stats
from ...runtime import telemetry as _tel
from ...sql import ast as A
from ...table import Table
from ...utils import Pluggable


class StatementDispatcher(Pluggable):
    """Statement AST class name -> handler registry."""


def _meta_table(data: dict, context) -> Table:
    return Table.from_pydict(data, context.device)


def _strings(values) -> np.ndarray:
    return np.array(list(values), dtype=object)


# ---------------------------------------------------------------------------
# schemas
# ---------------------------------------------------------------------------

def _create_schema(stmt: A.CreateSchema, context, sql):
    if stmt.name in context.schema:
        if stmt.if_not_exists:
            return None
        if not stmt.or_replace:
            raise RuntimeError(
                f"A schema with the name {stmt.name} is already present.")
    context.create_schema(stmt.name)
    return None


def _drop_schema(stmt: A.DropSchema, context, sql):
    if stmt.name not in context.schema:
        if stmt.if_exists:
            return None
        raise RuntimeError(
            f"A schema with the name {stmt.name} is not present.")
    context.drop_schema(stmt.name)
    return None


def _use_schema(stmt: A.UseSchema, context, sql):
    if stmt.name not in context.schema:
        raise RuntimeError(
            f"A schema with the name {stmt.name} is not present.")
    context.schema_name = stmt.name
    return None


# ---------------------------------------------------------------------------
# tables and views
# ---------------------------------------------------------------------------

def _create_table_as(stmt: A.CreateTableAs, context, sql):
    """CREATE [OR REPLACE] TABLE ... AS runs the query on the context's
    device and stores its Table (no ingest statistics, as in the JAX
    package); CREATE VIEW ... AS stores the bound plan, which each query
    over the view binds again."""
    schema_name, name = context.fqn(stmt.name)
    if name in context.schema[schema_name].tables:
        if stmt.if_not_exists:
            return None
        if not stmt.or_replace:
            raise RuntimeError(
                f"A table with the name {name} is already present.")
    plan = context._get_plan(stmt.query, sql)
    if stmt.view:
        entry = TableEntry(plan=plan)
    else:
        entry = TableEntry(table=context._execute_query_plan(plan))
    context.schema[schema_name].tables[name] = entry
    context.bump_table_epoch(schema_name, name)
    return None


def _drop_table(stmt: A.DropTable, context, sql):
    schema_name, name = context.fqn(stmt.name)
    if name not in context.schema[schema_name].tables:
        if stmt.if_exists:
            return None
        raise RuntimeError(f"A table with the name {name} is not present.")
    context.drop_table(name, schema_name=schema_name)
    return None


# ---------------------------------------------------------------------------
# SHOW / DESCRIBE
# ---------------------------------------------------------------------------

def _show_schemas(stmt: A.ShowSchemas, context, sql):
    from ..rex.ops import sql_like_to_regex

    names = list(context.schema) + ["information_schema"]
    if stmt.like:
        rx = re.compile(sql_like_to_regex(stmt.like))
        names = [n for n in names if rx.match(n)]
    return _meta_table({"Schema": _strings(names)}, context)


def _show_tables(stmt: A.ShowTables, context, sql):
    schema_name = stmt.schema or context.schema_name
    if schema_name not in context.schema:
        raise AttributeError(f"Schema {schema_name} is not defined.")
    return _meta_table({"Table": _strings(context.schema[schema_name].tables)},
                       context)


def _show_columns(stmt: A.ShowColumns, context, sql):
    resolved = context.resolve_table(stmt.table)
    if resolved is None:
        raise AttributeError(f"Table {'.'.join(stmt.table)} is not defined.")
    fields = resolved[2]
    return _meta_table({
        "Column": _strings(f.name for f in fields),
        "Type": _strings(str(f.stype).lower() for f in fields),
        "Extra": _strings("" for _ in fields),
        "Comment": _strings("" for _ in fields),
    }, context)


def _describe_table(stmt: A.DescribeTable, context, sql):
    return _show_columns(A.ShowColumns(table=stmt.table), context, sql)


# ---------------------------------------------------------------------------
# EXPLAIN
# ---------------------------------------------------------------------------

def _explain(stmt: A.ExplainStatement, context, sql):
    if stmt.profile:
        raise NotImplementedError(
            "EXPLAIN PROFILE is not ported yet: it waits for "
            "runtime/profiler.py")
    plan = context._get_plan(stmt.query, sql)
    if stmt.analyze:
        lines = _explain_analyze(plan, context)
    else:
        # the plan, then the operator variants the statistics predict
        lines = plan.explain().splitlines() + _stats.explain_lines(plan,
                                                                   context)
    return _meta_table({"PLAN": _strings(lines)}, context)


def _explain_analyze(plan, context) -> list:
    """Run the plan on the eager executor, each node timed and its rows
    counted (``telemetry.record_nodes``), and render the tree annotated
    ``[rows= time= self=]``; then the run's wall and rows, what the result
    cache would do for a plain run (``-- cache: disabled``,
    ``uncacheable``, ``miss`` or ``hit tier=...``, probed before the run),
    the operator variants the run took, the tier a plain run would take
    (``compiled.tier_probe``) and the telemetry counters it moved.  Node
    times are host walls: on the card they count the launches, not the
    kernels' completion.  As in the JAX package the analyzed run is always
    eager (a compiled program has no per-node boundaries to time) and
    stores its result, so the next plain run hits."""
    from ...runtime import result_cache as _rc
    from ..compiled import tier_probe
    from .executor import RelExecutor

    cache = _rc.get_cache()
    ckey = _rc.plan_key(plan, context) if cache.enabled() else None
    if not cache.enabled():
        cache_line = "-- cache: disabled"
    elif ckey is None:
        cache_line = "-- cache: uncacheable (volatile or chunked plan)"
    else:
        tier = cache.probe(ckey)
        cache_line = (f"-- cache: hit tier={tier}" if tier is not None
                      else "-- cache: miss")

    # the tier a plain run would take, probed before the analyzed run
    # (always eager) changes anything
    try:
        exec_tier = tier_probe(plan, context)
    except Exception:
        exec_tier = "eager"
    snap0 = _tel.REGISTRY.counters()
    t0 = time.perf_counter()
    with _stats.capture() as choices, _tel.record_nodes() as rec:
        if getattr(context, "_has_chunked", False):
            from ..streaming import execute_streaming, plan_references_chunked
            if plan_references_chunked(plan, context):
                # the chunked scans hold binding stubs: the plan streams
                result = execute_streaming(plan, context)
            else:
                result = RelExecutor(context).execute(plan)
        else:
            result = RelExecutor(context).execute(plan)
    wall_ms = (time.perf_counter() - t0) * 1e3
    snap1 = _tel.REGISTRY.counters()

    def annotate(node):
        r = rec.get(node)
        if r is None:
            return "[not executed]"
        total_ms, rows, calls = r
        child_ms = sum(rec.get(c)[0] for c in node.inputs
                       if rec.get(c) is not None)
        extra = f" calls={calls}" if calls > 1 else ""
        return (f"[rows={rows} time={total_ms:.3f}ms "
                f"self={max(total_ms - child_ms, 0.0):.3f}ms{extra}]")

    if ckey is not None and result is not None:
        cache.put(ckey, result)
    lines = plan.explain(annotate=annotate).splitlines()
    lines.append(f"-- analyzed: wall={wall_ms:.3f}ms "
                 f"rows_out={result.num_rows} nodes={len(rec.records)}")
    lines.append(cache_line)
    lines.extend("-- operator: " + _stats.format_choice(op, variant, info)
                 for op, variant, info in choices)
    lines.append(f"-- tier: {exec_tier}")
    delta = {k: v - snap0.get(k, 0) for k, v in snap1.items()
             if v != snap0.get(k, 0)}
    if delta:
        lines.append("-- counters: " + " ".join(
            f"{k}=+{v}" for k, v in sorted(delta.items())))
    return lines


# ---------------------------------------------------------------------------
# PREPARE / EXECUTE / DEALLOCATE
# ---------------------------------------------------------------------------

def _prepare(stmt: A.PrepareStatement, context, sql):
    context._prepared[stmt.name.lower()] = stmt
    return None


def _execute_prepared(stmt: A.ExecuteStatement, context, sql):
    prep = context._prepared.get(stmt.name.lower())
    if prep is None:
        raise RuntimeError(
            f"Prepared statement {stmt.name!r} does not exist.")
    if len(stmt.params) < prep.num_params:
        raise RuntimeError(
            f"Prepared statement {stmt.name!r} requires {prep.num_params} "
            f"parameters, {len(stmt.params)} given.")
    plan = context._get_plan(prep.query, sql, params=stmt.params)
    _tel.inc("prepared_executes")
    return context._execute_query_plan(plan)


def _deallocate(stmt: A.DeallocateStatement, context, sql):
    if stmt.name is None:
        context._prepared.clear()
    elif context._prepared.pop(stmt.name.lower(), None) is None:
        raise RuntimeError(
            f"Prepared statement {stmt.name!r} does not exist.")
    return None


# ---------------------------------------------------------------------------
# not ported yet
# ---------------------------------------------------------------------------

def _waits_for(what: str, module: str):
    def handler(stmt, context, sql):
        raise NotImplementedError(
            f"{what} is not ported yet: it waits for {module}")
    return handler


_UNPORTED = {
    "CreateTable": ("CREATE TABLE ... WITH (location=...)",
                    "io/inputs.py (its readers are pandas)"),
    "AnalyzeTable": ("ANALYZE TABLE", "a host path without pandas"),
    "CreateMaterializedView": ("CREATE MATERIALIZED VIEW",
                               "runtime/matview.py"),
    "DropMaterializedView": ("DROP MATERIALIZED VIEW", "runtime/matview.py"),
    "RefreshMaterializedView": ("REFRESH MATERIALIZED VIEW",
                                "runtime/matview.py"),
    "InsertInto": ("INSERT INTO",
                   "runtime/delta.py and Context.append_rows"),
    "ShowModels": ("SHOW MODELS", "models/ and register_model"),
    "DescribeModel": ("DESCRIBE MODEL", "models/ and register_model"),
    "CreateModel": ("CREATE MODEL", "models/ and register_model"),
    "DropModel": ("DROP MODEL", "models/ and register_model"),
    "CreateExperiment": ("CREATE EXPERIMENT", "models/ and register_model"),
    "ExportModel": ("EXPORT MODEL", "models/ and register_model"),
}

for _name, (_what, _module) in _UNPORTED.items():
    StatementDispatcher.add_plugin(_name, _waits_for(_what, _module))

StatementDispatcher.add_plugin("CreateSchema", _create_schema)
StatementDispatcher.add_plugin("DropSchema", _drop_schema)
StatementDispatcher.add_plugin("UseSchema", _use_schema)
StatementDispatcher.add_plugin("CreateTableAs", _create_table_as)
StatementDispatcher.add_plugin("DropTable", _drop_table)
StatementDispatcher.add_plugin("ShowSchemas", _show_schemas)
StatementDispatcher.add_plugin("ShowTables", _show_tables)
StatementDispatcher.add_plugin("ShowColumns", _show_columns)
StatementDispatcher.add_plugin("DescribeTable", _describe_table)
StatementDispatcher.add_plugin("ExplainStatement", _explain)
StatementDispatcher.add_plugin("PrepareStatement", _prepare)
StatementDispatcher.add_plugin("ExecuteStatement", _execute_prepared)
StatementDispatcher.add_plugin("DeallocateStatement", _deallocate)
