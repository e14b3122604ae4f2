"""Statement handlers: schemas, tables and views, materialized views,
INSERT INTO, SHOW / DESCRIBE, ANALYZE TABLE, EXPLAIN [ANALYZE], PREPARE /
EXECUTE / DEALLOCATE.

The counterpart of ``dask_sql_tpu/physical/rel/custom.py``: one handler per
statement AST class, registered in ``StatementDispatcher``.  A handler takes
(statement, context, sql text) and returns a device ``Table`` of rows (SHOW,
DESCRIBE, EXPLAIN, EXECUTE) or None (DDL).

The statements whose machinery the port lacks raise ``NotImplementedError``
naming themselves and what they wait for (``_UNPORTED``): CREATE TABLE ...
WITH (location) (the file readers, ``io/inputs.py``), the model statements
(``models/``, with ``register_model``) and EXPLAIN PROFILE
(``runtime/profiler.py``).

Every statement that reads a table's rows (CTAS, INSERT INTO ... SELECT,
ANALYZE TABLE over a view) runs its plan through
``Context._execute_query_plan``, so a chunked table streams and is never
read through its one-row binding stub; ANALYZE TABLE streams a chunked
table's batches one column at a time.
"""
from __future__ import annotations

import datetime
import math
import re
import time

import numpy as np
import torch

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
    reg = context._matviews()
    if reg is not None:
        # replacing a materialized view ends its maintenance
        reg.discard_view(schema_name, name)
    if stmt.view:
        entry = TableEntry(plan=plan)
    else:
        entry = TableEntry(table=context._execute_query_plan(plan))
    context.schema[schema_name].tables[name] = entry
    context.bump_table_epoch(schema_name, name)
    return None


def _create_matview(stmt: A.CreateMaterializedView, context, sql):
    from ...runtime import matview as _mv
    _mv.create_matview(context, stmt.name, stmt.query, sql,
                       if_not_exists=stmt.if_not_exists,
                       or_replace=stmt.or_replace)
    return None


def _drop_matview(stmt: A.DropMaterializedView, context, sql):
    from ...runtime import matview as _mv
    _mv.drop_matview(context, stmt.name, if_exists=stmt.if_exists)
    return None


def _refresh_matview(stmt: A.RefreshMaterializedView, context, sql):
    from ...runtime import matview as _mv
    _mv.refresh_matview(context, stmt.name)
    return None


def _insert_into(stmt: A.InsertInto, context, sql):
    """INSERT INTO: the source query (VALUES is a query too) runs through
    the query path, and its rows go to ``Context.append_rows``.  A column
    list names target columns by position of the source's; the others
    fill NULL."""
    from ...runtime.resilience import SchemaMismatch

    plan = context._get_plan(stmt.query, sql)
    rows = context._execute_query_plan(plan)
    schema_name, name = context.fqn(stmt.table)
    payload = rows
    if stmt.columns is not None:
        if len(stmt.columns) != rows.num_columns:
            raise SchemaMismatch(
                f"INSERT INTO {name} names {len(stmt.columns)} columns but "
                f"the source produces {rows.num_columns}.")
        entry = context.schema[schema_name].tables.get(name)
        if entry is not None and entry.table is not None:
            given = [c.lower() for c in stmt.columns]
            target = list(entry.table.names)
            unknown = [c for c in given
                       if c not in {t.lower() for t in target}]
            if unknown:
                raise SchemaMismatch(
                    f"INSERT INTO {name} names columns {unknown} that the "
                    f"table does not have (columns: {target}).")
            # every target column by name; the unnamed ones fill NULL
            from ...table import Column, Scalar
            by_name = dict(zip(given, rows.columns))
            payload = Table(target, [
                by_name[t.lower()] if t.lower() in by_name
                else Column.from_scalar(Scalar(None, tc.stype),
                                        rows.num_rows, context.device)
                for t, tc in zip(target, entry.table.columns)])
    context.append_rows(name, payload, schema_name=schema_name)
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
# ANALYZE TABLE
# ---------------------------------------------------------------------------

def _analyze_table(stmt: A.AnalyzeTable, context, sql):
    """ANALYZE TABLE: the JAX package's table, which is pandas'
    ``DataFrame.describe(include="all")`` with a ``data_type`` and a
    ``col_name`` row, every cell a string (NULL where describe has none),
    computed here on the table's device (``_describe``).

    A resident table is read from its ``Table``, and a view runs its plan
    through ``Context._execute_query_plan``.  A chunked table is read one
    column at a time (``_chunked_column``): its catalog entry holds only a
    one-row binding stub, and the table does not fit on the device."""
    resolved = context.resolve_table(stmt.table)
    if resolved is None:
        raise AttributeError(f"Table {'.'.join(stmt.table)} is not defined.")
    schema_name, table_name, fields, _ = resolved
    entry = context.schema[schema_name].tables[table_name]
    if entry.chunked is not None:
        source = entry.chunked
        columns = stmt.columns or list(source.names)
        _chunked_budget(source, columns)
        described = [_describe(_chunked_column(source, c, context))
                     for c in columns]
        stypes = [source.stypes[source.names.index(c)] for c in columns]
    else:
        table = (context._execute_query_plan(entry.plan)
                 if entry.table is None else entry.table)
        columns = stmt.columns or table.names
        described = [_describe(table.column(c)) for c in columns]
        stypes = [table.column(c).stype for c in columns]
    # pandas' row order: the columns' statistic lists, shortest first
    # (stable), each name at its first appearance
    names: list = []
    for _, stats in sorted(described, key=lambda d: len(d[1])):
        for k in stats:
            if k not in names:
                names.append(k)
    out = {"statistic": _strings(names + ["data_type", "col_name"])}
    for c, stype, (kind, stats) in zip(columns, stypes, described):
        # an all-integer categorical series reads as int64 unless
        # describe's union of rows gives it NaN, which makes it float64
        as_float = kind == "num" or (kind == "int" and len(names) > len(stats))
        cells = []
        for k in names:
            v = stats.get(k)
            if v is None or (isinstance(v, float) and math.isnan(v)):
                cells.append(None)
            elif as_float:
                cells.append(repr(float(v)))
            else:
                cells.append(str(v))
        cells += [str(stype).lower(), c]
        out[c] = np.array(cells, dtype=object)
    return _meta_table(out, context)


def _chunked_budget(source, columns) -> None:
    """Refuse before any upload a column that would not fit: a column's
    quartiles and most frequent value need all of its rows at once, so
    each column (its data and NULL mask) is gathered on the device, one
    at a time, within the streaming executor's ``DSQL_STREAM_PARTIAL_BYTES``."""
    from ..streaming import PARTIAL_BYTES_BUDGET, StreamingUnsupported

    for c in columns:
        ci = source.names.index(c)
        width = max((b[ci][0].itemsize + (b[ci][1] is not None)
                     for b in source.batches), default=0)
        need = source.n_rows * width
        if need > PARTIAL_BYTES_BUDGET:
            raise StreamingUnsupported(
                f"ANALYZE TABLE needs column {c} whole on the device "
                f"({need} bytes), past DSQL_STREAM_PARTIAL_BYTES "
                f"({PARTIAL_BYTES_BUDGET}); raise it, or name fewer or "
                "narrower columns")


def _chunked_column(source, name: str, context):
    """One column of a chunked table on the device: its batches streamed
    (that column only, the ``chunked_read`` fault site retried) into one
    buffer of its rows and one of its NULL mask, so the device holds one
    column and one batch, never the table."""
    from ...runtime import resilience as _res
    from ...table import Column

    ci = source.names.index(name)
    device = context.device
    data = mask = None
    off = 0
    for bi, enc in enumerate(source.batches):
        _res.check("stream_batch")
        batch, _ = _res.retry_transient(
            lambda: source.batch_table(bi, device, [name]),
            site="chunked_read")
        _tel.inc("stream_batches")
        col = batch.columns[0]
        n = len(enc[ci][0])
        if data is None:
            data = torch.empty(source.n_rows, dtype=col.data.dtype,
                               device=device)
        data[off:off + n].copy_(col.data[:n])
        if col.mask is not None:
            if mask is None:
                mask = torch.ones(source.n_rows, dtype=torch.bool,
                                  device=device)
            mask[off:off + n].copy_(col.mask[:n])
        off += n
    if data is None:
        data = source.schema_table(device).column(name).data[:0]
    return Column(data, source.stypes[ci], mask, source.dictionaries[ci])


_QUANTILES = (("25%", 0.25), ("50%", 0.5), ("75%", 0.75))


def _describe(col) -> tuple:
    """(kind, {statistic: value}) of one column as pandas describes the
    JAX package's host copy of it: numeric columns without NULLs and
    floating ones by count, mean, std (ddof 1), min, linear quartiles and
    max; timestamps and dates by count, mean, min, quartiles and max;
    strings, booleans, times and integers with NULLs (an object column
    there) by count, unique, top and freq, the top's ties going to the
    value seen first.  ``kind``: ``num`` (a float64 series), ``int`` (a
    categorical whose four values are integers), ``obj``."""
    st = col.stype
    valid = col.valid_mask()
    has_nulls = col.mask is not None and not bool(valid.all())
    if st.name in ("TIMESTAMP", "TIMESTAMP_WITH_LOCAL_TIME_ZONE", "DATE"):
        return "obj", _describe_temporal(col, valid)
    if st.is_numeric and st.name != "BOOLEAN" and (
            not has_nulls or col.data.dtype.is_floating_point):
        return "num", _describe_numeric(col.data[valid])
    return _describe_categorical(col, valid)


def _lerp(a, b, t: float) -> float:
    """numpy's linear interpolation (``numpy.lib._function_base_impl._lerp``):
    from the upper neighbour when ``t >= 0.5``."""
    d = b - a
    if t >= 0.5:
        return float(b) - float(d) * (1.0 - t)
    return float(a) + float(d) * t


def _quantiles(sorted_vals: torch.Tensor) -> list:
    """The 25%, 50% and 75% points of sorted values, by numpy's linear
    method; the neighbours are read to the host in one copy."""
    n = int(sorted_vals.numel())
    picks = []
    for _, q in _QUANTILES:
        v = (n - 1) * q          # numpy's virtual index; q < 1
        lo = math.floor(v)
        picks.append((lo, min(lo + 1, n - 1), v - lo))
    idx = torch.tensor([i for lo, hi, _ in picks for i in (lo, hi)],
                       device=sorted_vals.device)
    vals = sorted_vals[idx].tolist()
    return [_lerp(vals[2 * k], vals[2 * k + 1], gamma)
            for k, (_, _, gamma) in enumerate(picks)]


def _describe_numeric(x: torch.Tensor) -> dict:
    n = int(x.numel())
    stats = {"count": float(n)}
    if n == 0:
        stats.update({k: math.nan for k in
                      ("mean", "std", "min", "25%", "50%", "75%", "max")})
        return stats
    xf = x.to(torch.float64)
    total = xf.sum()
    mean = total / n
    sq = ((mean - xf) ** 2).sum()
    srt = torch.sort(x).values
    mean, sq, lo, hi = torch.stack([mean, sq, srt[0].to(torch.float64),
                                    srt[-1].to(torch.float64)]).tolist()
    stats["mean"] = mean
    stats["std"] = math.sqrt(sq / (n - 1)) if n > 1 else math.nan
    stats["min"] = lo
    for (k, _), v in zip(_QUANTILES, _quantiles(srt)):
        stats[k] = v
    stats["max"] = hi
    return stats


def _describe_temporal(col, valid: torch.Tensor) -> dict:
    """pandas reads a DATE as datetime64[s] and a TIMESTAMP as
    datetime64[us]; its mean and quantiles are computed in floats of that
    unit and truncated.  The mean's sum is exact here (two 32-bit halves
    summed in int64), which pandas' float sum is below 2**53."""
    if col.stype.name == "DATE":
        x, unit = col.data[valid].to(torch.int64) * 86400, "s"
    else:
        x, unit = col.data[valid].to(torch.int64), "us"
    n = int(x.numel())
    stats = {"count": n}
    if n == 0:
        stats.update({k: None for k in
                      ("mean", "min", "25%", "50%", "75%", "max")})
        return stats
    hi_part, lo_part = x >> 32, x & 0xFFFFFFFF
    srt = torch.sort(x).values
    s_hi, s_lo, vmin, vmax = torch.stack(
        [hi_part.sum(), lo_part.sum(), srt[0], srt[-1]]).tolist()
    total = (s_hi << 32) + s_lo

    def fmt(v) -> str:
        return str(np.datetime64(int(v), unit).astype(datetime.datetime))

    stats["mean"] = fmt(math.trunc(float(total) / n))
    stats["min"] = fmt(vmin)
    for (k, _), v in zip(_QUANTILES, _quantiles(srt)):
        stats[k] = fmt(math.trunc(v))
    stats["max"] = fmt(vmax)
    return stats


def _describe_categorical(col, valid: torch.Tensor) -> tuple:
    n_rows = col.data.shape[0]
    pos = torch.nonzero(valid).reshape(-1)
    if col.stype.is_string:
        slots = col.data[valid].to(torch.int64)
        counts = torch.bincount(slots, minlength=len(col.dictionary))
    else:
        _, slots, counts = torch.unique(col.data[valid], return_inverse=True,
                                        return_counts=True)
    first = torch.full_like(counts, n_rows).scatter_reduce(0, slots, pos,
                                                           "amin")
    stats = {"count": int(pos.numel()), "unique": int((counts > 0).sum()),
             "top": None, "freq": None}
    if stats["unique"] == 0:
        return "obj", stats
    stats["freq"] = int(counts.max())
    # among the most frequent values, the one seen first
    slot = int(torch.argmin(torch.where(counts == stats["freq"], first,
                                        n_rows + 1)))
    row = torch.tensor([int(first[slot])], device=col.data.device)
    top = stats["top"] = col.take(row).to_pylist()[0]
    return ("int" if isinstance(top, int) and not isinstance(top, bool)
            else "obj"), stats


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
StatementDispatcher.add_plugin("CreateMaterializedView", _create_matview)
StatementDispatcher.add_plugin("DropMaterializedView", _drop_matview)
StatementDispatcher.add_plugin("RefreshMaterializedView", _refresh_matview)
StatementDispatcher.add_plugin("InsertInto", _insert_into)
StatementDispatcher.add_plugin("AnalyzeTable", _analyze_table)
StatementDispatcher.add_plugin("ShowSchemas", _show_schemas)
StatementDispatcher.add_plugin("ShowTables", _show_tables)
StatementDispatcher.add_plugin("ShowColumns", _show_columns)
StatementDispatcher.add_plugin("DescribeTable", _describe_table)
StatementDispatcher.add_plugin("ExplainStatement", _explain)
StatementDispatcher.add_plugin("PrepareStatement", _prepare)
StatementDispatcher.add_plugin("ExecuteStatement", _execute_prepared)
StatementDispatcher.add_plugin("DeallocateStatement", _deallocate)
