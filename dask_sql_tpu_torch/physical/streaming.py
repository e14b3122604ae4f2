"""Streaming (out-of-device-memory) execution over chunked tables.

The counterpart of ``dask_sql_tpu/physical/streaming.py``.  A table bigger
than the card registers as a ``ChunkedSource`` (``io/chunked.py``), and
this module lowers plans over it by ITERATIVE REWRITING: while the plan
still references a chunked scan, find a streamable SPLIT whose subtree
contains exactly that one scan, execute the subtree batch by batch,
materialize its (small) result as a resident temp, and substitute it
back.  Split strategies, tried innermost-first:

  * aggregate: everything below the lowest aggregate runs PER BATCH (same
    shapes and shared dictionaries: one program, replayed for every
    batch); partials merge by algebra (SUM/$SUM0->SUM, COUNT->$SUM0,
    MIN/MAX->self, AVG->(sum,count)+final divide);
  * distinct aggregate: when every call is DISTINCT on one argument (or a
    dedup-invariant MIN/MAX of it), the per-batch plan is a group-by
    DEDUP of (group keys, argument); the final aggregate re-deduplicates
    across batches by construction;
  * top-k: a LIMIT-ed sort streams as per-batch top-(limit+offset), then
    top-k of the concatenated partials;
  * semi/anti key-set: a SEMI/ANTI join whose BUILD (right) side holds the
    chunked scan streams the build as a per-batch DEDUP of the join-key
    (and residual-referenced) columns; the join then runs resident
    against the merged key set;
  * window regroup: a window with PARTITION BY streams its input per batch
    to the host, hash-buckets the rows on the partition keys (whole
    partitions land in one bucket), and runs the window resident per
    equal-capacity bucket; a table-sized window output re-registers as a
    chunked source so streaming continues above it.

Joins on a streamed path keep the build (resident) side fixed: subtrees
not containing the chunked scan are materialized ONCE into temp tables and
reused across batches.  Multiple chunked scans (TPC-H Q17/Q21 read
lineitem two or three times) lower one subtree per iteration.  An INNER
equi-join with a chunked scan on BOTH sides lowers via the grace-hash
partitioned join in ``physical/morsel.py`` when spilling is enabled
(``DSQL_SPILL_MB > 0``).

Per batch: ``resilience.check("stream_batch")``, a ``stream_batch`` span
with the batch index and its ``upload_bytes``, the upload of the columns
the scan reads (the ``chunked_read`` fault site, retried), then the
compiled tier with the eager executor where it declines.  On the card the batch table is a
copied input of the program's CUDA graph (``compiled._copied_positions``),
so a batch is one device copy and one replay: a query takes at most two
captures per streamed program (the full batch and the padded last one).
Partial results come to the host at once (``_host_partial``: one
transfer per batch, or none where the compiled tier's small-result fetch
already holds host copies), so one batch at a time is resident; when
their total size exceeds ``DSQL_STREAM_PARTIAL_BYTES`` the aggregate
merges on the host (``_merge_aggregate_on_host``, a numpy group-by),
and key-set and dedup partials deduplicate after every batch, so the
host working set is bounded by the DISTINCT count, not the row count.

Plans outside every strategy (a window without PARTITION BY over the
chunked scan, no aggregate/limit split, chunked on the NULL-extended side
of an outer join) raise ``StreamingUnsupported`` with a reason, never a
wrong answer on binding stubs.

Under ``Context(mesh=...)`` each uploaded batch is row-sharded over the
mesh (``_set_batch_entry``): out-of-core and over the mesh at once.  On a
mesh in one process (or a world of one rank) the batch is placed whole on
the context's device, as a resident mesh table is, and its plans run on
the compiled tier.  On a mesh across processes of more than one rank each
rank uploads only its rows of every batch (``ChunkedSource.batch_table``'s
``ranks``, ``_batch_ranks``), and the batch entry holds them as a
rank-local catalog entry does (``TableEntry.rank_rows``); a plan that
scans it goes to the SPMD walker first, and where the walker declines it
the tiers run it over the batch gathered whole once
(``_run_resident``).  ``stream_batches`` and ``stream_batch_rows`` count
the global batch on every rank.
"""
from __future__ import annotations

import logging
import os
import threading
from typing import List, Optional

import numpy as np
import torch

from ..datacontainer import TableEntry
from ..plan.nodes import (
    AggCall, Field, LogicalAggregate, LogicalFilter, LogicalJoin,
    LogicalProject, LogicalSort, LogicalTableScan, LogicalWindow, RelNode,
    RexCall, RexInputRef,
)
from ..runtime import (faults as _faults, resilience as _res,
                       telemetry as _tel)
from ..table import (Column, Table, arrays_to_device, dict_sort_order,
                     host_encode_numpy, tensors_to_host)
from ..types import BIGINT, DOUBLE

logger = logging.getLogger(__name__)

STREAM_SCHEMA = "__stream__"
BATCH_TABLE = "batch"

_MERGEABLE = {"SUM", "$SUM0", "COUNT", "MIN", "MAX", "AVG"}

# above this many accumulated partial bytes the merge happens on host
PARTIAL_BYTES_BUDGET = int(os.environ.get("DSQL_STREAM_PARTIAL_BYTES",
                                          str(1 << 30)))


class StreamingUnsupported(_res.UserError):
    """Plan shape the streaming executor cannot run out-of-core.

    A typed UserError: the message always names the remedy, and the
    server maps it to a USER_ERROR payload."""


# ---------------------------------------------------------------------------
# plan inspection
# ---------------------------------------------------------------------------

def _is_chunked_scan(rel: RelNode, context) -> bool:
    if not isinstance(rel, LogicalTableScan):
        return False
    entry = context.schema.get(rel.schema_name, None)
    entry = entry.tables.get(rel.table_name) if entry else None
    return entry is not None and getattr(entry, "chunked", None) is not None


def _chunked_scans(plan: RelNode, context) -> List[LogicalTableScan]:
    from ..plan.nodes import RexScalarSubquery

    out = []

    def walk_rex(rex):
        if isinstance(rex, RexScalarSubquery):
            walk(rex.plan)
        for o in getattr(rex, "operands", []) or []:
            walk_rex(o)

    def walk(rel: RelNode):
        if isinstance(rel, LogicalTableScan):
            if _is_chunked_scan(rel, context):
                out.append(rel)
            return
        for i in rel.inputs:
            walk(i)
        # scalar-subquery plans hide extra scans inside rex trees
        if isinstance(rel, LogicalProject):
            for e in rel.exprs:
                walk_rex(e)
        elif isinstance(rel, LogicalFilter):
            walk_rex(rel.condition)
        elif isinstance(rel, LogicalJoin) and rel.condition is not None:
            walk_rex(rel.condition)

    walk(plan)
    return out


def plan_references_chunked(plan: RelNode, context) -> bool:
    return bool(_chunked_scans(plan, context))


def _path_to(plan: RelNode, target: RelNode) -> Optional[List[RelNode]]:
    """Nodes from root to target (inclusive), by identity."""
    if plan is target:
        return [plan]
    for i in plan.inputs:
        sub = _path_to(i, target)
        if sub is not None:
            return [plan] + sub
    return None


def _replace(plan: RelNode, old: RelNode, new: RelNode) -> RelNode:
    if plan is old:
        return new
    if not plan.inputs:
        return plan
    return plan.with_inputs([_replace(i, old, new) for i in plan.inputs])


# ---------------------------------------------------------------------------
# execution plumbing
# ---------------------------------------------------------------------------

def _run_tiers(plan: RelNode, context) -> Table:
    from .compiled import try_execute_compiled
    from .rel.executor import RelExecutor

    result = try_execute_compiled(plan, context)
    if result is None:
        result = RelExecutor(context).execute(plan)
    return result


def _scans_rank_local(plan: RelNode, context) -> bool:
    """Whether ``plan`` scans a ``__stream__`` entry that holds this rank's
    rows only (a batch on a mesh across processes)."""
    if not getattr(context, "_rank_local", False):
        return False
    temps = context.schema.get(STREAM_SCHEMA)
    if temps is None:
        return False
    from ..runtime.ingest import _collect_scans

    scans: list = []
    _collect_scans(plan, scans)
    return any(s.schema_name == STREAM_SCHEMA and getattr(
        temps.tables.get(s.table_name), "rank_rows", None) is not None
        for s in scans)


def _run_resident(plan: RelNode, context) -> Table:
    """``plan`` on the resident tiers: the compiled tier, the eager
    executor where it declines.  A plan that scans a rank-local batch
    goes to the SPMD walker first, over this rank's rows
    (``stream_tier=spmd`` on the span); where the walker declines it or a
    runtime flag trips (alike on every rank) the tiers run it over the
    batch gathered whole once (``parallel.gather.whole_tables``,
    ``stream_tier=gathered``), after the previous batch's gathered
    columns were dropped, so that at most one gathered batch is resident.
    The streamed plan's resident tables are pinned whole already
    (``Context._whole_tables``): their columns are cached and not gathered
    again.  Called under ``_EXEC_LOCK``; the walker and the gather take
    ``mesh.group.lock`` inside it, never the other way round (neither the
    compiled tier's stage workers nor its background builds take
    either)."""
    if not _scans_rank_local(plan, context):
        return _run_tiers(plan, context)
    from ..parallel import gather
    from ..parallel.spmd import try_execute_spmd

    result = try_execute_spmd(plan, context)
    if result is not None:
        _tel.annotate(stream_tier="spmd")
        return result
    gather.drop_schema(context, STREAM_SCHEMA)
    _tel.annotate(stream_tier="gathered")
    with gather.whole_tables(context, plan):
        return _run_tiers(plan, context)


_tmp_counter = [0]   # temp names of the running query (reset per query)

# execute_streaming serialization (see its docstring): one streaming query
# at a time per process; depth per context id so only the outermost frame
# of a same-thread nesting pops the temp schema
_EXEC_LOCK = threading.RLock()
_exec_depth: dict = {}


def _ensure_schema(context) -> None:
    if STREAM_SCHEMA not in context.schema:
        context.create_schema(STREAM_SCHEMA)


def _register_temp(context, table: Table, row_valid=None) -> LogicalTableScan:
    """Register a materialized table under __stream__ and return its scan."""
    _ensure_schema(context)
    _tmp_counter[0] += 1
    name = f"t{_tmp_counter[0]}"
    # intermediate schemas may carry duplicate/empty names; ordinals are
    # what matter downstream, so names are sanitized for registration
    names = [f"c{i}" for i in range(table.num_columns)]
    table = table.with_names(names)
    context.schema[STREAM_SCHEMA].tables[name] = TableEntry(
        table=table, row_valid=row_valid)
    fields = [Field(n, c.stype) for n, c in zip(names, table.columns)]
    return LogicalTableScan(schema_name=STREAM_SCHEMA, table_name=name,
                            schema=fields)


def _register_temp_typed(context, table: Table, fields) -> LogicalTableScan:
    """Register a temp table and return its scan RE-TYPED to ``fields``'
    stypes (temp registration sanitizes names; ordinals carry meaning)."""
    return _retype(_register_temp(context, table), fields)


def _retype(scan: LogicalTableScan, fields) -> LogicalTableScan:
    return LogicalTableScan(
        schema_name=scan.schema_name, table_name=scan.table_name,
        schema=[Field(f2.name, f1.stype)
                for f1, f2 in zip(fields, scan.schema)])


def _register_chunked_temp(context, source) -> str:
    """Register ``source`` as a chunked temp under __stream__; its name."""
    _ensure_schema(context)
    _tmp_counter[0] += 1
    name = f"t{_tmp_counter[0]}"
    context.schema[STREAM_SCHEMA].tables[name] = TableEntry(
        table=source.schema_table(context.device), chunked=source)
    return name


def _batch_ranks(context):
    """The rank slice a batch upload takes (``ChunkedSource.batch_table``'s
    ``ranks``): the mesh of a context whose catalog holds each rank's rows
    (a mesh across processes of more than one rank), else None."""
    return context.mesh if getattr(context, "_rank_local", False) else None


def _set_batch_entry(context, table: Table, row_valid,
                     name: str = BATCH_TABLE, rank_rows=None) -> None:
    """The ``__stream__`` entry ``name`` (the batch, a window bucket, a
    grace pair side).  ``rank_rows``: the batch holds this rank's rows of
    the global padded batch (``ChunkedSource.batch_rank_rows``), kept as
    it is, as a rank-local catalog entry; otherwise under a mesh the
    batch is placed whole."""
    _ensure_schema(context)
    if rank_rows is None and getattr(context, "mesh", None) is not None \
            and name == BATCH_TABLE:
        # streaming x mesh: the uploaded batch is row-sharded over the
        # mesh, its row_valid ANDed into the shard validity, so that the
        # batch's program runs over the mesh table as a resident one does
        from ..parallel.mesh import shard_table_with_validity
        table, shard_valid = shard_table_with_validity(table, context.mesh)
        if row_valid is not None:
            n = (len(shard_valid) if shard_valid is not None
                 else table.num_rows)
            rv = torch.zeros(n, dtype=torch.bool, device=row_valid.device)
            rv[:len(row_valid)] = row_valid
            row_valid = rv if shard_valid is None else (rv & shard_valid)
        else:
            row_valid = shard_valid
    context.schema[STREAM_SCHEMA].tables[name] = TableEntry(
        table=table, row_valid=row_valid, rank_rows=rank_rows)


def _cleanup(context) -> None:
    context.schema.pop(STREAM_SCHEMA, None)
    if getattr(context, "_rank_local", False):
        # no gathered batch outlives its query, on the error path neither
        from ..parallel.gather import drop_schema
        drop_schema(context, STREAM_SCHEMA)
    # grace-hash joins (physical/morsel.py) spill partition/output runs;
    # free them on the error path too, so a failed query leaks no bytes
    runs = getattr(context, "_spill_runs", None)
    if runs:
        from ..runtime import spill as _spill
        store = _spill.get_store()
        for r in runs:
            store.free_run(r)
        runs.clear()


def _stream_partial_plans(subtree: RelNode, scan: LogicalTableScan,
                          path: List[RelNode], context) -> RelNode:
    """The per-batch subtree: ``subtree`` with (a) the chunked scan replaced
    by the batch scan and (b) off-path join subtrees pre-materialized.
    ``path`` is any root-to-scan node list covering the subtree."""
    path_ids = {id(p) for p in path}

    def rebuild(rel: RelNode) -> RelNode:
        if rel is scan:
            fields = list(scan.schema)
            return LogicalTableScan(schema_name=STREAM_SCHEMA,
                                    table_name=BATCH_TABLE, schema=fields)
        if id(rel) not in path_ids:
            # off the streamed path: resident, materialized once
            if isinstance(rel, LogicalTableScan):
                if _is_chunked_scan(rel, context):
                    raise StreamingUnsupported(
                        "a second chunked table feeds the streamed subtree")
                return rel
            t = _run_resident(rel, context)
            row_valid = None
            if getattr(context, "_rank_local", False):
                # whole on every rank, its length a multiple of the mesh
                # size, so that the walker can split it beside a
                # rank-local batch
                from ..parallel.mesh import shard_table_with_validity
                t, row_valid = shard_table_with_validity(t, context.mesh)
            return _retype(_register_temp(context, t, row_valid),
                           rel.schema)
        if isinstance(rel, LogicalJoin):
            left_on = any(id(rel.left) == id(p) for p in path) or rel.left is scan
            jt = rel.join_type
            ok = (jt == "INNER"
                  or (jt in ("LEFT", "SEMI", "ANTI") and left_on)
                  or (jt == "RIGHT" and not left_on))
            if not ok:
                raise StreamingUnsupported(
                    f"{jt} join with the chunked table on the NULL-extended "
                    "side cannot stream (every build row must see all probe "
                    "rows)")
        if isinstance(rel, LogicalWindow):
            # a window executed per batch sees only that batch's slice of
            # each partition; _find_split gives windows their own
            # regrouping split, so one on the streamed path cannot run
            raise StreamingUnsupported(
                "window function on the streamed path cannot run per batch")
        return rel.with_inputs([rebuild(i) for i in rel.inputs])

    return rebuild(subtree)


def _partial_and_merge_aggs(agg: LogicalAggregate):
    """(partial_aggs, partial_fields, merge_aggs, post_exprs, needs_project)

    Partial layout: one column per non-AVG call, (sum, count) for AVG.
    Merge layout mirrors the partial layout; post_exprs map the merged
    columns back to agg.schema (the AVG division happens here).
    """
    gk = len(agg.group_keys)
    partial_aggs: List[AggCall] = []
    partial_fields: List[Field] = []
    merge_aggs: List[AggCall] = []
    post_exprs: List = []
    needs_project = False
    agg_fields = agg.schema[gk:]
    for call, field in zip(agg.aggs, agg_fields):
        if call.udaf is not None or call.distinct:
            raise StreamingUnsupported(
                f"{'DISTINCT ' if call.distinct else ''}{call.op} does not "
                "merge across batches")
        if call.op not in _MERGEABLE:
            raise StreamingUnsupported(f"aggregate {call.op} does not merge")
        base = gk + len(partial_aggs)
        if call.op == "AVG":
            needs_project = True
            s_st = field.stype if field.stype.name in ("DOUBLE", "FLOAT",
                                                       "DECIMAL") else DOUBLE
            partial_aggs.append(AggCall("SUM", list(call.args), False, s_st,
                                        f"{field.name}$sum",
                                        filter_arg=call.filter_arg))
            partial_aggs.append(AggCall("COUNT", list(call.args), False,
                                        BIGINT, f"{field.name}$cnt",
                                        filter_arg=call.filter_arg))
            partial_fields.append(Field(f"{field.name}$sum", s_st))
            partial_fields.append(Field(f"{field.name}$cnt", BIGINT))
            merge_aggs.append(AggCall("SUM", [base], False, s_st,
                                      f"{field.name}$sum"))
            merge_aggs.append(AggCall("$SUM0", [base + 1], False, BIGINT,
                                      f"{field.name}$cnt"))
            post_exprs.append(("avg", base, base + 1, field))
        else:
            merge_op = {"SUM": "SUM", "$SUM0": "$SUM0", "COUNT": "$SUM0",
                        "MIN": "MIN", "MAX": "MAX"}[call.op]
            partial_aggs.append(AggCall(call.op, list(call.args), False,
                                        field.stype, field.name,
                                        filter_arg=call.filter_arg))
            partial_fields.append(Field(field.name, field.stype))
            merge_aggs.append(AggCall(merge_op, [base], False, field.stype,
                                      field.name))
            post_exprs.append(("ref", base, None, field))
    return partial_aggs, partial_fields, merge_aggs, post_exprs, needs_project


def _distinct_dedup_shape(agg: LogicalAggregate) -> Optional[int]:
    """The single argument column index when this aggregate can stream as a
    per-batch dedup: every call is DISTINCT on that one argument, or a
    dedup-invariant MIN/MAX of it.  (Mixed distinct arguments or plain
    SUM/COUNT alongside a DISTINCT cannot share one dedup stream.)"""
    arg: Optional[int] = None
    for call in agg.aggs:
        if call.udaf is not None or not call.args:
            return None
        a = call.args[0]
        if call.distinct:
            if call.op not in ("COUNT", "SUM", "AVG", "MIN", "MAX"):
                return None
        elif call.op not in ("MIN", "MAX"):
            return None
        if call.filter_arg is not None:
            return None
        if arg is None:
            arg = a
        elif arg != a:
            return None
    return arg


# ---------------------------------------------------------------------------
# host-side partial accumulation
# ---------------------------------------------------------------------------

def _host_partial(result: Table) -> tuple:
    """Fetch a partial result to the host NOW: streaming's memory bound is
    one batch resident at a time, so partial outputs must not pin device
    buffers across iterations.  Returns (names, per-col host tuples).

    One device-to-host transfer of every column (``tensors_to_host``), or
    none where the compiled tier's small-result fetch already keeps host
    copies (``Column.host``).  The transfer is the ``host_transfer`` fault
    site, retried (the device buffers stay alive until it lands)."""
    if all(c.host is not None for c in result.columns):
        return (list(result.names),
                [(np.asarray(c.host[0]), c.host[1], c.stype, c.dictionary)
                 for c in result.columns])

    def fetch():
        _faults.maybe_fail("host_transfer")
        bufs = []
        for c in result.columns:
            bufs.append(c.data)
            if c.mask is not None:
                bufs.append(c.mask)
        return tensors_to_host(bufs)

    host = iter(_res.retry_transient(fetch, site="host_transfer"))
    cols = []
    for c in result.columns:
        data = next(host)
        mask = next(host) if c.mask is not None else None
        cols.append((data, mask, c.stype, c.dictionary))
    return (list(result.names), cols)


def _partial_bytes(partials: List[tuple]) -> int:
    total = 0
    for _, cols in partials:
        for data, mask, _, _ in cols:
            total += data.nbytes + (mask.nbytes if mask is not None else 0)
    return total


def _concat_host(partials: List[tuple]):
    """Concatenate host partials column-wise; returns (names, cols) in the
    _host_partial layout.  Dictionaries must agree (they do when every
    batch ran the same program over the shared global dictionaries); a
    diverging eager batch triggers a decode + re-encode."""
    names, first_cols = partials[0]
    ncols = len(first_cols)
    out = []
    for ci in range(ncols):
        per = [p[1][ci] for p in partials]
        stype, d0 = per[0][2], per[0][3]
        same_dict = all(
            d is d0 or (d is not None and d0 is not None
                        and len(d) == len(d0) and (d == d0).all())
            for _, _, _, d in per)
        if not same_dict:
            decoded = np.concatenate([
                d[np.clip(data, 0, len(d) - 1)].astype(object)
                for data, _, _, d in per])
            data, m, st, d = host_encode_numpy(decoded)
            mask = np.concatenate(
                [m if m is not None else np.ones(len(dd), bool)
                 for dd, m, _, _ in per])
            if m is not None:
                mask &= m
            out.append((data, mask if not mask.all() else None, st, d))
            continue
        data = np.concatenate([data for data, _, _, _ in per])
        if any(m is not None for _, m, _, _ in per):
            mask = np.concatenate(
                [m if m is not None else np.ones(len(dd), bool)
                 for dd, m, _, _ in per])
        else:
            mask = None
        out.append((data, mask, stype, d0))
    return names, out


def _host_cols_to_table(cols, device, pad_to: Optional[int] = None) -> Table:
    """A device table of host columns, uploaded together (each padded with
    zeros, a mask with False, to ``pad_to`` rows when given)."""
    arrays = []
    for data, mask, _, _ in cols:
        arrays.append(data)
        if mask is not None:
            arrays.append(mask)
    tensors = iter(arrays_to_device(arrays, device, pad_to=pad_to))
    device_cols = []
    for _data, mask, stype, d in cols:
        dev = next(tensors)
        m = next(tensors) if mask is not None else None
        device_cols.append(Column(dev, stype, m, d))
    return Table([f"c{i}" for i in range(len(cols))], device_cols)


def _host_cols_to_temp(names, cols, context) -> LogicalTableScan:
    return _register_temp(context, _host_cols_to_table(cols, context.device))


def _dedup_host(names, cols):
    """Row-dedup host partials (NULL-aware): the incremental bound for
    key-set and distinct-dedup streams."""
    if not cols or not len(cols[0][0]):
        return names, cols
    keys = []
    for data, mask, _, _ in cols:
        if data.dtype.kind in "fc":
            # NaN needs its own channel: nan_to_num would merge NaN with 0
            keys.append(np.nan_to_num(data, nan=0.0))
            keys.append(np.isnan(data))
        else:
            keys.append(data)
        keys.append(np.ones(len(data), bool) if mask is None else mask)
    order = np.lexsort(tuple(reversed(keys)))
    stacked = [k[order] for k in keys]
    n = len(order)
    diff = np.zeros(n, dtype=bool)
    diff[0] = True
    for k in stacked:
        diff[1:] |= k[1:] != k[:-1]
    keep = order[diff]
    keep.sort()
    out = []
    for data, mask, stype, d in cols:
        out.append((data[keep], None if mask is None else mask[keep],
                    stype, d))
    return names, out


def _null_of(data: np.ndarray, mask: Optional[np.ndarray]) -> np.ndarray:
    """Rows that are NULL for the host merge: masked, or a float NaN (the
    JAX package's pandas merge treats NaN as missing)."""
    null = (np.zeros(len(data), bool) if mask is None else ~mask)
    if data.dtype.kind == "f":
        null = null | np.isnan(data)
    return null


def _group_ids(cols, gk: int):
    """(group id per row, number of groups) over the first ``gk`` columns,
    NULL keys forming one group per column (pandas ``dropna=False``),
    numbered by first appearance (pandas ``sort=False``)."""
    n = len(cols[0][0]) if cols else 0
    if gk == 0:
        return np.zeros(n, dtype=np.int64), (1 if n else 0)
    parts = []
    for data, mask, _, _ in cols[:gk]:
        null = _null_of(data, mask)
        if data.dtype.kind == "f":
            # -0.0 groups with +0.0
            key = np.where(null, 0.0, data.astype(np.float64) + 0.0)
        else:
            key = np.where(null, 0, data.astype(np.int64))
        parts.extend([null, key])
    order = np.lexsort(tuple(reversed(parts)))
    starts = np.ones(n, dtype=bool)
    for p in parts:
        s = p[order]
        starts[1:] &= s[1:] == s[:-1]
    starts = ~starts
    if n:
        starts[0] = True
    sorted_ids = np.cumsum(starts) - 1
    n_groups = int(sorted_ids[-1]) + 1 if n else 0
    # renumber by first appearance
    first = np.full(n_groups, n, dtype=np.int64)
    np.minimum.at(first, sorted_ids, order)
    rank = np.empty(n_groups, dtype=np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(n_groups)
    ids = np.empty(n, dtype=np.int64)
    ids[order] = rank[sorted_ids]
    return ids, n_groups


def _merge_host_column(op: str, data, mask, d, ids, n_groups):
    """One merged aggregate column: (data, mask) over ``n_groups``."""
    null = _null_of(data, mask)
    valid = ~null
    counts = np.bincount(ids[valid], minlength=n_groups)
    if op in ("SUM", "$SUM0"):
        if data.dtype.kind in "iub":
            # integer partials sum exactly in int64, never through floats
            vals = np.where(valid, data.astype(np.int64), 0)
            out = np.zeros(n_groups, dtype=np.int64)
            np.add.at(out, ids, vals)
            out = out.astype(data.dtype if data.dtype.kind != "b"
                             else np.int64)
        else:
            vals = np.where(valid, data, 0.0)
            out = np.bincount(ids, weights=vals,
                              minlength=n_groups).astype(data.dtype)
        if op == "$SUM0":
            return out, None
        # SUM over only-NULL partials stays NULL (pandas' min_count=1)
        m = counts > 0
        return out, (None if m.all() else m)
    # MIN / MAX: strings by collation rank in the shared dictionary,
    # integers exactly in int64
    if d is not None:
        order = dict_sort_order(d)
        ranks = np.empty(len(order), dtype=np.int64)
        ranks[order] = np.arange(len(order))
        key = ranks[np.clip(data, 0, len(d) - 1)]
    elif data.dtype.kind in "iub":
        key = data.astype(np.int64)
    else:
        key = data.astype(np.float64)
    if key.dtype.kind == "f":
        fill = np.inf if op == "MIN" else -np.inf
    else:
        info = np.iinfo(np.int64)
        fill = info.max if op == "MIN" else info.min
    best = np.full(n_groups, fill, dtype=key.dtype)
    (np.minimum if op == "MIN" else np.maximum).at(best, ids[valid],
                                                   key[valid])
    # the first row that attains its group's extreme carries the value
    rows = np.flatnonzero(valid & (key == best[ids]))[::-1]
    pick = np.zeros(n_groups, dtype=np.int64)
    pick[ids[rows]] = rows
    out = data[pick] if len(data) else np.zeros(n_groups, data.dtype)
    m = counts > 0
    return out, (None if m.all() else m)


def _merge_aggregate_on_host(names, cols, gk: int, merge_aggs, group_fields,
                             context) -> LogicalTableScan:
    """Out-of-device-memory final merge: a numpy group-by over the host
    partials (the partial algebra is SUM/$SUM0/MIN/MAX only), then a small
    device temp of the merged result.  The JAX package's pandas merge, by
    its rules: NULL group keys form one group; SUM over only-NULL partials
    is NULL and $SUM0 is 0; integer sums stay exact int64; every column
    keeps its partial's type."""
    ids, n_groups = _group_ids(cols, gk)
    first = np.full(n_groups, len(ids), dtype=np.int64)
    np.minimum.at(first, ids, np.arange(len(ids)))
    out = []
    for data, mask, stype, d in cols[:gk]:
        null = _null_of(data, mask)[first]
        out.append((data[first], None if not null.any() else ~null,
                    stype, d))
    for j, call in enumerate(merge_aggs):
        data, mask, stype, d = cols[gk + j]
        mdata, mmask = _merge_host_column(call.op, data, mask, d, ids,
                                          n_groups)
        out.append((mdata, mmask, stype, d))
    return _register_temp(context, _host_cols_to_table(out, context.device))


# ---------------------------------------------------------------------------
# batch loop
# ---------------------------------------------------------------------------

def _scan_columns(scan: LogicalTableScan) -> List[str]:
    """The columns a chunked scan reads: its batches upload only these."""
    return [f.name for f in scan.schema]


def _run_batches(partial_plan: RelNode, source, context, columns,
                 dedup_each_batch: bool = False) -> List[tuple]:
    acc: List[tuple] = []
    ranks = _batch_ranks(context)
    for bi in range(source.n_batches):
        # per-batch checkpoint: a cancelled/over-deadline query stops
        # between batches, not after the remaining uploads
        _res.check("stream_batch")
        with _tel.span("stream_batch", index=bi):
            table, row_valid = _res.retry_transient(
                lambda: source.batch_table(bi, context.device, columns,
                                           ranks),
                site="chunked_read")
            # the global batch's rows, also where this rank uploaded only
            # its part of it
            _tel.inc("stream_batches")
            _tel.inc("stream_batch_rows", int(source.batch_rows))
            _set_batch_entry(
                context, table, row_valid,
                rank_rows=(None if ranks is None
                           else source.batch_rank_rows(bi, ranks)))
            result = _run_resident(partial_plan, context)
            # the (small, post-aggregate) partial comes to the host NOW:
            # at most one batch stays resident on the device
            acc.append(_host_partial(result))
            _tel.annotate(partial_rows=result.num_rows)
        if dedup_each_batch and len(acc) > 1:
            names, cols = _dedup_host(*_concat_host(acc))
            acc = [(names, cols)]
        logger.debug("streamed batch %d/%d -> %d partial rows", bi + 1,
                     source.n_batches, result.num_rows)
    return acc


# ---------------------------------------------------------------------------
# split strategies: each streams ONE subtree and returns (old_subtree,
# replacement node)
# ---------------------------------------------------------------------------

def _stream_aggregate_split(agg: LogicalAggregate, scan, path, source,
                            context) -> RelNode:
    gk = len(agg.group_keys)
    dedup_arg = None
    if any(c.distinct for c in agg.aggs):
        dedup_arg = _distinct_dedup_shape(agg)
        if dedup_arg is None:
            raise StreamingUnsupported(
                "DISTINCT aggregates mixed with non-dedup-invariant calls "
                "do not merge across batches")

    below = _stream_partial_plans(agg.inputs[0], scan, path, context)
    group_fields = agg.schema[:gk]

    if dedup_arg is not None:
        # per-batch dedup of (group keys, argument); the final aggregate's
        # own DISTINCT re-deduplicates across batches
        in_fields = below.schema
        dd_fields = [Field(f.name, f.stype) for f in group_fields]
        dd_fields.append(Field("arg", in_fields[dedup_arg].stype))
        partial_plan = LogicalAggregate(
            input=below, group_keys=list(agg.group_keys) + [dedup_arg],
            aggs=[], schema=dd_fields)
        partials = _run_batches(partial_plan, source, context,
                                _scan_columns(scan),
                                dedup_each_batch=True)
        names, cols = _dedup_host(*_concat_host(partials))
        ptmp = _retype(_host_cols_to_temp(names, cols, context), dd_fields)
        final_aggs = [
            AggCall(c.op, [gk], c.distinct, c.stype, c.name)
            for c in agg.aggs]
        return agg, LogicalAggregate(input=ptmp,
                                     group_keys=list(range(gk)),
                                     aggs=final_aggs,
                                     schema=list(agg.schema))

    (partial_aggs, partial_fields, merge_aggs, post_exprs,
     needs_project) = _partial_and_merge_aggs(agg)
    partial_schema = list(group_fields) + partial_fields
    partial_plan = LogicalAggregate(input=below,
                                    group_keys=list(agg.group_keys),
                                    aggs=partial_aggs, schema=partial_schema)

    partials = _run_batches(partial_plan, source, context,
                            _scan_columns(scan))

    names, cols = _concat_host(partials)
    merge_schema = list(group_fields) + [
        Field(a.name, a.stype) for a in merge_aggs]
    if gk > 0 and _partial_bytes(partials) > PARTIAL_BYTES_BUDGET:
        # high-cardinality GROUP BY: merging on the device would
        # materialize a temp bigger than the budget; merge on the host
        # (global aggregates have one-row partials: device merge always)
        logger.info("streaming: %d partial bytes exceed budget; merging "
                    "on host", _partial_bytes(partials))
        merge = _retype(_merge_aggregate_on_host(
            names, cols, gk, merge_aggs, group_fields, context),
            merge_schema)
        final: RelNode = merge
    else:
        ptmp = _retype(_host_cols_to_temp(names, cols, context),
                       partial_schema)
        final = LogicalAggregate(input=ptmp,
                                 group_keys=list(range(gk)),
                                 aggs=merge_aggs, schema=merge_schema)
    if needs_project:
        exprs = [RexInputRef(i, f.stype) for i, f in enumerate(group_fields)]
        for kind, i, j, field in post_exprs:
            if kind == "ref":
                exprs.append(RexInputRef(i, field.stype))
            else:
                num = RexInputRef(i, merge_schema[i].stype)
                den = RexCall("CAST", [RexInputRef(j, BIGINT)], DOUBLE,
                              info=DOUBLE)
                exprs.append(RexCall("/", [num, den], field.stype))
        final = LogicalProject(input=final, exprs=exprs,
                               schema=list(agg.schema))
    return agg, final


def _stream_topk_split(sort: LogicalSort, scan, path, source,
                       context) -> RelNode:
    keep = (sort.limit or 0) + (sort.offset or 0)
    below = _stream_partial_plans(sort.inputs[0], scan, path, context)
    partial_plan = LogicalSort(input=below, collation=sort.collation,
                               offset=0, limit=keep,
                               schema=list(sort.schema))
    partials = _run_batches(partial_plan, source, context,
                            _scan_columns(scan))

    names, cols = _concat_host(partials)
    ptmp = _retype(_host_cols_to_temp(names, cols, context), sort.schema)
    final = LogicalSort(input=ptmp, collation=sort.collation,
                        offset=sort.offset, limit=sort.limit,
                        schema=list(sort.schema))
    return sort, final


def _bucket_ids(cols, keys: List[int], n_buckets: int) -> np.ndarray:
    """FNV-style row hash of the partition-key columns (host numpy).
    String columns hash their dictionary CODES (all batches share the
    global dictionaries, so equal values have equal codes); floats
    canonicalize NaN into its own channel."""
    total = len(cols[0][0]) if cols else 0
    if n_buckets <= 1:
        return np.zeros(total, dtype=np.int64)
    h = np.zeros(total, dtype=np.uint64)
    P = np.uint64(1099511628211)
    NAN_SALT = np.uint64(0x9E3779B97F4A7C15)
    for k in keys:
        data, mask, _, _ = cols[k]
        if data.dtype.kind == "f":
            isnan = np.isnan(data)
            # + 0.0 folds -0.0 into +0.0, as the resident engine's keys do
            canon = np.where(isnan, 0.0, data).astype(np.float64) + 0.0
            part = canon.view(np.uint64) ^ (isnan.astype(np.uint64)
                                            * NAN_SALT)
        else:
            part = data.astype(np.int64, copy=False).view(np.uint64)
        if mask is not None:
            # data under a NULL slot is arbitrary: every NULL key hashes
            # alike
            part = np.where(mask, part, np.uint64(0))
            h = (h ^ mask.astype(np.uint64)) * P
        h = (h ^ part) * P
    return (h % np.uint64(n_buckets)).astype(np.int64)


def _stream_window_split(win: LogicalWindow, scan, path, source, context):
    """Window over a chunked scan: stream the below-window subtree per
    batch, regroup the (host) rows into hash buckets of the PARTITION BY
    keys, and run the window resident per bucket: every partition lands
    wholly inside one bucket, so any ORDER BY / frame inside it is exact.
    Buckets pad to one shared capacity: one program, replayed per
    bucket."""
    common: Optional[set] = None
    for call in win.calls:
        if not call.partition:
            raise StreamingUnsupported(
                "window without PARTITION BY over a chunked table needs the "
                "whole input resident at once")
        common = (set(call.partition) if common is None
                  else common & set(call.partition))
    if not common:
        raise StreamingUnsupported(
            "window calls share no PARTITION BY column to regroup on")
    keys = sorted(common)

    below = _stream_partial_plans(win.inputs[0], scan, path, context)
    # the bare below-window subtree per batch: results are compacted, so
    # host partials hold exactly the real rows
    partials = _run_batches(below, source, context, _scan_columns(scan))
    names, cols = _concat_host(partials)
    total = len(cols[0][0]) if cols else 0

    n_buckets = max(1, -(-total // max(int(source.batch_rows), 1)))
    ids = _bucket_ids(cols, keys, n_buckets)
    # one stable argsort + boundary search, not an O(rows x buckets) scan
    order = np.argsort(ids, kind="stable")
    bounds = np.searchsorted(ids[order], np.arange(n_buckets + 1))
    selections = [order[bounds[b]:bounds[b + 1]]
                  for b in range(n_buckets) if bounds[b] < bounds[b + 1]]
    if not selections:
        selections = [np.arange(0)]
    cap = max(len(s) for s in selections)
    if cap > 2 * int(source.batch_rows):
        # hash skew / one giant partition: the shared capacity exceeds the
        # batch size, weakening the out-of-core bound to ~cap resident
        # rows.  Partitions must stay whole, so it cannot be tighter; it
        # must never weaken silently
        logger.warning(
            "streaming window: partition skew — largest bucket %d rows vs "
            "batch_rows %d; device working set for the window step is "
            "~%.1fx the configured bound", cap, int(source.batch_rows),
            cap / max(int(source.batch_rows), 1))

    import torch

    fields = [Field(f.name, f.stype) for f in below.schema]
    batch_scan = LogicalTableScan(schema_name=STREAM_SCHEMA,
                                  table_name=BATCH_TABLE, schema=fields)
    win_plan = LogicalWindow(input=batch_scan, calls=list(win.calls),
                             schema=list(win.schema))

    out_parts: List[tuple] = []
    for sel in selections:
        bcols = [(data[sel], None if mask is None else mask[sel], stype, d)
                 for data, mask, stype, d in cols]
        btable = _host_cols_to_table(bcols, context.device,
                                     pad_to=cap).with_names(names)
        # ALWAYS pass row_valid: the program key holds its presence, so
        # the one full (pad == 0) bucket would otherwise take a second
        # program
        row_valid = torch.arange(cap, device=context.device) < len(sel)
        with _tel.span("stream_batch", bucket_rows=len(sel)):
            # whole on every rank of a mesh across processes too: the
            # bucket is built on the host from the below-window rows,
            # which every rank holds whole (each batch's result came to
            # every rank), and the walker declines a LogicalWindow
            # (spmd._gate_plan), so a rank-local bucket would only be
            # gathered back whole
            _set_batch_entry(context, btable, row_valid)
            result = _run_resident(win_plan, context)
            _tel.inc("stream_batches")
            out_parts.append(_host_partial(result))
        logger.debug("window bucket -> %d rows", result.num_rows)

    out_names, out_cols = _concat_host(out_parts)
    if _partial_bytes(out_parts) <= PARTIAL_BYTES_BUDGET:
        tmp = _retype(_host_cols_to_temp(out_names, out_cols, context),
                      win.schema)
        return win, tmp
    # table-sized window output: re-register as a CHUNKED source so the
    # strategies above the window keep streaming instead of materializing
    from ..io.chunked import ChunkedSource

    br = max(int(source.batch_rows), 1)
    out_total = len(out_cols[0][0]) if out_cols else 0
    batches = []
    for s0 in range(0, max(out_total, 1), br):
        batches.append([(data[s0:s0 + br],
                         None if mask is None else mask[s0:s0 + br])
                        for data, mask, _, _ in out_cols])
    src = ChunkedSource([f"c{i}" for i in range(len(out_cols))],
                        [f.stype for f in win.schema],
                        [d for _, _, _, d in out_cols],
                        batches, out_total, br)
    name = _register_chunked_temp(context, src)
    # sanitized c{i} names on BOTH the source and the scan: downstream
    # nodes reference ordinals, and the executor matches scan fields to
    # table columns by name
    return win, LogicalTableScan(
        schema_name=STREAM_SCHEMA, table_name=name,
        schema=[Field(f"c{i}", f.stype)
                for i, f in enumerate(win.schema)])


def _semi_build_refs(join: LogicalJoin) -> Optional[List[int]]:
    """Right-side column indices the SEMI/ANTI join condition references,
    or None when the condition has a shape the key-set rewrite can't remap."""
    from ..plan.nodes import RexLiteral

    nl = len(join.left.schema)
    refs: List[int] = []
    ok = [True]

    def walk(rex):
        if isinstance(rex, RexInputRef):
            if rex.index >= nl and (rex.index - nl) not in refs:
                refs.append(rex.index - nl)
            return
        if isinstance(rex, RexCall):
            for o in rex.operands:
                walk(o)
            return
        if isinstance(rex, RexLiteral):
            return
        ok[0] = False

    if join.condition is not None:
        walk(join.condition)
    if not ok[0]:
        return None
    return sorted(refs)


def _remap_condition(rex, nl: int, refs: List[int]):
    """Rewrite right-side input refs to the key-set table's ordinals."""
    if isinstance(rex, RexInputRef):
        if rex.index >= nl:
            return RexInputRef(nl + refs.index(rex.index - nl), rex.stype)
        return rex
    if isinstance(rex, RexCall):
        return RexCall(rex.op, [_remap_condition(o, nl, refs)
                                for o in rex.operands], rex.stype,
                       info=getattr(rex, "info", None))
    return rex


def _stream_keyset_split(join: LogicalJoin, scan, source, context):
    """SEMI/ANTI with the chunked scan on the BUILD (right) side: stream the
    build as a dedup of the condition-referenced columns; existence
    semantics are preserved under dedup."""
    refs = _semi_build_refs(join)
    if refs is None:
        raise StreamingUnsupported(
            "semi/anti condition too complex for the key-set rewrite")
    right = join.right
    sub_path = _path_to(right, scan)
    below = _stream_partial_plans(right, scan, sub_path, context)
    # dedup of the referenced columns, per batch
    dd_fields = [Field(f"k{i}", right.schema[r].stype)
                 for i, r in enumerate(refs)]
    partial_plan = LogicalAggregate(input=below, group_keys=list(refs),
                                    aggs=[], schema=dd_fields)
    partials = _run_batches(partial_plan, source, context,
                            _scan_columns(scan), dedup_each_batch=True)
    names, cols = _dedup_host(*_concat_host(partials))
    ptmp = _retype(_host_cols_to_temp(names, cols, context), dd_fields)
    nl = len(join.left.schema)
    new_cond = (None if join.condition is None
                else _remap_condition(join.condition, nl, refs))
    new_join = LogicalJoin(left=join.left, right=ptmp, condition=new_cond,
                           join_type=join.join_type,
                           schema=list(join.schema))
    if hasattr(join, "null_aware"):
        # NOT IN's null-aware anti semantics survive the key-set rewrite:
        # a NULL key among the deduped build rows poisons exactly as the
        # full build side would
        new_join.null_aware = join.null_aware  # type: ignore[attr-defined]
    return join, new_join


# ---------------------------------------------------------------------------
# the iterative lowering loop
# ---------------------------------------------------------------------------

def _find_split(plan: RelNode, scan: LogicalTableScan, context):
    """(kind, node, path) for the innermost streamable split above ``scan``
    whose subtree contains no OTHER chunked scan."""
    path = _path_to(plan, scan)
    if path is None:
        raise StreamingUnsupported(
            "chunked table referenced inside a scalar subquery cannot "
            "stream; materialize the subquery first")
    # innermost-first: walk up from the scan
    for node in reversed(path[:-1]):
        if isinstance(node, LogicalWindow):
            if len(_chunked_scans(node, context)) == 1:
                return "window", node, path
        elif isinstance(node, LogicalAggregate):
            if len(_chunked_scans(node, context)) == 1:
                return "agg", node, path
        elif isinstance(node, LogicalSort) and node.limit is not None:
            if len(_chunked_scans(node, context)) == 1:
                return "topk", node, path
        elif (isinstance(node, LogicalJoin)
              and node.join_type in ("SEMI", "ANTI")):
            right_has = _path_to(node.right, scan) is not None
            if right_has and len(_chunked_scans(node.right, context)) == 1:
                return "keyset", node, path
        elif isinstance(node, LogicalJoin):
            # TWO chunked sides: no single-scan strategy applies; the
            # grace-hash partitioned join (physical/morsel.py) does, when
            # spilling is enabled and an equi-key exists
            from . import morsel as _morsel
            if _morsel.grace_applicable(node, context):
                return "grace", node, path
    raise StreamingUnsupported(
        "no aggregate or LIMIT above the chunked scan — the full result "
        "would be as large as the table; add a GROUP BY or LIMIT")


def _rewrite_rex_subqueries(rex, context):
    from ..plan.nodes import RexScalarSubquery

    if isinstance(rex, RexScalarSubquery):
        if plan_references_chunked(rex.plan, context):
            return RexScalarSubquery(_lower_chunked(rex.plan, context),
                                     rex.stype)
        return rex
    if isinstance(rex, RexCall):
        ops = [_rewrite_rex_subqueries(o, context) for o in rex.operands]
        if all(a is b for a, b in zip(ops, rex.operands)):
            return rex
        return RexCall(rex.op, ops, rex.stype,
                       info=getattr(rex, "info", None))
    return rex


def _lower_subqueries(plan: RelNode, context) -> RelNode:
    """Chunked scans hidden inside scalar-subquery rex plans lower
    recursively (TPC-H Q15: WHERE total = (SELECT MAX(...) FROM revenue)
    with revenue built over chunked lineitem)."""
    new_inputs = [_lower_subqueries(i, context) for i in plan.inputs]
    if any(a is not b for a, b in zip(new_inputs, plan.inputs)):
        plan = plan.with_inputs(new_inputs)
    if isinstance(plan, LogicalProject):
        exprs = [_rewrite_rex_subqueries(e, context) for e in plan.exprs]
        if any(a is not b for a, b in zip(exprs, plan.exprs)):
            plan = LogicalProject(input=plan.input, exprs=exprs,
                                  schema=plan.schema)
    elif isinstance(plan, LogicalFilter) and plan.condition is not None:
        cond = _rewrite_rex_subqueries(plan.condition, context)
        if cond is not plan.condition:
            plan = LogicalFilter(input=plan.input, condition=cond,
                                 schema=plan.schema)
    elif isinstance(plan, LogicalJoin) and plan.condition is not None:
        cond = _rewrite_rex_subqueries(plan.condition, context)
        if cond is not plan.condition:
            plan = plan.with_inputs([plan.left, plan.right])
            plan.condition = cond
    return plan


def _lower_chunked(plan: RelNode, context) -> RelNode:
    """Rewrite until no chunked scans remain (the iterative loop)."""
    for _ in range(16):  # bound: each iteration removes >= 1 chunked scan
        plan = _lower_subqueries(plan, context)
        scans = _chunked_scans(plan, context)
        if not scans:
            return plan
        last_err = None
        replaced = False
        for scan in scans:
            entry = context.schema[scan.schema_name].tables[scan.table_name]
            source = entry.chunked
            try:
                kind, node, path = _find_split(plan, scan, context)
                if kind == "agg":
                    old, new = _stream_aggregate_split(
                        node, scan, path, source, context)
                elif kind == "topk":
                    old, new = _stream_topk_split(node, scan, path,
                                                  source, context)
                elif kind == "window":
                    old, new = _stream_window_split(node, scan, path,
                                                    source, context)
                elif kind == "grace":
                    from . import morsel as _morsel
                    old, new = _morsel.grace_join_split(node, context)
                else:
                    old, new = _stream_keyset_split(node, scan, source,
                                                    context)
            except StreamingUnsupported as e:
                last_err = e
                continue
            plan = _replace(plan, old, new)
            replaced = True
            break
        if not replaced:
            raise last_err or StreamingUnsupported(
                "no streamable split found")
    raise StreamingUnsupported("chunked lowering did not converge")


def execute_streaming(plan: RelNode, context) -> Table:
    """Lower a plan referencing chunked tables by iterative subtree
    streaming, then run the rewritten (chunk-free) plan resident.

    Serialized under a process lock: the executor stages temps and the
    shared ``batch`` entry in the context's ``__stream__`` schema, and two
    interleaved queries would clobber each other's entries (the server
    runs queries on threads).  Streaming queries are whole-table scans
    fighting for the same device memory anyway; serializing them costs
    little.  The depth counter keeps a nested streaming execution (a
    view's plan executed mid-lowering on the same thread) from popping
    the outer query's temps: only the outermost frame cleans up."""
    with _EXEC_LOCK:
        if not _exec_depth:
            # temps are named t1, t2, ... in each query, so a repeated
            # query keys the same programs (their tables are copied
            # inputs of the graphs: compiled._copied_positions)
            _tmp_counter[0] = 0
        key = id(context)
        _exec_depth[key] = _exec_depth.get(key, 0) + 1
        try:
            lowered = _lower_chunked(plan, context)
            result = _run_resident(lowered, context)
        finally:
            _exec_depth[key] -= 1
            if _exec_depth[key] == 0:
                del _exec_depth[key]
                _cleanup(context)
    # temp-table scans carry sanitized column names (c0, c1, ...); the
    # user-visible names are the plan root's schema, always
    return result.with_names([f.name for f in plan.schema])
