"""Grace-hash partitioned joins: the morsel pipeline over the spill store.

The counterpart of ``dask_sql_tpu/physical/morsel.py``.
``physical/streaming.py`` lowers plans over ONE chunked table per split; a
join of TWO chunked tables (TPC-H Q3's orders ⋈ lineitem, both bigger than
the card) takes the classic grace-hash strategy on top of the spill store
(``runtime/spill.py``):

1. **Partition.**  Each side's subtree streams batch by batch exactly
   like a streaming split (the same per-batch program, the same global
   dictionaries), but instead of accumulating partials the rows are
   hash-partitioned on the equi-join keys into P spill runs.
   ``partition_codes`` gives int64 codes: ``code in [0, P)`` routes a row
   to its partition, ``-1`` marks a dead slot (a NULL equi-key: an INNER
   equi-join can never match it, so it is dropped at the partitioner).
   The hash is streaming's ``_bucket_ids`` over dictionary CODES for
   strings of one table; across two tables the codes differ, so string
   keys hash their decoded VALUES instead.
2. **Join pairs.**  Equal keys land in the same partition index on both
   sides, so pair p⋈p is a complete sub-join.  Every pair loads to the
   device padded to ONE shared capacity per side and runs under FIXED
   temp names (``grace_l``/``grace_r``, overwritten per pair like
   streaming's ``batch`` table): one program, and on the card one CUDA
   graph whose pair tables are copied inputs (``compiled._copied_positions``).
   Pairs with an empty side are skipped entirely.
3. **Output.**  Pair results append to an output spill run.  A small
   total materializes as a resident temp; a table-sized one re-enters the
   streaming pipeline as a ``SpillBackedSource`` chunked temp, so the
   GROUP BY above pipelines per-chunk partials through the partial/merge
   algebra and the full join result never materializes.

Skew: one shared pad capacity means a hot key inflates every pair.
Correctness is unaffected; the weakened device bound is reported
(``morsel_skew_warnings`` and a warning), never silently.

Everything here is gated on ``DSQL_SPILL_MB > 0``: with spilling disabled
the streaming lowerer never dispatches here and a join of two chunked
tables raises ``StreamingUnsupported``.  Every run a query opens is freed
when it ends, on the error path too (``streaming._cleanup``).  The JAX
package's autopilot partition hint and event publication have no
counterpart here: their modules are not ported (``DSQL_AUTOPILOT`` and
``DSQL_EVENTS`` raise at every query).
"""
from __future__ import annotations

import logging
import os
from typing import List, Optional, Tuple

import numpy as np

from ..io.chunked import ChunkedSource
from ..plan.nodes import (
    Field, LogicalFilter, LogicalJoin, LogicalProject, LogicalTableScan,
    RelNode, RexCall, RexInputRef,
)
from ..runtime import (faults as _faults, resilience as _res,
                       spill as _spill, telemetry as _tel)
from . import streaming as _stream

logger = logging.getLogger(__name__)

#: fixed per-pair table names, overwritten each pair so that every pair
#: join shares one program (fresh names would force P programs)
GRACE_LEFT = "grace_l"
GRACE_RIGHT = "grace_r"

#: upper bound on partition count: P beyond this buys no memory headroom
#: (partitions only need to fit a batch) and costs per-pair overhead
MAX_PARTITIONS = max(int(os.environ.get("DSQL_GRACE_MAX_PARTITIONS",
                                        "256") or 256), 1)

#: a pair capacity beyond this multiple of batch_rows is reported as skew
SKEW_FACTOR = 4


# ---------------------------------------------------------------------------
# applicability
# ---------------------------------------------------------------------------

def equi_key_pairs(join: LogicalJoin) -> Optional[List[Tuple[int, int]]]:
    """``[(left_col, right_col), ...]`` for every top-level equality
    conjunct crossing the join boundary, or None when there is none to
    partition on.  Non-equi conjuncts are NOT rejected: the full original
    condition runs inside every pair join, so residuals stay exact; the
    equi subset only has to be non-empty."""
    if join.condition is None:
        return None
    nl = len(join.left.schema)
    pairs: List[Tuple[int, int]] = []

    def conjuncts(rex):
        if isinstance(rex, RexCall) and rex.op == "AND":
            for o in rex.operands:
                yield from conjuncts(o)
        else:
            yield rex

    for c in conjuncts(join.condition):
        if (isinstance(c, RexCall) and c.op == "=" and len(c.operands) == 2
                and all(isinstance(o, RexInputRef) for o in c.operands)):
            a, b = c.operands
            if a.index < nl <= b.index:
                pairs.append((a.index, b.index - nl))
            elif b.index < nl <= a.index:
                pairs.append((b.index, a.index - nl))
    return pairs or None


def _side_row_local(side: RelNode, context) -> bool:
    """True when the path from ``side`` down to its chunked scan passes
    only through nodes whose per-batch evaluation distributes over row
    unions: Project, Filter, and INNER joins whose other input is
    resident.  An Aggregate/Sort/Window/Union on the path would compute
    per-BATCH results (TPC-H Q17's AVG-per-partkey subquery would average
    each batch separately), so such sides lower through the iterative
    one-subtree-at-a-time strategies first."""
    scans = _stream._chunked_scans(side, context)
    if len(scans) != 1:
        return False
    path = _stream._path_to(side, scans[0])
    if path is None:
        return False
    for node in path[:-1]:
        if isinstance(node, (LogicalProject, LogicalFilter)):
            continue
        if (isinstance(node, LogicalJoin) and node.join_type == "INNER"
                and not getattr(node, "null_aware", False)):
            continue
        return False
    return True


def grace_applicable(node: RelNode, context) -> bool:
    """True when ``node`` is an INNER equi-join with exactly one chunked
    scan on EACH side, both sides row-local above their scan, and
    spilling enabled: the shape the single-chunked streaming strategies
    cannot lower."""
    if not isinstance(node, LogicalJoin) or node.join_type != "INNER":
        return False
    if getattr(node, "null_aware", False):
        return False
    if not _spill.enabled():
        return False
    if not _side_row_local(node.left, context):
        return False
    if not _side_row_local(node.right, context):
        return False
    return equi_key_pairs(node) is not None


# ---------------------------------------------------------------------------
# host partitioning
# ---------------------------------------------------------------------------

_NAN_KEY_SALT = np.int64(-0x5851F42D4C957F2D)


def _canonical_int_keys(data: np.ndarray) -> np.ndarray:
    """Dtype-independent int64 image of a numeric key column: equal
    VALUES map to equal int64s whether the column arrived as int, bool,
    unsigned, or float (5 and 5.0 agree; -0.0 folds into +0.0; every NaN
    collapses to one salt)."""
    if data.dtype.kind != "f":
        return data.astype(np.int64, copy=False)
    d64 = data.astype(np.float64) + 0.0  # -0.0 -> +0.0
    isnan = np.isnan(d64)
    safe = np.where(isnan, 0.0, d64)
    integral = (np.isfinite(safe) & (np.floor(safe) == safe)
                & (np.abs(safe) < float(1 << 62)))
    as_int = np.clip(safe, -float(1 << 62), float(1 << 62)).astype(np.int64)
    canon = np.where(integral, as_int, safe.view(np.int64))
    return np.where(isnan, _NAN_KEY_SALT, canon)


def partition_codes(cols, keys: List[int], n_parts: int) -> np.ndarray:
    """Host partition codes: int64, ``code in [0, n_parts)`` routes the
    row, ``-1`` = dead slot (a NULL equi-key row, unmatched by any INNER
    equality, dropped here so it never costs spill bytes).  ``cols`` is
    the host-partial layout; string keys hash their decoded values
    (two tables' dictionaries need not agree), everything else hashes
    like ``streaming._bucket_ids`` over a value-canonical int64 image."""
    total = len(cols[0][0]) if cols else 0
    hash_cols = list(cols)
    for k in keys:
        data, mask, stype, d = cols[k]
        if d is not None:
            # decode codes -> per-value stable hash: two tables' codes
            # for the same string differ, but the value hash does not
            vals = d[np.clip(data, 0, max(len(d) - 1, 0))]
            data = np.fromiter(
                (hash(v) & 0x7FFFFFFFFFFFFFFF for v in vals),
                count=len(vals), dtype=np.int64)
            d = None
        elif data.dtype.kind in "biuf":
            # an int key joined to a float key must send 5 and 5.0 to one
            # partition, and integral floats (all-zero low mantissa bits)
            # would collapse the hash: every numeric key becomes a
            # value-equal int64 (non-integral floats keep their bits)
            data = _canonical_int_keys(data)
        if mask is None:
            # _bucket_ids mixes mask PRESENCE into the hash: both sides
            # take the same path, or equal keys land apart
            mask = np.ones(len(data), dtype=bool)
        hash_cols[k] = (data, mask, stype, d)
    codes = _stream._bucket_ids(hash_cols, keys, n_parts) \
        if n_parts > 1 else np.zeros(total, dtype=np.int64)
    dead = None
    for k in keys:
        mask = cols[k][1]
        if mask is not None:
            dead = ~mask if dead is None else (dead | ~mask)
    if dead is not None:
        codes = np.where(dead, np.int64(-1), codes)
    return codes


def _partition_side(side: RelNode, scan: LogicalTableScan, source,
                    context, keys: List[int], P: int, runs: List[str],
                    store: "_spill.SpillStore"):
    """Stream one join side batch by batch and hash-partition its rows
    into the given spill runs.  Returns the host column layout
    ``(names, [(dtype, stype, dictionary), ...])`` for empty-partition
    reconstruction."""
    path = _stream._path_to(side, scan)
    below = _stream._stream_partial_plans(side, scan, path, context)
    layout = None
    for bi in range(source.n_batches):
        _res.check("grace_partition")
        with _tel.span("morsel_batch", index=bi):
            table, row_valid = _res.retry_transient(
                lambda: source.batch_table(bi, context.device,
                                           _stream._scan_columns(scan)),
                site="chunked_read")
            _tel.inc("stream_batches")
            _tel.inc("stream_batch_rows", table.num_rows)
            _stream._set_batch_entry(context, table, row_valid)
            result = _stream._run_resident(below, context)
            names, cols = _stream._host_partial(result)
            if layout is None:
                layout = (names, [(d.dtype, st, di)
                                  for d, _m, st, di in cols])
            codes = partition_codes(cols, keys, P)
            order = np.argsort(codes, kind="stable")
            bounds = np.searchsorted(codes[order], np.arange(P + 1))
            routed = 0
            for p in range(P):
                sel = order[bounds[p]:bounds[p + 1]]
                if not len(sel):
                    continue
                pcols = [(d[sel], None if m is None else m[sel], st, di)
                         for d, m, st, di in cols]
                store.put_host(runs[p], names, pcols)
                routed += len(sel)
            _tel.annotate(partial_rows=int(result.num_rows),
                          routed_rows=routed)
    if layout is None:  # from_columns/from_pandas always give one batch
        from ..types import physical_dtype
        layout = ([f.name for f in side.schema],
                  [(np.dtype(physical_dtype(f.stype)), f.stype,
                    np.array([""], dtype=object) if f.stype.is_string
                    else None) for f in side.schema])
    return layout


# ---------------------------------------------------------------------------
# pair materialization
# ---------------------------------------------------------------------------

def _padded_masked(cols, cap: int, device):
    """(table, row_valid): host columns padded to ``cap`` rows, with masks
    ALWAYS present and row_valid always given, so that every pair (and
    every chunk of a spill-backed source) shares one program key."""
    import torch

    n = len(cols[0][0]) if cols else 0
    host = [(data, np.ones(n, dtype=bool) if mask is None else mask, stype, d)
            for data, mask, stype, d in cols]
    table = _stream._host_cols_to_table(host, device, pad_to=cap)
    row_valid = torch.arange(cap, device=device) < n
    upload = sum(cap * (d.itemsize + 1) for d, _m, _, _ in host)
    return table, row_valid, upload


def _set_grace_entry(context, name: str, run: Optional[str], layout,
                     cap: int, store: "_spill.SpillStore") -> int:
    """Materialize one partition (or a typed EMPTY side when run is
    None) as the fixed-name temp ``name``, padded to ``cap`` rows."""
    _names, colmeta = layout
    if run is not None and store.has_run(run):
        chunks = [store.get_host_cols(run, i)
                  for i in range(store.n_chunks(run))]
        _cn, cols = _stream._concat_host(chunks)
    else:
        cols = [(np.zeros(0, dtype=dt), None, st, di)
                for dt, st, di in colmeta]
    n = len(cols[0][0]) if cols else 0
    table, row_valid, _ = _padded_masked(cols, cap, context.device)
    _stream._set_batch_entry(context, table, row_valid, name=name)
    return n


# ---------------------------------------------------------------------------
# the join output re-entering streaming
# ---------------------------------------------------------------------------

class SpillBackedSource(ChunkedSource):
    """A ChunkedSource whose batches live in a spill run: grace-hash join
    outputs re-enter the streaming pipeline as a chunked temp so the
    aggregate above streams per-chunk partials.  Chunks pad to one shared
    capacity with masks and row_valid ALWAYS present: one program key
    across heterogeneous pair outputs."""

    def __init__(self, store: "_spill.SpillStore", run: str, names,
                 stypes, dictionaries, n_rows: int, batch_rows: int):
        super().__init__(names, stypes, dictionaries, [], n_rows,
                         batch_rows)
        self._store = store
        self._run = run

    @property
    def n_batches(self) -> int:
        return self._store.n_chunks(self._run)

    def batch_table(self, i: int, device, columns=None):
        _faults.maybe_fail("chunked_read")
        _cnames, cols = self._store.get_host_cols(self._run, i)
        keep = [ci for ci, name in enumerate(self.names)
                if columns is None or name in columns]
        fixed = []
        for ci in keep:
            data, mask, _stype, d = cols[ci]
            union = self.dictionaries[ci]
            if (union is not None and d is not None and d is not union
                    and not (len(d) == len(union) and (d == union).all())):
                # a pair result re-encoded its dictionary (an eager
                # path): remap codes against the sorted union
                data = np.searchsorted(
                    union, d[np.clip(data, 0, len(d) - 1)]
                ).astype(np.int32)
            fixed.append((data, mask, self.stypes[ci], union))
        table, row_valid, upload = _padded_masked(fixed, self.batch_rows,
                                                  device)
        _tel.annotate(upload_bytes=upload)
        return table.with_names([self.names[ci] for ci in keep]), row_valid


def _union_dictionaries(store: "_spill.SpillStore", run: str,
                        n_chunks: int, n_cols: int) -> list:
    """Per-column dictionary for the output source: identical chunk
    dictionaries pass through; divergent ones union (sorted, so the
    searchsorted remapping in batch_table stays valid)."""
    out = []
    for ci in range(n_cols):
        dicts = []
        for i in range(n_chunks):
            _n, _st, ds, _rows = store.chunk_meta(run, i)
            dicts.append(ds[ci])
        present = [d for d in dicts if d is not None]
        if not present:
            out.append(None)
            continue
        first = present[0]
        if all(d is first or (len(d) == len(first) and (d == first).all())
               for d in present):
            out.append(first)
        else:
            out.append(np.unique(
                np.concatenate([d.astype(object) for d in present])
            ).astype(object))
    return out


def _track_runs(context, runs: List[str]) -> None:
    lst = getattr(context, "_spill_runs", None)
    if lst is None:
        lst = context._spill_runs = []
    lst.extend(runs)


# ---------------------------------------------------------------------------
# the split
# ---------------------------------------------------------------------------

_grace_counter = [0]


def grace_join_split(join: LogicalJoin, context):
    """Lower one INNER join of two chunked sides via grace-hash
    partitioning; returns ``(join, replacement)`` for streaming's
    iterative rewrite loop."""
    store = _spill.get_store()
    _grace_counter[0] += 1
    tag = _grace_counter[0]

    lscan = _stream._chunked_scans(join.left, context)[0]
    rscan = _stream._chunked_scans(join.right, context)[0]
    lsrc = context.schema[lscan.schema_name].tables[lscan.table_name].chunked
    rsrc = context.schema[rscan.schema_name].tables[rscan.table_name].chunked
    pairs = equi_key_pairs(join)
    if pairs is None:  # grace_applicable guards this
        raise _stream.StreamingUnsupported(
            "join of two chunked tables has no equality key to "
            "partition on")
    lkeys = [p[0] for p in pairs]
    rkeys = [p[1] for p in pairs]

    # enough partitions that one partition ~ one batch of the larger side
    P = min(max(-(-int(lsrc.n_rows) // max(int(lsrc.batch_rows), 1)),
                -(-int(rsrc.n_rows) // max(int(rsrc.batch_rows), 1)),
                1), MAX_PARTITIONS)
    runs_l = [f"g{tag}:L{p}" for p in range(P)]
    runs_r = [f"g{tag}:R{p}" for p in range(P)]
    out_run = f"g{tag}:out"
    _track_runs(context, runs_l + runs_r + [out_run])

    with _tel.span("grace_join", partitions=P, spilled=True):
        _tel.inc("morsel_joins")
        llayout = _partition_side(join.left, lscan, lsrc, context, lkeys,
                                  P, runs_l, store)
        rlayout = _partition_side(join.right, rscan, rsrc, context, rkeys,
                                  P, runs_r, store)

        cap_l = max(max((store.run_rows(r) for r in runs_l), default=0), 1)
        cap_r = max(max((store.run_rows(r) for r in runs_r), default=0), 1)
        # partition skew ratio (max/mean over non-empty partitions)
        sizes = [n for r in runs_l + runs_r
                 if (n := store.run_rows(r)) > 0]
        if sizes:
            _tel.annotate(skew_ratio=round(
                max(sizes) / (sum(sizes) / len(sizes)), 3))
        for cap, src in ((cap_l, lsrc), (cap_r, rsrc)):
            if cap > SKEW_FACTOR * max(int(src.batch_rows), 1):
                # a hot key concentrates rows in one partition; every pair
                # pads to it, weakening the device bound: say so
                _tel.inc("morsel_skew_warnings")
                logger.warning(
                    "grace join: partition skew — largest partition %d "
                    "rows vs batch_rows %d; per-pair device working set "
                    "is ~%.1fx the configured bound", cap,
                    int(src.batch_rows),
                    cap / max(int(src.batch_rows), 1))

        lfields = [Field(f"c{i}", f.stype)
                   for i, f in enumerate(join.left.schema)]
        rfields = [Field(f"c{i}", f.stype)
                   for i, f in enumerate(join.right.schema)]
        pair_plan = LogicalJoin(
            left=LogicalTableScan(schema_name=_stream.STREAM_SCHEMA,
                                  table_name=GRACE_LEFT, schema=lfields),
            right=LogicalTableScan(schema_name=_stream.STREAM_SCHEMA,
                                   table_name=GRACE_RIGHT, schema=rfields),
            condition=join.condition, join_type="INNER",
            schema=list(join.schema))

        out_chunks = 0
        for p in range(P):
            _res.check("grace_pair")
            nl_rows = store.run_rows(runs_l[p])
            nr_rows = store.run_rows(runs_r[p])
            if nl_rows == 0 or nr_rows == 0:
                # an empty side means an empty pair join: skip the
                # device round trip entirely
                store.free_run(runs_l[p])
                store.free_run(runs_r[p])
                continue
            with _tel.span("grace_pair", index=p, left_rows=nl_rows,
                           right_rows=nr_rows):
                _set_grace_entry(context, GRACE_LEFT, runs_l[p],
                                 llayout, cap_l, store)
                _set_grace_entry(context, GRACE_RIGHT, runs_r[p],
                                 rlayout, cap_r, store)
                result = _stream._run_resident(pair_plan, context)
                _tel.inc("morsel_pairs")
                store.put_table(out_run, result)
                out_chunks += 1
            store.free_run(runs_l[p])
            store.free_run(runs_r[p])
        if out_chunks == 0:
            # no pair had rows on both sides: run ONE all-padded pair so
            # the output carries correctly typed (empty) columns
            _set_grace_entry(context, GRACE_LEFT, None, llayout, cap_l,
                             store)
            _set_grace_entry(context, GRACE_RIGHT, None, rlayout, cap_r,
                             store)
            result = _stream._run_resident(pair_plan, context)
            _tel.inc("morsel_pairs")
            store.put_table(out_run, result)
            out_chunks = 1
        # the last pair's padded tables leave the device before the plan
        # above the join runs
        temps = context.schema[_stream.STREAM_SCHEMA].tables
        temps.pop(GRACE_LEFT, None)
        temps.pop(GRACE_RIGHT, None)

        total_rows = store.run_rows(out_run)
        total_bytes = store.run_bytes(out_run)
        _tel.annotate(out_rows=total_rows, out_bytes=total_bytes)
        logger.debug("grace join: %d partitions -> %d output rows "
                     "(%d bytes, %d chunks)", P, total_rows, total_bytes,
                     out_chunks)

        if total_bytes <= _stream.PARTIAL_BYTES_BUDGET:
            partials = [store.get_host_cols(out_run, i)
                        for i in range(out_chunks)]
            names, cols = _stream._concat_host(partials)
            store.free_run(out_run)
            tmp = _stream._retype(
                _stream._host_cols_to_temp(names, cols, context),
                join.schema)
            return join, tmp

        # table-sized output: re-register as a chunked source (the
        # window-split pattern) so streaming keeps going above the join
        cap_out = max(max((store.chunk_meta(out_run, i)[3]
                           for i in range(out_chunks)), default=0), 1)
        dicts = _union_dictionaries(store, out_run, out_chunks,
                                    len(join.schema))
        src = SpillBackedSource(
            store, out_run, [f"c{i}" for i in range(len(join.schema))],
            [f.stype for f in join.schema], dicts, total_rows, cap_out)
        name = _stream._register_chunked_temp(context, src)
        return join, LogicalTableScan(
            schema_name=_stream.STREAM_SCHEMA, table_name=name,
            schema=[Field(f"c{i}", f.stype)
                    for i, f in enumerate(join.schema)])

