"""Physical executor: logical plan -> device Table, via a plugin registry.

The counterpart of the JAX package's eager executor
(``dask_sql_tpu/physical/rel/executor.py``): each plan-node class name maps
to a plugin ``plugin(node, executor)``; PyTorch runs eagerly, so each
plugin computes its result directly.  Ported: TableScan, Project, Filter,
Values, Aggregate (DISTINCT aggregates included), Sort (with OFFSET/LIMIT),
Join (every join type, equi keys plus a residual condition), the set
operations Union, Intersect and Except, Window (``ops/window.py``) and
Sample (TABLESAMPLE BERNOULLI / SYSTEM, seeded by REPEATABLE on the table's
device) and Predict (``FROM PREDICT(MODEL m, ...)``: the features go to the
host as one float64 matrix, the model predicts there, the prediction comes
back to the device).  A custom aggregation (``register_aggregation``) is a
host groupby-apply in pandas over the device's group codes, as in the JAX
package.

The statistics choose the operators, as in the JAX package
(``runtime/statistics.py``): ``groupby_decision`` picks the GROUP BY codes
(``hash``, ``sorted`` or ``dense``) and ``join_decision`` the join key
codes (``hash`` or ``dense``) of every join that builds them, the set
operations included.  Each choice that ran is recorded
(``record_choice``: a counter, and a line on the query's span).

The aggregate plugin first tries the static-domain route that the JAX
package keeps in its compiled tier (``physical/compiled.py``:
``_try_static_codes``, ``_decode_static_keys``,
``_static_domain_aggregate``): GROUP BY keys with a statically enumerable
domain of at most 256 slots (dictionary-encoded strings, booleans) and only
SUM/$SUM0/AVG/COUNT aggregates reduce through the fixed-point
segmented-sum kernel (``ops/gpu_kernels.py``); it is recorded as
``groupby=static``.  ``DSQL_FORCE_GROUPBY`` bypasses it, so that a forced
variant is the one that runs.
"""
from __future__ import annotations

import math
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ...ops import groupby as G
from ...ops import join as J
from ...ops import sort as S
from ...ops import window as W
from ...ops.gpu_kernels import segmented_sums_dispatch
from ...ops.kernels import decimal_unscale, join_key_codes, mask_to_indices
from ...plan.nodes import (
    LogicalAggregate, LogicalExcept, LogicalFilter, LogicalIntersect,
    LogicalJoin, LogicalProject, LogicalSample, LogicalSort, LogicalTableScan,
    LogicalUnion, LogicalValues, LogicalWindow, RelNode, RexCall,
)
from ...plan.optimizer import split_join_condition
from ...runtime import resilience as _res
from ...runtime import statistics as _stats
from ...runtime import telemetry as _tel
from ...table import Column, Scalar, Table, dict_sort_order
from ...types import BOOLEAN, exact_decimal_scale, physical_dtype, torch_dtype
from ...utils import Pluggable, import_pandas
from ..rex.cast import cast_column
from ..rex.evaluate import evaluate_predicate, evaluate_rex


class RelExecutor(Pluggable):
    """Plan-node class name -> physical plugin registry."""

    def __init__(self, context):
        self.context = context
        self.device = context.device

    def execute(self, rel: RelNode) -> Table:
        # the deadline/cancel checkpoint of every plan node: the eager
        # executor is the ladder's last rung, and no query runs past its
        # budget there either
        _res.check("eager")
        name = type(rel).__name__
        if not RelExecutor.has_plugin(name):
            raise NotImplementedError(f"Plan node {name} is not ported yet")
        plugin = RelExecutor.get_plugin(name)
        rec = _tel.active_node_recorder()
        if rec is None:
            return plugin(rel, self)
        # EXPLAIN ANALYZE: the node's wall (its children's included) and
        # output rows
        t0 = time.perf_counter()
        result = plugin(rel, self)
        rec.add(rel, (time.perf_counter() - t0) * 1e3, result.num_rows)
        return result


# ---------------------------------------------------------------------------
# core plugins
# ---------------------------------------------------------------------------

def _table_scan(rel: LogicalTableScan, ex: RelExecutor) -> Table:
    entry = ex.context.catalog_entry(rel.schema_name, rel.table_name)
    if entry.rank_rows is not None:
        from ...parallel.gather import check_whole
        check_whole(entry, rel.schema_name, rel.table_name)
    t = entry.table if entry.table is not None else ex.execute(entry.plan)
    if entry.table is not None and entry.row_valid is not None:
        # a padded table (a streamed batch, a stage boundary): drop the
        # padding rows (the compiled tier consumes the mask directly)
        t = t.take(mask_to_indices(entry.row_valid))
    names = [f.name for f in rel.schema]
    return t.limit_to(names) if t.names != names else t


def _project(rel: LogicalProject, ex: RelExecutor) -> Table:
    src = ex.execute(rel.input)
    cols: List[Column] = []
    for rex in rel.exprs:
        v = evaluate_rex(rex, src, ex)
        if isinstance(v, Scalar):
            v = Column.from_scalar(v, src.num_rows, ex.device)
        cols.append(v)
    return Table([f.name for f in rel.schema], cols)


def _filter(rel: LogicalFilter, ex: RelExecutor) -> Table:
    src = ex.execute(rel.input)
    mask = evaluate_predicate(rel.condition, src, ex)
    if isinstance(mask, bool):
        return src if mask else src.slice(0, 0)
    return src.take(mask_to_indices(mask))


def _values(rel: LogicalValues, ex: RelExecutor) -> Table:
    cols = []
    for j, f in enumerate(rel.schema):
        vals = [row[j].value for row in rel.rows]
        mask = np.array([v is not None for v in vals], dtype=bool)
        if f.stype.is_string:
            arr = np.array([v if v is not None else "" for v in vals], dtype=object)
            cols.append(Column._encode_strings(arr, None if mask.all() else mask,
                                               ex.device))
        else:
            arr = np.array([v if v is not None else 0 for v in vals])
            cols.append(Column.from_encoded(arr.astype(physical_dtype(f.stype)),
                                            f.stype, mask, None, ex.device))
    return Table([f.name for f in rel.schema], cols)


def _sort(rel: LogicalSort, ex: RelExecutor) -> Table:
    src = ex.execute(rel.input)
    if rel.collation:
        keys = [(c.index, c.ascending, c.effective_nulls_first)
                for c in rel.collation]
        src = S.apply_sort(src, keys)
    return S.apply_offset_limit(src, rel.offset, rel.limit)


# ---------------------------------------------------------------------------
# aggregate
# ---------------------------------------------------------------------------

def _agg_filter(agg, src: Table) -> Optional[torch.Tensor]:
    """The FILTER (WHERE ...) clause of one aggregate as a row mask."""
    if agg.filter_arg is None:
        return None
    fc = src.columns[agg.filter_arg]
    return fc.data.to(torch.bool) & fc.valid_mask()


def _aggregate(rel: LogicalAggregate, ex: RelExecutor) -> Table:
    src = ex.execute(rel.input)
    n = src.num_rows
    key_cols = [src.columns[i] for i in rel.group_keys]
    out_names = [f.name for f in rel.schema]

    if not rel.group_keys:
        if not rel.aggs:
            return Table([], [])
        out_cols = []
        for j, agg in enumerate(rel.aggs):
            f = rel.schema[j]
            col = src.columns[agg.args[0]] if agg.args else None
            fmask, rows = _agg_filter(agg, src), n
            if agg.udaf is not None:
                out_cols.append(_run_udaf(agg, col, None, 1, fmask, src,
                                          ex.device))
                continue
            if agg.distinct and col is not None:
                zeros = torch.zeros(n, dtype=torch.int64, device=ex.device)
                keep = G.dedup_for_distinct_agg(zeros, col, fmask)
                col, fmask, rows = col.take(keep), None, int(keep.shape[0])
            out_cols.append(G.whole_table_aggregate(
                agg.op, col, fmask, f.stype, rows, ex.device))
        return Table(out_names, out_cols)

    static = _static_domain_aggregate(rel, src, key_cols, ex.device)
    if static is not None:
        _stats.record_choice("groupby", "static")
        return static

    variant, info = _stats.groupby_decision(rel, ex.context)
    hint = (info["lo"], info["hi"]) if "lo" in info else None
    codes, first, num_groups, used = G.group_codes(key_cols, variant, hint)
    if used != "hash" or info:
        _stats.record_choice("groupby", used, **{
            k: v for k, v in info.items() if k not in ("lo", "hi")})
    out_cols = [c.take(first) for c in key_cols]
    for j, agg in enumerate(rel.aggs):
        f = rel.schema[len(rel.group_keys) + j]
        col = src.columns[agg.args[0]] if agg.args else None
        if agg.udaf is not None:
            out_cols.append(_run_udaf(agg, col, codes, num_groups,
                                      _agg_filter(agg, src), src, ex.device))
            continue
        if agg.distinct and col is not None:
            keep = G.dedup_for_distinct_agg(codes, col, _agg_filter(agg, src))
            out_cols.append(G.segment_aggregate(
                agg.op, col.take(keep), codes[keep], num_groups, f.stype, None,
                int(keep.shape[0])))
        else:
            out_cols.append(G.segment_aggregate(
                agg.op, col, codes, num_groups, f.stype, _agg_filter(agg, src), n))
    return Table(out_names, out_cols)


def _run_udaf(agg, col: Optional[Column], codes: Optional[torch.Tensor],
              num_groups: int, filter_mask: Optional[torch.Tensor],
              src: Table, device: torch.device) -> Column:
    """A custom aggregation: the values and the group codes come to the
    host, and pandas applies the function to each group's Series.  A
    group with no row (all filtered out) is NULL."""
    pd = import_pandas(f"The custom aggregation {agg.udaf.name}")
    vals = col.to_numpy() if col is not None else np.zeros(src.num_rows)
    np_codes = (codes.cpu().numpy() if codes is not None
                else np.zeros(len(vals), dtype=np.int64))
    keep = (filter_mask.cpu().numpy() if filter_mask is not None
            else np.ones(len(vals), bool))
    result = pd.Series(vals[keep]).groupby(
        pd.Series(np_codes[keep])).apply(agg.udaf.func)
    out = np.empty(num_groups, dtype=object)
    out[:] = None
    for k, v in result.items():
        out[int(k)] = v
    mask = np.array([v is not None for v in out], dtype=bool)
    if agg.stype.is_string:
        return Column._encode_strings(
            np.where(mask, out, "").astype(object),
            None if mask.all() else mask, device)
    arr = np.array([v if v is not None else 0 for v in out])
    return Column.from_encoded(arr.astype(physical_dtype(agg.stype)),
                               agg.stype, None if mask.all() else mask,
                               None, device)


# ---------------------------------------------------------------------------
# joins and set operations
# ---------------------------------------------------------------------------

def _join(rel: LogicalJoin, ex: RelExecutor) -> Table:
    left = ex.execute(rel.left)
    right = ex.execute(rel.right)
    equi, residual = split_join_condition(rel)
    jt = rel.join_type
    out_names = [f.name for f in rel.schema]
    lk = [k for k, _ in equi]
    rk = [k for _, k in equi]

    def key_variant() -> str:
        return _join_variant(rel, [left.columns[i] for i in lk],
                             [right.columns[i] for i in rk], ex)

    def pair_codes():
        return join_key_codes([left.columns[i] for i in lk],
                              [right.columns[i] for i in rk],
                              variant=key_variant())

    if jt in ("SEMI", "ANTI"):
        if not equi and residual:
            # correlated EXISTS with only non-equi predicates
            li, ri = J.cross_join_pairs(left.num_rows, right.num_rows, ex.device)
            return _semi_anti_pairs(ex, left, right, li, ri, residual, jt)
        if not equi:
            # EXISTS: all rows if the right side has any, else none
            return left if (right.num_rows > 0) == (jt == "SEMI") \
                else left.slice(0, 0)
        if residual:
            # equi + residual (a decorrelated EXISTS with an inequality):
            # expand the equi matches, apply the residual, keep existence
            li, ri, _ = J._expand_matches(*pair_codes())
            return _semi_anti_pairs(ex, left, right, li, ri, residual, jt)
        return J.join_tables(left, right, lk, rk, jt,
                             getattr(rel, "null_aware", False),
                             variant=key_variant())[0]

    if not equi:
        # cross join or pure non-equi: pair expansion + residual filter
        li, ri = J.cross_join_pairs(left.num_rows, right.num_rows, ex.device)
    elif not residual:
        return J.join_tables(left, right, lk, rk, jt, variant=key_variant()
                             )[0].with_names(out_names)
    else:
        li, ri, _ = J._expand_matches(*pair_codes())
    lt, rt = left.take(li), right.take(ri)
    pairs = Table(out_names, lt.columns + rt.columns)
    if not residual:
        return pairs
    keep = _pair_mask(ex, pairs, residual)
    if jt in ("INNER", "CROSS"):
        return pairs.take(mask_to_indices(keep))
    return J.rejoin_outer(left, right, pairs, keep, li, ri, jt
                          ).with_names(out_names)


def _join_variant(rel, left_cols: List[Column], right_cols: List[Column],
                  ex: RelExecutor) -> str:
    """The statistics' key coding for one join (``rel`` None for a set
    operation), recorded when it is not the statistics-free default."""
    variant, info = _stats.join_decision(rel, left_cols, right_cols,
                                         ex.context)
    if variant != "hash" or info:
        _stats.record_choice("join", variant, **info)
    return variant


def _pair_mask(ex: RelExecutor, pairs: Table, residual) -> torch.Tensor:
    keep = evaluate_predicate(_and_rex(residual), pairs, ex)
    if isinstance(keep, bool):
        keep = torch.full((pairs.num_rows,), keep, device=ex.device)
    return keep


def _semi_anti_pairs(ex: RelExecutor, left: Table, right: Table, li, ri,
                     residual, jt: str) -> Table:
    """SEMI/ANTI with residual predicates: evaluate the condition over the
    candidate (left, right) row pairs, then keep the left rows with (SEMI)
    or without (ANTI) a surviving match.  The keep-mask stays on the
    device."""
    lt, rt = left.take(li), right.take(ri)
    pairs = Table([f"l{i}" for i in range(len(lt.names))]
                  + [f"r{i}" for i in range(len(rt.names))],
                  lt.columns + rt.columns)
    keep = _pair_mask(ex, pairs, residual)
    matched = torch.zeros(left.num_rows, dtype=torch.bool, device=ex.device)
    matched[li[keep]] = True
    return left.take(mask_to_indices(matched if jt == "SEMI" else ~matched))


def _and_rex(rexes):
    out = rexes[0]
    for r in rexes[1:]:
        out = RexCall("AND", [out, r], BOOLEAN)
    return out


def _union(rel: LogicalUnion, ex: RelExecutor) -> Table:
    out_names = [f.name for f in rel.schema]
    aligned = []
    for t in (ex.execute(i) for i in rel.inputs_):
        cols = [c if c.stype.name == f.stype.name else cast_column(c, f.stype)
                for c, f in zip(t.columns, rel.schema)]
        aligned.append(Table(out_names, cols))
    out = J.concat_tables(aligned)
    return out if rel.all else out.take(G.distinct_rows(out.columns))


def _set_semi_anti(rel, ex: RelExecutor, jt: str) -> Table:
    """INTERSECT / EXCEPT: distinct left rows with (SEMI) or without (ANTI)
    an equal right row, where NULL equals NULL (IS NOT DISTINCT FROM)."""
    a = ex.execute(rel.inputs_[0])
    b = ex.execute(rel.inputs_[1])
    a = a.take(G.distinct_rows(a.columns))
    keys = list(range(a.num_columns))
    variant = _join_variant(None, a.columns, b.columns, ex)
    out, _ = J.join_tables(a, b, keys, keys, jt, null_equal=True,
                           variant=variant)
    return out.with_names([f.name for f in rel.schema])


def _intersect(rel: LogicalIntersect, ex: RelExecutor) -> Table:
    return _set_semi_anti(rel, ex, "SEMI")


def _except(rel: LogicalExcept, ex: RelExecutor) -> Table:
    return _set_semi_anti(rel, ex, "ANTI")


def _window(rel: LogicalWindow, ex: RelExecutor) -> Table:
    src = ex.execute(rel.input)
    names, cols = list(src.names), list(src.columns)
    for call in rel.calls:
        order = [(c.index, c.ascending, c.effective_nulls_first)
                 for c in call.order]
        cols.append(W.compute_window(src, call.op, call.args, call.partition,
                                     order, call.frame, call.stype))
        names.append(call.name)
    return Table(names, cols)


def _sample(rel: LogicalSample, ex: RelExecutor) -> Table:
    """TABLESAMPLE: each row kept with probability percentage / 100, from a
    generator on the table's device seeded by REPEATABLE (else from fresh
    entropy).  On one device SYSTEM (block sampling) equals BERNOULLI, as
    in the JAX package."""
    src = ex.execute(rel.input)
    g = torch.Generator(device=ex.device)
    if rel.seed is None:
        g.seed()
    else:
        g.manual_seed(int(rel.seed))
    u = torch.rand(src.num_rows, generator=g, dtype=torch.float64,
                   device=ex.device)
    return src.take(mask_to_indices(u < rel.percentage / 100.0))


def _predict(rel, ex: RelExecutor) -> Table:
    """PREDICT: the model's feature columns go to the host as one float64
    matrix (NULL as NaN; without training columns, a pandas frame of the
    input), ``model.predict`` runs there, and the prediction comes back to
    the device as the plan's ``target`` column."""
    from ...models.training import float64_matrix

    with _tel.span("predict_input"):
        src = ex.execute(rel.input)
    model, training_columns = ex.context._get_model(rel.model_name)
    with _tel.span("predict_gather"):
        if training_columns:
            X = float64_matrix([src.column(c) for c in training_columns],
                               src.num_rows, order="C")
        else:
            import_pandas("PREDICT without training columns")
            X = src.to_pandas()
    target = rel.schema[-1]
    with _tel.span("predict_model"):
        out = cast_column(Column.from_numpy(np.asarray(model.predict(X)),
                                            ex.device), target.stype)
    return Table(list(src.names) + [target.name], list(src.columns) + [out])


STATIC_DOMAIN_CAP = 4096
STATIC_DOMAIN_MAX = 256


def _try_static_codes(cols: List[Column]
                      ) -> Optional[Tuple[torch.Tensor, int, List[Tuple[int, bool]]]]:
    """Direct group codes when every key has a statically enumerable domain
    (dictionary-encoded strings, booleans): (codes int64 in [0, domain),
    domain, per-key (size, nullable)), or None.  Slot order is the generic
    group order: the NULL slot first, then dictionary rank order."""
    domain = 1
    parts: List[Tuple[torch.Tensor, int]] = []
    key_meta: List[Tuple[int, bool]] = []
    for c in cols:
        nullable = c.mask is not None
        if c.stype.is_string:
            size = len(c.dictionary)
            code = c.dict_ranks().data.to(torch.int64)
        elif c.data.dtype == torch.bool:
            size = 2
            code = c.data.to(torch.int64)
        else:
            return None
        if nullable:
            code = torch.where(c.mask, code + 1, 0)
            size += 1
        size = max(size, 1)
        domain *= size
        if domain > STATIC_DOMAIN_CAP:
            return None
        parts.append((code, size))
        key_meta.append((size, nullable))
    combined = parts[0][0]
    for code, size in parts[1:]:
        combined = combined * size + code
    return combined, domain, key_meta


def _decode_static_keys(cols: List[Column], key_meta, domain: int,
                        device: torch.device) -> List[Column]:
    """Group-key output columns straight from the slot index (mixed radix of
    rank+null digits) -- the row data is never touched."""
    g = torch.arange(domain, dtype=torch.int64, device=device)
    stride = domain
    out: List[Column] = []
    for c, (size, nullable) in zip(cols, key_meta):
        stride //= size
        code = torch.div(g, stride, rounding_mode="floor") % size
        mask = None
        if nullable:
            mask = code != 0
            code = (code - 1).clamp_min(0)
        if c.stype.is_string:
            # code is a sort rank; order[rank] = dictionary index
            order = torch.from_numpy(dict_sort_order(c.dictionary).astype(np.int32)
                                     ).to(device)
            out.append(Column(order[code], c.stype, mask, c.dictionary))
        else:
            out.append(Column(code.to(torch.bool), c.stype, mask))
    return out


def _static_domain_aggregate(rel: LogicalAggregate, src: Table,
                             key_cols: List[Column], device: torch.device
                             ) -> Optional[Table]:
    """GROUP BY over a static key domain through the fixed-point kernel.

    Returns None (the caller takes the generic path) when the shape does not
    fit: keys not enumerable, more than 256 slots, an aggregate other than
    SUM/$SUM0/AVG/COUNT or with DISTINCT, a string or boolean argument, or
    an integer-valued row with |v| >= 2**53 (the int grid is exact only
    below it).  Empty slots are dropped through the occupancy row."""
    static = _try_static_codes(key_cols)
    if static is None:
        return None
    codes, domain, key_meta = static
    if domain > STATIC_DOMAIN_MAX:
        return None
    for agg in rel.aggs:
        col = src.columns[agg.args[0]] if agg.args else None
        if agg.op not in ("SUM", "$SUM0", "AVG", "COUNT") or agg.distinct \
                or agg.udaf is not None:
            return None
        if col is not None and (col.stype.is_string or col.data.dtype == torch.bool):
            return None

    n = src.num_rows
    kmask = torch.ones(n, dtype=torch.bool, device=device)
    rows = [kmask.to(torch.float64)]      # row 0: occupancy counts
    row_classes = ["unit"]
    slots = []
    int_maxima = []
    for j, agg in enumerate(rel.aggs):
        f = rel.schema[len(rel.group_keys) + j]
        col = src.columns[agg.args[0]] if agg.args else None
        fmask = _agg_filter(agg, src)
        factor = 1.0
        if col is not None and agg.op in ("SUM", "$SUM0", "AVG"):
            ds = exact_decimal_scale(col.stype)
            if ds is not None:
                factor = 10.0 ** ds
        if col is None or agg.op == "COUNT":
            # COUNT(*) / COUNT(col): only the 0/1 count row is ever read --
            # it rides in the value slot too, with no magnitude check
            if col is None:
                vmask = kmask if fmask is None else fmask
            else:
                vmask = col.valid_mask() if fmask is None else (col.valid_mask() & fmask)
            vrow = vmask.to(torch.float64)
            crow = vrow
            rc = "unit"
        else:
            vmask = col.valid_mask() if fmask is None else (col.valid_mask() & fmask)
            data = col.data.to(torch.float64)
            if factor != 1.0:
                data = torch.round(data * factor)
            vrow = torch.where(vmask, data, 0.0)
            crow = vmask.to(torch.float64)
            is_int = factor != 1.0 or not col.data.dtype.is_floating_point
            if is_int:
                int_maxima.append(vrow.abs().amax() if n else vrow.new_zeros(()))
            rc = "int" if is_int else "float"
        slots.append((j, agg, f, len(rows), factor))
        rows.append(vrow)
        row_classes.append(rc)
        rows.append(crow)
        row_classes.append("unit")

    # host check of the int grid's exactness bound, before the kernel runs
    if int_maxima and float(torch.stack(int_maxima).max()) >= 2.0 ** 53:
        return None

    red = segmented_sums_dispatch(torch.stack(rows), codes, kmask, domain,
                                  row_classes=row_classes)
    occupied = mask_to_indices(red[0] > 0)

    out_cols = _decode_static_keys(key_cols, key_meta, domain, device)
    for j, agg, f, row0, factor in slots:
        sums, counts = red[row0], red[row0 + 1]
        has = counts > 0
        if agg.op == "COUNT":
            out_cols.append(Column(counts.to(torch.int64), f.stype, None))
        elif agg.op in ("$SUM0", "SUM"):
            out = sums
            if factor != 1.0:
                # integer-valued sums of scaled decimals: exact-quotient unscale
                out = decimal_unscale(sums.to(torch.int64),
                                      int(round(math.log10(factor))))
            out_cols.append(Column(out.to(torch_dtype(f.stype)), f.stype,
                                   None if agg.op == "$SUM0" else has))
        else:  # AVG
            out_cols.append(Column(sums / (counts.clamp_min(1.0) * factor),
                                   f.stype, has))
    return Table([f.name for f in rel.schema],
                 [c.take(occupied) for c in out_cols])


RelExecutor.add_plugin("LogicalTableScan", _table_scan)
RelExecutor.add_plugin("LogicalProject", _project)
RelExecutor.add_plugin("LogicalFilter", _filter)
RelExecutor.add_plugin("LogicalValues", _values)
RelExecutor.add_plugin("LogicalAggregate", _aggregate)
RelExecutor.add_plugin("LogicalSort", _sort)
RelExecutor.add_plugin("LogicalJoin", _join)
RelExecutor.add_plugin("LogicalUnion", _union)
RelExecutor.add_plugin("LogicalIntersect", _intersect)
RelExecutor.add_plugin("LogicalExcept", _except)
RelExecutor.add_plugin("LogicalWindow", _window)
RelExecutor.add_plugin("LogicalSample", _sample)
RelExecutor.add_plugin("LogicalPredict", _predict)
