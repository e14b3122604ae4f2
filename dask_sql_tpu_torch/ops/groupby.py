"""Segmented aggregation: SQL GROUP BY on the device.

The counterpart of ``dask_sql_tpu/ops/groupby.py``: keys become dense group
codes (NULLs form their own group) by one of three variants the statistics
choose between (``group_codes``: ``hash``, ``sorted``, ``dense``), then
every aggregate is a segment reduction (``index_add_`` /
``scatter_reduce_``) in ``segment_aggregate``, or a plain reduction in
``whole_table_aggregate``; ``distinct_rows`` and ``dedup_for_distinct_agg``
select the rows behind DISTINCT.  ``sorted_segment_aggregate`` is the
compiled tier's scatter-free form over group-sorted rows
(``ops/sorted_agg.py``).
"""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from ..table import dict_sort_order, Column
from ..types import SqlType, exact_decimal_scale, is_int_dtype, torch_dtype
from .kernels import comparable_data, decimal_unscale, factorize_columns


def group_codes(key_cols: List[Column], variant: str = "hash",
                dense_hint=None):
    """Dense group codes 0..G-1 of the key columns.

    Returns (codes, first_row_per_group, G, used_variant).  ``variant``
    comes from the statistics (``runtime/statistics.groupby_decision``):
    ``hash`` factorizes with ``torch.unique``; ``sorted`` is one stable
    lexsort and a boundary scan; ``dense`` indexes a single integer key
    directly (``slot = key - lo``).  All three number the groups alike
    (ascending key order, the NULL group first) and pick the same first
    rows, so the choice never changes an answer.  A variant that does not
    apply falls through: ``dense`` to ``sorted`` (which needs no float
    key) to ``hash``."""
    if not key_cols:
        return None, None, 1, "none"
    if variant == "dense":
        out = _dense_group_codes(key_cols, dense_hint)
        if out is not None:
            return (*out, "dense")
        variant = "sorted"
    if variant == "sorted":
        out = _sorted_group_codes(key_cols)
        if out is not None:
            return (*out, "sorted")
    return (*factorize_columns(key_cols, null_as_group=True), "hash")


#: most direct-index slots ``dense`` allocates, even when forced
_DENSE_HARD_CAP = 1 << 22
_I64 = torch.iinfo(torch.int64)


def _dense_group_codes(key_cols: List[Column], dense_hint=None):
    """Direct-index codes of ONE integer key: slot = key - lo (+1 when the
    key has NULLs, which take slot 0: the NULL group first), occupied slots
    numbered in slot order by a cumulative sum.  The valid rows' min and
    max (and whether there are valid and NULL rows) reach the host in one
    synchronisation, the group count in a second; occupancy is a scatter
    of flags (``torch.bincount`` would read its input's max on the card,
    another synchronisation).  None where it does not apply."""
    if len(key_cols) != 1:
        return None
    c = key_cols[0]
    if c.stype.is_string or not is_int_dtype(c.data.dtype):
        return None
    n = len(c)
    if n == 0:
        return None
    data = c.data.to(torch.int64)
    if c.mask is not None:
        # data under NULL rows is garbage: min and max of valid rows only
        probe = torch.stack([
            c.mask.any().to(torch.int64), (~c.mask).any().to(torch.int64),
            torch.where(c.mask, data, _I64.max).min(),
            torch.where(c.mask, data, _I64.min).max()])
        any_valid, has_null, vlo, vhi = probe.tolist()
        if not any_valid:
            return None
    else:
        vlo, vhi = torch.stack([data.min(), data.max()]).tolist()
        has_null = 0
    lo, hi = vlo, vhi
    if dense_hint is not None:
        lo, hi = int(dense_hint[0]), int(dense_hint[1])
        # stale statistics: rows outside the hinted domain void the hint
        if vlo < lo or vhi > hi:
            lo, hi = vlo, vhi
    domain = hi - lo + 1
    if domain <= 0 or domain > _DENSE_HARD_CAP:
        return None
    shift = 1 if has_null else 0
    slots = (data - lo).clamp(0, domain - 1) + shift
    if has_null:
        slots = torch.where(c.mask, slots, 0)
    # index_fill_ takes the scalar as it is; ``present[slots] = True``
    # would copy it to the card and synchronise
    present = torch.zeros(domain + shift, dtype=torch.bool,
                          device=data.device).index_fill_(0, slots, True)
    # occupied slot k -> its rank: ascending slot order IS ascending key
    # order with the NULL slot first, the numbering of factorize
    remap = torch.cumsum(present.to(torch.int64), 0) - 1
    num_groups = int(remap[-1]) + 1
    codes = remap[slots]
    first = torch.full((num_groups,), n, dtype=torch.int64, device=data.device)
    first.scatter_reduce_(0, codes, torch.arange(n, device=data.device),
                          reduce="amin", include_self=True)
    return codes, first, num_groups


def _sorted_group_codes(key_cols: List[Column]):
    """Sort-based codes: ONE stable lexsort over the keys (chained stable
    sorts, least significant first, as in ``ops/sort.py``), then group
    boundaries from adjacent-row comparisons.  Per column the order is
    (null flag, comparable value) with NULL first, so the numbering is
    factorize's, and the stable sort makes each group's first sorted row
    its smallest row index.  One synchronisation (the boundary count).
    None for float keys (NaN != NaN would split NaN groups that
    ``torch.unique``'s order keeps together): the caller takes ``hash``."""
    n = len(key_cols[0])
    if n == 0:
        return None
    keys = []  # significance order: col0 flag, col0 value, col1 flag, ...
    for c in key_cols:
        data = comparable_data(c)
        if data.dtype.is_floating_point:
            return None
        data = data.to(torch.int64)
        if c.mask is not None:
            keys.append(c.mask.to(torch.int64))    # NULL (0) first
            keys.append(torch.where(c.mask, data, data[0]))
        else:
            keys.append(data)
    order = torch.arange(n, device=keys[0].device)
    for k in reversed(keys):
        order = order[torch.sort(k[order], stable=True).indices]
    diff = torch.zeros(n - 1, dtype=torch.bool, device=order.device)
    for k in keys:
        ks = k[order]
        diff = diff | (ks[1:] != ks[:-1])
    boundary = torch.cat([torch.ones(1, dtype=torch.bool, device=order.device),
                          diff])
    starts = torch.nonzero(boundary).reshape(-1)
    num_groups = int(starts.shape[0])
    codes_sorted = torch.cumsum(boundary.to(torch.int64), 0) - 1
    codes = torch.empty(n, dtype=torch.int64, device=order.device)
    codes[order] = codes_sorted
    return codes, order[starts], num_groups


def distinct_rows(cols: List[Column]) -> torch.Tensor:
    """Row indices of the first occurrence of each distinct key combination,
    in row order."""
    return torch.sort(factorize_columns(cols)[1]).values


def dedup_for_distinct_agg(group_codes_arr: torch.Tensor, value_col: Column,
                           filter_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Rows to aggregate for a DISTINCT aggregate: the first row of each
    (group, value) pair among the valid (and FILTER-passing) rows, in row
    order."""
    vals_codes = factorize_columns([value_col])[0]
    n = vals_codes.shape[0]
    m = int(vals_codes.max()) + 1 if n else 1
    pair = group_codes_arr * m + vals_codes
    keep = value_col.valid_mask()
    if filter_mask is not None:
        keep = keep & filter_mask
    # dropped rows get unique negative pairs, so they never merge
    pair = torch.where(keep, pair, -1 - torch.arange(n, device=pair.device))
    uniq, inv = torch.unique(pair, sorted=True, return_inverse=True)
    first = torch.full((uniq.shape[0],), n, dtype=torch.int64, device=pair.device)
    first.scatter_reduce_(0, inv.reshape(-1), torch.arange(n, device=pair.device),
                          reduce="amin", include_self=True)
    return torch.sort(first[uniq >= 0]).values


def _masked(col: Column, extra_mask: Optional[torch.Tensor]):
    valid = col.valid_mask()
    if extra_mask is not None:
        valid = valid & extra_mask
    return col.data, valid


def _segment_sum(values: torch.Tensor, codes: torch.Tensor,
                 num_groups: int) -> torch.Tensor:
    """Per-group sums, the same bits on every run.  On the card a float
    ``index_add_`` adds with atomics in a varying order, so two runs of one
    SUM can differ in the last bit (and TPC-H Q15's ``total_revenue =
    (SELECT MAX(total_revenue) ...)`` then matches nothing); there float
    sums go through ``index_put_(accumulate=True)``, which sorts the codes
    and adds each group's values in row order.  Integer sums are exact in
    any order, and the CPU's ``index_add_`` adds in row order."""
    out = torch.zeros(num_groups, dtype=values.dtype, device=values.device)
    if values.is_cuda and values.dtype.is_floating_point:
        return out.index_put_((codes,), values, accumulate=True)
    return out.index_add_(0, codes, values)


def _segment_minmax(values: torch.Tensor, codes: torch.Tensor,
                    num_groups: int, op: str, sentinel) -> torch.Tensor:
    out = torch.full((num_groups,), sentinel, dtype=values.dtype,
                     device=values.device)
    return out.scatter_reduce_(0, codes, values,
                               reduce="amin" if op == "MIN" else "amax",
                               include_self=True)


def _decimal_exact_result(op: str, s_int, count, dscale: int,
                          out_type: SqlType) -> Column:
    """Tail of the exact scaled-int64 SUM/$SUM0/AVG paths: unscale via the
    exact-quotient route and apply the SQL NULL rules."""
    has_any = count > 0
    if op in ("SUM", "$SUM0"):
        s = decimal_unscale(s_int, dscale).to(torch_dtype(out_type))
        return Column(s, out_type, None if op == "$SUM0" else has_any)
    mean = s_int.to(torch.float64) / (count.clamp_min(1) * 10.0 ** dscale)
    return Column(mean, out_type, has_any)


def _decimal_scaled_ints(data, dscale: int):
    """Round f64 decimal data onto its integer grid (int64 'cents')."""
    return torch.round(data.to(torch.float64) * 10.0 ** dscale).to(torch.int64)


def _sum_work(data: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    if data.dtype.is_floating_point:
        return torch.where(valid, data.to(torch.float64), 0.0)
    return torch.where(valid, data.to(torch.int64), 0)


def _moments(op: str, s, s2, count, has_any, out_type: SqlType) -> Column:
    """AVG / VAR_* / STDDEV_* from the sum, the sum of squares and the count."""
    mean = s.to(torch.float64) / count.clamp_min(1)
    if op == "AVG":
        return Column(mean, out_type, has_any)
    var_pop = (s2 / count.clamp_min(1) - mean ** 2).clamp_min(0.0)
    if op == "VAR_POP":
        return Column(var_pop, out_type, has_any)
    var_samp = ((s2 - count * mean ** 2) / (count - 1).clamp_min(1)).clamp_min(0.0)
    ok = count > 1
    if op in ("VAR_SAMP", "VARIANCE"):
        return Column(var_samp, out_type, ok)
    if op == "STDDEV_POP":
        return Column(torch.sqrt(var_pop), out_type, has_any)
    return Column(torch.sqrt(var_samp), out_type, ok)


_SUM_FAMILY = ("SUM", "$SUM0", "AVG", "STDDEV", "STDDEV_POP", "STDDEV_SAMP",
               "VAR_POP", "VAR_SAMP", "VARIANCE")


def _minmax_sentinel(dtype: torch.dtype, op: str):
    if dtype.is_floating_point:
        return math.inf if op == "MIN" else -math.inf
    info = torch.iinfo(dtype)
    return info.max if op == "MIN" else info.min


def segment_aggregate(op: str, col: Optional[Column],
                      codes: Optional[torch.Tensor], num_groups: int,
                      out_type: SqlType,
                      filter_mask: Optional[torch.Tensor] = None,
                      n_rows: int = 0, device: Optional[torch.device] = None
                      ) -> Column:
    """One aggregate over segments. ``codes=None`` means whole-table (1 group)."""
    if codes is None:
        dev = device if col is None else col.device
        codes = torch.zeros(n_rows if col is None else len(col),
                            dtype=torch.int64, device=dev)
        num_groups = 1
    dev = codes.device

    if op in ("COUNT", "REGR_COUNT"):
        if col is None:
            ones = torch.ones(codes.shape[0], dtype=torch.int64, device=dev)
            if filter_mask is not None:
                ones = torch.where(filter_mask, ones, 0)
        else:
            _, valid = _masked(col, filter_mask)
            ones = valid.to(torch.int64)
        return Column(_segment_sum(ones, codes, num_groups), out_type, None)

    if col is None:
        raise ValueError(f"{op} requires an argument")
    data, valid = _masked(col, filter_mask)
    count = _segment_sum(valid.to(torch.int64), codes, num_groups)
    has_any = count > 0

    if op in _SUM_FAMILY:
        dscale = exact_decimal_scale(col.stype) if op in ("SUM", "$SUM0",
                                                          "AVG") else None
        if dscale is not None:
            iwork = torch.where(valid, _decimal_scaled_ints(data, dscale), 0)
            s_int = _segment_sum(iwork, codes, num_groups)
            return _decimal_exact_result(op, s_int, count, dscale, out_type)
        s = _segment_sum(_sum_work(data, valid), codes, num_groups)
        if op == "SUM":
            return Column(s.to(torch_dtype(out_type)), out_type, has_any)
        if op == "$SUM0":
            return Column(s.to(torch_dtype(out_type)), out_type, None)
        s2 = None
        if op != "AVG":
            s2 = _segment_sum(torch.where(valid, data.to(torch.float64) ** 2, 0.0),
                              codes, num_groups)
        return _moments(op, s, s2, count, has_any, out_type)

    if op in ("MIN", "MAX"):
        if col.stype.is_string:
            ranks = col.dict_ranks().data.to(torch.int64)
            sent = _minmax_sentinel(torch.int64, op)
            out_ranks = _segment_minmax(torch.where(valid, ranks, sent), codes,
                                        num_groups, op, sent)
            return _ranks_to_codes(out_ranks, col, out_type, has_any)
        if data.dtype == torch.bool:
            data = data.to(torch.int64)
        sent = _minmax_sentinel(data.dtype, op)
        out = _segment_minmax(torch.where(valid, data, sent), codes, num_groups,
                              op, sent)
        return Column(out.to(torch_dtype(out_type)), out_type, has_any)

    if op in ("EVERY", "BOOL_AND", "BOOL_OR", "ANY"):
        every = op in ("EVERY", "BOOL_AND")
        work = torch.where(valid, data.to(torch.bool), every).to(torch.int32)
        sent = _minmax_sentinel(torch.int32, "MIN" if every else "MAX")
        out = _segment_minmax(work, codes, num_groups,
                              "MIN" if every else "MAX", sent) > 0
        return Column(out, out_type, has_any)

    if op in _PICK_FAMILY:
        n = codes.shape[0]
        idx = torch.arange(n, device=dev)
        if op == "LAST_VALUE":
            pick = _segment_minmax(torch.where(valid, idx, -1), codes,
                                   num_groups, "MAX", -1)
        else:
            pick = _segment_minmax(torch.where(valid, idx, n), codes,
                                   num_groups, "MIN", n)
        return _picked(col, pick, has_any, n)

    if op in _BIT_OPS:
        return _segment_bits(op, data, valid, codes, num_groups, count,
                             has_any, out_type)

    if op == "LISTAGG":
        return _listagg(col, valid, codes, num_groups)

    raise NotImplementedError(f"Aggregate {op} is not ported yet")


_PICK_FAMILY = ("ANY_VALUE", "SINGLE_VALUE", "FIRST_VALUE", "LAST_VALUE")
_BIT_OPS = ("BIT_AND", "BIT_OR", "BIT_XOR")


def _picked(col: Column, pick: torch.Tensor, has_any: torch.Tensor,
            n: int) -> Column:
    """The rows ``pick`` of ``col``, NULL where a group has no valid row."""
    if n == 0:
        # no row to gather: every group is empty, every value NULL
        dictionary = col.dictionary
        if dictionary is not None and not len(dictionary):
            dictionary = np.array([""], dtype=object)
        return Column(torch.zeros_like(pick, dtype=col.data.dtype), col.stype,
                      torch.zeros_like(has_any), dictionary)
    out = col.take(pick.clamp(0, n - 1))
    return Column(out.data, out.stype, out.valid_mask() & has_any,
                  out.dictionary)


def _segment_bits(op: str, data: torch.Tensor, valid: torch.Tensor,
                  codes: torch.Tensor, num_groups: int, count: torch.Tensor,
                  has_any: torch.Tensor, out_type: SqlType) -> Column:
    """BIT_AND / BIT_OR / BIT_XOR per group, on the device: one integer
    segment sum per bit counts the valid rows with that bit set; the bit
    is set in the result where that count equals the group's valid count
    (AND), is positive (OR) or is odd (XOR).  An empty group gets the
    identity (all ones for AND, zero otherwise), as in the JAX package's
    host reduction; it is NULL all the same.  No NULL mask when every
    group has a row."""
    bits = data.element_size() * 8
    out = torch.zeros(num_groups, dtype=data.dtype, device=data.device)
    one = torch.ones((), dtype=data.dtype, device=data.device)
    for b in range(bits):
        bit = torch.where(valid, (data >> b) & 1, 0).to(torch.int64)
        set_rows = _segment_sum(bit, codes, num_groups)
        if op == "BIT_AND":
            on = set_rows == count
        elif op == "BIT_OR":
            on = set_rows > 0
        else:
            on = (set_rows & 1) == 1
        out = out | torch.where(on, one << b, 0).to(data.dtype)
    mask = None if bool(has_any.all()) else has_any
    return Column(out.to(torch_dtype(out_type)), out_type, mask)


def _listagg(col: Column, valid: torch.Tensor, codes: torch.Tensor,
             num_groups: int) -> Column:
    """LISTAGG: each group's valid values as text, joined by ',' in row
    order; NULL for a group without one.  A host loop over the values, as
    in the JAX package (strings live on the host)."""
    vals = col.decode() if col.stype.is_string \
        else col.to_numpy().astype(object)
    outs = [[] for _ in range(num_groups)]
    for c, v, ok in zip(codes.tolist(), vals, valid.tolist()):
        if ok:
            outs[c].append(str(v))
    strs = np.array([",".join(o) if o else None for o in outs], dtype=object)
    return Column._encode_strings(strs, None, codes.device)


def _ranks_to_codes(out_ranks: torch.Tensor, col: Column, out_type: SqlType,
                    has_any: torch.Tensor) -> Column:
    order = torch.from_numpy(dict_sort_order(col.dictionary).astype(np.int64)
                             ).to(out_ranks.device)
    safe = out_ranks.clamp(0, len(order) - 1)
    return Column(order[safe].to(torch.int32), out_type, has_any,
                  col.dictionary)


def sorted_segment_aggregate(op: str, col_sorted: Optional[Column],
                             valid_sorted: Optional[torch.Tensor],
                             codes_sorted: torch.Tensor, starts: torch.Tensor,
                             ends: torch.Tensor, out_type: SqlType) -> Column:
    """One aggregate over a group-sorted stream, gathers and scans only.

    ``col_sorted`` is the argument column already in group order (None for
    COUNT(*)); ``valid_sorted`` the row validity, FILTER and value
    nullability in the same order."""
    from . import sorted_agg as sa

    n = codes_sorted.shape[0]
    if valid_sorted is None:
        valid_sorted = torch.ones(n, dtype=torch.bool,
                                  device=codes_sorted.device)

    if op in ("COUNT", "REGR_COUNT"):
        return Column(sa.seg_count(valid_sorted, starts, ends), out_type, None)

    if col_sorted is None:
        raise ValueError(f"{op} requires an argument")
    data = col_sorted.data
    count = sa.seg_count(valid_sorted, starts, ends)
    has_any = count > 0

    if op in _SUM_FAMILY:
        dscale = exact_decimal_scale(col_sorted.stype) if op in (
            "SUM", "$SUM0", "AVG") else None
        if dscale is not None:
            s_int = sa.seg_sum(_decimal_scaled_ints(data, dscale),
                               valid_sorted, codes_sorted, starts, ends)
            return _decimal_exact_result(op, s_int.to(torch.int64), count,
                                         dscale, out_type)
        s = sa.seg_sum(data, valid_sorted, codes_sorted, starts, ends)
        if op == "SUM":
            return Column(s.to(torch_dtype(out_type)), out_type, has_any)
        if op == "$SUM0":
            return Column(s.to(torch_dtype(out_type)), out_type, None)
        s2 = None
        if op != "AVG":
            s2 = sa.seg_sum(data.to(torch.float64) ** 2, valid_sorted,
                            codes_sorted, starts, ends)
        return _moments(op, s, s2, count, has_any, out_type)

    if op in ("MIN", "MAX"):
        f = sa.seg_min if op == "MIN" else sa.seg_max
        if col_sorted.stype.is_string:
            ranked = col_sorted.dict_ranks().data.to(torch.int64)
            out_ranks = f(ranked, valid_sorted, codes_sorted, ends)
            return _ranks_to_codes(out_ranks, col_sorted, out_type, has_any)
        out = f(data, valid_sorted, codes_sorted, ends)
        return Column(out.to(torch_dtype(out_type)), out_type, has_any)

    if op in ("EVERY", "BOOL_AND", "BOOL_OR", "ANY"):
        every = op in ("EVERY", "BOOL_AND")
        work = torch.where(valid_sorted, data.to(torch.bool), every
                           ).to(torch.int32)
        f = sa.seg_min if every else sa.seg_max
        out = f(work, torch.ones_like(valid_sorted), codes_sorted, ends) > 0
        return Column(out, out_type, has_any)

    if op in _PICK_FAMILY:
        if op == "LAST_VALUE":
            pos = sa.seg_last_valid_pos(valid_sorted, codes_sorted, ends)
        else:
            pos = sa.seg_first_valid_pos(valid_sorted, codes_sorted, ends)
        out = col_sorted.take(pos.clamp(0, max(n - 1, 0)))
        return Column(out.data, out.stype, out.valid_mask() & has_any,
                      out.dictionary)

    raise NotImplementedError(f"Sorted aggregate {op}")


def whole_table_aggregate(op: str, col: Optional[Column],
                          fmask: Optional[torch.Tensor], out_type: SqlType,
                          n_rows: int, device: torch.device) -> Column:
    """Ungrouped aggregate as direct vector reductions -- no segment ops."""
    def _valid(c: Optional[Column]) -> torch.Tensor:
        v = (torch.ones(n_rows, dtype=torch.bool, device=device)
             if fmask is None else fmask)
        if c is not None and c.mask is not None:
            v = v & c.mask
        return v

    if op in ("COUNT", "REGR_COUNT"):
        v = _valid(col)
        return Column(v.to(torch.int64).sum().reshape(1), out_type, None)

    if col is None:
        raise ValueError(f"{op} requires an argument")
    valid = _valid(col)
    data = col.data
    count = valid.to(torch.int64).sum()
    has_any = (count > 0).reshape(1)

    if op in _SUM_FAMILY:
        dscale = exact_decimal_scale(col.stype) if op in ("SUM", "$SUM0",
                                                          "AVG") else None
        if dscale is not None:
            iwork = torch.where(valid, _decimal_scaled_ints(data, dscale), 0)
            return _decimal_exact_result(op, iwork.sum().reshape(1), count,
                                         dscale, out_type)
        s = _sum_work(data, valid).sum().reshape(1)
        if op == "SUM":
            return Column(s.to(torch_dtype(out_type)), out_type, has_any)
        if op == "$SUM0":
            return Column(s.to(torch_dtype(out_type)), out_type, None)
        s2 = None
        if op != "AVG":
            s2 = torch.where(valid, data.to(torch.float64) ** 2, 0.0).sum().reshape(1)
        return _moments(op, s, s2, count, has_any, out_type)

    if op in ("MIN", "MAX"):
        reduce = torch.amin if op == "MIN" else torch.amax
        if col.stype.is_string:
            if n_rows == 0:
                # no row: one NULL (code 0 of a dictionary that has one)
                d = col.dictionary if len(col.dictionary) else \
                    np.array([""], dtype=object)
                return Column(torch.zeros(1, dtype=torch.int32, device=device),
                              out_type, has_any, d)
            ranks = col.dict_ranks().data.to(torch.int64)
            sent = _minmax_sentinel(torch.int64, op)
            r = reduce(torch.where(valid, ranks, sent)).reshape(1)
            return _ranks_to_codes(r, col, out_type, has_any)
        if data.dtype == torch.bool:
            data = data.to(torch.int64)
        sent = _minmax_sentinel(data.dtype, op)
        if n_rows == 0:
            out = torch.full((1,), sent, dtype=data.dtype, device=device)
        else:
            out = reduce(torch.where(valid, data, sent)).reshape(1)
        return Column(out.to(torch_dtype(out_type)), out_type, has_any)

    if op in ("EVERY", "BOOL_AND"):
        out = torch.where(valid, data.to(torch.bool), True).all().reshape(1)
        return Column(out, out_type, has_any)
    if op in ("BOOL_OR", "ANY"):
        out = torch.where(valid, data.to(torch.bool), False).any().reshape(1)
        return Column(out, out_type, has_any)

    if op in _PICK_FAMILY:
        idx = torch.arange(n_rows, dtype=torch.int64, device=device)
        if n_rows == 0:
            pos = idx.new_zeros(1)
        elif op == "LAST_VALUE":
            pos = torch.where(valid, idx, -1).max().reshape(1)
        else:
            pos = torch.where(valid, idx, n_rows).min().reshape(1)
        return _picked(col, pos, has_any, n_rows)

    if op in _BIT_OPS or op == "LISTAGG":
        # the segment forms over one group
        zeros = torch.zeros(n_rows, dtype=torch.int64, device=device)
        return segment_aggregate(op, col, zeros, 1, out_type, fmask, n_rows)

    raise NotImplementedError(f"Whole-table aggregate {op} is not ported yet")
