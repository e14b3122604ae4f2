"""Segmented aggregation: SQL GROUP BY on the device.

The counterpart of ``dask_sql_tpu/ops/groupby.py``: keys factorize to dense
codes (NULLs form their own group), then every aggregate is a segment
reduction (``index_add_`` / ``scatter_reduce_``).  Ported here: the hash
variant of ``group_codes``, ``segment_aggregate`` and
``whole_table_aggregate``, and the row selections behind DISTINCT
(``distinct_rows``, ``dedup_for_distinct_agg``); the dense and sorted code
variants wait.
"""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from ..table import dict_sort_order, Column
from ..types import SqlType, exact_decimal_scale, torch_dtype
from .kernels import decimal_unscale, factorize_columns


def group_codes(key_cols: List[Column]):
    """Factorize group keys into dense codes 0..G-1 (ascending key order,
    NULL groups first).  Returns (codes, first_row_per_group, G)."""
    return factorize_columns(key_cols)


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

    raise NotImplementedError(f"Aggregate {op} is not ported yet")


def _ranks_to_codes(out_ranks: torch.Tensor, col: Column, out_type: SqlType,
                    has_any: torch.Tensor) -> Column:
    order = torch.from_numpy(dict_sort_order(col.dictionary).astype(np.int64)
                             ).to(out_ranks.device)
    safe = out_ranks.clamp(0, len(order) - 1)
    return Column(order[safe].to(torch.int32), out_type, has_any,
                  col.dictionary)


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

    raise NotImplementedError(f"Whole-table aggregate {op} is not ported yet")
