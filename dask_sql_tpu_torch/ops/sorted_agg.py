"""Segmented aggregation over group-sorted rows, without scatters.

The counterpart of ``dask_sql_tpu/ops/sorted_agg.py``, used by the compiled
tier's sorted GROUP BY (``DSQL_STRATEGY=tpu``) through
``groupby.sorted_segment_aggregate``.  Rows are sorted by group code
ascending (invalid rows past every real code), so segment g is the
half-open range [starts[g], ends[g]).  Aggregates are prefix-sum
differences (the SUM/COUNT family over integers) or segmented inclusive
scans (float sums, MIN/MAX, first/last positions).  The JAX package's
``associative_scan`` becomes the doubling scan of ``ops/window.py``; its
float sums may differ from the JAX package's in the last bits (another
order of additions), its integer and MIN/MAX results are equal.

``ieee_reassemble``: a sum of values with NaN/+Inf/-Inf replaced by 0,
plus per-group counts of each non-finite kind, recombines to the IEEE sum
(shared with the fixed-point kernel's route, ``ops/gpu_kernels.py``).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def ieee_reassemble(clean: torch.Tensor, nan_c: torch.Tensor,
                    pos_c: torch.Tensor, neg_c: torch.Tensor) -> torch.Tensor:
    """Recombine a sanitized sum with non-finite indicator counts."""
    out = torch.where(pos_c > 0, math.inf, clean)
    out = torch.where(neg_c > 0, -math.inf, out)
    out = torch.where((pos_c > 0) & (neg_c > 0), math.nan, out)
    return torch.where(nan_c > 0, math.nan, out)


def segment_bounds(codes_sorted: torch.Tensor, cap: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[starts, ends) of each group slot 0..cap-1 in the sorted code stream
    (codes are dense ranks; slot ``cap`` is the invalid rows' trash).  The
    k-th boundary in the stream is the start of slot k; empty slots
    collapse to [nvalid, nvalid)."""
    n = codes_sorted.shape[0]
    dev = codes_sorted.device
    valid = codes_sorted < cap
    first = torch.ones(min(n, 1), dtype=torch.bool, device=dev)
    boundary = valid & torch.cat([first, codes_sorted[1:] != codes_sorted[:-1]])
    pos = torch.where(boundary, torch.arange(n, dtype=torch.int64, device=dev),
                      n)
    pos = torch.sort(pos).values
    if n < cap:
        pos = torch.cat([pos, torch.full((cap - n,), n, dtype=torch.int64,
                                         device=dev)])
    starts = pos[:cap]
    nvalid = valid.to(torch.int64).sum()
    ends = torch.minimum(
        torch.cat([starts[1:], torch.full((1,), n, dtype=torch.int64,
                                          device=dev)]), nvalid)
    starts = torch.minimum(starts, nvalid)
    return starts, ends


def _prefix(x: torch.Tensor) -> torch.Tensor:
    """prefix[i] = sum(x[:i])."""
    return torch.cat([torch.zeros(1, dtype=x.dtype, device=x.device),
                      torch.cumsum(x, 0)])


def seg_count(valid: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor
              ) -> torch.Tensor:
    p = _prefix(valid.to(torch.int64))
    return p[ends] - p[starts]


def seg_sum(values: torch.Tensor, valid: torch.Tensor,
            codes_sorted: torch.Tensor, starts: torch.Tensor,
            ends: torch.Tensor) -> torch.Tensor:
    """Masked segmented sum: integers by the exact prefix-sum difference
    (int64 wraps cancel), floats by the per-segment scan (a global prefix
    would mix magnitudes across groups, and NaN/Inf stay in their group)."""
    if values.dtype.is_floating_point:
        v = torch.where(valid, values.to(torch.float64), 0.0)
        return seg_reduce_scan_codes(v, torch.ones_like(valid), codes_sorted,
                                     ends, torch.add, 0.0, starts=starts)
    p = _prefix(torch.where(valid, values.to(torch.int64), 0))
    return p[ends] - p[starts]


def _segmented_scan(values: torch.Tensor, segment_start: torch.Tensor,
                    combine) -> torch.Tensor:
    """Inclusive segmented scan, restarting at segment starts; element
    ends[g]-1 holds segment g's total."""
    from .window import segmented_scan
    return segmented_scan(values, segment_start, combine)


def seg_reduce_scan_codes(values: torch.Tensor, valid: torch.Tensor,
                          codes_sorted: torch.Tensor, ends: torch.Tensor,
                          combine, identity,
                          starts: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Segmented reduction by a scan over the sorted stream, segment starts
    from adjacent codes.  With ``starts``, empty slots give ``identity``
    (the gather at ends-1 would land in the previous segment)."""
    n = values.shape[0]
    if n == 0:
        return torch.full(ends.shape, identity, dtype=values.dtype,
                          device=values.device)
    flags = torch.cat([torch.ones(1, dtype=torch.bool, device=values.device),
                       codes_sorted[1:] != codes_sorted[:-1]])
    work = torch.where(valid, values, identity)
    scanned = _segmented_scan(work, flags, combine)
    out = scanned[(ends - 1).clamp(0, n - 1)]
    if starts is not None:
        out = torch.where(ends > starts, out, identity)
    return out


def _ident_minmax(values: torch.Tensor, low: bool):
    if values.dtype.is_floating_point:
        return values, (math.inf if low else -math.inf)
    if values.dtype == torch.bool:
        return values.to(torch.int64), (1 if low else 0)
    info = torch.iinfo(values.dtype)
    return values, (info.max if low else info.min)


def seg_min(values, valid, codes_sorted, ends):
    values, ident = _ident_minmax(values, True)
    return seg_reduce_scan_codes(values, valid, codes_sorted, ends,
                                 torch.minimum, ident)


def seg_max(values, valid, codes_sorted, ends):
    values, ident = _ident_minmax(values, False)
    return seg_reduce_scan_codes(values, valid, codes_sorted, ends,
                                 torch.maximum, ident)


def seg_first_valid_pos(valid: torch.Tensor, codes_sorted: torch.Tensor,
                        ends: torch.Tensor) -> torch.Tensor:
    """Sorted-stream position of each segment's first valid row (n if none)."""
    n = valid.shape[0]
    idx = torch.where(valid, torch.arange(n, dtype=torch.int64,
                                          device=valid.device), n)
    return seg_reduce_scan_codes(idx, torch.ones_like(valid), codes_sorted,
                                 ends, torch.minimum, n)


def seg_last_valid_pos(valid: torch.Tensor, codes_sorted: torch.Tensor,
                       ends: torch.Tensor) -> torch.Tensor:
    n = valid.shape[0]
    idx = torch.where(valid, torch.arange(n, dtype=torch.int64,
                                          device=valid.device), -1)
    return seg_reduce_scan_codes(idx, torch.ones_like(valid), codes_sorted,
                                 ends, torch.maximum, -1)
