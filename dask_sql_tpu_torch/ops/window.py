"""Window functions as sorted segmented scans.

The counterpart of ``dask_sql_tpu/ops/window.py``: rows are sorted by
(partition, order keys) with a chain of stable sorts, segment and peer
bounds come from scans over the sorted stream, each function is computed
in sorted order, and one scatter puts the result back in row order.

``jax.lax.associative_scan`` has no torch counterpart.  The scans over
positions (segment starts and ends, peer-group bounds) have an exact
closed form: a binary search of the running count of starts
(``_run_bounds``; ``cummax`` of flagged positions is exact too, but its
CUDA kernel, which also computes indices, took 17 ms per 6 M rows on an
H100); the value scans of MIN / MAX are a log-depth doubling loop
(``segmented_scan``), exact because they only select.  Integer prefix sums are exact differences of one global
``cumsum``; float frame sums are differences of one global prefix sum, as
in the JAX package, so they round in the prefix sum's order.

NTILE, LAG / LEAD and NTH_VALUE read their constant argument from column
data on the host: one synchronisation each.

NTILE gives SQL's buckets (the first n mod k one row larger), where the
JAX package's formula sizes them otherwise; LAG / LEAD give their third
argument (the default) outside the partition, where the JAX package gives
NULL; string-valued results (LAG of a string, FIRST_VALUE, MIN / MAX of a
string, ...) carry their dictionary, where the JAX package's raise.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..table import Column, Table, dict_sort_order
from ..types import SqlType, torch_dtype
from .kernels import (append_lexsort_operands, comparable_data, key_parts,
                      unify_string_codes)


#: window functions the compiled tier traces (the JAX package's set)
TRACE_SAFE_OPS = frozenset({
    "ROW_NUMBER", "RANK", "DENSE_RANK", "PERCENT_RANK", "CUME_DIST",
    "COUNT", "SUM", "$SUM0", "AVG", "MIN", "MAX",
    "FIRST_VALUE", "LAST_VALUE", "SINGLE_VALUE",
})


def _adjacent_diff(channels, n: int, device) -> torch.Tensor:
    """Row 0 True; row i True iff any (sorted) channel differs from row i-1.
    (Built by concatenation: ``out[0] = True`` on a card tensor copies a
    host scalar and synchronises.)"""
    diff = torch.zeros(max(n - 1, 0), dtype=torch.bool, device=device)
    for ch in channels:
        diff |= ch[1:] != ch[:-1]
    return torch.cat([torch.ones(min(n, 1), dtype=torch.bool, device=device),
                      diff])


def _run_bounds(starts: torch.Tensor):
    """(first, last) position of each row's run, where a run begins at each
    True of ``starts`` (row 0 must be True): the running count of starts
    is non-decreasing, so a binary search of it for each row's own count
    finds both ends (exact, no scan with indices)."""
    c = torch.cumsum(starts, 0)
    return (torch.searchsorted(c, c),
            torch.searchsorted(c, c, right=True) - 1)


def segmented_cumsum(x: torch.Tensor, seg_start: torch.Tensor) -> torch.Tensor:
    """Inclusive integer prefix sum that restarts at each row's segment
    start ``seg_start``: the global prefix sum less its value before the
    segment (exact)."""
    c = torch.cumsum(x, 0)
    return c - (c[seg_start] - x[seg_start])


def segmented_scan(x: torch.Tensor, starts: torch.Tensor, combine,
                   span: Optional[int] = None) -> torch.Tensor:
    """Inclusive scan of ``combine`` that restarts at ``starts``: a doubling
    loop over (flag, value) pairs, ceil(log2(span)) passes, where ``span``
    bounds the distance from any row back to its flag (default: n)."""
    n = x.shape[0]
    limit = n if span is None else min(span, n)
    v, f = x, starts
    d = 1
    while d < limit:
        nv = torch.where(f[d:], v[d:], combine(v[:-d], v[d:]))
        v = torch.cat([v[:d], nv])
        f = torch.cat([f[:d], f[d:] | f[:-d]])
        d *= 2
    return v


def _reverse_scan(x, flags_rev, combine, span=None):
    flip = lambda t: torch.flip(t, (0,))  # noqa: E731
    return flip(segmented_scan(flip(x), flags_rev, combine, span))


def window_frame_sums(x: torch.Tensor, start: torch.Tensor,
                      end: torch.Tensor) -> torch.Tensor:
    """Moving SUM/COUNT over per-row inclusive frame bounds (in sorted
    order, already clipped to the segment) by one prefix sum; an empty
    frame (``end < start``) sums to 0."""
    n = x.shape[0]
    prefix = torch.cumsum(x, 0)
    upper = prefix[end.clamp(0, n - 1)]
    start_c = start.clamp(0, n - 1)
    lower = torch.where(start_c > 0, prefix[(start_c - 1).clamp_min(0)],
                        torch.zeros((), dtype=prefix.dtype, device=x.device))
    return torch.where(end < start, torch.zeros((), dtype=prefix.dtype,
                                                device=x.device),
                       upper - lower)


def _lexsort(arrays: List[torch.Tensor], n: int, device) -> torch.Tensor:
    """Stable permutation by ``arrays`` (least significant first), as
    ``jnp.lexsort``: a chain of stable sorts, each of the last's result."""
    perm = torch.arange(n, device=device)
    for a in arrays:
        perm = perm[torch.sort(a[perm], stable=True).indices]
    return perm


def compute_window(table: Table, op: str, arg_cols: List[int],
                   partition_cols: List[int],
                   order_keys: List[Tuple[int, bool, bool]],
                   frame, stype: SqlType,
                   row_valid: Optional[torch.Tensor] = None) -> Column:
    """One window call as a column aligned with the table's rows.

    ``row_valid`` (the compiled tier's padded tables): invalid rows sort
    into their own trailing segment so that they never enter a real
    partition; their outputs are garbage for the caller's mask."""
    n = table.num_rows
    device = table.columns[0].device if table.columns else torch.device("cpu")
    if n == 0:
        return Column(torch.zeros(0, dtype=torch_dtype(stype), device=device),
                      stype, None,
                      np.array([], dtype=object) if stype.is_string else None)

    # 1. sort by (validity, partition, order keys); operands least
    # significant first, as for lexsort
    arrays = []
    for idx, asc, nulls_first in reversed(order_keys):
        col = table.columns[idx]
        data = comparable_data(col)
        if not data.dtype.is_floating_point:
            data = data.to(torch.int64)
        if not asc:
            data = -data
        arrays.append(data)
        if col.mask is not None:
            nullkey = (~col.mask).to(torch.int8)
            arrays.append(nullkey if not nulls_first else -nullkey)
    n_ord_ops = len(arrays)
    part_parts = key_parts([table.columns[i] for i in partition_cols]) \
        if partition_cols else []
    append_lexsort_operands(arrays, list(reversed(part_parts)))
    if row_valid is not None:
        arrays.append((~row_valid).to(torch.int8))  # invalid rows last

    arg_col0 = table.columns[arg_cols[0]] if arg_cols else None
    keys_msf = list(reversed(arrays))  # most significant first
    if keys_msf:
        perm = _lexsort(arrays, n, device)
        keys_sorted = [k[perm] for k in keys_msf]
    else:
        perm = torch.arange(n, device=device)
        keys_sorted = []

    def sorted_arg() -> Column:
        return arg_col0.take(perm)

    # 2. segment starts from adjacent differences of the sorted partition
    # (and validity) channels; peer groups from the order channels
    n_seg_ops = len(keys_msf) - n_ord_ops
    starts = _adjacent_diff(keys_sorted[:n_seg_ops], n, device)
    tie = (_adjacent_diff(keys_sorted[n_seg_ops:], n, device) & ~starts
           if order_keys else torch.zeros(n, dtype=torch.bool, device=device))
    pos = torch.arange(n, device=device)
    seg_start, seg_end = _run_bounds(starts)
    # the reverse stream's segment starts: row i is last of its segment iff
    # i == n-1 or starts[i+1]
    ends_flags = torch.flip(torch.cat([starts[1:], starts[:1]]), (0,))
    row_in_seg = pos - seg_start

    # peer-group bounds: SQL's default frame and RANGE CURRENT ROW include
    # the current row's peers
    if order_keys:
        tie_start, tie_end = _run_bounds(tie | starts)
    else:
        tie_start, tie_end = seg_start, seg_end

    def _value_bound(delta: float, side: str) -> torch.Tensor:
        """RANGE <offset> PRECEDING/FOLLOWING: positions by ORDER BY value,
        on the transformed (DESC-negated) sort channel, so the frame is
        [t + delta_lo, t + delta_hi] in sorted space.  A per-segment offset
        larger than the value span makes one globally sorted float64
        composite, so one searchsorted respects the segments.  Non-finite
        keys and invalid rows are clamped just outside the finite span
        (int64 keys above 2**53 lose ulps here)."""
        if len(order_keys) != 1:
            raise NotImplementedError(
                "RANGE offset frame requires exactly one ORDER BY key")
        kcol = table.columns[order_keys[0][0]]
        if kcol.mask is not None:
            raise NotImplementedError(
                "RANGE offset frame over a nullable ORDER BY key")
        t = keys_sorted[n_seg_ops]
        if not (t.dtype.is_floating_point or t.dtype == torch.int64):
            raise NotImplementedError(
                "RANGE offset frame requires a numeric ORDER BY key")
        tf = t.to(torch.float64)
        real = torch.isfinite(tf)
        if row_valid is not None:
            real = real & (keys_sorted[0] == 0)  # invalid rows sort last
        any_real = real.any()
        lo_r = torch.where(real, tf, torch.inf).min()
        hi_r = torch.where(real, tf, -torch.inf).max()
        lo_r = torch.where(any_real, lo_r, 0.0)
        hi_r = torch.where(any_real, hi_r, 0.0)
        neg = torch.isneginf(tf)
        tf_c = torch.where(real, tf, torch.where(neg, lo_r - 1.0, hi_r + 1.0))
        big = (hi_r - lo_r + 2.0) + (abs(delta) + 1.0)
        seg_id = torch.cumsum(starts.to(torch.int64), 0).to(torch.float64)
        g = tf_c + seg_id * big
        if side == "start":
            return torch.searchsorted(g, g + delta)
        return torch.searchsorted(g, g + delta, right=True) - 1

    def _resolve_bound(bound, which: str, kind: str):
        """(positions, kind) for one frame bound; kind is 'unb', 'fixed'
        (a row offset) or 'var' (peer or value positions)."""
        tag, nval = bound
        if tag == "UNBOUNDED_PRECEDING":
            return seg_start, "unb"
        if tag == "UNBOUNDED_FOLLOWING":
            return seg_end, "unb"
        if tag == "CURRENT":
            if kind == "RANGE":
                return (tie_start if which == "lo" else tie_end), "var"
            return pos, "fixed"
        delta = -float(nval) if tag == "PRECEDING" else float(nval)
        if kind == "ROWS":
            arr = pos + int(delta)
            arr = (torch.maximum(arr, seg_start) if which == "lo"
                   else torch.minimum(arr, seg_end))
            return arr, "fixed"
        return _value_bound(delta, "start" if which == "lo" else "end"), "var"

    # resolve the frame to per-row inclusive [fstart, fend] positions
    if frame is None:
        if order_keys and op not in ("ROW_NUMBER", "RANK", "DENSE_RANK"):
            # SQL default: RANGE UNBOUNDED PRECEDING .. CURRENT ROW
            fstart, lo_kind = seg_start, "unb"
            fend, hi_kind = tie_end, "var"
        else:
            fstart, lo_kind = seg_start, "unb"
            fend, hi_kind = seg_end, "unb"
        lo_off, hi_off = None, None
    else:
        kind = frame[0]
        fstart, lo_kind = _resolve_bound(frame[1], "lo", kind)
        fend, hi_kind = _resolve_bound(frame[2], "hi", kind)
        # row offsets, for the bounded MIN/MAX path
        lo_off = (int(-frame[1][1]) if frame[1][0] == "PRECEDING"
                  else int(frame[1][1]) if frame[1][0] == "FOLLOWING" else 0)
        hi_off = (int(-frame[2][1]) if frame[2][0] == "PRECEDING"
                  else int(frame[2][1]) if frame[2][0] == "FOLLOWING" else 0)

    def scatter_back(sorted_vals, mask_sorted=None, dictionary=None):
        """Sorted order -> row order: one scatter through ``perm``.  A
        string result passes the dictionary its int32 codes index."""
        out = torch.empty_like(sorted_vals)
        out[perm] = sorted_vals
        m = None
        if mask_sorted is not None:
            m = torch.empty_like(mask_sorted)
            m[perm] = mask_sorted
        return Column(out.to(torch_dtype(stype)), stype, m, dictionary)

    if op == "ROW_NUMBER":
        return scatter_back(row_in_seg + 1)

    if op in ("RANK", "DENSE_RANK", "PERCENT_RANK", "CUME_DIST"):
        rank = tie_start - seg_start + 1
        if op == "RANK":
            return scatter_back(rank)
        seg_len = seg_end - seg_start + 1
        f64 = lambda t: t.to(torch.float64)  # noqa: E731 (torch: int / int is f32)
        if op == "PERCENT_RANK":
            return scatter_back(torch.where(
                seg_len > 1, f64(rank - 1) / f64((seg_len - 1).clamp_min(1)),
                0.0))
        if op == "CUME_DIST":
            # rows with an order key <= the current one: the end of the peers
            return scatter_back(f64(tie_end - seg_start + 1) / f64(seg_len))
        # DENSE_RANK: peer-group starts up to here within the segment
        return scatter_back(segmented_cumsum((tie | starts).to(torch.int64),
                                             seg_start))

    if op == "NTILE":
        # SQL's buckets: the first (n mod k) hold one row more.  (The JAX
        # package's floor(row * k / n) + 1 sizes them otherwise, e.g.
        # 2, 1, 2, 1 for six rows in four buckets.)
        k = int(table.columns[arg_cols[0]].data[0]) if arg_cols else 1
        seg_len = seg_end - seg_start + 1
        q = torch.div(seg_len, k, rounding_mode="floor")
        r = seg_len - q * k
        big = r * (q + 1)
        fdiv = lambda a, b: torch.div(a, b, rounding_mode="floor")  # noqa: E731
        return scatter_back(torch.where(
            row_in_seg < big, fdiv(row_in_seg, q + 1),
            r + fdiv(row_in_seg - big, q.clamp_min(1))) + 1)

    if op in ("LAG", "LEAD"):
        col = table.columns[arg_cols[0]]
        offset = 1
        if len(arg_cols) > 1:
            offset = int(table.columns[arg_cols[1]].data[0])
        src = pos + (-offset if op == "LAG" else offset)
        valid = (src >= seg_start) & (src <= seg_end)
        gathered = sorted_arg().take(src.clamp(0, n - 1))
        data, mask = gathered.data, gathered.valid_mask() & valid
        dictionary = col.dictionary
        if len(arg_cols) > 2:
            # SQL's default: where the offset row lies outside the
            # partition, the third argument at the current row
            dflt = table.columns[arg_cols[2]].take(perm)
            if stype.is_string:
                codes, dcodes = unify_string_codes([gathered, dflt])
                dictionary = np.unique(np.concatenate(
                    [gathered.dictionary.astype(str),
                     dflt.dictionary.astype(str)])).astype(object)
                data, fill = codes.to(torch.int32), dcodes.to(torch.int32)
            else:
                fill = dflt.data.to(data.dtype)
            data = torch.where(valid, data, fill)
            mask = torch.where(valid, mask, dflt.valid_mask())
        return scatter_back(data, mask, dictionary)

    if op in ("FIRST_VALUE", "LAST_VALUE", "NTH_VALUE"):
        # the frame applies: FIRST_VALUE is the first frame row,
        # LAST_VALUE the last (under the default frame the current row's
        # last peer)
        col = sorted_arg()
        in_frame = fend >= fstart
        if op == "FIRST_VALUE":
            src = fstart
        elif op == "LAST_VALUE":
            src = fend
        else:
            k = int(table.columns[arg_cols[1]].data[0])
            src = fstart + (k - 1)
            in_frame = in_frame & (src <= fend)
            src = torch.minimum(src, torch.maximum(fend, fstart))
        gathered = col.take(src.clamp(0, n - 1))
        return scatter_back(gathered.data, gathered.valid_mask() & in_frame,
                            col.dictionary)

    # aggregate window functions
    if op == "COUNT":
        if arg_cols:
            x = sorted_arg().valid_mask().to(torch.int64)
        else:
            x = torch.ones(n, dtype=torch.int64, device=device)
        return scatter_back(window_frame_sums(x, fstart, fend))

    if op in ("SUM", "$SUM0", "AVG"):
        col = sorted_arg()
        valid = col.valid_mask()
        data = col.data.to(torch.int64 if not col.data.dtype.is_floating_point
                           else torch.float64)
        data = torch.where(valid, data, torch.zeros((), dtype=data.dtype,
                                                    device=device))
        s = window_frame_sums(data, fstart, fend)
        c = window_frame_sums(valid.to(torch.int64), fstart, fend)
        if op == "AVG":
            return scatter_back(s.to(torch.float64) / c.clamp_min(1), c > 0)
        if op == "$SUM0":
            return scatter_back(s)
        return scatter_back(s, c > 0)

    if op in ("MIN", "MAX"):
        col = sorted_arg()
        valid = col.valid_mask()
        data = comparable_data(col)
        if not data.dtype.is_floating_point:
            data = data.to(torch.int64)
            info = torch.iinfo(torch.int64)
            sentinel = info.max if op == "MIN" else info.min
        else:
            data = data.to(torch.float64)
            sentinel = torch.inf if op == "MIN" else -torch.inf
        x = torch.where(valid, data, sentinel)
        combine = torch.minimum if op == "MIN" else torch.maximum
        if lo_kind == "unb" and hi_kind == "unb":
            # whole partition: segment reduce, then broadcast
            out = segmented_scan(x, starts, combine)[seg_end]
        elif lo_kind == "unb":
            # UNBOUNDED PRECEDING .. bound: prefix scan and one gather
            fwd = segmented_scan(x, starts, combine)
            out = fwd[torch.minimum(torch.maximum(fend, seg_start), seg_end)]
        elif hi_kind == "unb":
            # bound .. UNBOUNDED FOLLOWING: suffix scan and one gather
            bwd = _reverse_scan(x, ends_flags, combine)
            out = bwd[torch.minimum(torch.maximum(fstart, seg_start), seg_end)]
        elif lo_kind == "var" or hi_kind == "var":
            raise NotImplementedError(
                "MIN/MAX over a RANGE frame bounded on both sides")
        else:
            # bounded frame: van Herk's two scans over width-w blocks; an
            # unclipped frame [a, a+w-1] spans at most two blocks.  Frames
            # clipped by a segment edge select from plain segment scans
            w = max(hi_off - lo_off + 1, 1)
            a_raw, b_raw = pos + lo_off, pos + hi_off
            low_clip, high_clip = a_raw < seg_start, b_raw > seg_end
            fwd_vh = segmented_scan(x, starts | (pos % w == 0), combine, w)
            rev_block = torch.flip(pos % w == w - 1, (0,)) | (pos == 0)
            bwd_vh = _reverse_scan(x, ends_flags | rev_block, combine, w)
            fwd_seg = segmented_scan(x, starts, combine)
            bwd_seg = _reverse_scan(x, ends_flags, combine)
            vh = combine(bwd_vh[a_raw.clamp(0, n - 1)],
                         fwd_vh[b_raw.clamp(0, n - 1)])
            cum = fwd_seg[torch.minimum(torch.maximum(b_raw, seg_start),
                                        seg_end)]
            suf = bwd_seg[torch.minimum(torch.maximum(a_raw, seg_start),
                                        seg_end)]
            tot = fwd_seg[seg_end]
            out = torch.where(low_clip & high_clip, tot,
                              torch.where(low_clip, cum,
                                          torch.where(high_clip, suf, vh)))
        m = window_frame_sums(valid.to(torch.int64), fstart, fend) > 0
        if col.stype.is_string:
            return _ranks_to_string(scatter_back(out, m, col.dictionary))
        return scatter_back(out, m)

    if op == "SINGLE_VALUE":
        col = sorted_arg()
        g = col.take(seg_start)
        return scatter_back(g.data, g.mask, col.dictionary)

    raise NotImplementedError(f"Window function {op}")


def _ranks_to_string(ranks: Column) -> Column:
    """A string column holding dictionary ranks -> the same column of codes."""
    order = torch.from_numpy(dict_sort_order(ranks.dictionary).astype(np.int64)
                             ).to(ranks.data.device)
    safe = ranks.data.to(torch.int64).clamp(0, len(order) - 1)
    return Column(order[safe].to(torch.int32), ranks.stype, ranks.mask,
                  ranks.dictionary)
