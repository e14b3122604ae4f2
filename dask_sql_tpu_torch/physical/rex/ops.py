"""Scalar operation library: REX op name -> device function.

The counterpart of ``dask_sql_tpu/physical/rex/ops.py``, with the same
``OPERATION_MAPPING`` keys: logic and comparisons with three-valued NULL
semantics, SQL truncating division, CASE / COALESCE / NULLIF / GREATEST /
LEAST, IS [NOT] TRUE / FALSE / NULL / DISTINCT FROM, IN lists and SEARCH,
LIKE / ILIKE / SIMILAR TO, the math functions, FLOOR / CEIL on numbers and
on dates, seeded RAND, the string functions and EXTRACT with its
shorthands.

String functions run once per dictionary entry on the host and map back
to the rows by a gather on the device (``map_dictionary``); only an
operator over several string columns at once, or a per-row LIKE pattern,
decodes rows on the host.  LIKE over a dictionary of at least
``DSQL_DEVICE_STRING_THRESHOLD`` entries matches on the device
(``ops/strings_fast.py``).

Value model: every op takes a list of Column/Scalar args plus the
binder-inferred result type and returns Column or Scalar.  Python float
scalars enter tensor arithmetic as float64 tensors, so an int column times
a float literal computes in float64 as it does under JAX's x64 mode (torch
would otherwise take a Python float as float32); DOUBLE-valued functions
of integer columns compute in float64 for the same reason.

Where the JAX package's answer is not SQL's, the port gives SQL's:
``POWER`` of integers with a negative exponent (JAX: INT64_MIN; here
``POWER(2, -1) = 0.5``), ``CBRT`` of a negative literal (JAX: the real part
of a complex root) and ``GREATEST`` / ``LEAST`` over strings (JAX raises).
"""
from __future__ import annotations

import math
import re
from typing import Callable, List, Optional, Union

import numpy as np
import torch

from ...ops import strings_fast as SF
from ...ops.kernels import (
    US_PER_DAY, civil_from_days, days_from_civil, extract_field,
    timestamp_time_of_day_us, timestamp_to_days, trunc_date,
    unify_string_codes,
)
from ...table import Column, Scalar
from ...types import (
    BOOLEAN, DOUBLE, VARCHAR, SqlType, physical_dtype, torch_dtype,
)

Value = Union[Column, Scalar]


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def is_string_value(v: Value) -> bool:
    return v.stype.is_string or (isinstance(v, Scalar) and isinstance(v.value, str))


def combine_masks(*vals: Value) -> Optional[torch.Tensor]:
    mask = None
    for v in vals:
        if isinstance(v, Column) and v.mask is not None:
            mask = v.mask if mask is None else (mask & v.mask)
    return mask


def _column_of(args: List[Value]) -> Optional[Column]:
    for a in args:
        if isinstance(a, Column):
            return a
    return None


def all_null_column(length: int, stype: SqlType, device) -> Column:
    return Column.from_scalar(Scalar(None, stype), length, device)


def _data(v: Value, device=None):
    """Tensor for a Column; for a Scalar, the Python value, or a float64
    tensor on ``device`` for a Python float (see the module docstring)."""
    if isinstance(v, Column):
        return v.data
    if isinstance(v.value, float) and device is not None:
        return torch.tensor(v.value, dtype=torch.float64, device=device)
    return v.value


def _any_null_scalar(args: List[Value]) -> bool:
    return any(isinstance(a, Scalar) and a.is_null for a in args)


def _null_result(args: List[Value], stype: SqlType) -> Value:
    c = _column_of(args)
    if c is None:
        return Scalar(None, stype)
    return all_null_column(len(c), stype, c.device)


# ---------------------------------------------------------------------------
# elementwise numeric ops
# ---------------------------------------------------------------------------

def numeric_op(fn: Callable, py_fn: Optional[Callable] = None):
    """Lift a tensor elementwise function into the Column/Scalar value model
    with NULL propagation."""

    def op(args: List[Value], stype: SqlType, ctx) -> Value:
        if _any_null_scalar(args):
            return _null_result(args, stype)
        col = _column_of(args)
        if col is None:
            out = (py_fn or fn)(*[a.value for a in args])
            if stype.is_integer and out is not None and not isinstance(out, bool):
                out = int(out)
            return Scalar(out, stype)
        out = fn(*[_data(a, col.device) for a in args])
        if not stype.is_string:
            out = out.to(torch_dtype(stype))
        return Column(out, stype, combine_masks(*args))

    return op


def _tensors(a, b):
    """Both operands as tensors on the column's device (a Python int
    scalar becomes a 0-dim tensor, which does not widen the column)."""
    dev = (a if isinstance(a, torch.Tensor) else b).device
    return torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev)


def sql_div(a, b):
    """SQL division: truncates toward zero for integers, and an integer
    divided by zero gives 0, as in the JAX package
    (``sign(a) * sign(b) * (|a| // |b|)``).  Floats keep IEEE results."""
    ta, tb = _tensors(a, b)
    if ta.dtype.is_floating_point or tb.dtype.is_floating_point:
        return ta / tb
    bb = tb.abs()
    q = torch.div(ta.abs(), torch.where(bb == 0, 1, bb), rounding_mode="floor")
    return torch.sign(ta) * torch.sign(tb) * q


def _py_div(a, b):
    if isinstance(a, int) and isinstance(b, int):
        return int(a / b) if b != 0 else None
    if b == 0:
        with np.errstate(divide="ignore", invalid="ignore"):
            return float(np.float64(a) / np.float64(b))
    return a / b


def _sql_mod(a, b):
    """``sign(a) * (|a| % |b|)``, a scalar on either side; an integer
    modulo zero gives 0, as in the JAX package."""
    ta, tb = _tensors(a, b)
    aa, bb = ta.abs(), tb.abs()
    if ta.dtype.is_floating_point or tb.dtype.is_floating_point:
        return torch.sign(ta) * torch.remainder(aa, bb)
    r = torch.remainder(aa, torch.where(bb == 0, 1, bb))
    return torch.sign(ta) * torch.where(bb == 0, 0, r)


def _py_mod(a, b):
    return math.copysign(abs(a) % abs(b), a)


# ---------------------------------------------------------------------------
# temporal arithmetic
# ---------------------------------------------------------------------------

def add_months(days: torch.Tensor, months) -> torch.Tensor:
    y, m, d = civil_from_days(days)
    total = (y * 12 + (m - 1)) + months
    ny = torch.div(total, 12, rounding_mode="floor")
    nm = total - ny * 12 + 1
    nm_next = torch.where(nm == 12, 1, nm + 1)
    ny_next = torch.where(nm == 12, ny + 1, ny)
    ones = torch.ones_like(d)
    month_len = days_from_civil(ny_next, nm_next, ones) - days_from_civil(ny, nm, ones)
    return days_from_civil(ny, nm, torch.minimum(d, month_len))


def _as_array(x, n, device):
    if isinstance(x, torch.Tensor) and x.ndim > 0:
        return x
    return torch.full((n,), x, dtype=torch.int64, device=device)


def _to_us(v: Value):
    if v.stype.name == "DATE":
        if isinstance(v, Scalar):
            return v.value * US_PER_DAY
        return v.data.to(torch.int64) * US_PER_DAY
    return _data(v)


def temporal_plus_minus(sign: int):
    """+/- over numbers, intervals, DATE and TIMESTAMP.  All-scalar operands
    compute on a one-element CPU tensor and return a Scalar."""
    def op(args: List[Value], stype: SqlType, ctx) -> Value:
        a, b = args
        if _any_null_scalar(args):
            return _null_result(args, stype)
        col = _column_of(args)
        if col is None and not (a.stype.is_temporal or b.stype.is_temporal):
            return Scalar(a.value + sign * b.value, stype)
        n, dev = (1, torch.device("cpu")) if col is None else (len(col), col.device)
        out = _temporal_plus_minus(a, b, sign, stype, n, dev)
        if col is None:
            return Scalar(out.reshape(-1)[0].item(), stype)
        return Column(out.to(torch_dtype(stype)), stype, combine_masks(a, b))

    return op


def _temporal_plus_minus(a: Value, b: Value, sign: int, stype: SqlType,
                         n: int, dev) -> torch.Tensor:
    at, bt = a.stype, b.stype
    if at.is_temporal and bt.is_temporal:
        return torch.div(_as_array(_to_us(a), n, dev) - _to_us(b), 1000,
                         rounding_mode="floor")
    if at.is_interval and bt.is_temporal:
        a, b = b, a
        at, bt = bt, at
    if at.is_temporal and bt.is_interval:
        if bt.name == "INTERVAL_YEAR_MONTH":
            months = _data(b) * sign
            if at.name == "DATE":
                return add_months(_as_array(_data(a), n, dev), months)
            us = _as_array(_data(a), n, dev)
            return (add_months(timestamp_to_days(us), months) * US_PER_DAY
                    + timestamp_time_of_day_us(us))
        ms = _data(b) * sign
        base = _as_array(_data(a), n, dev).to(torch.int64)
        if at.name == "DATE" and stype.name == "DATE":
            return base + torch.div(ms, 86_400_000, rounding_mode="floor") \
                if isinstance(ms, torch.Tensor) else base + ms // 86_400_000
        if at.name == "DATE":
            return base * US_PER_DAY + ms * 1000
        return base + ms * 1000
    # plain numeric (and interval +- interval)
    return _data(a, dev) + sign * _data(b, dev)


# ---------------------------------------------------------------------------
# comparisons (string-aware)
# ---------------------------------------------------------------------------

_CMP_FNS = {
    "=": (lambda a, b: a == b),
    "<>": (lambda a, b: a != b),
    "<": (lambda a, b: a < b),
    "<=": (lambda a, b: a <= b),
    ">": (lambda a, b: a > b),
    ">=": (lambda a, b: a >= b),
}
_SWAPPED = {"=": "=", "<>": "<>", "<": ">", "<=": ">=", ">": "<", ">=": "<="}
_TS = ("TIMESTAMP", "TIMESTAMP_WITH_LOCAL_TIME_ZONE")


def comparison(op_name: str):
    fn = _CMP_FNS[op_name]

    def op(args: List[Value], stype: SqlType, ctx) -> Value:
        a, b = args
        if _any_null_scalar(args):
            return _null_result(args, BOOLEAN)
        col = _column_of(args)
        if is_string_value(a) or is_string_value(b):
            return _string_compare(op_name, a, b)
        dev = None if col is None else col.device
        da, db = _data(a, dev), _data(b, dev)
        # DATE (days) against TIMESTAMP (microseconds)
        if a.stype.name == "DATE" and b.stype.name in _TS:
            da = _to_us(a)
        if b.stype.name == "DATE" and a.stype.name in _TS:
            db = _to_us(b)
        if col is None:
            return Scalar(bool(fn(da, db)), BOOLEAN)
        return Column(fn(da, db), BOOLEAN, combine_masks(a, b))

    return op


def _string_compare(op_name: str, a: Value, b: Value) -> Value:
    fn = _CMP_FNS[op_name]
    if isinstance(a, Scalar) and isinstance(b, Scalar):
        return Scalar(bool(fn(a.value, b.value)), BOOLEAN)
    if isinstance(a, Column) and isinstance(b, Column) \
            and a.stype.is_string and b.stype.is_string:
        ca, cb = unify_string_codes([a, b])
        return Column(fn(ca, cb), BOOLEAN, combine_masks(a, b))
    if isinstance(a, Scalar):
        a, b = b, a
        fn = _CMP_FNS[_SWAPPED[op_name]]
    col, scal = a, b
    if col.stype.is_string:
        d = col.dictionary.astype(str)
        per_dict = torch.from_numpy(np.asarray(fn(d, str(scal.value)), dtype=bool)
                                    ).to(col.device)
        out = per_dict[col.data.clamp(0, len(d) - 1).long()]
        return Column(out, BOOLEAN, col.mask)
    # numeric column vs string scalar: compare against the parsed number
    try:
        v = float(scal.value)
    except (TypeError, ValueError):
        return Column(torch.zeros(len(col), dtype=torch.bool, device=col.device),
                      BOOLEAN, col.mask)
    return Column(fn(col.data, v), BOOLEAN, col.mask)


# ---------------------------------------------------------------------------
# boolean logic: three-valued AND/OR/NOT
# ---------------------------------------------------------------------------

def _to_bool_parts(v: Value, n: int, device):
    """(value, known) tensors for Kleene logic."""
    if isinstance(v, Scalar):
        if v.is_null:
            z = torch.zeros(n, dtype=torch.bool, device=device)
            return z, z
        return (torch.full((n,), bool(v.value), device=device),
                torch.ones(n, dtype=torch.bool, device=device))
    known = v.valid_mask()
    return v.data.to(torch.bool) & known, known


def logical_and(args, stype, ctx):
    col = _column_of(args)
    if col is None:
        vals = [a.value for a in args]
        if any(v is False for v in vals):
            return Scalar(False, BOOLEAN)
        if any(v is None for v in vals):
            return Scalar(None, BOOLEAN)
        return Scalar(True, BOOLEAN)
    n, dev = len(col), col.device
    va, ka = _to_bool_parts(args[0], n, dev)
    vb, kb = _to_bool_parts(args[1], n, dev)
    # known if both known, or either is a known False
    known = (ka & kb) | (ka & ~va) | (kb & ~vb)
    return Column(va & vb, BOOLEAN, known)


def logical_or(args, stype, ctx):
    col = _column_of(args)
    if col is None:
        vals = [a.value for a in args]
        if any(v is True for v in vals):
            return Scalar(True, BOOLEAN)
        if any(v is None for v in vals):
            return Scalar(None, BOOLEAN)
        return Scalar(False, BOOLEAN)
    n, dev = len(col), col.device
    va, ka = _to_bool_parts(args[0], n, dev)
    vb, kb = _to_bool_parts(args[1], n, dev)
    known = (ka & kb) | (ka & va) | (kb & vb)
    return Column(va | vb, BOOLEAN, known)


def logical_not(args, stype, ctx):
    (a,) = args
    if isinstance(a, Scalar):
        return Scalar(None if a.is_null else (not bool(a.value)), BOOLEAN)
    return Column(~a.data.to(torch.bool), BOOLEAN, a.mask)


# ---------------------------------------------------------------------------
# IS ... predicates (never null)
# ---------------------------------------------------------------------------

def is_null(args, stype, ctx):
    (a,) = args
    if isinstance(a, Scalar):
        return Scalar(a.is_null, BOOLEAN)
    return Column(~a.valid_mask(), BOOLEAN, None)


def is_not_null(args, stype, ctx):
    (a,) = args
    if isinstance(a, Scalar):
        return Scalar(not a.is_null, BOOLEAN)
    return Column(a.valid_mask(), BOOLEAN, None)


def _is_bool(value: bool, negated: bool):
    def op(args, stype, ctx):
        (a,) = args
        if isinstance(a, Scalar):
            r = (not a.is_null) and bool(a.value) == value
            return Scalar((not r) if negated else r, BOOLEAN)
        r = a.valid_mask() & (a.data.to(torch.bool) == value)
        return Column(~r if negated else r, BOOLEAN, None)

    return op


def _null_flags(v: Value, n: int, device) -> torch.Tensor:
    if isinstance(v, Column):
        return ~v.valid_mask()
    return torch.full((n,), v.is_null, dtype=torch.bool, device=device)


def is_distinct_from(negated: bool):
    def op(args, stype, ctx):
        a, b = args
        col = _column_of(args)
        if col is None:
            an, bn = a.is_null, b.is_null
            distinct = (an != bn) if (an or bn) else a.value != b.value
            return Scalar((not distinct) if negated else distinct, BOOLEAN)
        n, dev = len(col), col.device
        ev, ek = _to_bool_parts(comparison("=")([a, b], BOOLEAN, ctx), n, dev)
        a_null, b_null = _null_flags(a, n, dev), _null_flags(b, n, dev)
        distinct = torch.where(a_null | b_null, ~(a_null & b_null), ~(ev & ek))
        return Column(~distinct if negated else distinct, BOOLEAN, None)

    return op


# ---------------------------------------------------------------------------
# CASE
# ---------------------------------------------------------------------------

def _cast_value_to(v: Value, stype: SqlType) -> Value:
    from .cast import cast_value  # local import to avoid a cycle
    return cast_value(v, stype)


def _as_col(v: Value, n: int, device) -> Column:
    if isinstance(v, Column):
        return v
    return Column.from_scalar(v, n, device)


def case_op(args: List[Value], stype: SqlType, ctx) -> Value:
    *pairs, else_v = args
    col = _column_of(args)
    if col is None:
        for i in range(0, len(pairs), 2):
            c = pairs[i]
            if not c.is_null and bool(c.value):
                return _cast_value_to(pairs[i + 1], stype)
        return _cast_value_to(else_v, stype)
    n, dev = len(col), col.device
    if stype.is_string:
        return _string_case(pairs, else_v, n, dev)
    else_c = _as_col(_cast_value_to(else_v, stype), n, dev)
    out_data = else_c.data
    out_valid = else_c.valid_mask()
    taken = torch.zeros(n, dtype=torch.bool, device=dev)
    for i in range(0, len(pairs), 2):
        val = _as_col(_cast_value_to(pairs[i + 1], stype), n, dev)
        cv, ck = _to_bool_parts(pairs[i], n, dev)
        sel = cv & ck & ~taken
        out_data = torch.where(sel, val.data, out_data)
        out_valid = torch.where(sel, val.valid_mask(), out_valid)
        taken = taken | sel
    return Column(out_data, stype, out_valid)


def _decode_value(v: Value, n: int) -> np.ndarray:
    """Host object array of strings/None for any value."""
    if isinstance(v, Column):
        if v.stype.is_string:
            return v.decode()
        return v.to_numpy().astype(object)
    return np.array([v.value] * n, dtype=object)


def _string_case(pairs, else_v, n, dev):
    sel_done = np.zeros(n, bool)
    out = np.array([None] * n, dtype=object)
    for i in range(0, len(pairs), 2):
        cv, ck = _to_bool_parts(pairs[i], n, dev)
        sel = (cv & ck).cpu().numpy() & ~sel_done
        vals = _decode_value(pairs[i + 1], n)
        out[sel] = vals[sel]
        sel_done |= sel
    ev = _decode_value(else_v, n)
    out[~sel_done] = ev[~sel_done]
    mask = np.array([o is not None for o in out])
    return Column._encode_strings(np.where(mask, out, ""),
                                  mask if not mask.all() else None, dev)


# ---------------------------------------------------------------------------
# COALESCE, IN lists
# ---------------------------------------------------------------------------

def _length(args: List[Value]) -> Optional[int]:
    col = _column_of(args)
    return None if col is None else len(col)


def coalesce_op(args: List[Value], stype: SqlType, ctx) -> Value:
    col = _column_of(args)
    if col is None:
        for a in args:
            if not a.is_null:
                return _cast_value_to(a, stype)
        return Scalar(None, stype)
    n, dev = len(col), col.device
    if stype.is_string:
        out = np.array([None] * n, dtype=object)
        filled = np.zeros(n, bool)
        for a in args:
            vals = _decode_value(a, n)
            avail = np.array([v is not None for v in vals], dtype=bool) & ~filled
            out[avail] = vals[avail]
            filled |= avail
        return Column._encode_strings(np.where(filled, out, ""),
                                      None if filled.all() else filled, dev)
    cols = [_as_col(_cast_value_to(a, stype), n, dev) for a in args]
    out, valid = cols[0].data, cols[0].valid_mask()
    for c in cols[1:]:
        out = torch.where(valid, out, c.data)
        valid = valid | c.valid_mask()
    return Column(out, stype, valid)


def in_list_op(args: List[Value], stype: SqlType, ctx) -> Value:
    """x IN (v1, v2, ...) as an OR of equalities (three-valued)."""
    expr, *values = args
    out = None
    for v in values:
        eq = comparison("=")([expr, v], BOOLEAN, ctx)
        out = eq if out is None else logical_or([out, eq], BOOLEAN, ctx)
    return Scalar(False, BOOLEAN) if out is None else out


def nullif_op(args, stype, ctx):
    a, b = args
    eq = comparison("=")([a, b], BOOLEAN, ctx)
    col = _column_of(args)
    if col is None:
        if not eq.is_null and eq.value:
            return Scalar(None, stype)
        return a
    n, dev = len(col), col.device
    ac = _as_col(a, n, dev)
    ev, ek = _to_bool_parts(eq, n, dev)
    return Column(ac.data, ac.stype, ac.valid_mask() & ~(ev & ek),
                  ac.dictionary)


def greatest_least(is_greatest: bool):
    """GREATEST / LEAST: NULL if any argument is NULL (Calcite).  Strings
    compare through their dictionaries, as ``_string_compare`` does: the
    codes of every argument on the sorted union of the dictionaries."""
    pick = torch.maximum if is_greatest else torch.minimum

    def op(args, stype, ctx):
        col = _column_of(args)
        if col is None:
            vals = [a.value for a in args]
            if any(v is None for v in vals):
                return Scalar(None, stype)
            return Scalar(max(vals) if is_greatest else min(vals), stype)
        if _any_null_scalar(args):
            return _null_result(args, stype)
        n, dev = len(col), col.device
        if stype.is_string:
            cols = [_as_col(_cast_value_to(a, VARCHAR), n, dev) for a in args]
            codes = unify_string_codes(cols)
            union = np.unique(np.concatenate([c.dictionary.astype(str)
                                              for c in cols]))
            out = codes[0]
            for c in codes[1:]:
                out = pick(out, c)
            return Column(out.to(torch.int32), VARCHAR, combine_masks(*cols),
                          union.astype(object))
        cols = [_as_col(_cast_value_to(a, stype), n, dev) for a in args]
        out = cols[0].data
        for c in cols[1:]:
            out = pick(out, c.data)
        return Column(out, stype, combine_masks(*cols))

    return op


def _search_op(args, stype, ctx):
    """SEARCH(x, Sarg): range-set membership.  The second argument is a
    Scalar holding a list of (lo, lo_open, hi, hi_open) ranges."""
    expr, ranges = args
    out = None
    for lo, lo_open, hi, hi_open in ranges.value:
        conds = []
        if lo is not None:
            conds.append(comparison(">" if lo_open else ">=")(
                [expr, Scalar(lo, expr.stype)], BOOLEAN, ctx))
        if hi is not None:
            conds.append(comparison("<" if hi_open else "<=")(
                [expr, Scalar(hi, expr.stype)], BOOLEAN, ctx))
        piece = conds[0] if conds else Scalar(True, BOOLEAN)
        for c in conds[1:]:
            piece = logical_and([piece, c], BOOLEAN, ctx)
        out = piece if out is None else logical_or([out, piece], BOOLEAN, ctx)
    return Scalar(False, BOOLEAN) if out is None else out


# ---------------------------------------------------------------------------
# LIKE / ILIKE / SIMILAR TO
# ---------------------------------------------------------------------------

def sql_like_to_regex(pattern: str, escape: Optional[str] = None) -> str:
    out = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if escape and c == escape and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        out.append(".*" if c == "%" else "." if c == "_" else re.escape(c))
        i += 1
    return "^" + "".join(out) + "$"


def sql_similar_to_regex(pattern: str, escape: Optional[str] = None) -> str:
    """SIMILAR TO: the ``%`` and ``_`` wildcards, and every other character
    passed through as a regex metacharacter or literal."""
    out = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if escape and c == escape and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        out.append(".*" if c == "%" else "." if c == "_" else c)
        i += 1
    return "^" + "".join(out) + "$"


def _like_regex(kind: str, pattern: str, escape: Optional[str]):
    rx = (sql_similar_to_regex(pattern, escape) if kind == "SIMILAR"
          else sql_like_to_regex(pattern, escape))
    return re.compile(rx, re.IGNORECASE if kind == "ILIKE" else 0)


def _regex_bitmap(kind: str, pattern: str, escape: Optional[str], d
                  ) -> np.ndarray:
    SF.stats["regex_bitmaps"] += 1
    rx = _like_regex(kind, pattern, escape)
    return np.array([rx.match(x) is not None for x in d], dtype=bool)


def like_bitmap(kind: str, pattern: str, escape: Optional[str],
                dictionary: np.ndarray, device) -> torch.Tensor:
    """The per-entry bitmap of a dictionary (or of a column's values as
    strings) on ``device``: matched on the device at or past
    ``DEVICE_STRING_THRESHOLD`` entries, else by the vectorized host bitmap,
    else (``_`` wildcards, SIMILAR TO) by regex."""
    if len(dictionary) >= SF.DEVICE_STRING_THRESHOLD:
        per = SF.device_like_bitmap(dictionary, pattern, escape, kind, device)
        if per is not None:
            SF.stats["device_bitmaps"] += 1
            return per
    d = SF.dict_as_str(dictionary)
    per = SF.like_bitmap_vectorized(d, pattern, escape, kind)
    if per is None:
        per = _regex_bitmap(kind, pattern, escape, d)
    else:
        SF.stats["vectorized_bitmaps"] += 1
    return torch.from_numpy(np.asarray(per, dtype=bool)).to(device)


def like_op(kind: str):
    """LIKE / ILIKE / SIMILAR TO over a dictionary column: one bitmap over
    the dictionary (``like_bitmap``) gathered by the codes on the device."""

    def op(args: List[Value], stype: SqlType, ctx) -> Value:
        expr, pattern, *rest = args
        escape = rest[0].value if rest else None
        if isinstance(pattern, Column):
            # per-row patterns: host path
            n = len(pattern)
            vals, pats = _decode_value(expr, n), _decode_value(pattern, n)
            out = np.zeros(n, bool)
            mask = np.ones(n, bool)
            for i, (v, p) in enumerate(zip(vals, pats)):
                if v is None or p is None:
                    mask[i] = False
                    continue
                out[i] = _like_regex(kind, p, escape).match(str(v)) is not None
            dev = pattern.device
            return Column(torch.from_numpy(out).to(dev), BOOLEAN,
                          None if mask.all() else torch.from_numpy(mask).to(dev))
        if pattern.is_null or (isinstance(expr, Scalar) and expr.is_null):
            n = _length(args)
            return (Scalar(None, BOOLEAN) if n is None
                    else all_null_column(n, BOOLEAN, expr.device))
        pat = str(pattern.value)
        if isinstance(expr, Scalar):
            return Scalar(_like_regex(kind, pat, escape).match(str(expr.value))
                          is not None, BOOLEAN)
        if expr.stype.is_string:
            dct = expr.dictionary
            per = like_bitmap(kind, pat, escape, dct, expr.device)
            idx = expr.data.clamp(0, max(len(dct) - 1, 0)).long()
            return Column(per[idx], BOOLEAN, expr.mask)
        per = like_bitmap(kind, pat, escape, expr.to_numpy().astype(str),
                          expr.device)
        return Column(per, BOOLEAN, expr.mask)

    return op


# ---------------------------------------------------------------------------
# string functions (dictionary path)
# ---------------------------------------------------------------------------

def map_dictionary(col: Column, fn: Callable[[np.ndarray], np.ndarray],
                   stype: SqlType) -> Column:
    """Apply ``fn`` over the dictionary on the host, map back to the rows
    with a gather on the device."""
    d = col.dictionary.astype(str)
    res = fn(d)
    idx = col.data.clamp(0, max(len(d) - 1, 0)).long()
    if stype.is_string:
        newdict, newcodes = np.unique(np.asarray(res).astype(str),
                                      return_inverse=True)
        table = torch.from_numpy(newcodes.reshape(-1).astype(np.int32))
        return Column(table.to(col.device)[idx], VARCHAR, col.mask,
                      newdict.astype(object))
    table = torch.from_numpy(np.asarray(res).astype(physical_dtype(stype)))
    return Column(table.to(col.device)[idx], stype, col.mask)


def string_unary(fn_one: Callable[[str], object]):
    """Lift a Python str -> value function: once per dictionary entry."""

    def op(args: List[Value], stype: SqlType, ctx) -> Value:
        (a,) = args
        if isinstance(a, Scalar):
            return Scalar(None if a.is_null else fn_one(str(a.value)), stype)
        return map_dictionary(
            a, lambda d: np.array([fn_one(x) for x in d], dtype=object), stype)

    return op


def string_nary(fn_row: Callable[..., object]):
    """N-ary string function: with one string column and scalar extras it
    runs per dictionary entry; any other mix of columns decodes rows on the
    host."""

    def op(args: List[Value], stype: SqlType, ctx) -> Value:
        n = _length(args)
        if _any_null_scalar(args):
            return (Scalar(None, stype) if n is None
                    else all_null_column(n, stype, _column_of(args).device))
        if n is None:
            return Scalar(fn_row(*[a.value for a in args]), stype)
        cols = [i for i, a in enumerate(args) if isinstance(a, Column)]
        if len(cols) == 1 and args[cols[0]].stype.is_string:
            pos = cols[0]
            fixed = [a.value if isinstance(a, Scalar) else None for a in args]

            def apply_dict(d):
                out = []
                for x in d:
                    fixed[pos] = x
                    out.append(fn_row(*fixed))
                return np.array(out, dtype=object)

            return map_dictionary(args[pos], apply_dict, stype)
        dev = args[cols[0]].device
        host = [_decode_value(a, n) for a in args]
        out = []
        mask = np.ones(n, bool)
        for i in range(n):
            row = [h[i] for h in host]
            if any(v is None for v in row):
                mask[i] = False
                out.append(None)
            else:
                out.append(fn_row(*row))
        if stype.is_string:
            return Column._encode_strings(
                np.array([o if o is not None else "" for o in out], dtype=object),
                None if mask.all() else mask, dev)
        arr = np.array([o if o is not None else 0 for o in out])
        return Column.from_encoded(arr.astype(physical_dtype(stype)), stype,
                                   None if mask.all() else mask, None, dev)

    return op


def _substring(s, start, length=None):
    """SQL SUBSTRING(s FROM start [FOR length]): positions count from 1; a
    start at or below 0 shortens the window."""
    start = int(start)
    begin = max(start - 1, 0)
    if start <= 0:
        begin = 0
        if length is not None:
            length = length + (start - 1)
            if length <= 0:
                return ""
    if length is None:
        return s[begin:]
    return s[begin: begin + max(int(length), 0)]


def substring_dict(d: np.ndarray, start: int, length=None):
    """``_substring`` over a whole ``<U`` dictionary at once for start >= 1
    and length >= 0: the characters are UCS-4 code points, so the slice is
    a column slice of the (entries, width) uint32 view.  None otherwise."""
    if start < 1 or (length is not None and length < 0) or d.dtype.kind != "U":
        return None
    width = d.dtype.itemsize // 4
    begin = start - 1
    end = width if length is None else min(width, begin + int(length))
    if end <= begin:
        return np.full(len(d), "", dtype="<U1")
    chars = d.view(np.uint32).reshape(len(d), width)[:, begin:end]
    return np.ascontiguousarray(chars).view(f"<U{end - begin}").reshape(-1)


def substring_op(args: List[Value], stype: SqlType, ctx) -> Value:
    """SUBSTRING(s FROM start [FOR length]): on a dictionary column with
    literal bounds, one vectorized slice of the dictionary; any other form
    runs ``_substring`` per entry or per row (``string_nary``)."""
    col, *bounds = args
    if (isinstance(col, Column) and col.stype.is_string
            and all(isinstance(b, Scalar) and isinstance(b.value, int)
                    for b in bounds)):
        fast = substring_dict(col.dictionary.astype(str),
                              *[b.value for b in bounds])
        if fast is not None:
            return map_dictionary(col, lambda d: fast, stype)
    return string_nary(_substring)(args, stype, ctx)


def _trim(side, chars, s):
    chars = chars or " "
    if side == "LEADING":
        return s.lstrip(chars)
    if side == "TRAILING":
        return s.rstrip(chars)
    return s.strip(chars)


def _overlay(s, repl, start, length=None):
    start = int(start)
    if length is None:
        length = len(repl)
    return s[: start - 1] + repl + s[start - 1 + int(length):]


def _split_part(s, delim, idx):
    parts = s.split(delim)
    i = int(idx)
    return parts[i - 1] if 1 <= i <= len(parts) else ""


def _left(s, k):
    return s[: int(k)] if k >= 0 else s[: max(len(s) + int(k), 0)]


def _right(s, k):
    if k > 0:
        return s[-int(k):]
    return s[-(len(s) + int(k)):] if len(s) + int(k) > 0 else ""


def _lpad(s, k, p=" "):
    k = int(k)
    return s[:k] if len(s) >= k else (p * k)[: k - len(s)] + s


def _rpad(s, k, p=" "):
    k = int(k)
    return s[:k] if len(s) >= k else s + (p * k)[: k - len(s)]


def _translate(s, frm, to):
    return s.translate(str.maketrans(frm, to[: len(frm)].ljust(len(frm))))


def _initcap(s):
    return re.sub(r"[a-zA-Z]+", lambda m: m.group(0).capitalize(), s)


def concat_op(args: List[Value], stype: SqlType, ctx) -> Value:
    """``||`` / CONCAT: NULL if any argument is NULL (Calcite)."""
    return string_nary(lambda *vals: "".join(str(v) for v in vals))(
        args, stype, ctx)


# ---------------------------------------------------------------------------
# EXTRACT
# ---------------------------------------------------------------------------

def extract_op(args: List[Value], stype: SqlType, ctx) -> Value:
    field_v, src = args
    field = str(field_v.value)
    if isinstance(src, Scalar):
        if src.is_null:
            return Scalar(None, stype)
        one = Column(torch.as_tensor([src.value]), src.stype)
        return Scalar(int(extract_op([field_v, one], stype, ctx).data[0]), stype)
    if src.stype.name == "DATE":
        days, tod = src.data.to(torch.int64), None
    elif src.stype.is_temporal:
        days, tod = timestamp_to_days(src.data), timestamp_time_of_day_us(src.data)
    elif src.stype.is_interval:
        ms = src.data.to(torch.int64)
        f = field.upper()
        parts = {"DAY": lambda: _fdiv(ms, 86_400_000),
                 "HOUR": lambda: _fdiv(ms, 3_600_000) % 24,
                 "MINUTE": lambda: _fdiv(ms, 60_000) % 60,
                 "SECOND": lambda: _fdiv(ms, 1000) % 60,
                 "EPOCH": lambda: _fdiv(ms, 1000)}
        if f not in parts:
            raise NotImplementedError(f"EXTRACT {field} from interval")
        return Column(parts[f](), stype, src.mask)
    else:
        raise TypeError(f"EXTRACT from {src.stype}")
    return Column(extract_field(field, days, tod).to(torch.int64), stype, src.mask)


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _shorthand(field: str):
    """YEAR(x), MONTH(x), ...: EXTRACT(field FROM x)."""
    def op(args, stype, ctx):
        return extract_op([Scalar(field, SqlType("SYMBOL")), args[0]], stype,
                          ctx)
    return op


# ---------------------------------------------------------------------------
# FLOOR / CEIL, on numbers and TO <unit> on DATE and TIMESTAMP
# ---------------------------------------------------------------------------

def floor_ceil_op(is_floor: bool):
    def op(args: List[Value], stype: SqlType, ctx) -> Value:
        if not (len(args) == 2 and isinstance(args[1], Scalar)
                and args[1].stype.name == "SYMBOL"):
            fn = torch.floor if is_floor else torch.ceil
            py = math.floor if is_floor else math.ceil
            return numeric_op(fn, py)(args[:1], stype, ctx)
        src, unit = args[0], str(args[1].value)
        if isinstance(src, Scalar):
            if src.is_null:
                return Scalar(None, stype)
            one = Column(torch.as_tensor([src.value]), src.stype)
            return Scalar(int(op([one, args[1]], stype, ctx).data[0]), stype)
        if src.stype.name == "DATE":
            days = src.data.to(torch.int64)
            fdays, _ = trunc_date(unit, days, None)
            out = fdays if is_floor else _ceil_date(unit, days, fdays, None,
                                                    None)
            return Column(out.to(torch_dtype(stype)), stype, src.mask)
        days = timestamp_to_days(src.data)
        tod = timestamp_time_of_day_us(src.data)
        fdays, ftod = trunc_date(unit, days, tod)
        floored = fdays * US_PER_DAY + (0 if ftod is None else ftod)
        out = floored if is_floor else _ceil_date(unit, days, fdays, tod,
                                                  floored)
        return Column(out.to(torch.int64), stype, src.mask)

    return op


def _ceil_date(unit, days, floored_days, tod, floored_us):
    """CEIL(x TO unit): x if already aligned, else the floor plus one unit
    (as in the JAX package, a DATE's QUARTER and DAY are the date itself)."""
    u = unit.upper()
    if floored_us is None:
        aligned = days == floored_days
        if u == "YEAR":
            y, m, d = civil_from_days(days)
            return torch.where(aligned, days, days_from_civil(
                y + 1, torch.ones_like(m), torch.ones_like(d)))
        if u == "MONTH":
            return torch.where(aligned, days, add_months(floored_days, 1))
        if u == "WEEK":
            return torch.where(aligned, days, floored_days + 7)
        return days
    orig = days * US_PER_DAY + tod
    aligned = orig == floored_us
    if u == "YEAR":
        y, m, d = civil_from_days(days)
        nxt = days_from_civil(y + 1, torch.ones_like(m),
                              torch.ones_like(d)) * US_PER_DAY
        return torch.where(aligned, orig, nxt)
    if u == "MONTH":
        nxt = add_months(timestamp_to_days(floored_us), 1) * US_PER_DAY
        return torch.where(aligned, orig, nxt)
    step = {"DAY": US_PER_DAY, "HOUR": 3_600_000_000, "MINUTE": 60_000_000,
            "SECOND": 1_000_000, "WEEK": 7 * US_PER_DAY}.get(u)
    if step is None:
        raise NotImplementedError(f"CEIL unit {unit}")
    return torch.where(aligned, orig, floored_us + step)


# ---------------------------------------------------------------------------
# math
# ---------------------------------------------------------------------------

def _fl(x):
    """An operand of a DOUBLE-valued function: a float tensor keeps its
    dtype (as under jnp); an integer tensor or a Python number computes in
    float64 (torch would take float32)."""
    if isinstance(x, torch.Tensor):
        return x if x.dtype.is_floating_point else x.to(torch.float64)
    return torch.tensor(float(x), dtype=torch.float64)


def _float_fn(fn: Callable):
    return lambda *xs: fn(*[_fl(x) for x in xs])


def _power(a, b):
    """POWER in the result type: integers compute in float64, so that
    ``POWER(2, -1) = 0.5`` (the JAX package gives INT64_MIN there)."""
    return torch.pow(_fl(a), _fl(b))


def _log(a, b=None):
    """LOG(x), or LOG(base, x)."""
    return torch.log(_fl(a)) if b is None else torch.log(_fl(b)) / torch.log(_fl(a))


def _py_log(a, b=None):
    return math.log(a) if b is None else math.log(b, a)


def _sign(a):
    # torch.sign(NaN) is 0; SQL and jnp.sign give NaN
    out = torch.sign(a)
    return torch.where(torch.isnan(a), a, out) if a.dtype.is_floating_point \
        else out


def _cbrt(a):
    """Real cube root: ``sign(a) * |a| ** (1/3)`` and one Newton step,
    which brings it within an ulp or two of a correctly rounded root."""
    a = _fl(a)
    y = torch.sign(a) * a.abs().pow(1.0 / 3.0)
    step = (y * y * y - a) / (3.0 * y * y)
    return torch.where(torch.isfinite(step) & (y != 0), y - step, y)


def _py_cbrt(a):
    return math.copysign(abs(a) ** (1.0 / 3.0), a)


def _scaled(fn: Callable):
    """ROUND / TRUNCATE with optional digits: ``fn(a * 10**d) / 10**d``."""
    def f(a, d=None):
        if d is None:
            return fn(a) if a.dtype.is_floating_point else a
        scale = 10.0 ** (_fl(d) if isinstance(d, torch.Tensor) else d)
        return fn(_fl(a) * scale) / scale
    return f


def _py_round(a, d=None):
    return round(a) if d is None else round(a, int(d))


def _py_truncate(a, d=None):
    return math.trunc(a) if d is None else math.trunc(a * 10 ** d) / 10 ** d


# ---------------------------------------------------------------------------
# random, seeded on the table's device
# ---------------------------------------------------------------------------

def _generator(seed: Optional[int], device) -> torch.Generator:
    g = torch.Generator(device=device)
    if seed is None:
        g.seed()
    else:
        g.manual_seed(seed)
    return g


def _table_device(table):
    return table.columns[0].device if table.columns else torch.device("cpu")


def rand_op(args: List[Value], stype: SqlType, ctx) -> Value:
    """RAND([seed]): uniform [0, 1) doubles, one per row."""
    dev = _table_device(ctx)
    g = _generator(int(args[0].value) if args else None, dev)
    return Column(torch.rand(ctx.num_rows, generator=g, dtype=torch.float64,
                             device=dev), DOUBLE, None)


def rand_integer_op(args: List[Value], stype: SqlType, ctx) -> Value:
    """RAND_INTEGER([seed,] bound): uniform integers in [0, bound)."""
    seed = int(args[0].value) if len(args) == 2 else None
    dev = _table_device(ctx)
    out = torch.randint(0, int(args[-1].value), (ctx.num_rows,),
                        generator=_generator(seed, dev), device=dev)
    return Column(out.to(torch.int32), stype, None)


# ---------------------------------------------------------------------------
# THE MAPPING (the keys of the JAX package's OPERATION_MAPPING)
# ---------------------------------------------------------------------------

OPERATION_MAPPING = {
    # logic
    "AND": logical_and,
    "OR": logical_or,
    "NOT": logical_not,
    # comparison
    "=": comparison("="),
    "<>": comparison("<>"),
    "<": comparison("<"),
    "<=": comparison("<="),
    ">": comparison(">"),
    ">=": comparison(">="),
    # arithmetic
    "+": temporal_plus_minus(+1),
    "-": temporal_plus_minus(-1),
    "*": numeric_op(lambda a, b: a * b, lambda a, b: a * b),
    "/": numeric_op(sql_div, _py_div),
    "%": numeric_op(_sql_mod, _py_mod),
    "MOD": numeric_op(_sql_mod, _py_mod),
    "NEGATE": numeric_op(lambda a: -a, lambda a: -a),
    # is-ness
    "IS_NULL": is_null,
    "IS_NOT_NULL": is_not_null,
    "IS_TRUE": _is_bool(True, False),
    "IS_NOT_TRUE": _is_bool(True, True),
    "IS_FALSE": _is_bool(False, False),
    "IS_NOT_FALSE": _is_bool(False, True),
    "IS_DISTINCT_FROM": is_distinct_from(False),
    "IS_NOT_DISTINCT_FROM": is_distinct_from(True),
    # conditional
    "CASE": case_op,
    "COALESCE": coalesce_op,
    "IFNULL": coalesce_op,
    "NVL": coalesce_op,
    "NULLIF": nullif_op,
    "GREATEST": greatest_least(True),
    "LEAST": greatest_least(False),
    "IN_LIST": in_list_op,
    "SEARCH": _search_op,
    # pattern matching
    "LIKE": like_op("LIKE"),
    "ILIKE": like_op("ILIKE"),
    "SIMILAR": like_op("SIMILAR"),
    # math
    "ABS": numeric_op(torch.abs, abs),
    "SQRT": numeric_op(_float_fn(torch.sqrt), math.sqrt),
    "EXP": numeric_op(_float_fn(torch.exp), math.exp),
    "LN": numeric_op(_float_fn(torch.log), math.log),
    "LOG10": numeric_op(_float_fn(torch.log10), math.log10),
    "LOG": numeric_op(_log, _py_log),
    "POWER": numeric_op(_power, math.pow),
    "POW": numeric_op(_power, math.pow),
    "SIN": numeric_op(_float_fn(torch.sin), math.sin),
    "COS": numeric_op(_float_fn(torch.cos), math.cos),
    "TAN": numeric_op(_float_fn(torch.tan), math.tan),
    "ASIN": numeric_op(_float_fn(torch.asin), math.asin),
    "ACOS": numeric_op(_float_fn(torch.acos), math.acos),
    "ATAN": numeric_op(_float_fn(torch.atan), math.atan),
    "ATAN2": numeric_op(_float_fn(torch.atan2), math.atan2),
    "SINH": numeric_op(_float_fn(torch.sinh), math.sinh),
    "COSH": numeric_op(_float_fn(torch.cosh), math.cosh),
    "TANH": numeric_op(_float_fn(torch.tanh), math.tanh),
    "COT": numeric_op(_float_fn(lambda a: 1.0 / torch.tan(a)),
                      lambda a: 1.0 / math.tan(a)),
    "DEGREES": numeric_op(_float_fn(lambda a: a * (180.0 / math.pi)),
                          math.degrees),
    "RADIANS": numeric_op(_float_fn(lambda a: a * (math.pi / 180.0)),
                          math.radians),
    "SIGN": numeric_op(_sign, lambda a: (a > 0) - (a < 0)),
    "CBRT": numeric_op(_cbrt, _py_cbrt),
    "ROUND": numeric_op(_scaled(torch.round), _py_round),
    "TRUNCATE": numeric_op(_scaled(torch.trunc), _py_truncate),
    "PI": lambda args, stype, ctx: Scalar(math.pi, DOUBLE),
    "FLOOR": floor_ceil_op(True),
    "CEIL": floor_ceil_op(False),
    "CEILING": floor_ceil_op(False),
    "RAND": rand_op,
    "RANDOM": rand_op,
    "RAND_INTEGER": rand_integer_op,
    # strings
    "||": concat_op,
    "CONCAT": concat_op,
    "UPPER": string_unary(str.upper),
    "LOWER": string_unary(str.lower),
    "INITCAP": string_unary(_initcap),
    "REVERSE": string_unary(lambda x: x[::-1]),
    "CHAR_LENGTH": string_unary(len),
    "CHARACTER_LENGTH": string_unary(len),
    "LENGTH": string_unary(len),
    "OCTET_LENGTH": string_unary(lambda x: len(x.encode())),
    "ASCII": string_unary(lambda x: ord(x[0]) if x else 0),
    "CHR": string_nary(lambda c: chr(int(c))),
    "SUBSTRING": substring_op,
    "SUBSTR": substring_op,
    "TRIM": string_nary(_trim),
    "LTRIM": string_nary(lambda x, c=" ": x.lstrip(c)),
    "RTRIM": string_nary(lambda x, c=" ": x.rstrip(c)),
    "BTRIM": string_nary(lambda x, c=" ": x.strip(c)),
    "POSITION": string_nary(lambda needle, hay: hay.find(needle) + 1),
    "STRPOS": string_nary(lambda hay, needle: hay.find(needle) + 1),
    "OVERLAY": string_nary(_overlay),
    "REPLACE": string_nary(lambda x, old, new: x.replace(old, new)),
    "REPEAT": string_nary(lambda x, k: x * int(k)),
    "LEFT": string_nary(_left),
    "RIGHT": string_nary(_right),
    "LPAD": string_nary(_lpad),
    "RPAD": string_nary(_rpad),
    "SPLIT_PART": string_nary(_split_part),
    "TRANSLATE": string_nary(_translate),
    "REGEXP_REPLACE": string_nary(lambda x, p, r: re.sub(p, r, x)),
    # datetime
    "EXTRACT": extract_op,
    "YEAR": _shorthand("YEAR"),
    "MONTH": _shorthand("MONTH"),
    "DAY": _shorthand("DAY"),
    "HOUR": _shorthand("HOUR"),
    "MINUTE": _shorthand("MINUTE"),
    "SECOND": _shorthand("SECOND"),
    "QUARTER": _shorthand("QUARTER"),
    "DAYOFWEEK": _shorthand("DOW"),
    "DAYOFMONTH": _shorthand("DAY"),
    "DAYOFYEAR": _shorthand("DOY"),
    "WEEK": _shorthand("WEEK"),
}
