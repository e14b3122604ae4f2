"""Scalar operation library: REX op name -> device function.

The counterpart of ``dask_sql_tpu/physical/rex/ops.py`` for the operators
TPC-H Q1-Q22 reach: arithmetic, comparisons (string-aware), three-valued
AND/OR/NOT, IS [NOT] NULL, CASE, COALESCE, IN lists, LIKE / ILIKE,
SUBSTRING, EXTRACT, and DATE / TIMESTAMP arithmetic and comparisons.
Any other operator raises ``NotImplementedError`` naming it (see
``OPERATION_MAPPING``).

String functions run once per dictionary entry on the host and map back
to the rows by a gather on the device (``map_dictionary``); only an
operator over several string columns at once, or a per-row LIKE pattern,
decodes rows on the host.

Value model: every op takes a list of Column/Scalar args plus the
binder-inferred result type and returns Column or Scalar.  Python float
scalars enter tensor arithmetic as float64 tensors, so an int column times
a float literal computes in float64 as it does under JAX's x64 mode (torch
would otherwise take a Python float as float32).
"""
from __future__ import annotations

import math
import re
from typing import Callable, List, Optional, Union

import numpy as np
import torch

from ...ops.kernels import (
    US_PER_DAY, civil_from_days, days_from_civil, extract_field,
    timestamp_time_of_day_us, timestamp_to_days, unify_string_codes,
)
from ...table import Column, Scalar
from ...types import BOOLEAN, VARCHAR, SqlType, physical_dtype, torch_dtype

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


# ---------------------------------------------------------------------------
# LIKE / ILIKE
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


def _like_regex(kind: str, pattern: str, escape: Optional[str]):
    return re.compile(sql_like_to_regex(pattern, escape),
                      re.IGNORECASE if kind == "ILIKE" else 0)


def like_op(kind: str):
    """LIKE over a dictionary column: the pattern runs once per dictionary
    entry on the host and the codes gather the bitmap on the device."""

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
        rx = _like_regex(kind, str(pattern.value), escape)
        if isinstance(expr, Scalar):
            return Scalar(rx.match(str(expr.value)) is not None, BOOLEAN)
        if expr.stype.is_string:
            return map_dictionary(
                expr, lambda d: np.array([rx.match(x) is not None for x in d],
                                         dtype=bool), BOOLEAN)
        d = expr.to_numpy().astype(str)
        per = np.array([rx.match(x) is not None for x in d], dtype=bool)
        return Column(torch.from_numpy(per).to(expr.device), BOOLEAN, expr.mask)

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


# ---------------------------------------------------------------------------
# THE MAPPING (the ported subset of the JAX package's OPERATION_MAPPING)
# ---------------------------------------------------------------------------

OPERATION_MAPPING = {
    "AND": logical_and,
    "OR": logical_or,
    "NOT": logical_not,
    "=": comparison("="),
    "<>": comparison("<>"),
    "<": comparison("<"),
    "<=": comparison("<="),
    ">": comparison(">"),
    ">=": comparison(">="),
    "+": temporal_plus_minus(+1),
    "-": temporal_plus_minus(-1),
    "*": numeric_op(lambda a, b: a * b),
    "/": numeric_op(sql_div, _py_div),
    "%": numeric_op(_sql_mod, _py_mod),
    "MOD": numeric_op(_sql_mod, _py_mod),
    "NEGATE": numeric_op(lambda a: -a),
    "IS_NULL": is_null,
    "IS_NOT_NULL": is_not_null,
    "CASE": case_op,
    "COALESCE": coalesce_op,
    "IN_LIST": in_list_op,
    "LIKE": like_op("LIKE"),
    "ILIKE": like_op("ILIKE"),
    "SUBSTRING": substring_op,
    "EXTRACT": extract_op,
}
