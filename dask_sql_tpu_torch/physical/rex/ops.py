"""Scalar operation library: REX op name -> device function.

The counterpart of ``dask_sql_tpu/physical/rex/ops.py`` for the operators
the first slice reaches: arithmetic, comparisons (string-aware), three-valued
AND/OR/NOT, IS [NOT] NULL, CASE, and DATE /
TIMESTAMP arithmetic and comparisons.  Any other operator raises
``NotImplementedError`` naming it (see ``OPERATION_MAPPING``).

Value model: every op takes a list of Column/Scalar args plus the
binder-inferred result type and returns Column or Scalar.  Python float
scalars enter tensor arithmetic as float64 tensors, so an int column times
a float literal computes in float64 as it does under JAX's x64 mode (torch
would otherwise take a Python float as float32).
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Union

import numpy as np
import torch

from ...ops.kernels import (
    US_PER_DAY, civil_from_days, days_from_civil, timestamp_time_of_day_us,
    timestamp_to_days, unify_string_codes,
)
from ...table import Column, Scalar
from ...types import BOOLEAN, SqlType, torch_dtype

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


def sql_div(a, b):
    """SQL division: truncates toward zero for integers."""
    ta = a if isinstance(a, torch.Tensor) else torch.tensor(a)
    tb = b if isinstance(b, torch.Tensor) else torch.tensor(b)
    if not ta.dtype.is_floating_point and not tb.dtype.is_floating_point:
        return torch.div(a, b, rounding_mode="trunc")
    return a / b


def _py_div(a, b):
    if isinstance(a, int) and isinstance(b, int):
        return int(a / b) if b != 0 else None
    if b == 0:
        with np.errstate(divide="ignore", invalid="ignore"):
            return float(np.float64(a) / np.float64(b))
    return a / b


def _sql_mod(a, b):
    return torch.sign(a) * torch.remainder(torch.abs(a), torch.abs(b))


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
}
