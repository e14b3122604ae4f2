"""CAST between logical types: the counterpart of
``dask_sql_tpu/physical/rex/cast.py``."""
from __future__ import annotations

import datetime
from typing import Union

import numpy as np
import torch

from ...ops.kernels import US_PER_DAY, timestamp_to_days
from ...table import Column, Scalar
from ...types import (
    SqlType, physical_dtype, physical_to_python_value, python_value_to_physical,
    torch_dtype,
)

Value = Union[Column, Scalar]


def cast_value(v: Value, target: SqlType) -> Value:
    if isinstance(v, Scalar):
        return _cast_scalar(v, target)
    return cast_column(v, target)


def _cast_scalar(v: Scalar, target: SqlType) -> Scalar:
    if v.is_null:
        return Scalar(None, target)
    sv = v.value
    sn, tn = v.stype.name, target.name
    if sn == tn:
        return Scalar(sv, target)
    if v.stype.is_string:
        return Scalar(_parse_string_scalar(str(sv), target), target)
    if target.is_string:
        return Scalar(_format_value(sv, v.stype), target)
    if tn == "DATE" and sn in ("TIMESTAMP", "TIMESTAMP_WITH_LOCAL_TIME_ZONE"):
        return Scalar(int(sv) // US_PER_DAY, target)
    if sn == "DATE" and tn in ("TIMESTAMP", "TIMESTAMP_WITH_LOCAL_TIME_ZONE"):
        return Scalar(int(sv) * US_PER_DAY, target)
    if target.name == "BOOLEAN":
        return Scalar(bool(sv), target)
    if target.is_integer:
        return Scalar(int(sv), target)
    if target.is_floating:
        return Scalar(float(sv), target)
    return Scalar(python_value_to_physical(sv, target), target)


def _parse_string_scalar(s: str, target: SqlType):
    tn = target.name
    if target.is_string:
        return s
    if tn == "BOOLEAN":
        return s.strip().lower() in ("t", "true", "1", "yes", "y")
    if target.is_integer:
        return int(float(s))
    if target.is_floating:
        return float(s)
    return python_value_to_physical(s.strip(), target)


def _format_value(v, stype: SqlType) -> str:
    py = physical_to_python_value(v, stype)
    if isinstance(py, bool):
        return "true" if py else "false"
    if isinstance(py, float) and py == int(py) and abs(py) < 1e15:
        return repr(py)
    if isinstance(py, datetime.datetime):
        return py.isoformat(sep=" ")
    return str(py)


def cast_column(col: Column, target: SqlType) -> Column:
    sn, tn = col.stype.name, target.name
    if tn == "DECIMAL" and col.stype.is_numeric and target.scale is not None \
            and 0 <= target.scale <= 9 and not (
                sn == "DECIMAL" and col.stype.scale == target.scale):
        # CAST to DECIMAL(p, s) quantizes (half-even over the f64 value)
        f = 10.0 ** target.scale
        data = torch.round(col.data.to(torch.float64) * f) / f
        return Column(data, target, col.mask)
    if sn == tn or (col.stype.is_string and target.is_string):
        return Column(col.data, target, col.mask, col.dictionary)
    if col.stype.is_string:
        return _cast_string_column(col, target)
    if target.is_string:
        vals = np.asarray(col.to_numpy())
        strs = np.array(
            [None if _is_na(x) else _format_value(python_value_to_physical(x, col.stype), col.stype)
             for x in vals.tolist()],
            dtype=object,
        )
        return Column._encode_strings(strs, None, col.device)
    if sn == "DATE" and tn in ("TIMESTAMP", "TIMESTAMP_WITH_LOCAL_TIME_ZONE"):
        return Column(col.data.to(torch.int64) * US_PER_DAY, target, col.mask)
    if sn in ("TIMESTAMP", "TIMESTAMP_WITH_LOCAL_TIME_ZONE") and tn == "DATE":
        return Column(timestamp_to_days(col.data).to(torch.int32), target, col.mask)
    if target.name == "BOOLEAN":
        return Column(col.data != 0, target, col.mask)
    data = col.data
    if target.is_integer and data.dtype.is_floating_point:
        # float -> int truncates, NaN -> 0
        data = torch.trunc(torch.where(torch.isnan(data), 0.0, data))
    return Column(data.to(torch_dtype(target)), target, col.mask)


def _cast_string_column(col: Column, target: SqlType) -> Column:
    d = col.dictionary.astype(str)
    parsed = []
    bad = np.zeros(len(d), bool)
    for i, s in enumerate(d):
        try:
            parsed.append(_parse_string_scalar(s, target))
        except (ValueError, TypeError):
            parsed.append(0)
            bad[i] = True
    arr = torch.from_numpy(np.asarray(parsed, dtype=physical_dtype(target))
                           ).to(col.device)
    idx = col.data.clamp(0, len(d) - 1).long()
    mask = col.mask
    if bad.any():
        okay = torch.from_numpy(~bad).to(col.device)[idx]
        mask = okay if mask is None else (mask & okay)
    return Column(arr[idx], target, mask)


def _is_na(x) -> bool:
    if x is None:
        return True
    if isinstance(x, float) and np.isnan(x):
        return True
    if isinstance(x, np.datetime64) and np.isnat(x):
        return True
    return False
