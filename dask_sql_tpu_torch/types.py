"""SQL logical type system and mappings to numpy/torch physical types.

TPU-native re-design of the reference's type mapping layer
(upstream dask_sql/mappings.py:1-300).  The reference maps SQL types to
pandas/numpy dtypes (including pandas nullable extension dtypes); here every
logical type maps to a *fixed-width device dtype* plus an explicit validity
mask, because TPUs have no NaN-as-null story for ints and XLA wants static,
uniform buffers:

- BOOLEAN            -> bool_
- TINYINT..BIGINT    -> int8/int16/int32/int64
- FLOAT/DOUBLE       -> float32/float64
- DECIMAL(p, s)      -> float64 (documented precision compromise, like the
                        reference's DECIMAL->float64, mappings.py:64)
- VARCHAR/CHAR       -> int32 dictionary codes + host-side dictionary
- DATE               -> int32 days since Unix epoch
- TIMESTAMP          -> int64 microseconds since Unix epoch
- TIME               -> int64 microseconds since midnight
- INTERVAL day-time  -> int64 milliseconds (Calcite's representation)
- INTERVAL year-month-> int64 months
"""
from __future__ import annotations

import datetime
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch


@dataclass(frozen=True)
class SqlType:
    """A logical SQL type. ``name`` is the canonical upper-case SQL name."""

    name: str
    precision: Optional[int] = None
    scale: Optional[int] = None
    nullable: bool = True

    def __str__(self) -> str:
        if self.name == "DECIMAL" and self.precision is not None:
            return f"DECIMAL({self.precision}, {self.scale or 0})"
        return self.name

    # -- classification helpers -------------------------------------------
    @property
    def is_numeric(self) -> bool:
        return self.name in _NUMERIC

    @property
    def is_integer(self) -> bool:
        return self.name in _INTEGER

    @property
    def is_floating(self) -> bool:
        return self.name in ("FLOAT", "DOUBLE", "REAL", "DECIMAL")

    @property
    def is_string(self) -> bool:
        return self.name in ("VARCHAR", "CHAR")

    @property
    def is_temporal(self) -> bool:
        return self.name in ("DATE", "TIMESTAMP", "TIMESTAMP_WITH_LOCAL_TIME_ZONE", "TIME")

    @property
    def is_interval(self) -> bool:
        return self.name in ("INTERVAL_DAY_TIME", "INTERVAL_YEAR_MONTH")

    @property
    def is_boolean(self) -> bool:
        return self.name == "BOOLEAN"

    def with_nullable(self, nullable: bool) -> "SqlType":
        return SqlType(self.name, self.precision, self.scale, nullable)


_INTEGER = {"TINYINT", "SMALLINT", "INTEGER", "BIGINT"}
_NUMERIC = _INTEGER | {"FLOAT", "REAL", "DOUBLE", "DECIMAL"}

# Canonical singletons
BOOLEAN = SqlType("BOOLEAN")
TINYINT = SqlType("TINYINT")
SMALLINT = SqlType("SMALLINT")
INTEGER = SqlType("INTEGER")
BIGINT = SqlType("BIGINT")
FLOAT = SqlType("FLOAT")
DOUBLE = SqlType("DOUBLE")
VARCHAR = SqlType("VARCHAR")
DATE = SqlType("DATE")
TIMESTAMP = SqlType("TIMESTAMP")
TIME = SqlType("TIME")
INTERVAL_DAY_TIME = SqlType("INTERVAL_DAY_TIME")
INTERVAL_YEAR_MONTH = SqlType("INTERVAL_YEAR_MONTH")
NULLTYPE = SqlType("NULL")


def decimal(precision: int = 38, scale: int = 0) -> SqlType:
    return SqlType("DECIMAL", precision, scale)


def exact_decimal_scale(stype: SqlType):
    """Scale for EXACT scaled-int64 aggregation, or None.

    DECIMAL(p<=15, 0<=s<=9) sums fit int64 at any realistic row count
    (SF100 money sums are ~6e15 'cents' < 2^53 < 2^63): SUM/AVG over such
    columns accumulate in integers — bit-stable across runs and matching a
    true decimal engine exactly, unlike the f64 fold the reference uses
    (mappings.py:64 maps DECIMAL to float64 end to end).

    The precision gate is 15, not 18: values are STORED as f64, so an
    individual value must be exactly representable in the 53-bit mantissa
    (10^15 < 2^53 < 10^16) or the scaled-int conversion already misrounds
    before any summation happens.
    """
    if stype.name != "DECIMAL" or stype.scale is None:
        return None
    if not (0 <= stype.scale <= 9):
        return None
    if stype.precision is not None and stype.precision > 15:
        return None
    return stype.scale


# ---------------------------------------------------------------------------
# logical type -> physical numpy dtype (device representation)
# ---------------------------------------------------------------------------

_PHYSICAL: dict[str, np.dtype] = {
    "BOOLEAN": np.dtype(np.bool_),
    "TINYINT": np.dtype(np.int8),
    "SMALLINT": np.dtype(np.int16),
    "INTEGER": np.dtype(np.int32),
    "BIGINT": np.dtype(np.int64),
    "FLOAT": np.dtype(np.float32),
    "REAL": np.dtype(np.float32),
    "DOUBLE": np.dtype(np.float64),
    "DECIMAL": np.dtype(np.float64),
    "VARCHAR": np.dtype(np.int32),  # dictionary codes
    "CHAR": np.dtype(np.int32),
    "DATE": np.dtype(np.int32),
    "TIMESTAMP": np.dtype(np.int64),
    "TIMESTAMP_WITH_LOCAL_TIME_ZONE": np.dtype(np.int64),
    "TIME": np.dtype(np.int64),
    "INTERVAL_DAY_TIME": np.dtype(np.int64),
    "INTERVAL_YEAR_MONTH": np.dtype(np.int64),
    "NULL": np.dtype(np.float64),
}


def physical_dtype(stype: SqlType) -> np.dtype:
    return _PHYSICAL[stype.name]


_NUMPY_TO_TORCH: dict[np.dtype, torch.dtype] = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


_INT_DTYPES = (torch.int8, torch.int16, torch.int32, torch.int64, torch.uint8)


def is_int_dtype(dtype: torch.dtype) -> bool:
    """Integer dtype, bool excluded (numpy's ``issubdtype(.., integer)``)."""
    return dtype in _INT_DTYPES


def torch_dtype(stype: SqlType) -> torch.dtype:
    """Device dtype of a logical type: ``physical_dtype`` as a torch dtype."""
    return _NUMPY_TO_TORCH[_PHYSICAL[stype.name]]


# ---------------------------------------------------------------------------
# numpy/pandas dtype -> logical SQL type  (reference: mappings.py:17-41)
# ---------------------------------------------------------------------------

def sql_type_from_numpy(dtype) -> SqlType:
    dtype = np.dtype(dtype) if not isinstance(dtype, np.dtype) else dtype
    kind = dtype.kind
    if kind == "b":
        return BOOLEAN
    if kind == "i":
        return {1: TINYINT, 2: SMALLINT, 4: INTEGER, 8: BIGINT}[dtype.itemsize]
    if kind == "u":
        # SQL has no unsigned types: widen
        return {1: SMALLINT, 2: INTEGER, 4: BIGINT, 8: BIGINT}[dtype.itemsize]
    if kind == "f":
        return FLOAT if dtype.itemsize <= 4 else DOUBLE
    if kind == "M":
        return TIMESTAMP
    if kind == "m":
        return INTERVAL_DAY_TIME
    if kind in ("U", "S", "O"):
        return VARCHAR
    raise NotImplementedError(f"No SQL type for numpy dtype {dtype}")


# ---------------------------------------------------------------------------
# type promotion for arithmetic / comparison / set operations
# ---------------------------------------------------------------------------

_NUM_ORDER = ["TINYINT", "SMALLINT", "INTEGER", "BIGINT", "FLOAT", "REAL", "DOUBLE", "DECIMAL"]


def promote(a: SqlType, b: SqlType) -> SqlType:
    """Least common supertype for binary operations."""
    if a.name == b.name:
        if a.name == "DECIMAL":
            return SqlType(
                "DECIMAL",
                max(a.precision or 38, b.precision or 38),
                max(a.scale or 0, b.scale or 0),
            )
        return SqlType(a.name)
    if a.name == "NULL":
        return SqlType(b.name, b.precision, b.scale)
    if b.name == "NULL":
        return SqlType(a.name, a.precision, a.scale)
    if a.is_numeric and b.is_numeric:
        ia, ib = _NUM_ORDER.index(a.name), _NUM_ORDER.index(b.name)
        winner = _NUM_ORDER[max(ia, ib)]
        if winner == "DECIMAL":
            # decimal vs float -> double; decimal vs int -> decimal
            other = a if winner == b.name else b
            if other.name in ("FLOAT", "REAL", "DOUBLE"):
                return DOUBLE
            d = a if a.name == "DECIMAL" else b
            return SqlType("DECIMAL", d.precision, d.scale)
        return SqlType(winner)
    if a.is_string and b.is_string:
        return VARCHAR
    if a.is_temporal and b.is_temporal:
        return TIMESTAMP if "TIMESTAMP" in (a.name, b.name) else SqlType(a.name)
    # date/timestamp +- interval
    if a.is_temporal and b.is_interval:
        return SqlType(a.name)
    if b.is_temporal and a.is_interval:
        return SqlType(b.name)
    if a.is_boolean and b.is_boolean:
        return BOOLEAN
    # string vs anything: compare as the other type (SQL implicit cast)
    if a.is_string:
        return SqlType(b.name, b.precision, b.scale)
    if b.is_string:
        return SqlType(a.name, a.precision, a.scale)
    raise TypeError(f"Cannot promote {a} and {b}")


def parse_type_name(name: str, precision=None, scale=None) -> SqlType:
    """Map a SQL type name as written (``INT``, ``STRING``...) to a SqlType."""
    n = name.upper()
    aliases = {
        "INT": "INTEGER",
        "STRING": "VARCHAR",
        "TEXT": "VARCHAR",
        "REAL": "FLOAT",
        "FLOAT4": "FLOAT",
        "FLOAT8": "DOUBLE",
        "DOUBLE PRECISION": "DOUBLE",
        "NUMERIC": "DECIMAL",
        "DEC": "DECIMAL",
        "BOOL": "BOOLEAN",
        "INT2": "SMALLINT",
        "INT4": "INTEGER",
        "INT8": "BIGINT",
        "LONG": "BIGINT",
        "DATETIME": "TIMESTAMP",
    }
    n = aliases.get(n, n)
    if n == "DECIMAL":
        return SqlType("DECIMAL", precision or 38, scale or 0)
    if n in ("VARCHAR", "CHAR") and precision is not None:
        return SqlType(n, precision)
    if n not in _PHYSICAL:
        raise NotImplementedError(f"Unknown SQL type: {name}")
    return SqlType(n)


# ---------------------------------------------------------------------------
# python scalar <-> SQL value conversion (reference: mappings.py:103-190)
# ---------------------------------------------------------------------------

_EPOCH = datetime.datetime(1970, 1, 1)
_EPOCH_DATE = datetime.date(1970, 1, 1)


def python_value_to_physical(value: Any, stype: SqlType):
    """Convert a python literal to its physical (device) representation."""
    if value is None:
        return None
    n = stype.name
    if n == "DATE":
        if isinstance(value, datetime.datetime):
            value = value.date()
        if isinstance(value, datetime.date):
            return (value - _EPOCH_DATE).days
        if isinstance(value, str):
            return (datetime.date.fromisoformat(value) - _EPOCH_DATE).days
        return int(value)
    if n in ("TIMESTAMP", "TIMESTAMP_WITH_LOCAL_TIME_ZONE"):
        if isinstance(value, str):
            value = datetime.datetime.fromisoformat(value)
        if isinstance(value, datetime.datetime):
            if value.tzinfo is not None:
                value = value.astimezone(datetime.timezone.utc).replace(tzinfo=None)
            return int((value - _EPOCH).total_seconds() * 1_000_000)
        if isinstance(value, datetime.date):
            return int((datetime.datetime.combine(value, datetime.time()) - _EPOCH).total_seconds() * 1_000_000)
        if isinstance(value, np.datetime64):
            return int(value.astype("datetime64[us]").astype(np.int64))
        return int(value)
    if n == "TIME":
        if isinstance(value, str):
            value = datetime.time.fromisoformat(value)
        if isinstance(value, datetime.time):
            return ((value.hour * 60 + value.minute) * 60 + value.second) * 1_000_000 + value.microsecond
        return int(value)
    if n == "INTERVAL_DAY_TIME":
        if isinstance(value, datetime.timedelta):
            return int(value.total_seconds() * 1000)
        if isinstance(value, np.timedelta64):
            return int(value.astype("timedelta64[ms]").astype(np.int64))
        return int(value)
    if n == "BOOLEAN":
        return bool(value)
    if n in _INTEGER or n == "INTERVAL_YEAR_MONTH":
        return int(value)
    if stype.is_floating:
        return float(value)
    return value


def physical_to_python_value(value: Any, stype: SqlType) -> Any:
    """Convert a physical scalar back to a rich python value."""
    if value is None:
        return None
    n = stype.name
    if n == "DATE":
        return _EPOCH_DATE + datetime.timedelta(days=int(value))
    if n in ("TIMESTAMP", "TIMESTAMP_WITH_LOCAL_TIME_ZONE"):
        return _EPOCH + datetime.timedelta(microseconds=int(value))
    if n == "TIME":
        us = int(value)
        return datetime.time(us // 3_600_000_000, us // 60_000_000 % 60, us // 1_000_000 % 60, us % 1_000_000)
    if n == "INTERVAL_DAY_TIME":
        return datetime.timedelta(milliseconds=int(value))
    if n == "BOOLEAN":
        return bool(value)
    if stype.is_integer or n == "INTERVAL_YEAR_MONTH":
        return int(value)
    if stype.is_floating:
        return float(value)
    return value
