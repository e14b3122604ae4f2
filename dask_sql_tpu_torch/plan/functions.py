"""Operator/function metadata: names, classification, result-type inference.

The operator vocabulary mirrors the reference's scalar-op library
(upstream dask_sql/physical/rex/core/call.py:685-762) and aggregation
mapping (physical/rel/logical/aggregate.py:91-117), plus the window ops
(physical/rel/logical/window.py:220-231).  Implementations live in
``physical/rex/ops.py``; this module is what the binder consults for typing.
"""
from __future__ import annotations

from typing import List

from ..types import (
    BIGINT, BOOLEAN, DATE, DOUBLE, INTEGER, INTERVAL_DAY_TIME, NULLTYPE,
    SqlType, TIMESTAMP, VARCHAR, promote,
)

# ---------------------------------------------------------------------------
# classification
# ---------------------------------------------------------------------------

AGGREGATE_FUNCTIONS = {
    "COUNT", "SUM", "$SUM0", "AVG", "MIN", "MAX", "ANY_VALUE", "EVERY",
    "SINGLE_VALUE", "BIT_AND", "BIT_OR", "BIT_XOR", "STDDEV", "STDDEV_POP",
    "STDDEV_SAMP", "VAR_POP", "VAR_SAMP", "VARIANCE", "REGR_COUNT",
    "BOOL_AND", "BOOL_OR", "LISTAGG",
}

WINDOW_ONLY_FUNCTIONS = {
    "ROW_NUMBER", "RANK", "DENSE_RANK", "PERCENT_RANK", "CUME_DIST", "NTILE",
    "LAG", "LEAD", "FIRST_VALUE", "LAST_VALUE", "NTH_VALUE",
}


def is_aggregate(op: str) -> bool:
    return op in AGGREGATE_FUNCTIONS


def is_window_only(op: str) -> bool:
    return op in WINDOW_ONLY_FUNCTIONS


# ---------------------------------------------------------------------------
# result-type inference for scalar calls
# ---------------------------------------------------------------------------

_COMPARISONS = {"=", "<>", "<", "<=", ">", ">="}
_BOOL_OPS = {"AND", "OR", "NOT", "LIKE", "ILIKE", "SIMILAR", "REGEXP",
             "IS_NULL", "IS_NOT_NULL", "IS_TRUE", "IS_NOT_TRUE", "IS_FALSE",
             "IS_NOT_FALSE", "IS_DISTINCT_FROM", "IS_NOT_DISTINCT_FROM",
             "IN_LIST", "BETWEEN", "EXISTS"}

_STRING_RESULT = {
    "||", "CONCAT", "UPPER", "LOWER", "INITCAP", "SUBSTRING", "SUBSTR",
    "TRIM", "LTRIM", "RTRIM", "BTRIM", "OVERLAY", "REPLACE", "REPEAT",
    "REVERSE", "LEFT", "RIGHT", "LPAD", "RPAD", "CHR", "SPLIT_PART",
    "REGEXP_REPLACE", "TO_CHAR", "TRANSLATE",
}

_INT_RESULT = {"CHAR_LENGTH", "CHARACTER_LENGTH", "LENGTH", "POSITION",
               "STRPOS", "ASCII", "OCTET_LENGTH", "SIGN_INT"}

_BIGINT_RESULT = {"EXTRACT", "YEAR", "MONTH", "DAY", "HOUR", "MINUTE",
                  "SECOND", "QUARTER", "DAYOFWEEK", "DAYOFMONTH", "DAYOFYEAR",
                  "WEEK", "TIMESTAMPDIFF", "DATEDIFF"}

_DOUBLE_RESULT = {
    "SQRT", "EXP", "LN", "LOG10", "LOG", "POWER", "POW", "SIN", "COS", "TAN",
    "ASIN", "ACOS", "ATAN", "ATAN2", "SINH", "COSH", "TANH", "COT", "DEGREES",
    "RADIANS", "CBRT", "RAND", "RANDOM", "PI",
}

_SAME_AS_ARG = {"NEGATE", "ABS", "FLOOR", "CEIL", "CEILING", "ROUND",
                "TRUNCATE", "TRUNC", "SIGN"}


def infer_call_type(op: str, arg_types: List[SqlType]) -> SqlType:
    nullable = any(t.nullable for t in arg_types) if arg_types else False
    if op in _COMPARISONS or op in _BOOL_OPS:
        return BOOLEAN
    if op in _STRING_RESULT:
        return VARCHAR
    if op in _INT_RESULT:
        return INTEGER
    if op in _BIGINT_RESULT:
        return BIGINT
    if op in _DOUBLE_RESULT:
        return DOUBLE
    if op in _SAME_AS_ARG:
        t = arg_types[0]
        if op in ("FLOOR", "CEIL", "CEILING") and len(arg_types) == 2:
            return t  # datetime FLOOR(d TO unit)
        if t.name == "NULL":
            return DOUBLE
        return SqlType(t.name, t.precision, t.scale)
    if op == "MOD" or op == "%":
        return promote(arg_types[0], arg_types[1])
    if op in ("+", "-"):
        a, b = arg_types
        # temporal arithmetic
        if a.is_temporal and b.is_interval:
            if b.name == "INTERVAL_YEAR_MONTH":
                return SqlType(a.name)
            return SqlType(a.name)
        if b.is_temporal and a.is_interval and op == "+":
            return SqlType(b.name)
        if a.is_temporal and b.is_temporal and op == "-":
            return INTERVAL_DAY_TIME
        if a.is_interval and b.is_interval:
            return SqlType(a.name)
        return promote(a, b)
    if op == "*":
        a, b = arg_types
        if a.is_interval or b.is_interval:
            return SqlType(a.name if a.is_interval else b.name)
        return promote(a, b)
    if op == "/":
        a, b = arg_types
        if a.is_interval:
            return SqlType(a.name)
        t = promote(a, b)
        # SQL integer division stays integral (reference SQLDivisionOperator,
        # call.py:120-144 truncates int results)
        return t
    if op in ("COALESCE", "IFNULL", "NVL", "GREATEST", "LEAST", "NULLIF", "CASE"):
        ts = [t for t in arg_types if t.name != "NULL"]
        if not ts:
            return NULLTYPE
        out = ts[0]
        for t in ts[1:]:
            out = promote(out, t)
        return out
    if op in ("CURRENT_DATE",):
        return DATE
    if op in ("CURRENT_TIMESTAMP", "NOW", "LOCALTIMESTAMP", "CURRENT_TIME", "LOCALTIME"):
        return TIMESTAMP
    if op == "LAST_DAY":
        return DATE
    if op == "DATE_TRUNC":
        return TIMESTAMP
    if op == "TIMESTAMPADD":
        return arg_types[-1]
    if op == "RAND_INTEGER":
        return INTEGER
    if op == "ROW":
        return arg_types[0] if arg_types else NULLTYPE
    if op == "SEARCH":
        return BOOLEAN
    if op == "CAST":
        raise AssertionError("CAST typed by binder directly")
    raise KeyError(op)


def infer_agg_type(op: str, arg_types: List[SqlType]) -> SqlType:
    if op in ("COUNT", "REGR_COUNT", "ROW_NUMBER", "RANK", "DENSE_RANK", "NTILE"):
        return SqlType("BIGINT", nullable=False)
    if op in ("SUM", "$SUM0"):
        t = arg_types[0]
        if t.is_integer:
            return BIGINT
        if t.name == "DECIMAL":
            return SqlType("DECIMAL", t.precision, t.scale)
        return DOUBLE
    if op in ("AVG", "STDDEV", "STDDEV_POP", "STDDEV_SAMP", "VAR_POP",
              "VAR_SAMP", "VARIANCE", "PERCENT_RANK", "CUME_DIST"):
        return DOUBLE
    if op in ("EVERY", "BOOL_AND", "BOOL_OR"):
        return BOOLEAN
    if op == "LISTAGG":
        return VARCHAR
    if op in ("MIN", "MAX", "ANY_VALUE", "SINGLE_VALUE", "BIT_AND", "BIT_OR",
              "BIT_XOR", "FIRST_VALUE", "LAST_VALUE", "NTH_VALUE", "LAG", "LEAD"):
        t = arg_types[0]
        return SqlType(t.name, t.precision, t.scale)
    raise KeyError(op)
