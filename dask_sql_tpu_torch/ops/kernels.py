"""Shared device primitives: key factorization, string-code unification,
compaction, civil-date arithmetic.

The counterpart of ``dask_sql_tpu/ops/kernels.py`` for what the eager
executor calls: factorization, the join key codes (the shared ``hash``
factorize and the statistics-driven ``dense`` coding), compaction, civil
dates, EXTRACT and FLOOR/CEIL's ``trunc_date``, and the total-order key
parts (``key_parts``, ``append_lexsort_operands``) the window operator
sorts by.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..table import Column
from ..types import is_int_dtype


# ---------------------------------------------------------------------------
# factorization: columns -> dense int codes
# ---------------------------------------------------------------------------

def unify_string_codes(cols: List[Column]) -> List[torch.Tensor]:
    """Re-code string columns onto their sorted dictionary union, so that
    equality and order of the returned int64 codes are string-correct."""
    dicts = [c.dictionary.astype(str) for c in cols]
    union = np.unique(np.concatenate(dicts))
    out = []
    for c, d in zip(cols, dicts):
        remap = torch.from_numpy(np.searchsorted(union, d).astype(np.int64)
                                 ).to(c.device)
        out.append(remap[c.data.clamp(0, len(d) - 1).long()])
    return out


def comparable_data(col: Column) -> torch.Tensor:
    """Numeric tensor whose order matches SQL ordering for this column."""
    if col.stype.is_string:
        return col.dict_ranks().data.to(torch.int64)
    if col.data.dtype == torch.bool:
        return col.data.to(torch.int64)
    return col.data


def factorize_columns(cols: List[Column], *, null_as_group: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Multi-column factorize: rows -> dense codes 0..G-1 in ascending key
    order, NULL first per column.

    Returns (codes int64, representative (first) row per group, G).  Rows
    with a NULL key form their own groups by null pattern
    (``null_as_group=True``, GROUP BY semantics) or get code -1 (join-key
    semantics, where NULL never matches).
    """
    n = len(cols[0])
    dev = cols[0].device
    per_col_codes = []
    for c in cols:
        data = comparable_data(c)
        if c.mask is not None:
            fill = data.min() if n else 0
            _, inv = torch.unique(torch.where(c.mask, data, fill),
                                  sorted=True, return_inverse=True)
            inv = torch.where(c.mask, inv + 1, 0)
        else:
            _, inv = torch.unique(data, sorted=True, return_inverse=True)
            inv = inv + 1
        per_col_codes.append(inv.reshape(-1).to(torch.int64))

    combined = per_col_codes[0]
    for c in per_col_codes[1:]:
        m = int(c.max()) + 1 if n else 1
        combined = combined * m + c

    uniq_codes, codes = torch.unique(combined, sorted=True, return_inverse=True)
    codes = codes.reshape(-1)
    num_groups = int(uniq_codes.shape[0])
    rows = torch.arange(n, device=dev)
    first = torch.full((num_groups,), n, dtype=torch.int64, device=dev)
    if null_as_group:
        first.scatter_reduce_(0, codes, rows, reduce="amin", include_self=True)
        return codes, first, num_groups
    any_null = torch.zeros(n, dtype=torch.bool, device=dev)
    for c in cols:
        if c.mask is not None:
            any_null = any_null | ~c.mask
    codes = torch.where(any_null, -1, codes)
    valid = codes >= 0
    first.scatter_reduce_(0, torch.where(valid, codes, 0),
                          torch.where(valid, rows, n), reduce="amin",
                          include_self=True)
    return codes, first, num_groups


def join_key_codes(left: List[Column], right: List[Column],
                   null_equal: bool = False, variant: str = "hash"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Codes of left+right key columns on a shared domain.

    Returns int64 codes for each side; -1 marks rows with a NULL key, which
    never match.  ``null_equal=True`` is set-operation equality (IS NOT
    DISTINCT FROM): NULL gets its own shared code and matches NULL.

    ``variant="hash"`` factorizes both sides together (``torch.unique``
    over the concatenated keys).  ``variant="dense"`` (the statistics'
    choice for one integer key pair) codes ``key - lo`` with no unique and
    no sort, and falls back to ``hash`` where it does not apply.  Both
    give equal codes to equal keys in key order, so joins pair the same
    rows in the same order under either."""
    if variant == "dense":
        out = _dense_join_codes(left, right, null_equal)
        if out is not None:
            return out
    nl = len(left[0]) if left else 0
    per = []
    for lc, rc in zip(left, right):
        if lc.stype.is_string or rc.stype.is_string:
            data = torch.cat(unify_string_codes([lc, rc]))
        else:
            dt = torch.promote_types(lc.data.dtype, rc.data.dtype)
            data = torch.cat([lc.data.to(dt), rc.data.to(dt)])
        _, inv = torch.unique(data, sorted=True, return_inverse=True)
        inv = inv.reshape(-1).to(torch.int64)
        if lc.mask is not None or rc.mask is not None:
            mask = torch.cat([lc.valid_mask(), rc.valid_mask()])
            inv = torch.where(mask, inv + 1, 0) if null_equal \
                else torch.where(mask, inv, -1)
        per.append(inv)

    combined = per[0]
    bad = per[0] < 0
    for c in per[1:]:
        m = max(int(c.max()) + 1 if c.shape[0] else 1, 1)
        combined = combined * m + c.clamp_min(0)
        bad = bad | (c < 0)
    combined = torch.where(bad, -1, combined)
    return combined[:nl], combined[nl:]


_I64_MAX = torch.iinfo(torch.int64).max
_I64_MIN = torch.iinfo(torch.int64).min


def _dense_join_codes(left: List[Column], right: List[Column],
                      null_equal: bool):
    """Direct shared coding of one integer key pair: ``code = key - lo``
    (``+1``, with NULL as the shared code 0, under ``null_equal``), where
    ``lo`` is the smallest valid key of either side.  No unique and no
    sort: the four masked min/max reductions are read to the host in one
    synchronisation, the only one.  None where it does not apply
    (several key columns, strings, floats, no rows, every key NULL, or a
    spread of 2**62 or more that ``key - lo`` could overflow)."""
    if len(left) != 1 or len(right) != 1:
        return None
    lc, rc = left[0], right[0]
    for c in (lc, rc):
        if c.stype.is_string or not is_int_dtype(c.data.dtype):
            return None
    if len(lc) + len(rc) == 0:
        return None
    bounds = []
    for c in (lc, rc):
        if not len(c):
            continue
        data = c.data.to(torch.int64)
        if c.mask is not None:
            bounds += [torch.where(c.mask, data, _I64_MAX).min(),
                       torch.where(c.mask, data, _I64_MIN).max()]
        else:
            bounds += [data.min(), data.max()]
    got = torch.stack(bounds).tolist()
    los = [v for v in got[0::2] if v != _I64_MAX]
    his = [v for v in got[1::2] if v != _I64_MIN]
    if not los or not his:
        return None  # every key NULL on both sides
    lo, hi = min(los), max(his)
    if hi - lo >= 2 ** 62:
        return None
    shift = 1 if null_equal else 0
    out = []
    for c in (lc, rc):
        codes = c.data.to(torch.int64) - lo + shift
        if c.mask is not None:
            codes = torch.where(c.mask, codes, 0 if null_equal else -1)
        out.append(codes)
    return out[0], out[1]


# ---------------------------------------------------------------------------
# compaction (filter -> gather indices)
# ---------------------------------------------------------------------------

def mask_to_indices(mask: torch.Tensor) -> torch.Tensor:
    """Boolean mask -> row indices (host-synced size; eager execution)."""
    return torch.nonzero(mask).reshape(-1)


# ---------------------------------------------------------------------------
# civil-date arithmetic (Howard Hinnant's algorithms, pure integer ops)
# ---------------------------------------------------------------------------

US_PER_DAY = 86_400_000_000


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def civil_from_days(z: torch.Tensor):
    """days-since-epoch -> (year, month, day), vectorized integer math."""
    z = z.to(torch.int64) + 719468
    era = _fdiv(z, 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524) - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = mp + torch.where(mp < 10, 3, -9)
    y = y + (m <= 2).to(torch.int64)
    return y, m, d


def days_from_civil(y: torch.Tensor, m: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    y = y.to(torch.int64) - (m <= 2).to(torch.int64)
    era = _fdiv(y, 400)
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = _fdiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def timestamp_to_days(us: torch.Tensor) -> torch.Tensor:
    return _fdiv(us.to(torch.int64), US_PER_DAY)


def timestamp_time_of_day_us(us: torch.Tensor) -> torch.Tensor:
    return us.to(torch.int64) - timestamp_to_days(us) * US_PER_DAY


def extract_field(field: str, days: torch.Tensor,
                  tod_us: Optional[torch.Tensor]) -> torch.Tensor:
    """EXTRACT over a (days, time-of-day microseconds) pair; ``tod_us`` is
    None for DATE columns.  Field names follow Calcite/PostgreSQL."""
    y, m, d = civil_from_days(days)
    f = field.upper()
    if f == "YEAR":
        return y
    if f == "MONTH":
        return m
    if f in ("DAY", "DAYOFMONTH"):
        return d
    if f == "QUARTER":
        return _fdiv(m - 1, 3) + 1
    if f == "DECADE":
        return _fdiv(y, 10)
    if f == "CENTURY":
        return _fdiv(y + 99, 100)
    if f == "MILLENNIUM":
        return _fdiv(y + 999, 1000)
    days = days.to(torch.int64)
    if f in ("DOW", "DAYOFWEEK"):
        # PostgreSQL DOW: 0 = Sunday; epoch day 0 was a Thursday
        return torch.remainder(days + 4, 7)
    if f == "ISODOW":
        return torch.remainder(days + 3, 7) + 1
    if f in ("DOY", "DAYOFYEAR"):
        return days - days_from_civil(y, torch.ones_like(m), torch.ones_like(d)) + 1
    if f == "WEEK":
        # ISO week number
        thursday = days - (torch.remainder(days + 3, 7) + 1) + 4
        ty, _, _ = civil_from_days(thursday)
        jan1 = days_from_civil(ty, torch.ones_like(m), torch.ones_like(d))
        return _fdiv(thursday - jan1, 7) + 1
    if f == "EPOCH":
        base = days * 86400
        if tod_us is not None:
            base = base + _fdiv(tod_us, 1_000_000)
        return base
    if tod_us is None:
        tod_us = torch.zeros_like(days)
    if f == "HOUR":
        return _fdiv(tod_us, 3_600_000_000)
    if f == "MINUTE":
        return _fdiv(tod_us, 60_000_000) % 60
    if f == "SECOND":
        return _fdiv(tod_us, 1_000_000) % 60
    if f == "MILLISECOND":
        return _fdiv(tod_us, 1000) % 60_000
    if f == "MICROSECOND":
        return tod_us % 60_000_000
    raise NotImplementedError(f"EXTRACT field {field}")


def decimal_unscale(s_int: torch.Tensor, scale: int) -> torch.Tensor:
    """Correctly-rounded ``s_int / 10**scale``: an exact integer quotient
    plus a sub-unit remainder, as in the JAX package."""
    if scale == 0:
        return s_int.to(torch.float64)
    f = 10 ** scale
    q = _fdiv(s_int, f)
    r = s_int - q * f
    return q.to(torch.float64) + r.to(torch.float64) / float(f)


def trunc_date(unit: str, days: torch.Tensor, tod_us: Optional[torch.Tensor]):
    """FLOOR(ts TO unit): returns (days, tod_us); ``tod_us`` is None for a
    DATE and stays None."""
    u = unit.upper()
    y, m, d = civil_from_days(days)
    one = torch.ones_like(m)
    zeros = None if tod_us is None else torch.zeros_like(tod_us)
    if u == "YEAR":
        return days_from_civil(y, one, one), zeros
    if u == "QUARTER":
        return days_from_civil(y, _fdiv(m - 1, 3) * 3 + 1, one), zeros
    if u == "MONTH":
        return days_from_civil(y, m, one), zeros
    if u == "WEEK":
        isodow = torch.remainder(days + 3, 7) + 1
        return days - (isodow - 1), zeros
    if u == "DAY":
        return days, zeros
    if tod_us is None:
        return days, None
    step = {"HOUR": 3_600_000_000, "MINUTE": 60_000_000, "SECOND": 1_000_000,
            "MILLISECOND": 1000}.get(u)
    if step is None:
        raise NotImplementedError(f"FLOOR unit {unit}")
    return days, _fdiv(tod_us, step) * step


# ---------------------------------------------------------------------------
# total-order keys (windows): floats stay f64 with NULL/NaN class flags
# ---------------------------------------------------------------------------

def float_class(x: torch.Tensor, null: Optional[torch.Tensor]) -> torch.Tensor:
    """0 = NULL (first), 1 = ordinary value, 2 = NaN (last)."""
    cls = torch.where(torch.isnan(x), 2, 1).to(torch.int8)
    if null is not None:
        cls = torch.where(null, 0, cls).to(torch.int8)
    return cls


def canon_f64(x: torch.Tensor) -> torch.Tensor:
    """Canonical f64 sort/equality key: -0.0 -> +0.0, NaN -> 0 (the class
    flag tells NaN apart)."""
    x = x.to(torch.float64) + 0.0
    return torch.where(torch.isnan(x), 0.0, x)


def orderable_int64(x: torch.Tensor) -> torch.Tensor:
    """int64 key for non-float comparable data (ints, bools, dictionary
    ranks, dates): ``comparable_data`` already made the order numeric."""
    return x.to(torch.int64)


def key_parts(cols: List[Column]
              ) -> List[Tuple[torch.Tensor, Optional[torch.Tensor]]]:
    """(data, optional class flag) per key column.

    ``data`` is canonical f64 for float columns, or int64 with a NULL
    sentinel otherwise; the int8 flag orders NULL(0) < values(1) < NaN(2)
    and tells a sentinel from a value.  The flag is None for a key with no
    NULLs that is not a float.  Equality of (data, flag) is SQL group
    equality (-0.0 == +0.0, NaNs together, NULLs together)."""
    out = []
    for c in cols:
        raw = comparable_data(c)
        null = None if c.mask is None else ~c.mask
        if raw.dtype.is_floating_point:
            d = canon_f64(raw)
            flag = float_class(raw, null)
            if null is not None:
                d = torch.where(null, 0.0, d)
        else:
            d = orderable_int64(raw)
            flag = None
            if null is not None:
                d = torch.where(null, _I64_MIN, d)
                flag = torch.where(null, 0, 1).to(torch.int8)
        out.append((d, flag))
    return out


def append_lexsort_operands(arrays: list, parts) -> None:
    """Append key-part sort operands (data, then its class flag) to
    ``arrays``, least significant first (``lexsort`` order)."""
    for d, flag in reversed(parts):
        arrays.append(d)
        if flag is not None:
            arrays.append(flag)
