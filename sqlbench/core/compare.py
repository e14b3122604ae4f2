"""The comparison of one answer with the reference's.

Rows are matched on the template's key columns (a result's GROUP BY keys,
or its one row).  Strings, dates and integers must be equal; a float
column's gap is measured against the largest magnitude the reference has in
that column (``|got - want| / max|want|``), so a sum near zero in one row
is judged at the scale of its column.  The program's own row order must
follow the template's ORDER BY, judged on the program's values.

Readings per answer:

- ``exact_mismatches``: missing or extra rows, a different column count,
  and unequal exact cells, or a NULL against a value;
- ``max_rel_gap``: the widest float gap, as above;
- ``order_violations``: adjacent rows out of the ORDER BY's order.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np


def _normal(values: np.ndarray) -> np.ndarray:
    """Host values of either side in a comparable form: dates as days,
    integers as int64, strings as str, NULL as None."""
    arr = np.asarray(values)
    if arr.dtype.kind == "M":
        out = arr.astype("datetime64[D]").astype(np.int64).astype(object)
        out[np.isnat(arr)] = None
        return out
    if arr.dtype.kind in "iub":
        return arr.astype(np.int64).astype(object)
    if arr.dtype.kind == "f":
        out = arr.astype(object)
        out[np.isnan(arr)] = None
        return out
    return np.array([None if v is None else (v if isinstance(v, str) else
                                             v.item() if hasattr(v, "item")
                                             else v) for v in arr],
                    dtype=object)


def _is_float(values: np.ndarray) -> bool:
    return np.asarray(values).dtype.kind == "f"


def _key(cols: List[np.ndarray], key: Sequence[int], i: int) -> tuple:
    return tuple(cols[k][i] for k in key)


def compare(got: Sequence[np.ndarray], want: Sequence[np.ndarray],
            key: Sequence[int], order: Sequence) -> Dict[str, float]:
    """Readings of one answer (``got``, the program's columns in its row
    order) against the reference's (``want``)."""
    out = {"exact_mismatches": 0, "max_rel_gap": 0.0, "order_violations": 0}
    if len(got) != len(want):            # another column count: all wrong
        out["exact_mismatches"] = 1 + (len(want[0]) if want else 0)
        return out
    g_norm = [_normal(c) for c in got]
    w_norm = [_normal(c) for c in want]
    n_got = len(g_norm[0]) if g_norm else 0
    n_want = len(w_norm[0]) if w_norm else 0
    if key:
        g_rows = {_key(g_norm, key, i): i for i in range(n_got)}
        w_rows = {_key(w_norm, key, i): i for i in range(n_want)}
        if len(g_rows) != n_got:                  # a key twice in the answer
            out["exact_mismatches"] += n_got - len(g_rows)
        pairs = [(g_rows[k], w_rows[k]) for k in w_rows if k in g_rows]
        out["exact_mismatches"] += len(set(w_rows) ^ set(g_rows))
    else:
        pairs = [(i, i) for i in range(min(n_got, n_want))]
        out["exact_mismatches"] += abs(n_got - n_want)
    if pairs:
        gi = np.array([p[0] for p in pairs])
        wi = np.array([p[1] for p in pairs])
        for j in range(len(want)):
            if j in key:
                continue
            gv, wv = g_norm[j][gi], w_norm[j][wi]
            g_null = np.array([x is None for x in gv])
            w_null = np.array([x is None for x in wv])
            out["exact_mismatches"] += int((g_null != w_null).sum())
            both = ~g_null & ~w_null
            if _is_float(want[j]) or _is_float(got[j]) and not _int_like(
                    want[j]):
                a = np.array(gv[both], dtype=np.float64)
                b = np.array(wv[both], dtype=np.float64)
                scale = np.abs(np.array(w_norm[j][~np.array(
                    [x is None for x in w_norm[j]])], dtype=np.float64))
                scale = float(scale.max()) if scale.size else 0.0
                if a.size:
                    gap = np.abs(a - b)
                    rel = float(gap.max()) / scale if scale > 0 else (
                        0.0 if float(gap.max()) == 0.0 else math.inf)
                    if not np.isfinite(a).all():
                        rel = math.inf
                    out["max_rel_gap"] = max(out["max_rel_gap"], rel)
            else:
                out["exact_mismatches"] += int(sum(
                    1 for x, y in zip(gv[both], wv[both]) if not _same(x, y)))
    out["order_violations"] = order_violations(g_norm, order)
    return out


def _int_like(values: np.ndarray) -> bool:
    return np.asarray(values).dtype.kind in "iub"


def _same(x, y) -> bool:
    if isinstance(x, float) or isinstance(y, float):
        return float(x) == float(y)
    return x == y


def order_violations(cols: List[np.ndarray], order: Sequence) -> int:
    """Adjacent rows whose ORDER BY keys are out of order (NULLs last)."""
    if not order or not cols or len(cols[0]) < 2:
        return 0
    bad = 0
    n = len(cols[0])
    for i in range(n - 1):
        for j, direction in order:
            a, b = cols[j][i], cols[j][i + 1]
            if a == b:
                continue
            if a is None or b is None:
                if a is None:
                    bad += 1
                break
            wrong = (a > b) if direction == "asc" else (a < b)
            bad += int(wrong)
            break
    return bad


def combine(readings: Sequence[Dict[str, float]]) -> Dict[str, float]:
    """The run's readings: sums of the counts, the widest gap."""
    out = {"exact_mismatches": 0, "max_rel_gap": 0.0, "order_violations": 0}
    for r in readings:
        out["exact_mismatches"] += r["exact_mismatches"]
        out["order_violations"] += r["order_violations"]
        out["max_rel_gap"] = max(out["max_rel_gap"], r["max_rel_gap"])
    return out
