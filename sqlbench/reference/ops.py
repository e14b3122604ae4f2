"""Plain torch building blocks of the reference: key lookups, grouping,
string predicates over dictionaries, and the final ORDER BY and LIMIT.

Nothing here imports the system under test.  Every function works on the
benchmark's own columns (``core.data.Col``) on any device, so the same code
runs on the card after the window and on the CPU in the tests.
"""
from __future__ import annotations

import re
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.data import Col, days

_YEAR0 = 1960
_YEARS = np.arange(_YEAR0, 2041)
_YEAR_START = np.array([days(f"{y}-01-01") for y in _YEARS], np.int64)


def lookup(build: torch.Tensor, probe: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row of each probe key in ``build`` (unique keys): (index, found)."""
    keys, order = torch.sort(build)
    probe = probe.contiguous()
    pos = torch.searchsorted(keys, probe).clamp(max=max(len(keys) - 1, 0))
    found = keys[pos] == probe if len(keys) else torch.zeros_like(
        probe, dtype=torch.bool)
    return order[pos], found


def member(values: torch.Tensor, allowed: torch.Tensor) -> torch.Tensor:
    """``values IN allowed``."""
    if allowed.numel() == 0:
        return torch.zeros_like(values, dtype=torch.bool)
    keys = torch.unique(allowed)
    pos = torch.searchsorted(keys, values).clamp(max=len(keys) - 1)
    return keys[pos] == values


def group(*keys: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Group rows by the key tuple: (inverse index, keys of each group)."""
    if len(keys) == 1:
        uniq, inv = torch.unique(keys[0], return_inverse=True)
        return inv, [uniq]
    stacked = torch.stack([k.to(torch.int64) for k in keys], dim=1)
    uniq, inv = torch.unique(stacked, dim=0, return_inverse=True)
    return inv, [uniq[:, i].to(k.dtype) for i, k in enumerate(keys)]


def gsum(values: torch.Tensor, inv: torch.Tensor, n: int,
         dtype: torch.dtype) -> torch.Tensor:
    """SUM per group in ``dtype``.  A few large groups are summed one by
    one with torch's tree reduction, whose rounding grows with log(rows):
    a scatter-add's grows with the rows, and at SF 10 reaches a part in
    1e10 of a group's sum."""
    values = values.to(dtype)
    if n <= 64:
        return torch.stack([values[inv == g].sum() for g in range(n)]) \
            if n else torch.zeros(0, dtype=dtype, device=values.device)
    return torch.zeros(n, dtype=dtype, device=values.device).index_add_(
        0, inv, values)


def gcount(inv: torch.Tensor, n: int) -> torch.Tensor:
    return torch.bincount(inv, minlength=n)


def count_distinct(inv: torch.Tensor, n: int, values: torch.Tensor
                   ) -> torch.Tensor:
    """COUNT(DISTINCT values) per group."""
    pairs = torch.unique(torch.stack([inv, values.to(torch.int64)], 1),
                         dim=0)
    return torch.bincount(pairs[:, 0], minlength=n)


def year(day: torch.Tensor) -> torch.Tensor:
    """EXTRACT(YEAR FROM a date of days since 1970-01-01)."""
    starts = torch.as_tensor(_YEAR_START, device=day.device)
    return torch.searchsorted(starts, day, right=True) - 1 + _YEAR0


def _like_regex(pattern: str) -> re.Pattern:
    out = "".join(".*" if ch == "%" else "." if ch == "_" else re.escape(ch)
                  for ch in pattern)
    return re.compile(out + r"\Z", re.DOTALL)


def dict_mask(col: Col, keep) -> torch.Tensor:
    """Rows whose string satisfies ``keep(str) -> bool``, decided once per
    dictionary entry."""
    table = np.fromiter((bool(keep(s)) for s in col.dictionary.tolist()),
                        dtype=bool, count=len(col.dictionary))
    return torch.as_tensor(table, device=col.data.device)[col.data.long()]


def like(col: Col, pattern: str) -> torch.Tensor:
    rx = _like_regex(pattern)
    return dict_mask(col, lambda s: rx.match(s) is not None)


def eq(col: Col, value: str) -> torch.Tensor:
    return dict_mask(col, lambda s: s == value)


def isin(col: Col, values: Sequence[str]) -> torch.Tensor:
    allowed = set(values)
    return dict_mask(col, lambda s: s in allowed)


def between_str(col: Col, lo: str, hi: str) -> torch.Tensor:
    return dict_mask(col, lambda s: lo <= s <= hi)


def code(col: Col) -> torch.Tensor:
    """A string column's sort rank (its dictionary is sorted)."""
    return col.data.to(torch.int64)


def decode(col: Col, codes: torch.Tensor) -> np.ndarray:
    return col.dictionary[codes.cpu().numpy()]


def host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def as_dates(day: torch.Tensor) -> np.ndarray:
    return host(day).astype("datetime64[D]")


def null_if_empty(value: torch.Tensor, n_rows: int) -> np.ndarray:
    """A one-row aggregate without GROUP BY: NULL over zero rows."""
    v = host(value.reshape(1)).astype(np.float64)
    return v if n_rows else np.array([np.nan])


def finish(cols: List[np.ndarray], order: Sequence, limit: Optional[int]
           ) -> List[np.ndarray]:
    """ORDER BY (column, "asc"/"desc") pairs, then LIMIT; rows that tie on
    the ORDER BY keep the order of every column, ascending."""
    n = len(cols[0]) if cols else 0
    if n == 0:
        return cols
    keys = []
    for i, direction in reversed(list(order)):
        rank = np.unique(cols[i], return_inverse=True)[1].reshape(-1)
        keys.append(-rank if direction == "desc" else rank)
    ties = [np.unique(c, return_inverse=True)[1].reshape(-1)
            for c in reversed(cols)]
    idx = np.lexsort(ties + keys) if keys or ties else np.arange(n)
    if limit is not None:
        idx = idx[:limit]
    return [c[idx] for c in cols]
