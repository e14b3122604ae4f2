"""Carry a table of the JAX package across to the port, as numpy arrays.

Each column arrives as ``(name, sql type name, data, mask or None,
dictionary or None)``: the physical data the JAX package holds on its device
(int32 dictionary codes for strings, int64 microseconds for timestamps,
...), its validity mask, and the host dictionary of a string column.  Both
engines then query identically encoded data -- the same dictionaries and the
same codes -- so their answers can be compared value for value.  Nothing of
``dask_sql_tpu`` is imported here: the caller hands over numpy arrays.
"""
from __future__ import annotations

import re
from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from .table import Column, Table
from .types import SqlType, parse_type_name

ColumnSpec = Tuple[str, str, np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]

_DECIMAL = re.compile(r"^\s*DECIMAL\s*\(\s*(\d+)\s*,\s*(\d+)\s*\)\s*$", re.I)


def sql_type_from_name(name: str) -> SqlType:
    """``str(SqlType)`` back to a SqlType (``DECIMAL(p, s)`` included)."""
    m = _DECIMAL.match(name)
    if m:
        return SqlType("DECIMAL", int(m.group(1)), int(m.group(2)))
    if name in ("TIMESTAMP_WITH_LOCAL_TIME_ZONE", "INTERVAL_DAY_TIME",
                "INTERVAL_YEAR_MONTH", "NULL"):
        return SqlType(name)
    return parse_type_name(name)


def table_from_columns(columns: Iterable[ColumnSpec],
                       device: torch.device) -> Table:
    """Build the port's ``Table`` on ``device`` from per-column specs."""
    names, cols = [], []
    for name, type_name, data, mask, dictionary in columns:
        stype = sql_type_from_name(type_name)
        if stype.is_string and dictionary is None:
            raise ValueError(f"string column {name!r} needs its dictionary")
        names.append(name)
        cols.append(Column.from_encoded(
            np.asarray(data), stype,
            None if mask is None else np.asarray(mask, dtype=bool),
            None if dictionary is None else np.asarray(dictionary, dtype=object),
            device))
    return Table(names, cols)
