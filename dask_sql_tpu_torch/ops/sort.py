"""Sort kernels: multi-key ORDER BY with NULLS FIRST/LAST on the device.

The counterpart of ``dask_sql_tpu/ops/sort.py``.  torch has no ``lexsort``:
the same operand list the JAX package hands to ``jnp.lexsort`` (least
significant first) is applied as a chain of stable sorts, each permuting
the result of the last, which gives the identical permutation.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..table import Table
from .kernels import comparable_data


def _negate(data: torch.Tensor) -> torch.Tensor:
    # NaN stays NaN and sorts last either way, as in the JAX package
    if data.dtype.is_floating_point:
        return -data
    return -data.to(torch.int64)


def sort_indices(table: Table,
                 keys: List[Tuple[int, bool, bool]]) -> torch.Tensor:
    """Stable permutation for ORDER BY.

    ``keys`` = [(column_index, ascending, nulls_first), ...] in priority order.
    """
    arrays = []
    for idx, ascending, nulls_first in reversed(keys):
        col = table.columns[idx]
        data = comparable_data(col)
        if not data.dtype.is_floating_point:
            data = data.to(torch.int64)
        if not ascending:
            data = _negate(data)
        arrays.append(data)
        if col.mask is not None:
            nullkey = (~col.mask).to(torch.int64)
            arrays.append(nullkey if not nulls_first else -nullkey)
    perm = torch.arange(table.num_rows, device=table.columns[0].device
                        if table.columns else None)
    for a in arrays:
        order = torch.sort(a[perm], stable=True).indices
        perm = perm[order]
    return perm


def apply_sort(table: Table, keys: List[Tuple[int, bool, bool]]) -> Table:
    if table.num_rows <= 1 or not keys:
        return table
    return table.take(sort_indices(table, keys))


def apply_offset_limit(table: Table, offset: Optional[int],
                       limit: Optional[int]) -> Table:
    start = offset or 0
    stop = table.num_rows if limit is None else min(start + limit, table.num_rows)
    if start == 0 and stop == table.num_rows:
        return table
    return table.slice(start, stop)
