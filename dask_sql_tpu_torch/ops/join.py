"""Equi-join kernels: sort-probe pair expansion on the device.

The counterpart of ``dask_sql_tpu/ops/join.py``: keys get codes on a shared
domain (``kernels.join_key_codes``, by the ``hash`` or the statistics'
``dense`` variant, which give equal keys equal codes in the same order),
the build side is sorted by code
(stable), probes binary-search their run, and the matched pairs are
materialized with a cumsum expansion -- all plain torch ops.  The pair order
is the JAX package's: left rows in order, and for each left row its right
matches in right-row order.  Each join syncs its output size to the host
once (eager execution).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..table import Column, Scalar, Table
from .kernels import join_key_codes, mask_to_indices


def _match_runs(lcodes: torch.Tensor, rcodes: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(right rows in code order, each left row's first match in that order,
    each left row's match count).  Code -1 never matches."""
    order = torch.argsort(rcodes, stable=True)
    sorted_r = rcodes[order]
    start = torch.searchsorted(sorted_r, lcodes)
    stop = torch.searchsorted(sorted_r, lcodes, right=True)
    return order, start, torch.where(lcodes >= 0, stop - start, 0)


def _expand_matches(lcodes: torch.Tensor, rcodes: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Matching (left_row, right_row) index pairs for equi keys.

    Returns (left_idx, right_idx, left_match_count).  Code -1 never matches.
    """
    order, start, counts = _match_runs(lcodes, rcodes)
    total = int(counts.sum())
    offsets = torch.cumsum(counts, 0)
    idx = torch.arange(total, device=lcodes.device)
    li = torch.searchsorted(offsets, idx, right=True)
    prev = torch.where(li > 0, offsets[(li - 1).clamp_min(0)], 0)
    ri = order[start[li] + (idx - prev)]
    return li, ri, counts


def join_tables(left: Table, right: Table, left_keys: List[int],
                right_keys: List[int], join_type: str,
                null_aware_anti: bool = False,
                null_equal: bool = False,
                variant: str = "hash") -> Tuple[Table, None]:
    """Equi-join two tables.

    Returns (joined table, None): left columns then right columns, or only
    the left columns for SEMI/ANTI.  Outer-join unmatched rows follow the
    matched pairs, with NULLs on the other side.  ``variant`` is the key
    coding (``kernels.join_key_codes``)."""
    nl, nr = left.num_rows, right.num_rows
    dev = left.columns[0].device if left.columns else torch.device("cpu")
    if left_keys:
        lcodes, rcodes = join_key_codes(
            [left.columns[i] for i in left_keys],
            [right.columns[i] for i in right_keys], null_equal=null_equal,
            variant=variant)
    else:
        # cross join: all pairs
        lcodes = torch.zeros(nl, dtype=torch.int64, device=dev)
        rcodes = torch.zeros(nr, dtype=torch.int64, device=dev)

    if join_type in ("SEMI", "ANTI"):
        counts = _match_runs(lcodes, rcodes)[2]
    if join_type == "SEMI":
        return left.take(mask_to_indices(counts > 0)), None
    if join_type == "ANTI":
        if null_aware_anti:
            # NOT IN: a NULL on the build side qualifies nothing; a NULL
            # probe key qualifies only against an EMPTY build side
            if nr and bool((rcodes < 0).any()):
                return left.slice(0, 0), None
            keep = (counts == 0) & ((lcodes >= 0) | (nr == 0))
        else:
            keep = counts == 0
        return left.take(mask_to_indices(keep)), None
    li, ri, counts = _expand_matches(lcodes, rcodes)
    return _assemble(left, right, li, ri, counts, join_type), None


def _assemble(left: Table, right: Table, li, ri, counts,
              join_type: str) -> Table:
    parts_l, parts_r = [left.take(li)], [right.take(ri)]
    if join_type in ("LEFT", "FULL"):
        extra = mask_to_indices(counts == 0)
        if int(extra.shape[0]):
            parts_l.append(left.take(extra))
            parts_r.append(_null_table(right, int(extra.shape[0])))
    if join_type in ("RIGHT", "FULL"):
        matched_r = torch.zeros(right.num_rows, dtype=torch.bool,
                                device=counts.device)
        matched_r[ri] = True
        extra = mask_to_indices(~matched_r)
        if int(extra.shape[0]):
            parts_l.append(_null_table(left, int(extra.shape[0])))
            parts_r.append(right.take(extra))
    lfull, rfull = concat_tables(parts_l), concat_tables(parts_r)
    return Table(lfull.names + rfull.names, lfull.columns + rfull.columns)


def rejoin_outer(left: Table, right: Table, pairs_table: Table,
                 keep_pairs: torch.Tensor, li: torch.Tensor, ri: torch.Tensor,
                 join_type: str) -> Table:
    """Apply a residual filter to matched pairs, then restore the outer
    rows that lost every match."""
    kept = mask_to_indices(keep_pairs)
    parts = [pairs_table.take(kept)]
    for side, idx in (("LEFT", li), ("RIGHT", ri)):
        if join_type not in (side, "FULL"):
            continue
        this = left if side == "LEFT" else right
        has = torch.zeros(this.num_rows, dtype=torch.bool, device=kept.device)
        has[idx[kept]] = True
        missing = mask_to_indices(~has)
        k = int(missing.shape[0])
        if k:
            if side == "LEFT":
                lt, rt = left.take(missing), _null_table(right, k)
            else:
                lt, rt = _null_table(left, k), right.take(missing)
            parts.append(Table(lt.names + rt.names, lt.columns + rt.columns))
    return concat_tables(parts)


def _null_table(src: Table, n: int) -> Table:
    cols = []
    for c in src.columns:
        null_col = Column.from_scalar(Scalar(None, c.stype), n, c.device)
        if c.stype.is_string:
            null_col = Column(null_col.data, c.stype, null_col.mask, c.dictionary)
        cols.append(null_col)
    return Table(list(src.names), cols)


def concat_tables(tables: List[Table]) -> Table:
    """Row-wise concatenation, merging string dictionaries."""
    if len(tables) == 1:
        return tables[0]
    names = tables[0].names
    return Table(list(names), [concat_columns([t.columns[i] for t in tables])
                               for i in range(len(names))])


def concat_columns(cols: List[Column]) -> Column:
    t0 = cols[0]
    if t0.stype.is_string:
        dicts = [c.dictionary.astype(str) for c in cols]
        union = np.unique(np.concatenate(dicts))
        datas = []
        for c, d in zip(cols, dicts):
            remap = torch.from_numpy(np.searchsorted(union, d).astype(np.int32)
                                     ).to(c.device)
            datas.append(remap[c.data.clamp(0, max(len(d) - 1, 0)).long()])
        return Column(torch.cat(datas), t0.stype, _concat_masks(cols),
                      union.astype(object))
    dt = cols[0].data.dtype
    for c in cols[1:]:
        dt = torch.promote_types(dt, c.data.dtype)
    return Column(torch.cat([c.data.to(dt) for c in cols]), t0.stype,
                  _concat_masks(cols))


def _concat_masks(cols: List[Column]) -> Optional[torch.Tensor]:
    if all(c.mask is None for c in cols):
        return None
    return torch.cat([c.valid_mask() for c in cols])


def cross_join_pairs(nl: int, nr: int, device
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    li = torch.arange(nl, device=device).repeat_interleave(nr)
    ri = torch.arange(nr, device=device).repeat(nl)
    return li, ri
