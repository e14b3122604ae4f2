"""Per-shard partial aggregates and their combine trees.

The counterpart of ``dask_sql_tpu/parallel/partial_agg.py``: every
supported aggregate splits into a PARTIAL local to one shard and an
associative COMBINE over the row axis: a psum for SUM and COUNT (AVG is
psum(sum) / psum(count)), a pmin / pmax for MIN and MAX.  A grouped
aggregate after a hash exchange owns disjoint groups per shard, so its
slot tables combine by an all_gather.

The JAX functions run inside ``shard_map`` on one device's shard; these
take one tensor per shard, in shard order (a list of one for a replicated
table, whose combine is the identity), and reduce in shard order on the
first shard's device, so that two runs give the same bits.  Under a mesh
across processes (``group``) the list holds this rank's shards, and the
combine gathers every rank's partials and reduces them in global shard
order on every rank (``group.ordered_sum``): the same bits as the
single-process mesh, for any world size.  Segment sums
go through ``ops.groupby._segment_sum`` spread over lanes, deterministic
on the card.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..ops.groupby import _segment_sum
from . import group as G
from .exchange import gather_build
from .mesh import on


def _widen(data: torch.Tensor) -> torch.Tensor:
    """Accumulator dtype: f64 for floats, i64 for ints and bools."""
    if data.dtype.is_floating_point:
        return data.to(torch.float64)
    return data.to(torch.int64)


def psum(parts: Sequence[torch.Tensor], group=None) -> torch.Tensor:
    """Elementwise sum of the shards' values, in shard order."""
    if group is not None:
        return G.ordered_sum(group, parts)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + on(p, acc.device)
    return acc


def pminmax(parts: Sequence[torch.Tensor], is_min: bool,
            group=None) -> torch.Tensor:
    """Elementwise min (or max) of the shards' values."""
    dev = parts[0].device
    if group is not None:
        parts = G.gather_shards(group, parts)
    stacked = torch.stack([on(p, dev) for p in parts])
    return stacked.amin(0) if is_min else stacked.amax(0)


def global_sum(datas: Sequence[torch.Tensor], oks: Sequence[torch.Tensor],
               group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum, valid count) over every live row of every shard."""
    s = [torch.where(ok, _widen(d), torch.zeros((), dtype=_widen(d).dtype,
                                                 device=d.device)).sum()
         for d, ok in zip(datas, oks)]
    return psum(s, group), global_count(oks, group)


def global_count(oks: Sequence[torch.Tensor], group=None) -> torch.Tensor:
    return psum([ok.to(torch.int64).sum() for ok in oks], group)


def minmax_sentinel(dtype: torch.dtype, is_min: bool):
    """The identity that masks dead rows out of a min/max reduction."""
    if dtype.is_floating_point:
        return float("inf") if is_min else float("-inf")
    if dtype == torch.bool:
        return True if is_min else False
    info = torch.iinfo(dtype)
    return info.max if is_min else info.min


def _minmax_work(data: torch.Tensor, ok: torch.Tensor,
                 is_min: bool) -> torch.Tensor:
    sent = torch.full((), minmax_sentinel(data.dtype, is_min),
                      dtype=data.dtype, device=data.device)
    work = torch.where(ok, data, sent)
    return work.to(torch.int32) if work.dtype == torch.bool else work


def global_minmax(datas: Sequence[torch.Tensor],
                  oks: Sequence[torch.Tensor], is_min: bool,
                  group=None) -> torch.Tensor:
    local = [(_minmax_work(d, ok, is_min).amin() if is_min
              else _minmax_work(d, ok, is_min).amax())
             for d, ok in zip(datas, oks)]
    return pminmax(local, is_min, group)


# ---------------------------------------------------------------------------
# grouped partials: local slot tables
# ---------------------------------------------------------------------------

def local_slots(codes: torch.Tensor, cap: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A dense group slot in ``[0, cap)`` for each local row.

    ``codes``: int64 group codes, -1 for dead rows.  After the exchange
    every group lives wholly on one shard, so local slots are global ones.
    Returns ``(slot, slot_codes, overflow)``: ``slot[i]`` in ``[0, cap]``
    (``cap`` is the trash slot of dead rows and of groups past the cap),
    ``slot_codes[g]`` the group's code (-1 for an empty slot), and
    ``overflow`` set when more than ``cap`` groups appeared."""
    n = codes.shape[0]
    dev = codes.device
    big = torch.full((), 1 << 62, dtype=torch.int64, device=dev)
    skey = torch.where(codes >= 0, codes, big)
    order = torch.argsort(skey, stable=True)
    sc = skey[order]
    live = sc < big
    first = torch.cat([live[:1], (sc[1:] != sc[:-1]) & live[1:]])
    rank = torch.cumsum(first.to(torch.int64), 0) - 1
    overflow = (live & (rank >= cap)).any()
    slot_sorted = torch.where(live & (rank < cap), rank,
                              torch.full_like(rank, cap))
    slot = torch.full((n,), cap, dtype=torch.int64, device=dev)
    slot[order] = slot_sorted
    buf = torch.full((cap + 1,), -1, dtype=torch.int64, device=dev)
    buf[slot_sorted] = torch.where(live, sc, torch.full_like(sc, -1))
    return slot, buf[:cap], overflow


def slot_sum(data: torch.Tensor, ok: torch.Tensor, slot: torch.Tensor,
             cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(per-slot sum, per-slot valid count): the grouped partial of SUM,
    AVG and COUNT(col).  Dead rows go to the trash slot and fall off."""
    w = _widen(data)
    work = torch.where(ok, w, torch.zeros((), dtype=w.dtype, device=w.device))
    s = _segment_sum(work, slot, cap + 1, spread=True)[:cap]
    return s, slot_count(ok, slot, cap)


def slot_count(ok: torch.Tensor, slot: torch.Tensor, cap: int
               ) -> torch.Tensor:
    return _segment_sum(ok.to(torch.int64), slot, cap + 1,
                        spread=True)[:cap]


def slot_minmax(data: torch.Tensor, ok: torch.Tensor, slot: torch.Tensor,
                cap: int, is_min: bool) -> torch.Tensor:
    work = _minmax_work(data, ok, is_min)
    ident = minmax_sentinel(work.dtype, is_min)
    out = torch.full((cap + 1,), ident, dtype=work.dtype, device=work.device)
    out.scatter_reduce_(0, slot, work, reduce="amin" if is_min else "amax",
                        include_self=True)
    return out[:cap]


def gather_groups(parts: Sequence[torch.Tensor], group=None) -> torch.Tensor:
    """Disjoint per-shard slot tables into the global group table: a plain
    all_gather (ownership is disjoint after the exchange)."""
    return gather_build(parts, group)


def psum_table(parts: Sequence[torch.Tensor], group=None) -> torch.Tensor:
    """OVERLAPPING per-shard partials (the static-domain path, where every
    shard fills the same dense slot table) combined by a psum."""
    return psum(parts, group)
