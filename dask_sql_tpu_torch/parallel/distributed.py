"""Standalone collective functions over a row mesh.

The counterpart of ``dask_sql_tpu/parallel/distributed.py``, whose
functions each wrap one ``shard_map`` program.  Here each takes global
row-sharded tensors (length a multiple of the mesh size, on
``mesh.devices[0]``), splits them into the mesh's shards
(``Mesh.split``), runs the local step per shard and the collective over
the list, and returns global tensors on ``devices[0]``:

- ``dist_segment_sum`` / ``dist_segment_minmax``: local segment
  reductions combined by psum / pmin / pmax (a bounded key domain);
- ``hash_exchange``: the all_to_all shuffle of ``exchange.exchange``;
- ``dist_groupby_sum_exchange``: exchange, local reduce, psum of the
  disjoint partials;
- ``dist_join_broadcast``: all_gather of the build side, local sorted
  probe;
- ``ring_shift``: ppermute to the next shard on the ring;
- ``dist_prefix_sum``: local cumsum plus the all_gathered shard totals
  (integers accumulate in int64, as numpy and the JAX package do).

The SPMD executor (``parallel/spmd.py``) uses the per-shard halves in
``exchange.py`` and ``partial_agg.py`` instead.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from ..ops.groupby import _segment_sum
from . import exchange as X
from . import partial_agg as PA
from .mesh import Mesh, on


def _global(parts: List[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    dev = mesh.devices[0]
    return torch.cat([on(p, dev) for p in parts])


def dist_segment_sum(mesh: Mesh, values: torch.Tensor, codes: torch.Tensor,
                     num_groups: int) -> torch.Tensor:
    """Per-group sums over a row-sharded array: local partials + psum.
    The result is replicated (one tensor on ``devices[0]``)."""
    local = [_segment_sum(v, c.to(torch.int64), num_groups, spread=True)
             for v, c in zip(mesh.split(values), mesh.split(codes))]
    return PA.psum(local)


def dist_segment_minmax(mesh: Mesh, values: torch.Tensor,
                        codes: torch.Tensor, num_groups: int, is_min: bool,
                        sentinel) -> torch.Tensor:
    """Per-group MIN (or MAX): local segment reductions (empty groups and
    non-finite results become ``sentinel``) combined by pmin / pmax."""
    local = []
    for v, c in zip(mesh.split(values), mesh.split(codes)):
        ident = PA.minmax_sentinel(v.dtype, is_min)
        out = torch.full((num_groups,), ident, dtype=v.dtype,
                         device=v.device)
        out.scatter_reduce_(0, c.to(torch.int64), v,
                            reduce="amin" if is_min else "amax",
                            include_self=True)
        sent = torch.full((), sentinel, dtype=v.dtype, device=v.device)
        keep = (torch.isfinite(out) if v.dtype.is_floating_point
                else torch.ones_like(out, dtype=torch.bool))
        local.append(torch.where(keep | (out == sent), out, sent))
    return PA.pminmax(local, is_min)


def hash_exchange(mesh: Mesh, codes: torch.Tensor, *payload: torch.Tensor
                  ) -> Tuple[torch.Tensor, ...]:
    """Rows radix-partitioned by ``code % n_dev`` and exchanged so that
    equal codes land on one shard; each shard holds ``n_dev * local``
    slots (code -1 and payload 0 where unused).  Returns the global
    (new_codes, *new_payload)."""
    c_parts = mesh.split(codes)
    p_parts = [mesh.split(p) for p in payload]
    per_shard = [[p[s] for p in p_parts] for s in range(mesh.size)]
    c_out, p_out = X.exchange(c_parts, per_shard, mesh.devices)
    return (_global(c_out, mesh),
            *[_global([p_out[s][j] for s in range(mesh.size)], mesh)
              for j in range(len(payload))])


def dist_groupby_sum_exchange(mesh: Mesh, codes: torch.Tensor,
                              values: torch.Tensor, num_groups: int
                              ) -> torch.Tensor:
    """A large-domain GROUP BY: hash exchange so that each shard owns its
    keys, local reduce, psum of the disjoint partials (replicated)."""
    new_codes, new_vals = hash_exchange(mesh, codes, values)
    local = []
    for c, v in zip(mesh.split(new_codes), mesh.split(new_vals)):
        valid = c >= 0
        local.append(_segment_sum(
            torch.where(valid, v, torch.zeros_like(v)),
            torch.where(valid, c, torch.zeros_like(c)), num_groups,
            spread=True))
    return PA.psum(local)


def dist_join_broadcast(mesh: Mesh, probe_codes: torch.Tensor,
                        build_codes: torch.Tensor,
                        build_values: torch.Tensor, default) -> torch.Tensor:
    """The broadcast join of 1:1 build keys: all_gather the build side,
    probe each shard locally; each probe row gets its build value or
    ``default``."""
    bc_all = X.gather_build(mesh.split(build_codes))
    bv_all = X.gather_build(mesh.split(build_values))
    order = torch.argsort(bc_all, stable=True)
    sc, sv = bc_all[order], bv_all[order]
    out = []
    for pc in mesh.split(probe_codes):
        s, v = on(sc, pc.device), on(sv, pc.device)
        pos = torch.clamp(torch.searchsorted(s, pc), 0, s.shape[0] - 1)
        hit = (s[pos] == pc) & (pc >= 0)
        out.append(torch.where(hit, v[pos], torch.full((), default,
                                                       dtype=v.dtype,
                                                       device=v.device)))
    return _global(out, mesh)


def ring_shift(mesh: Mesh, x: torch.Tensor, shift: int = 1) -> torch.Tensor:
    """ppermute on the ring: shard ``i`` receives shard ``i - shift``."""
    parts = mesh.split(x)
    n = mesh.size
    return _global([on(parts[(i - shift) % n], mesh.devices[i])
                    for i in range(n)], mesh)


def dist_prefix_sum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over a row-sharded array: local cumsum plus
    the exclusive scan of the all_gathered shard totals."""
    local = [torch.cumsum(v, 0) for v in mesh.split(x)]
    totals = [c[-1] if c.shape[0] else torch.zeros((), dtype=c.dtype,
                                                   device=c.device)
              for c in local]
    out = []
    for i, c in enumerate(local):
        offset = PA.psum(totals[:i]) if i else torch.zeros(
            (), dtype=c.dtype, device=c.device)
        out.append(c + on(offset, c.device))
    return _global(out, mesh)
