"""Hash-partition exchange and broadcast primitives of the SPMD stages.

The counterpart of ``dask_sql_tpu/parallel/exchange.py``.  There each
function runs inside a ``shard_map`` body on one device's local shard and
calls a ``jax.lax`` collective.  Here the stage walker
(``parallel/spmd.py``) holds one local tensor per shard, in shard order,
and each collective is a plain function that combines those lists:

- ``all_to_all`` (``exchange``): each shard buckets its rows by
  destination, then the list of buckets is transposed and each
  destination's rows are concatenated in source order on its device;
- ``all_gather`` (``gather_build``): the shards concatenated in order;
- ``pmax`` of a flag (``replicated_flag``): ``any`` over the shards.

Shapes stay static, as in JAX: ``exchange`` sends a full local-length
bucket to every destination, so every shard receives ``n_dev * local``
rows, and the byte counters count what the JAX ones count from the same
local shapes.

Conventions shared with the walker: partition codes are int64 with -1 for
a dead slot; broadcast-side keys carry ``BROADCAST_SENTINEL`` for dead
rows; flags are 0-d bool tensors read on the host after the stage ran.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from .mesh import on

#: Dead-slot key of the broadcast join: above every key the engine makes,
#: so it sorts after every live key and never equals a live probe key (a
#: live key equal to it raises the ``join_key_sentinel`` flag).
BROADCAST_SENTINEL = (1 << 62)


def replicated_flag(flags: Sequence[torch.Tensor]) -> torch.Tensor:
    """The shards' local bool observations combined into one (any)."""
    dev = flags[0].device
    return torch.stack([on(f.reshape(()), dev) for f in flags]).any()


def shard_replicated(r: torch.Tensor, n_dev: int
                     ) -> Tuple[List[torch.Tensor], int]:
    """A replicated value as row shards: padded to ``ceil(k/n) * n`` rows
    and sliced per shard (JAX emits it so through the stage's uniform
    row-sharded out-spec).  Returns (the shards, the padded length)."""
    k = int(r.shape[0])
    per = max(1, -(-k // n_dev))
    kp = per * n_dev
    if kp != k:
        r = torch.cat([r, torch.zeros((kp - k,) + tuple(r.shape[1:]),
                                      dtype=r.dtype, device=r.device)])
    return [r[i * per:(i + 1) * per] for i in range(n_dev)], kp


def _buckets(codes: torch.Tensor, payloads: Sequence[torch.Tensor],
             n_dev: int) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """One shard's send buffers: ``[n_dev, local]`` per array, row ``d``
    holding the rows bound for shard ``d`` in their local order (code -1
    and 0 fill the rest)."""
    local = codes.shape[0]
    dev = codes.device
    dest = torch.where(codes >= 0, codes % n_dev, torch.zeros_like(codes))
    order = torch.argsort(dest, stable=True)
    sorted_dest = dest[order]
    start = torch.searchsorted(sorted_dest,
                               torch.arange(n_dev, device=dev,
                                            dtype=sorted_dest.dtype))
    pos = torch.arange(local, device=dev) - start[sorted_dest]

    def scatter(x: torch.Tensor, fill) -> torch.Tensor:
        buf = torch.full((n_dev, local), fill, dtype=x.dtype, device=dev)
        buf[sorted_dest, pos] = x[order]
        return buf

    return scatter(codes, -1), [scatter(v, 0) for v in payloads]


def _all_to_all(bufs: Sequence[torch.Tensor], devices) -> List[torch.Tensor]:
    """Destination ``d`` receives row ``d`` of every source's buffer,
    concatenated in source order, on its own device."""
    return [torch.cat([on(b[d], dev) for b in bufs])
            for d, dev in enumerate(devices)]


def exchange(codes: Sequence[torch.Tensor],
             payloads: Sequence[Sequence[torch.Tensor]], devices
             ) -> Tuple[List[torch.Tensor], List[List[torch.Tensor]]]:
    """Radix-partition every shard's rows by ``code % n_dev`` and
    all_to_all them: equal codes land on one shard, no row is dropped.
    ``codes[s]`` and ``payloads[s]`` are shard ``s``'s; the result has
    ``n_dev * local`` rows per shard, payloads 0-filled where the code
    is -1."""
    n_dev = len(devices)
    sent = [_buckets(c, p, n_dev) for c, p in zip(codes, payloads)]
    codes_out = _all_to_all([s[0] for s in sent], devices)
    n_pay = len(payloads[0]) if payloads else 0
    cols = [_all_to_all([s[1][j] for s in sent], devices)
            for j in range(n_pay)]
    return codes_out, [[col[d] for col in cols] for d in range(n_dev)]


def exchange_bytes(codes: torch.Tensor, payloads: Sequence[torch.Tensor],
                   n_dev: int) -> int:
    """Bytes one ``exchange`` moves across the mesh, from one shard's
    local shapes (send-buffer volume)."""
    return sum(int(a.numel()) * a.element_size() * n_dev * n_dev
               for a in (codes, *payloads))


def gather_bytes(arrs: Sequence[torch.Tensor], n_dev: int) -> int:
    """Bytes an all_gather of ``arrs`` (one shard's local arrays) moves:
    every shard receives every other shard's."""
    return sum(int(a.numel()) * a.element_size() * n_dev * n_dev
               for a in arrs)


def psum_bytes(arrs: Sequence[torch.Tensor], n_dev: int) -> int:
    """Bytes a psum of ``arrs`` reduces across the mesh (buffer x n_dev,
    the JAX package's upper-bound volume)."""
    return sum(int(a.numel()) * a.element_size() * n_dev for a in arrs)


def gather_build(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """all_gather of a (small) build side: the shards concatenated in
    order on the first shard's device."""
    dev = parts[0].device
    return torch.cat([on(p, dev) for p in parts])


def sorted_probe(build_keys: torch.Tensor, probe_keys: torch.Tensor,
                 sentinel: int = BROADCAST_SENTINEL
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Probe ``probe_keys`` against ``build_keys`` by sort + searchsorted.

    Dead rows on either side carry ``sentinel``.  Returns ``(idx, hit,
    dup)``: ``idx[i]`` indexes build-row order for probe row i (valid
    where ``hit``); ``dup`` is set when two live build keys are equal,
    where the single-match form is wrong and the caller raises its flag."""
    order = torch.argsort(build_keys, stable=True)
    sk = build_keys[order]
    hi = max(int(sk.shape[0]) - 1, 0)
    pos = torch.clamp(torch.searchsorted(sk, probe_keys), 0, hi)
    hit = (sk[pos] == probe_keys) & (probe_keys != sentinel)
    if sk.shape[0] > 1:
        dup = ((sk[1:] == sk[:-1]) & (sk[1:] != sentinel)).any()
    else:
        dup = torch.zeros((), dtype=torch.bool, device=sk.device)
    return order[pos], hit, dup
