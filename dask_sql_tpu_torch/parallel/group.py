"""The collectives of a mesh across processes, over ``torch.distributed``.

A mesh made by ``init_multihost`` with a coordinator spans ``world_size``
processes (ranks).  Each rank holds ``local_size`` shards on its own
device, so shard ``rank * local_size + i`` is this rank's ``i``-th.  The
functions here combine this rank's list of per-shard tensors with the
other ranks' through the process group: NCCL on cards, gloo on the CPU.

- ``all_to_all``: every local shard sends one bucket to every global
  shard (static shapes, as ``exchange.py`` describes), one
  ``all_to_all_single`` per exchange over all its arrays packed as bytes;
- ``all_gather`` / ``gather_shards``: every rank gets every rank's
  tensors, in rank (so global shard) order;
- ``ordered_sum``: the per-shard partials gathered, then added on every
  rank in global shard order.  No ``all_reduce`` SUM: a ring or tree
  order would change the bits of a float sum from one world size to
  another, and from the single-process mesh's;
- ``agree``: the elementwise max of a small int vector over the ranks
  (a flag vector every rank then reads alike);
- ``rendezvous``: every rank's host status (a small JSON object) through
  the group's key-value store, keyed by round.  A store key cannot pair
  with the wrong collective, so it is how the SPMD walker agrees on the
  outcome of a stage even when a rank raised part-way through it.

Each collective counts ``mesh_process_collectives`` and, with the bytes
this rank put into it, ``mesh_process_bytes``.  A collective that fails
(the group's timeout, a peer gone) marks the group broken: collectives
after it would pair with the wrong peers' calls, so every later one
raises ``CollectiveError`` at once.

A stage program captured as a CUDA graph (``physical/graphs.py``) holds
its NCCL calls inside the graph, and a replay runs no Python.  So a
capture records its collectives and their bytes per group
(``recording_collectives``) instead of counting them, and each replay
adds them once (``count_replay``): ``ProcessGroup.collectives``, which
every rank's agreed stage outcome carries, advances on a replay as on an
eager run.  A replayed NCCL kernel whose peer is gone spins for ever, and
PyTorch's watchdog does not track work launched inside a graph, so the
caller waits for a replay with ``wait_device``: at most the group's
timeout, after which the group is broken, its communicator aborted (no
kernel stays spinning on the stream) and ``CollectiveError`` raised.
"""
from __future__ import annotations

import datetime
import json
import logging
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence

import torch

from ..runtime import telemetry as _tel

logger = logging.getLogger(__name__)

#: seconds a collective or a rendezvous waits for the other ranks
DEFAULT_TIMEOUT_S = 300.0
#: seconds ``wait_device`` gives the communicator's abort before it
#: raises (the abort goes on in its thread: NCCL's can wait for a peer
#: that is gone)
ABORT_WAIT_S = 5.0


class CollectiveError(RuntimeError):
    """A collective of the mesh's process group failed, or the group broke
    earlier and can no longer pair collectives across the ranks."""


class ProcessGroup:
    """This rank's handle on the processes of a mesh: its rank, the world
    size, its device, the backend and the group's key-value store.
    ``lock`` keeps one query's collectives contiguous on this rank (a
    second thread's would interleave with them)."""

    def __init__(self, rank: int, world_size: int, device: torch.device,
                 backend: str, timeout_s: float, store):
        self.rank = rank
        self.world_size = world_size
        self.device = device
        self.backend = backend
        self.timeout_s = timeout_s
        self.store = store
        self.collectives = 0
        self.rounds = 0
        self.broken: Optional[str] = None
        self.lock = threading.RLock()

    def __repr__(self) -> str:
        return (f"ProcessGroup(rank {self.rank} of {self.world_size}, "
                f"{self.backend}, {self.device})")


def init_group(coordinator_address: str, num_processes: int,
               process_id: int, device=None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> ProcessGroup:
    """Join (or reuse) the default process group: ``init_method`` is
    ``tcp://<coordinator_address>`` ("host:port"), NCCL on a card and gloo
    on the CPU.  On a card rank ``r`` takes ``cuda:{r % device_count}``
    unless ``device`` names one.  Nothing falls back: a rank whose card or
    NCCL group cannot be set up raises."""
    import torch.distributed as dist

    if num_processes is None or process_id is None:
        raise ValueError("init_multihost: a coordinator needs num_processes "
                         "and process_id")
    world, rank = int(num_processes), int(process_id)
    if not 0 <= rank < world:
        raise ValueError(f"init_multihost: process_id {rank} outside a "
                         f"world of {world}")
    kind = torch.device("cuda" if device is None else device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_multihost: CUDA is not available; pass "
                               "device='cpu' for a gloo group on the CPU")
        dev = (torch.device("cuda", rank % torch.cuda.device_count())
               if device is None or torch.device(device).index is None
               else torch.device(device))
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif kind == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
    else:
        raise ValueError(f"init_multihost: no process group for {kind}")
    if dist.is_initialized():
        # as the JAX function reuses an initialized runtime
        if (dist.get_world_size(), dist.get_rank()) != (world, rank):
            raise RuntimeError(
                f"init_multihost: a process group of world "
                f"{dist.get_world_size()} rank {dist.get_rank()} is already "
                f"set up, not world {world} rank {rank}")
        if dist.get_backend() != backend:
            raise RuntimeError(f"init_multihost: the process group runs "
                               f"{dist.get_backend()}, not {backend}")
    else:
        kwargs = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    store = dist.PrefixStore("dsql_mesh/",
                             dist.distributed_c10d._get_default_store())
    return ProcessGroup(rank, world, dev, backend, timeout_s, store)


def close(group: ProcessGroup) -> None:
    """Leave the mesh: every rank calls this last.  Rank 0's process
    serves the group's store, so it waits (within the timeout) until every
    other rank has made its last store call, then the default group is
    destroyed (a broken group is left to the process's exit: its
    collectives no longer pair)."""
    import torch.distributed as dist

    done = [f"done/{k}" for k in range(1, group.world_size)]
    if group.rank:
        group.store.set(done[group.rank - 1], "1")
    elif done:
        try:
            group.store.wait(done,
                             datetime.timedelta(seconds=group.timeout_s))
        except Exception:  # the store's timeout: a rank is gone already
            pass
    if group.broken is None and dist.is_initialized():
        dist.destroy_process_group()
    group.broken = group.broken or "closed"


# ---------------------------------------------------------------------------
# bytes: every collective moves uint8 (NCCL and gloo take no bool), each
# array padded to 8 bytes so that a slice views back as any dtype
# ---------------------------------------------------------------------------

def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    b = t.contiguous().reshape(-1).view(torch.uint8)
    pad = (-b.numel()) % 8
    return torch.cat([b, b.new_zeros(pad)]) if pad else b


def _refuse_broken(group: ProcessGroup) -> None:
    if group.broken is not None:
        raise CollectiveError(f"rank {group.rank}: the mesh's process group "
                              f"broke earlier ({group.broken}); set it up "
                              f"again with init_multihost")


# a capture on this thread records its collectives here: {id(group):
# [group, collectives, bytes]}
_record_tls = threading.local()


@contextmanager
def recording_collectives():
    """Collectives issued on this thread in the block are recorded in the
    yielded dict (per group: ``[group, collectives, bytes]``) instead of
    counted: a capture records them into a graph, which runs them once per
    replay (``count_replay``).  A call that fails while recording fails
    the capture only: nothing was sent, so the group stays whole."""
    prev = getattr(_record_tls, "tally", None)
    tally: Dict[int, list] = {}
    _record_tls.tally = tally
    try:
        yield tally
    finally:
        _record_tls.tally = prev


def count_replay(tally: Sequence[list]) -> None:
    """A replay of a graph whose capture recorded ``tally`` (the values of
    ``recording_collectives``' dict): each group's collectives and bytes
    counted once, as an eager run counts them.  Raises ``CollectiveError``
    (and counts nothing) if one of the groups broke."""
    for group, _, _ in tally:
        _refuse_broken(group)
    for group, n, nbytes in tally:
        group.collectives += n
        _tel.inc("mesh_process_collectives", n)
        _tel.inc("mesh_process_bytes", nbytes)


def _collective(group: ProcessGroup, nbytes: int, fn):
    _refuse_broken(group)
    tally = getattr(_record_tls, "tally", None)
    if tally is not None:
        rec = tally.setdefault(id(group), [group, 0, 0])
        rec[1] += 1
        rec[2] += nbytes
        return fn()
    group.collectives += 1
    _tel.inc("mesh_process_collectives")
    _tel.inc("mesh_process_bytes", nbytes)
    try:
        return fn()
    except Exception as e:
        group.broken = f"{type(e).__name__}: {str(e)[:200]}"
        raise CollectiveError(f"rank {group.rank}: collective "
                              f"#{group.collectives} failed: "
                              f"{group.broken}") from e


def wait_device(group: ProcessGroup, what: str = "a graph replay") -> None:
    """Wait for the work queued on the current stream of the group's card
    (``what``: a replay whose collectives the watchdog does not track), at
    most the group's timeout, polling an event recorded after it.  Past
    the timeout the group is broken, its communicator's abort started on a
    thread of its own (a replayed NCCL kernel whose peer is gone would
    spin on the stream for ever) and given ``ABORT_WAIT_S``, and
    ``CollectiveError`` raised.  On the CPU the work has ended already."""
    if group.device.type != "cuda":
        return
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(group.device))
    deadline = time.monotonic() + group.timeout_s
    pause = 2e-5
    while not done.query():
        if time.monotonic() > deadline:
            group.broken = (f"{what} did not end within "
                            f"{group.timeout_s:g} s")
            aborting = threading.Thread(target=_abort, args=(group,),
                                        name="dsql-abort", daemon=True)
            aborting.start()
            aborting.join(ABORT_WAIT_S)
            raise CollectiveError(
                f"rank {group.rank}: {group.broken}; the communicator's "
                f"abort " + ("is still running" if aborting.is_alive()
                             else "ended"))
        time.sleep(pause)
        pause = min(2 * pause, 1e-3)


def _abort(group: ProcessGroup) -> None:
    """Abort the default group's communicator (best-effort: the group is
    broken either way and never used again)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return
    c10d = dist.distributed_c10d
    pg = c10d._get_default_group()
    tries = []
    if hasattr(c10d, "_abort_process_group"):
        tries.append(lambda: c10d._abort_process_group(pg))
    tries.append(lambda: pg._get_backend(group.device).abort())
    tries.append(lambda: pg.abort())
    for attempt in tries:
        try:
            attempt()
            return
        except Exception as e:  # the next way, on an older torch
            logger.debug("communicator abort failed (%s: %s)",
                         type(e).__name__, str(e)[:160])
    logger.warning("rank %d: the communicator could not be aborted",
                   group.rank)


def _gather_rows(group: ProcessGroup, b: torch.Tensor) -> torch.Tensor:
    """[world, len(b)]: every rank's ``b`` in rank order."""
    import torch.distributed as dist

    w = group.world_size
    if group.backend == "nccl":
        out = b.new_empty(w * b.numel())
        gather = (getattr(dist, "all_gather_single", None)
                  or dist.all_gather_into_tensor)
        gather(out, b)
        return out.view(w, -1)
    outs = [torch.empty_like(b) for _ in range(w)]
    dist.all_gather(outs, b)
    return torch.stack(outs)


def all_gather(group: ProcessGroup, t: torch.Tensor) -> torch.Tensor:
    """``[world, *t.shape]``: every rank's ``t`` (same shape and dtype on
    every rank), in rank order."""
    b = _as_bytes(t)
    rows = _collective(group, b.numel(), lambda: _gather_rows(group, b))
    return rows.view(t.dtype)[:, :t.numel()].reshape(
        (group.world_size,) + tuple(t.shape))


def gather_shards(group: ProcessGroup, parts: Sequence[torch.Tensor]
                  ) -> List[torch.Tensor]:
    """Every global shard's tensor, in shard order, from this rank's
    ``parts`` (one per local shard, all of one shape)."""
    g = all_gather(group, torch.stack(list(parts)))
    return list(g.reshape((-1,) + tuple(parts[0].shape)).unbind(0))


def ordered_sum(group: ProcessGroup, parts: Sequence[torch.Tensor]
                ) -> torch.Tensor:
    """The sum of every global shard's partial, added in shard order on
    every rank (the single-process mesh's order, so the same bits)."""
    every = gather_shards(group, parts)
    acc = every[0]
    for p in every[1:]:
        acc = acc + p
    return acc


def agree(group: ProcessGroup, values: torch.Tensor) -> torch.Tensor:
    """The elementwise max of ``values`` (a small int vector) over the
    ranks: every rank reads the same combined vector."""
    return all_gather(group, values).amax(0)


def all_to_all(group: ProcessGroup,
               arrays: Sequence[Sequence[torch.Tensor]]
               ) -> List[List[torch.Tensor]]:
    """``arrays[j][s]``: local shard ``s``'s send buffer of array ``j``,
    ``[n_global, m_j]``, row ``d`` bound for global shard ``d``.  Returns
    ``out[j][d]``: what local shard ``d`` receives of array ``j``,
    ``[n_global * m_j]``, in global source order.  One
    ``all_to_all_single`` carries every array."""
    import torch.distributed as dist

    w, loc = group.world_size, len(arrays[0])
    blocks, metas = [], []
    for bufs in arrays:
        m = int(bufs[0].shape[1])
        # [src local, dst rank, dst local, m] -> one block per dst rank
        x = torch.stack(list(bufs)).reshape(loc, w, loc, m)
        x = x.permute(1, 0, 2, 3).contiguous().reshape(w, -1)
        b = x.view(torch.uint8)
        pad = (-b.shape[1]) % 8
        if pad:
            b = torch.cat([b, b.new_zeros(w, pad)], 1)
        blocks.append(b)
        metas.append((bufs[0].dtype, m, b.shape[1]))
    send = torch.cat(blocks, 1).contiguous()
    recv = torch.empty_like(send)
    _collective(group, send.numel(),
                lambda: dist.all_to_all_single(recv, send))
    out, off = [], 0
    for dtype, m, nb in metas:
        n = loc * loc * m
        x = recv[:, off:off + nb].contiguous().view(dtype)[:, :n]
        # [src rank, src local, dst local, m]
        x = x.reshape(w, loc, loc, m)
        out.append([x[:, :, d, :].reshape(-1) for d in range(loc)])
        off += nb
    return out


def rendezvous(group: ProcessGroup, payload: dict,
               wait_s: Optional[float] = None) -> List[Optional[dict]]:
    """Every rank's ``payload`` (JSON), in rank order, through the store.
    A rank that does not arrive within ``wait_s`` (the group's timeout by
    default) reads as None.  Every rank calls this as often as the
    others: each call is a round with keys of its own."""
    group.rounds += 1
    r = group.rounds
    keys = [f"rv/{r}/{k}" for k in range(group.world_size)]
    group.store.set(keys[group.rank], json.dumps(payload))
    wait = group.timeout_s if wait_s is None else min(wait_s,
                                                      group.timeout_s)
    try:
        group.store.wait(keys, datetime.timedelta(seconds=wait))
    except Exception:  # the store's timeout: read who arrived
        pass
    out: List[Optional[dict]] = []
    for k in keys:
        out.append(json.loads(group.store.get(k))
                   if group.store.check([k]) else None)
    if r > 2:
        # every rank has read round r - 2 once it wrote round r - 1
        group.store.delete_key(f"rv/{r - 2}/{group.rank}")
    return out

