"""The device mesh: an ordered tuple of devices on one row axis.

The counterpart of ``dask_sql_tpu/parallel/mesh.py``.  The JAX package
keeps a sharded column as one global ``jax.Array`` with a
``NamedSharding`` and lets ``shard_map`` hand each device its shard.
PyTorch has neither, so the port keeps a single controller and makes
every placement explicit:

- a ``Mesh`` is an ordered tuple of ``torch.device``s on the axis
  ``ROW_AXIS`` ("data"); shard ``i`` of a row-sharded tensor is rows
  ``[i * local, (i + 1) * local)``;
- a mesh may repeat one device: ``Mesh(["cuda:0"] * 4)`` is four shards
  on one card, the counterpart of the JAX tests' virtual CPU devices
  (``Mesh(["cpu"] * 8)`` on the CPU);
- the catalog holds a table's global padded columns and its ``row_valid``
  on ``devices[0]`` (the context's device), where the single-device tiers
  read them.  ``Mesh.split`` gives the shards: ``narrow`` views where the
  shard's device is ``devices[0]`` (a repeated-device mesh copies
  nothing), and on a mesh of distinct cards a copy on the shard's own
  card, made once per tensor (so once per catalog epoch) and counted
  (``mesh_placements``, ``mesh_placement_bytes``).

A mesh across processes (``init_multihost`` with a coordinator) spans
``world_size`` ranks, one process each, and carries their
``group.ProcessGroup``.  Its ``devices`` are this rank's shards, one
device repeated ``local_size`` times (``devices[0]`` is the rank's
context device); ``size`` is the global shard count, ``world_size *
local_size``, and this rank's shards are the global ones ``rank *
local_size`` to ``rank * local_size + local_size - 1``.  Every rank runs
the same program over the same registered data, and the catalog
holds the whole padded table on each rank's device: ``split`` picks this
rank's shards out of it.
"""
from __future__ import annotations

import threading
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..runtime import telemetry as _tel

ROW_AXIS = "data"


class Mesh:
    """A 1-D row mesh over ``devices`` (in shard order)."""

    axis_names: Tuple[str, ...] = (ROW_AXIS,)

    def __init__(self, devices: Sequence, group=None):
        """``group``: the ``group.ProcessGroup`` of a mesh across
        processes (``devices`` are then this rank's shards, all on its
        device), None for a mesh of this process's devices."""
        if not devices:
            raise ValueError("a mesh needs at least one device")
        # "cuda" and "cuda:0" name one card: placements compare indices
        self.devices: Tuple[torch.device, ...] = tuple(
            torch.device("cuda", torch.cuda.current_device())
            if torch.device(d) == torch.device("cuda") else torch.device(d)
            for d in devices)
        if group is not None and set(self.devices) != {group.device}:
            raise ValueError(f"a mesh across processes holds its rank's "
                             f"shards on {group.device}, not {self.devices}")
        self.group = group
        self._lock = threading.Lock()
        self._placed: Dict[int, tuple] = {}

    @property
    def local_size(self) -> int:
        """This rank's shards (every shard of a single-process mesh)."""
        return len(self.devices)

    @property
    def world_size(self) -> int:
        return 1 if self.group is None else self.group.world_size

    @property
    def rank(self) -> int:
        return 0 if self.group is None else self.group.rank

    @property
    def size(self) -> int:
        """The global shard count."""
        return self.local_size * self.world_size

    @property
    def spans_processes(self) -> bool:
        """The collectives go through a process group (even of one rank)."""
        return self.group is not None

    @property
    def virtual(self) -> bool:
        """Every shard on one device (no transfer between shards)."""
        return not self.spans_processes and len(set(self.devices)) == 1

    def distinct_devices(self) -> List[torch.device]:
        return list(dict.fromkeys(self.devices))

    def signature(self) -> str:
        """The layout a program is built for: axis, size and placement
        (and across processes the world size and this rank)."""
        sig = f"{ROW_AXIS}:{self.size}@" + ",".join(str(d)
                                                     for d in self.devices)
        if self.group is not None:
            sig += f"/world{self.world_size}:rank{self.rank}"
        return sig

    def __repr__(self) -> str:
        return f"Mesh({self.signature()})"

    def split(self, t: torch.Tensor) -> List[torch.Tensor]:
        """This process's row shards of the global ``t`` (whose length
        divides by the size), each on its shard's device."""
        local = int(t.shape[0]) // self.size
        first = self.rank * self.local_size
        parts = [t.narrow(0, (first + i) * local, local)
                 for i in range(self.local_size)]
        if all(d == t.device for d in self.devices):
            return parts
        key = id(t)
        with self._lock:
            hit = self._placed.get(key)
            if hit is not None and hit[0]() is t:
                return list(hit[1])
        placed = [on(p, d)
                  for p, d in zip(parts, self.devices)]
        moved = sum(p.numel() * p.element_size()
                    for p, d in zip(parts, self.devices) if d != t.device)
        _tel.inc("mesh_placements")
        _tel.inc("mesh_placement_bytes", moved)
        with self._lock:
            self._placed[key] = (
                weakref.ref(t, lambda _r, k=key: self._placed.pop(k, None)),
                tuple(placed))
        return placed

    def split_local(self, t: torch.Tensor) -> List[torch.Tensor]:
        """The row shards of ``t`` that holds this process's rows only (a
        stage output of a mesh across processes), one per local shard."""
        if self.group is None:
            return self.split(t)
        local = int(t.shape[0]) // self.local_size
        return [on(t.narrow(0, i * local, local), d)
                for i, d in enumerate(self.devices)]


def on(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` on ``device``: itself when it is there already (a move to the
    same device would read as a host transfer to a graph's trace)."""
    return t if t.device == device else t.to(device)


def default_mesh(n_devices: Optional[int] = None,
                 device: Optional[str] = None) -> Mesh:
    """The row mesh over the first ``n_devices`` visible cards (all by
    default).  Raises where there is no card, unless the caller asks for
    the CPU (``device="cpu"``: a mesh of one CPU shard)."""
    kind = torch.device("cuda" if device is None else device).type
    if kind == "cpu":
        devices = [torch.device("cpu")]
    elif not torch.cuda.is_available():
        raise RuntimeError("default_mesh: CUDA is not available; pass "
                           "device='cpu' to build a CPU mesh")
    else:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(devices)


def pad_to_multiple(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k


def _padded(t: torch.Tensor, pad: int, device) -> torch.Tensor:
    t = on(t, device)
    if not pad:
        return t
    return torch.cat([t, torch.zeros(pad, dtype=t.dtype, device=device)])


def shard_table_with_validity(table, mesh: Mesh):
    """The catalog's placement under a mesh: rows padded to a multiple of
    the mesh size on ``devices[0]``, column NULL masks untouched (padding
    is a table property: COUNT(*) must not see pad rows), and a
    ``row_valid`` marking the real rows, None when nothing was padded."""
    from ..table import Column, Table

    n = table.num_rows
    k = mesh.size
    padded = pad_to_multiple(max(n, 1), k)
    pad = padded - n
    dev = mesh.devices[0]
    cols = [Column(_padded(c.data, pad, dev), c.stype,
                   None if c.mask is None else _padded(c.mask, pad, dev),
                   c.dictionary)
            for c in table.columns]
    row_valid = (torch.arange(padded, device=dev) < n) if pad else None
    return Table(list(table.names), cols), row_valid


def shard_table(table, mesh: Mesh):
    """Every column padded to a multiple of the mesh size: (padded table,
    valid row count).  Padding rows are masked invalid, so kernels that
    respect masks ignore them; count-style kernels slice to the count."""
    from ..table import Column, Table

    n = table.num_rows
    k = mesh.size
    padded = pad_to_multiple(max(n, 1), k)
    pad = padded - n
    dev = mesh.devices[0]
    cols = []
    for c in table.columns:
        mask = c.valid_mask() if (c.mask is not None or pad) else None
        cols.append(Column(_padded(c.data, pad, dev), c.stype,
                           None if mask is None else _padded(mask, pad, dev),
                           c.dictionary))
    return Table(list(table.names), cols), n


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   device: Optional[str] = None, local_shards: int = 1,
                   timeout_s: Optional[float] = None) -> Mesh:
    """The row mesh.  Without a coordinator, this host's
    (``default_mesh(device=device)``).  With one ("host:port"), a mesh
    across ``num_processes`` processes, this one rank ``process_id``:
    every process calls this with the same address and world size, then
    runs the same program over the same data, and every rank gets
    every answer (as the JAX package's ``jax.distributed`` contract).
    The group is NCCL on a card (rank ``r`` on ``cuda:{r % cards}``
    unless ``device`` names one) and gloo on the CPU (``device="cpu"``);
    a group already set up is reused.  The rank holds ``local_shards``
    shards on its device, so the mesh has ``num_processes *
    local_shards``.  ``timeout_s`` (``group.DEFAULT_TIMEOUT_S``) bounds
    every collective's and every stage agreement's wait."""
    if coordinator_address is None:
        return default_mesh(device=device)
    from .group import DEFAULT_TIMEOUT_S, init_group

    group = init_group(coordinator_address, num_processes, process_id,
                       device=device,
                       timeout_s=(DEFAULT_TIMEOUT_S if timeout_s is None
                                  else float(timeout_s)))
    return Mesh([group.device] * int(local_shards), group=group)
