"""The compiled tier's programs as CUDA graphs.

``jax.jit`` traces a program once and dispatches it as one executable;
on the card the counterpart is one ``torch.cuda.CUDAGraph`` replay.
``GraphProgram`` wraps a traced function ``fn(*flat) -> tuple of
tensors``:

- The first call on a set of input tensors runs ``fn`` eagerly (the
  warm-up; its outputs answer that call), then captures it.  Every later
  call on the same input tensors is one ``replay()``.  The graph bakes in
  the input pointers, so a capture keeps its input tensors alive and is
  keyed by them: reloaded data with the same layout reuses the program
  (the cache key in ``compiled.py``) and takes one more capture.  At most
  ``CAPTURES_PER_PROGRAM`` captures per program and graph memory pools of
  a quarter of the card in all stay alive, least recently used first out.
- Inputs that change on every call (``copied``: the hoisted parameters,
  a stage graph's boundary tables) do not key a capture.  Each capture
  owns a buffer for each of them; a call copies the new values in
  (``copy_``, non-blocking: from pinned host memory for a parameter, on
  the card for a boundary table) and replays.  A new literal or a new
  stage output is one replay, not a capture.
- Outputs of a replay live in the graph's memory pool and are overwritten
  by the next replay: the caller copies them out before it calls again.
- On the CPU nothing is captured: ``fn`` runs eagerly on every call, the
  first under the same trace checks as a warm-up.

The warm-up and the capture run under ``_TraceMode``, a
``TorchFunctionMode`` (the mode stack is per thread, so one thread's
trace never sees another's ops) that

- follows the input tensors' data through every op, and raises
  ``HostRead`` where the trace reads such data on the host (``item``,
  ``tolist``, ``bool()``, ``int()``, ``.cpu()``) or runs an op whose output
  size depends on it (``nonzero``, ``unique``, boolean-mask indexing, ...):
  a graph cannot hold it, so the plan is outside the compilable subset, on
  the CPU as on the card;
- records every host-to-device copy of the warm-up (the program's
  constants: dictionary-derived lookup tables, literals) by content, and
  during the capture hands back the recorded tensor in place of the copy,
  which a capture cannot hold;
- during the capture, keeps a reference to every card tensor an op reads
  that the capture did not make, so that no cached tensor the graph reads
  (kernel 1's layout tables, string byte matrices) is freed while the
  graph lives.

Threads: stage workers and background compiles warm up and capture while
other threads run queries.  Nothing here is process-wide for the length
of a warm-up or a capture:

- a warm-up's host synchronisations are caught per thread (``_SyncWatch``:
  ``torch.cuda.set_sync_debug_mode("warn")`` while any warm-up runs, and a
  warning hook that keeps the warming threads' warnings and drops the
  others'), reported as ``HostRead`` before the capture; another thread's
  ``.item()`` meanwhile neither raises nor counts;
- each capture has its own stream and ``capture_error_mode=
  "thread_local"`` (an unsafe call on another thread does not break it),
  and is begun without ``torch.cuda.graph``'s device-wide synchronize; the
  allocator's free blocks are released before it only while no other
  capture runs (the allocator must not release blocks during one);
- a device-wide ``torch.cuda.synchronize()`` on another thread still
  invalidates a capture; a background build (``capture_retry_scope``,
  armed by tiering's build thread and the stage workers it starts)
  captures once more on its own thread, counted
  ``background_capture_retries``, and only a second failure fails it;
- kernel launches recorded into a graph go to the capture's own record
  (``gpu_kernels.recording_launches``) and are added to
  ``gpu_kernels.LAUNCHES`` once per replay; other threads' launches count
  as usual.

Collectives of a mesh across processes (``parallel/group.py``): a
capture records the process group's ``all_gather_into_tensor`` /
``all_to_all_single`` calls into the graph, after a warm-up that ran them
for real (which sets up NCCL's connections lazily, as a capture cannot).
The capture records them instead of counting them
(``group.recording_collectives``), and each replay adds its collectives
and bytes to the group and to ``mesh_process_collectives`` /
``mesh_process_bytes`` once (``group.count_replay``), as if they had run
on the host.  A program made with the ``group`` whose collectives it
holds waits for its warm-up's work within the group's timeout before it
captures (``group.wait_device``: a warm-up whose peer is gone would
otherwise block the capture's device synchronisation for ever), and
holds its first capture (on the CPU, the check that ends its first
call) until the caller has agreed it with the other ranks:
``capture_outcome`` says whether this rank's succeeded, ``confirm(keep)``
keeps it or drops it, so that every rank keeps its graph or every rank
drops it; a failed capture is then reported instead of raised.  On the
CPU the step that would capture is ``_capture``, which captures nothing
there.

A program over several cards (``devices``: an SPMD stage of a mesh of
distinct cards in one process) is one CUDA graph that holds every card's
nodes (``_capture``): the other cards' side streams join the capture
through events and their allocations go to private pools, so a copy
between cards is an edge of the graph.  A replay waits for every card's
current stream and every card's current stream waits for it; the
warm-up's constants are made on the card of the program that a copy
names, which a build record cannot say: such a program keeps none.

Build records (``runtime/program_store.py``): ``build_record`` hands out
what the last capture learned, its constants with their host copies (and
the cached uploads its warm-up read, ``gpu_kernels.note_cached``), its
pool's bytes and its hand kernels; a program made with a record's
``consts`` takes its first capture on the card straight from them, with
the kernels' libraries loaded first and no warm-up, and the capture's
replay answers the call.  A capture that asks for a constant the record
lacks raises, as do the host reads a warm-up would have reported.

Under ``DSQL_PROFILE`` the first warm-up of a program also counts its work
(``_CostCount``, kept as ``GraphProgram.cost``): the device profiler's
cost model, in place of XLA's ``cost_analysis()``.  It counts once per
program, never in a capture or a replay, and a hand kernel's function
counts as the one record its entry point reports
(``gpu_kernels.kernel_work``).
"""
from __future__ import annotations

import hashlib
import logging
import threading
import time
import warnings
import weakref
from collections import OrderedDict
from contextlib import ExitStack, contextmanager
from typing import Dict, FrozenSet, List, Optional

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_leaves, tree_map

from ..ops import gpu_kernels as gk
from ..runtime import gates
from ..runtime import telemetry as _tel

logger = logging.getLogger(__name__)

#: captures kept per program (distinct input tensors)
CAPTURES_PER_PROGRAM = 2
#: the graphs' memory pools may hold this share of the card in all
POOL_SHARE = 0.25


class HostRead(Exception):
    """The traced program reads device data on the host, or runs an op
    whose output size depends on it: outside the compilable subset."""


_READ_METHODS = frozenset({
    "item", "tolist", "__bool__", "__int__", "__float__", "__index__",
    "__complex__", "numpy", "is_nonzero", "cpu", "__array__",
})
_SIZE_OPS = frozenset({
    "nonzero", "argwhere", "unique", "unique_consecutive", "masked_select",
    "bincount", "repeat_interleave", "equal", "allclose", "histc",
})
_INDEX_OPS = frozenset({"__getitem__", "__setitem__", "index_put_",
                        "index_put"})
_H2D_FACTORIES = frozenset({"tensor", "as_tensor", "asarray"})


def _is_bool_tensor(x) -> bool:
    return isinstance(x, torch.Tensor) and x.dtype == torch.bool \
        and x.dim() > 0


def _digest(host: torch.Tensor) -> tuple:
    h = hashlib.blake2b(digest_size=16)
    h.update(host.contiguous().view(-1).numpy().tobytes()
             if host.dtype != torch.bool
             else host.contiguous().view(-1).to(torch.uint8).numpy().tobytes())
    return (str(host.dtype), tuple(host.shape), h.hexdigest())


_SYNC_TEXT = "synchroniz"


class _SyncWatch:
    """Host synchronisations of warm-ups, caught per thread.

    ``torch.cuda.set_sync_debug_mode`` is process-wide, and its ``"error"``
    setting would make any other thread's ``.item()`` raise.  Instead the
    mode is ``"warn"`` while at least one warm-up runs, and a
    ``warnings.showwarning`` hook files each synchronisation warning under
    the thread that raised it: a warming thread's are kept (and raise
    ``HostRead`` after its warm-up), the others' are dropped (the mode is
    on only for the warm-ups)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._active: Dict[int, List[str]] = {}
        self._tls = threading.local()
        self._prev_mode = 0
        self._prev_show = None
        self._filtered = False
        # one bound method, so that the restore below can tell by identity
        # whether the hook is still installed (every ``self._show`` is a
        # new object)
        self._hook = self._show

    @contextmanager
    def watch(self):
        """Yield the list this thread's synchronisations are added to."""
        tid = threading.get_ident()
        seen: List[str] = []
        with self._lock:
            if not self._active:
                if not self._filtered:
                    warnings.filterwarnings("always", message=".*" + _SYNC_TEXT)
                    self._filtered = True
                self._prev_mode = torch.cuda.get_sync_debug_mode()
                self._prev_show = warnings.showwarning
                warnings.showwarning = self._hook
                torch.cuda.set_sync_debug_mode("warn")
            self._active[tid] = seen
        try:
            yield seen
        finally:
            with self._lock:
                del self._active[tid]
                if not self._active:
                    torch.cuda.set_sync_debug_mode(self._prev_mode)
                    if warnings.showwarning is self._hook:
                        warnings.showwarning = self._prev_show

    @contextmanager
    def suspended(self):
        """This thread's synchronisations in the block are not kept."""
        prev = getattr(self._tls, "off", False)
        self._tls.off = True
        try:
            yield
        finally:
            self._tls.off = prev

    def _show(self, message, category, filename, lineno, file=None,
              line=None):
        if _SYNC_TEXT in str(message):
            seen = self._active.get(threading.get_ident())
            if seen is not None:
                if not getattr(self._tls, "off", False):
                    seen.append(f"{filename}:{lineno}: {message}")
                return
            if self._prev_mode == 0:
                return
        show = self._prev_show or warnings._showwarning_orig
        show(message, category, filename, lineno, file, line)


_SYNCS = _SyncWatch()


class _IdSet:
    """A set of tensors by identity that does not keep them alive."""

    def __init__(self, items=()):
        self._d: Dict[int, "weakref.ref"] = {}
        for t in items:
            self.add(t)

    def add(self, t: torch.Tensor) -> None:
        k = id(t)
        self._d[k] = weakref.ref(t, lambda _r, k=k: self._d.pop(k, None))

    def __contains__(self, t) -> bool:
        r = self._d.get(id(t))
        return r is not None and r() is t


class _Consts:
    """A program's host-to-device constants, by content: recorded in the
    warm-up, handed back in the same order per content during capture.

    Each content keeps its host copy, so that a build record
    (``GraphProgram.build_record``) can carry it to another process; a
    cached upload the warm-up reads without making it
    (``gpu_kernels.note_cached``: kernel 1's layouts, string byte matrices)
    is noted with its host copy as well, since a process whose cache is
    cold makes that copy inside the capture."""

    def __init__(self, device: torch.device, others=()):
        self.device = device
        #: the program's other cards, where a copy that names one goes
        self.others = frozenset(others)
        self.by_key: Dict[tuple, List[torch.Tensor]] = {}
        self.host: Dict[tuple, torch.Tensor] = {}
        self._noted: Dict[tuple, int] = {}
        self._seen = _IdSet()
        self._cursor: Dict[tuple, int] = {}

    def _card(self, device) -> torch.device:
        """Where a copy to ``device`` goes: that card where it is one of
        the program's other cards, else the program's first card."""
        return device if device in self.others else self.device

    def record(self, host: torch.Tensor, device=None) -> torch.Tensor:
        # the copy synchronises; a capture replays its result, so it is
        # not a synchronisation of the program
        with _SYNCS.suspended():
            dev = host.to(self._card(device))
        key = _digest(host)
        self.by_key.setdefault(key, []).append(dev)
        self.host.setdefault(key, host)
        self._seen.add(dev)
        return dev

    def note(self, dev: torch.Tensor, host: torch.Tensor) -> None:
        """The warm-up read ``dev``, a cached upload of ``host``."""
        if dev in self._seen:
            return
        self._seen.add(dev)
        key = _digest(host)
        self.host.setdefault(key, host)
        self._noted[key] = self._noted.get(key, 0) + 1

    def replay(self, host: torch.Tensor, device=None) -> torch.Tensor:
        key = _digest(host)
        i = self._cursor.get(key, 0)
        got = self.by_key.get(key, [])
        want = self._card(device)
        if i >= len(got) or (self.others and got[i].device != want):
            raise RuntimeError(
                f"compiled program: a host-to-device copy ({key[0]}, shape "
                f"{key[1]}, to {want}) during capture that the warm-up did "
                f"not make")
        self._cursor[key] = i + 1
        return got[i]

    def rewind(self) -> None:
        """Hand the constants out from the first again (a capture that is
        taken once more)."""
        self._cursor.clear()

    def trim(self) -> None:
        """Let go of the constants the capture did not ask for."""
        self.by_key = {k: ts[:self._cursor.get(k, 0)]
                       for k, ts in self.by_key.items()}

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for ts in self.by_key.values() for t in ts)

    def to_record(self) -> Dict[tuple, tuple]:
        """{content digest: (host numpy array, count)}: every copy the
        warm-up made and every cached upload it read."""
        out = {}
        for key, host in self.host.items():
            n = len(self.by_key.get(key, ())) + self._noted.get(key, 0)
            out[key] = (host.contiguous().numpy(), n)
        return out

    @classmethod
    def from_record(cls, device: torch.device, record: Dict[tuple, tuple]
                    ) -> "_Consts":
        """The constants of a build record, copied to ``device`` (before a
        capture: the copies synchronise)."""
        consts = cls(device)
        for key, (arr, n) in record.items():
            host = torch.from_numpy(arr)
            consts.host[key] = host
            consts.by_key[key] = [host.to(device) for _ in range(int(n))]
        return consts


def check_record(record: Dict[tuple, tuple]) -> None:
    """Raise ``ValueError`` unless every constant of a build record matches
    the content digest it is filed under."""
    for key, (arr, n) in record.items():
        if int(n) < 1 or _digest(torch.from_numpy(arr)) != key:
            raise ValueError(f"a recorded constant ({key[0]}, shape "
                             f"{key[1]}) does not match its digest")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


#: a gather reads as many bytes of its source as it writes (not the whole
#: source), a scatter those of its values; both read their index
_GATHER_OPS = frozenset({"__getitem__", "index_select", "take", "gather",
                         "take_along_dim"})
_SCATTER_OPS = frozenset({"__setitem__", "index_put_", "index_put",
                          "scatter", "scatter_", "scatter_add",
                          "scatter_add_", "scatter_reduce",
                          "scatter_reduce_", "index_add", "index_add_",
                          "index_copy", "index_copy_"})
_INPLACE_DUNDERS = frozenset({"__iadd__", "__isub__", "__imul__",
                              "__itruediv__", "__ifloordiv__", "__imod__",
                              "__iand__", "__ior__", "__ixor__",
                              "__ilshift__", "__irshift__"})
_MATMUL_OPS = frozenset({"matmul", "mm", "bmm", "__matmul__", "__rmatmul__"})
_TRANSCENDENTAL_OPS = frozenset({
    "exp", "exp_", "exp2", "expm1", "log", "log_", "log2", "log10",
    "log1p", "pow", "pow_", "__pow__", "__rpow__", "float_power", "sin",
    "cos", "tan", "asin", "acos", "atan", "atan2", "sinh", "cosh", "tanh",
    "arcsin", "arccos", "arctan", "arctan2"})


class _CostCount:
    """The work of one warm-up: ``bytes`` each op reads and writes (a view
    moves none; a gather reads as many as it writes plus its index; a
    scatter reads and writes its values and index), ``flops`` the
    elements each op writes (``2mnk`` for a product), ``transcendentals``
    the elements of exp/log/pow/trigonometric outputs, and ``kernels``
    the records of hand kernels (``gpu_kernels.kernel_work``), whose ops
    are not counted again (``suspended``)."""

    def __init__(self):
        self.flops = 0
        self.bytes = 0
        self.transcendentals = 0
        self.kernels: Dict[str, Dict[str, int]] = {}
        self.suspended = 0

    def kernel(self, name: str, nbytes: int, flops: int) -> None:
        rec = self.kernels.setdefault(name, {"launches": 0, "bytes": 0,
                                             "flops": 0})
        rec["launches"] += 1
        rec["bytes"] += int(nbytes)
        rec["flops"] += int(flops)
        self.bytes += int(nbytes)
        self.flops += int(flops)

    def op(self, name: str, args, leaves, out) -> None:
        ins: Dict[int, torch.Tensor] = {}
        for t in leaves:
            if isinstance(t, torch.Tensor):
                ins.setdefault(id(t), t)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        target = args[0] if args and isinstance(args[0], torch.Tensor) \
            else None
        if name in _SCATTER_OPS:
            vals = [t for k, t in ins.items()
                    if target is None or k != id(target)]
            moved = sum(_nbytes(t) for t in vals)
            self.bytes += 2 * moved
            self.flops += max((t.numel() for t in vals), default=0)
            if not name.endswith("_") and not name.startswith("__") \
                    and target is not None:
                # the out-of-place form copies its target first
                self.bytes += 2 * _nbytes(target)
            return
        if name in _INPLACE_DUNDERS or (
                name.endswith("_") and not name.startswith("_")):
            if target is None:
                return
            self.bytes += sum(_nbytes(t) for t in ins.values()) \
                + _nbytes(target)
            self.flops += target.numel()
            return
        fresh = [o for o in outs
                 if o._base is None and id(o) not in ins]
        if not fresh:
            return              # a view, an alias or a non-tensor result
        out_bytes = sum(_nbytes(o) for o in fresh)
        if name in _GATHER_OPS:
            index = [t for k, t in ins.items()
                     if target is None or k != id(target)]
            self.bytes += sum(_nbytes(t) for t in index) + 2 * out_bytes
        else:
            self.bytes += sum(_nbytes(t) for t in ins.values()) + out_bytes
        elems = sum(o.numel() for o in fresh)
        if name in _MATMUL_OPS and target is not None and target.dim() > 0:
            self.flops += 2 * elems * int(target.shape[-1])
        else:
            self.flops += elems
        if name in _TRANSCENDENTAL_OPS:
            self.transcendentals += elems

    def summary(self) -> Dict[str, object]:
        return {"flops": float(self.flops), "bytes": float(self.bytes),
                "transcendentals": float(self.transcendentals),
                "kernels": {k: dict(v) for k, v in self.kernels.items()}}


class _TraceMode(TorchFunctionMode):
    """Host-read checks, constant record/replay and keep-alive for one
    warm-up or capture, and the work count of a profiled warm-up (see the
    module docstring)."""

    def __init__(self, inputs, consts: Optional[_Consts] = None,
                 capture: bool = False, cost: Optional[_CostCount] = None):
        super().__init__()
        self.tainted = _IdSet(inputs)
        self.consts = consts
        self.capture = capture
        self.cost = cost
        self.hold: Dict[int, torch.Tensor] = {}
        # tensors made during the capture live in the graph's pool: they
        # are not held, so that the capture can reuse their memory
        self.made = _IdSet()

    # -- helpers -----------------------------------------------------------
    def _const(self, host: torch.Tensor, device) -> torch.Tensor:
        host = host.detach()
        if self.capture:
            return self.consts.replay(host, device)
        return self.consts.record(host, device)

    def _h2d(self, name, args, kwargs):
        """The constant for a host-to-device copy, or None if the call is
        not one."""
        if self.consts is None:
            return None
        if name in ("to", "cuda") and args and isinstance(args[0],
                                                         torch.Tensor):
            src = args[0]
            if src.device.type != "cpu":
                return None
            if name == "cuda":
                dev, dtype = None, None
            else:
                try:
                    dev, dtype = torch._C._nn._parse_to(*args[1:],
                                                        **kwargs)[:2]
                except (TypeError, RuntimeError):
                    return None
                if dev is None or torch.device(dev).type != "cuda":
                    return None
            host = src if dtype is None else src.to(dtype)
            return self._const(host, None if dev is None
                               else torch.device(dev))
        if name in _H2D_FACTORIES:
            dev = kwargs.get("device")
            if dev is None or torch.device(dev).type != "cuda":
                return None
            host_kw = {k: v for k, v in kwargs.items() if k != "device"}
            data = args[0]
            if isinstance(data, torch.Tensor) and data.device.type != "cpu":
                return None
            # the same factory without the device: the host copy
            return self._const(getattr(torch, name)(data, **host_kw),
                               torch.device(dev))
        return None

    def _check_read(self, name, args, kwargs, leaves):
        tainted = any(isinstance(t, torch.Tensor) and t in self.tainted
                      for t in leaves)
        if not tainted:
            return
        if name in _READ_METHODS or name in _SIZE_OPS \
                or (name == "where" and len(args) == 1 and not kwargs):
            raise HostRead(f"host read of device data: {name}")
        if name in _INDEX_OPS and len(args) > 1 and any(
                _is_bool_tensor(x) for x in tree_leaves(args[1])):
            raise HostRead(f"boolean-mask indexing of device data: {name}")
        if name == "to" and args:
            try:
                dev = torch._C._nn._parse_to(*args[1:], **kwargs)[0]
            except (TypeError, RuntimeError):
                dev = None
            if dev is not None and torch.device(dev).type == "cpu":
                raise HostRead("host read of device data: to(cpu)")

    # -- the hook ----------------------------------------------------------
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        const = self._h2d(name, args, kwargs)
        if const is not None:
            return const
        leaves = tree_leaves((args, kwargs))
        self._check_read(name, args, kwargs, leaves)
        if self.consts is not None and name in _INDEX_OPS and len(args) > 1:
            # a CPU index tensor into a card tensor is copied by the op
            # itself: make it a recorded constant instead
            base = args[0]
            if isinstance(base, torch.Tensor) and base.is_cuda:
                idx = tree_map(
                    lambda x: self._const(x, base.device)
                    if isinstance(x, torch.Tensor)
                    and x.device.type == "cpu" and x.dim() > 0 else x,
                    args[1])
                args = (base, idx) + tuple(args[2:])
                leaves = tree_leaves((args, kwargs))
        if self.capture:
            for t in leaves:
                if isinstance(t, torch.Tensor) and t.is_cuda \
                        and t not in self.made:
                    self.hold.setdefault(id(t), t)
        out = func(*args, **kwargs)
        if self.cost is not None and not self.cost.suspended:
            self.cost.op(name, args, leaves, out)
        if self.capture:
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    self.made.add(t)
        if any(isinstance(t, torch.Tensor) and t in self.tainted
               for t in leaves):
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    self.tainted.add(t)
        return out


# a background build retries a capture that another thread's device-wide
# synchronisation invalidated (cudaErrorStreamCaptureInvalidated, 901, or
# cudaErrorStreamCaptureUnsupported, 900): once, on its own thread
_retry = threading.local()
_RETRIED_CODES = (900, 901)
_RETRIED_NAMES = ("cudaerrorstreamcaptureinvalidated",
                  "cudaerrorstreamcaptureunsupported",
                  "operation not permitted when stream is capturing",
                  "operation failed due to a previous error during capture")


def capture_retry_armed() -> bool:
    return getattr(_retry, "armed", False)


@contextmanager
def capture_retry_scope(armed: bool = True):
    """Arm the one capture retry for this thread (a background build and
    the stage workers it starts)."""
    prev = capture_retry_armed()
    _retry.armed = armed
    try:
        yield
    finally:
        _retry.armed = prev


def _invalidated_capture(exc: BaseException) -> bool:
    from ..runtime.resilience import _cuda_code

    text = str(exc).lower()
    return (_cuda_code(exc) in _RETRIED_CODES
            or any(m in text for m in _RETRIED_NAMES))


def capture_retrying(attempt):
    """``attempt()`` (one capture); under ``capture_retry_scope`` a capture
    invalidated by another thread runs once more, counted
    ``background_capture_retries``.  A second failure propagates."""
    try:
        return attempt()
    except Exception as e:
        if not (capture_retry_armed() and _invalidated_capture(e)):
            raise
        _tel.inc("background_capture_retries")
        return attempt()


class _Capture:
    __slots__ = ("graph", "outs", "inputs", "consts", "hold", "launches",
                 "collectives", "pool_bytes", "__weakref__")


def _pool_release(devices, pool) -> None:
    """Let the allocator free the private pools once their graph is gone
    (a finalizer of the capture: no replay can follow)."""
    for d in devices:
        try:
            torch._C._cuda_releasePool(d.index, pool)
        except Exception:  # pragma: no cover - interpreter shutdown
            logger.debug("graph pool of %s not released", d, exc_info=True)


_lock = threading.RLock()
#: every live capture, least recently used first: (program, key) -> bytes
_LIVE: "OrderedDict[tuple, int]" = OrderedDict()

# captures in progress: the cache's free blocks are released before a
# capture (its pool cannot reuse them) only while no other capture runs,
# since the allocator must not release blocks during one
_capture_gate = threading.Lock()
_captures_underway = 0


def _capture_enter() -> None:
    """Count a capture in; the first releases the free blocks of every
    card's cache (``empty_cache`` empties every card's allocator, so a
    capture over several cards has all of its cards emptied)."""
    global _captures_underway
    with _capture_gate:
        if _captures_underway == 0:
            torch.cuda.empty_cache()
        _captures_underway += 1


def _capture_exit() -> None:
    global _captures_underway
    with _capture_gate:
        _captures_underway -= 1


def live_pool_bytes() -> int:
    with _lock:
        return sum(_LIVE.values())


class GraphProgram:
    """One compiled program: ``fn`` captured and replayed on the card, run
    eagerly on the CPU (module docstring).  ``copied``: the positions of
    the inputs that change per call, copied into each capture's own
    buffers.  ``record``: a build record's ``consts`` and ``kernels``
    (``runtime/program_store.py``), from which the first capture on the
    card is taken without a warm-up; the CPU ignores it.  ``group``: the
    process group whose collectives ``fn`` holds; a warm-up is waited for
    and a first capture held for ``confirm`` (module docstring)."""

    def __init__(self, fn, device: torch.device, copied=(), record=None,
                 group=None, devices=()):
        self.fn = fn
        self.device = torch.device(device)
        #: every card ``fn`` runs on, ``device`` (the capturing card) first
        self.devices = tuple(dict.fromkeys(
            [self.device] + [torch.device(d) for d in devices]))
        self.copied: FrozenSet[int] = frozenset(copied)
        self.lock = threading.RLock()
        self.checked = False
        self.captures: "OrderedDict[tuple, _Capture]" = OrderedDict()
        #: the first profiled warm-up's counted work (``_CostCount``)
        self.cost: Optional[Dict[str, object]] = None
        self.record = record if self.device.type == "cuda" else None
        self.group = group
        #: a first capture awaiting ``confirm`` (with a ``group``): (key,
        #: the capture or None on the CPU, the exception of a failed one)
        self.pending: Optional[tuple] = None

    def _cost_count(self) -> Optional[_CostCount]:
        """A work count for this warm-up: under ``DSQL_PROFILE``, once."""
        if self.cost is not None or not gates.profile_on():
            return None
        return _CostCount()

    def _warm_up(self, inputs, consts: Optional[_Consts] = None):
        count = self._cost_count()
        with gk.counting_work(count), \
                gk.noting_cached(None if consts is None else consts.note), \
                _TraceMode(inputs, consts, cost=count):
            outs = self.fn(*inputs)
        if count is not None:
            self.cost = count.summary()
        return outs

    def build_record(self) -> Dict[str, object]:
        """What the last capture learned, for a build record: its
        constants with their host copies (``_Consts.to_record``), its
        memory pool's bytes and the hand kernels it launches.  Empty on
        the CPU, which captures nothing."""
        if not self.captures:
            return {"consts": {}, "pool_bytes": 0, "kernels": []}
        cap = next(reversed(self.captures.values()))
        return {"consts": cap.consts.to_record(),
                "pool_bytes": int(cap.pool_bytes),
                "kernels": sorted(cap.launches)}

    def __call__(self, *flat):
        if self.device.type != "cuda":
            if self.checked:
                return self.fn(*flat)
            outs = self._warm_up(flat)
            self._captured(None, lambda: self._capture(flat, None))
            return outs
        key = tuple(t.data_ptr() for i, t in enumerate(flat)
                    if i not in self.copied)
        with self.lock:
            cap = self.captures.get(key)
            if cap is not None:
                self.captures.move_to_end(key)
                with _lock:
                    if (self, key) in _LIVE:
                        _LIVE.move_to_end((self, key))
                self._load(cap.inputs, flat)
                return self._replay(cap)
            return self._warm_and_capture(key, flat)

    def _captured(self, key, take) -> Optional["_Capture"]:
        """The step after a warm-up: ``take()`` captures (None on the CPU,
        whose program is then checked).  Kept at once, or, with a
        ``group``, held for ``confirm``, a failure included."""
        try:
            cap = take()
        except Exception as e:
            if self.group is None:
                raise
            logger.debug("capture failed, held for agreement (%s: %s)",
                         type(e).__name__, str(e)[:160])
            self.pending = (key, None, e)
            return None
        if self.group is not None:
            self.pending = (key, cap, None)
        else:
            self._install(key, cap)
        return cap

    def _install(self, key, cap: Optional["_Capture"]) -> None:
        if cap is None:
            self.checked = True
        else:
            self._keep(key, cap)

    def capture_outcome(self) -> Optional[bool]:
        """Whether this rank's held capture succeeded (None: none held)."""
        if self.pending is None:
            return None
        return self.pending[2] is None

    def confirm(self, keep: bool) -> bool:
        """Keep the held capture (``keep``, and it succeeded) or drop it;
        True if it was kept."""
        with self.lock:
            held, self.pending = self.pending, None
            if held is None:
                return False
            key, cap, failed = held
            if keep and failed is None:
                self._install(key, cap)
                return True
            if cap is not None:
                cap.graph.reset()
            return False

    def _replay(self, cap: "_Capture"):
        if cap.collectives:
            from ..parallel import group as _G
            _G.count_replay(cap.collectives)
        others = self.devices[1:]
        launch = torch.cuda.current_stream(self.device)
        for d in others:
            # eager work queued on another card (a placement, the copied
            # inputs) is done before the graph's nodes there read it
            launch.wait_stream(torch.cuda.current_stream(d))
        cap.graph.replay()
        for d in others:
            torch.cuda.current_stream(d).wait_stream(launch)
        gk.add_launches(cap.launches)
        _tel.inc("graph_replays")
        _tel.annotate(graph_pool_bytes=cap.pool_bytes)
        return cap.outs

    def _load(self, inputs, flat) -> None:
        """Copy this call's values of the copied inputs into a capture's
        buffers (ordered on the current stream; a pinned host source is
        read without a synchronisation)."""
        for i in self.copied:
            inputs[i].copy_(flat[i], non_blocking=True)

    def _warm_and_capture(self, key, flat):
        inputs = tuple(torch.empty(t.shape, dtype=t.dtype, device=self.device)
                       if i in self.copied else t
                       for i, t in enumerate(flat))
        self._load(inputs, flat)
        record, self.record = self.record, None
        if record is not None:
            return self._capture_from_record(key, inputs, record)
        consts = _Consts(self.device, self.devices[1:])
        t0 = time.perf_counter()
        with _SYNCS.watch() as seen:
            outs = self._warm_up(inputs, consts)
        if seen:
            raise HostRead(f"synchronisation in the trace: {seen[0]}")
        if self.group is not None:
            from ..parallel import group as _G
            _G.wait_device(self.group, "a warm-up")
        t1 = time.perf_counter()
        cap = self._captured(key, lambda: capture_retrying(
            lambda: self._capture(inputs, consts)))
        if cap is not None:
            _tel.inc("graph_captures")
            _tel.annotate(graph_pool_bytes=cap.pool_bytes,
                          graph_const_bytes=consts.nbytes(),
                          graph_warmup_ms=(t1 - t0) * 1e3,
                          graph_capture_ms=(time.perf_counter() - t1) * 1e3)
        return outs

    def _capture_from_record(self, key, inputs, record):
        """The first capture from a build record: its hand kernels' libraries
        loaded and its constants copied to the card first, then the capture
        with no warm-up, whose replay answers the call.  A capture that asks
        for a constant the record lacks, or reads device data on the host,
        raises: the caller builds the program anew."""
        for name in record.get("kernels", ()):
            gk.load_kernel_library(name)
        consts = _Consts.from_record(self.device, record["consts"])
        t0 = time.perf_counter()
        cap = capture_retrying(lambda: self._capture(inputs, consts))
        consts.trim()
        self._keep(key, cap)
        t1 = time.perf_counter()
        _tel.inc("graph_captures")
        _tel.annotate(graph_const_bytes=consts.nbytes(), graph_warmup_ms=0.0,
                      graph_capture_ms=(t1 - t0) * 1e3)
        return self._replay(cap)

    def _keep(self, key, cap: "_Capture") -> None:
        """Keep a new capture within the per-program and pool budgets."""
        self.captures[key] = cap
        while len(self.captures) > CAPTURES_PER_PROGRAM:
            self._drop(next(iter(self.captures)))
        with _lock:
            _LIVE[(self, key)] = cap.pool_bytes
            budget = POOL_SHARE * torch.cuda.get_device_properties(
                self.device).total_memory
            while len(_LIVE) > 1 and sum(_LIVE.values()) > budget:
                prog, k = next(iter(_LIVE))
                prog._drop(k)

    def _capture(self, inputs, consts: Optional[_Consts]
                 ) -> Optional["_Capture"]:
        """One capture of ``fn`` on a stream of its own; None on the CPU,
        which captures nothing (its program runs ``fn`` on every call).

        Over several cards it is one graph that holds every card's nodes:
        the capture begins on a side stream of the first card; each other
        card's side stream joins it by waiting on an event recorded on the
        capturing stream, is that card's current stream while ``fn`` runs
        (so a copy between cards records events between captured streams,
        edges of the graph), and its allocations go to a private pool of
        that card; before the capture ends every card's branch joins the
        capturing stream again."""
        if self.device.type != "cuda":
            return None
        from ..parallel import group as _G

        graph = torch.cuda.CUDAGraph()
        consts.rewind()
        mode = _TraceMode(inputs, consts, capture=True)
        others = self.devices[1:]
        current = {d: torch.cuda.current_stream(d) for d in self.devices}
        streams = {d: torch.cuda.Stream(d) for d in self.devices}
        for d in self.devices:
            streams[d].wait_stream(current[d])
        stream = streams[self.device]
        # the other cards' allocations go to one private pool id, as
        # capture_begin routes the capturing card's: without it a block
        # the graph still uses would be handed to eager work
        pool = torch.cuda.graph_pool_handle() if others else None
        routed: List[torch.device] = []
        _capture_enter()
        try:
            r0 = sum(torch.cuda.memory_reserved(d) for d in self.devices)
            failed: Optional[BaseException] = None
            with ExitStack() as stack:
                launched = stack.enter_context(gk.recording_launches())
                collectives = stack.enter_context(
                    _G.recording_collectives())
                # the other cards' streams first: entering a stream makes
                # its card current, and the capturing card must be last
                for d in others:
                    stack.enter_context(torch.cuda.stream(streams[d]))
                stack.enter_context(torch.cuda.stream(stream))
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    if others:
                        fork = torch.cuda.Event()
                        fork.record(stream)
                    try:
                        for d in others:
                            streams[d].wait_event(fork)
                            torch._C._cuda_beginAllocateCurrentThreadToPool(
                                d.index, pool)
                            routed.append(d)
                        with mode:
                            static = self.fn(*inputs)
                    finally:
                        for d in routed:
                            torch._C._cuda_endAllocateToPool(d.index, pool)
                    for d in others:
                        join = torch.cuda.Event()
                        join.record(streams[d])
                        stream.wait_event(join)
                except BaseException as e:
                    failed = e
                try:
                    graph.capture_end()
                except Exception as e:
                    if failed is None:
                        failed = e
                if failed is not None:
                    # destroy the failed graph now: a destructor that runs
                    # later (the exception's frames keep the object alive
                    # until the cycle collector frees it) would call into
                    # CUDA in the middle of this thread's next capture and
                    # invalidate it
                    try:
                        graph.reset()
                    except Exception:
                        logger.debug("failed graph not reset", exc_info=True)
                    _pool_release(routed, pool)
                    raise failed
            for d in self.devices:
                current[d].wait_stream(streams[d])
            r1 = sum(torch.cuda.memory_reserved(d) for d in self.devices)
        finally:
            _capture_exit()
        cap = _Capture()
        cap.graph, cap.outs, cap.inputs = graph, static, inputs
        cap.consts, cap.hold = consts, mode.hold
        cap.launches = {k: v for k, v in launched.items() if v}
        cap.collectives = list(collectives.values())
        cap.pool_bytes = max(r1 - r0, 0)
        if pool is not None:
            weakref.finalize(cap, _pool_release, others, pool)
        return cap

    def _drop(self, key) -> None:
        self.captures.pop(key, None)
        with _lock:
            _LIVE.pop((self, key), None)

    def release(self) -> None:
        """Drop every capture (the program left the cache)."""
        for key in list(self.captures):
            self._drop(key)
