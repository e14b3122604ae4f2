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
- kernel launches recorded into a graph go to the capture's own record
  (``gpu_kernels.recording_launches``) and are added to
  ``gpu_kernels.LAUNCHES`` once per replay; other threads' launches count
  as usual.
"""
from __future__ import annotations

import hashlib
import threading
import time
import warnings
import weakref
from collections import OrderedDict
from contextlib import contextmanager
from typing import Dict, FrozenSet, List, Optional

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_leaves, tree_map

from ..ops import gpu_kernels as gk
from ..runtime import telemetry as _tel

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
                warnings.showwarning = self._show
                torch.cuda.set_sync_debug_mode("warn")
            self._active[tid] = seen
        try:
            yield seen
        finally:
            with self._lock:
                del self._active[tid]
                if not self._active:
                    torch.cuda.set_sync_debug_mode(self._prev_mode)
                    if warnings.showwarning is self._show:
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


class _Consts:
    """A program's host-to-device constants, by content: recorded in the
    warm-up, handed back in the same order per content during capture."""

    def __init__(self, device: torch.device):
        self.device = device
        self.by_key: Dict[tuple, List[torch.Tensor]] = {}
        self._cursor: Dict[tuple, int] = {}

    def record(self, host: torch.Tensor) -> torch.Tensor:
        # the copy synchronises; a capture replays its result, so it is
        # not a synchronisation of the program
        with _SYNCS.suspended():
            dev = host.to(self.device)
        self.by_key.setdefault(_digest(host), []).append(dev)
        return dev

    def replay(self, host: torch.Tensor) -> torch.Tensor:
        key = _digest(host)
        i = self._cursor.get(key, 0)
        got = self.by_key.get(key, [])
        if i >= len(got):
            raise RuntimeError(
                f"compiled program: a host-to-device copy ({key[0]}, shape "
                f"{key[1]}) during capture that the warm-up did not make")
        self._cursor[key] = i + 1
        return got[i]

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for ts in self.by_key.values() for t in ts)


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


class _TraceMode(TorchFunctionMode):
    """Host-read checks, constant record/replay and keep-alive for one
    warm-up or capture (see the module docstring)."""

    def __init__(self, inputs, consts: Optional[_Consts] = None,
                 capture: bool = False):
        super().__init__()
        self.tainted = _IdSet(inputs)
        self.consts = consts
        self.capture = capture
        self.hold: Dict[int, torch.Tensor] = {}
        # tensors made during the capture live in the graph's pool: they
        # are not held, so that the capture can reuse their memory
        self.made = _IdSet()

    # -- helpers -----------------------------------------------------------
    def _const(self, host: torch.Tensor) -> torch.Tensor:
        host = host.detach()
        if self.capture:
            return self.consts.replay(host)
        return self.consts.record(host)

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
                dtype = None
            else:
                try:
                    dev, dtype = torch._C._nn._parse_to(*args[1:],
                                                        **kwargs)[:2]
                except (TypeError, RuntimeError):
                    return None
                if dev is None or torch.device(dev).type != "cuda":
                    return None
            host = src if dtype is None else src.to(dtype)
            return self._const(host)
        if name in _H2D_FACTORIES:
            dev = kwargs.get("device")
            if dev is None or torch.device(dev).type != "cuda":
                return None
            host_kw = {k: v for k, v in kwargs.items() if k != "device"}
            data = args[0]
            if isinstance(data, torch.Tensor) and data.device.type != "cpu":
                return None
            # the same factory without the device: the host copy
            return self._const(getattr(torch, name)(data, **host_kw))
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
                    lambda x: self._const(x) if isinstance(x, torch.Tensor)
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


class _Capture:
    __slots__ = ("graph", "outs", "inputs", "consts", "hold", "launches",
                 "pool_bytes")


_lock = threading.RLock()
#: every live capture, least recently used first: (program, key) -> bytes
_LIVE: "OrderedDict[tuple, int]" = OrderedDict()

# captures in progress: the cache's free blocks are released before a
# capture (its pool cannot reuse them) only while no other capture runs,
# since the allocator must not release blocks during one
_capture_gate = threading.Lock()
_captures_underway = 0


def _capture_enter(device: torch.device) -> None:
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
    buffers."""

    def __init__(self, fn, device: torch.device, copied=()):
        self.fn = fn
        self.device = torch.device(device)
        self.copied: FrozenSet[int] = frozenset(copied)
        self.lock = threading.RLock()
        self.checked = False
        self.captures: "OrderedDict[tuple, _Capture]" = OrderedDict()

    def __call__(self, *flat):
        if self.device.type != "cuda":
            if self.checked:
                return self.fn(*flat)
            with _TraceMode(flat):
                outs = self.fn(*flat)
            self.checked = True
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
                cap.graph.replay()
                gk.add_launches(cap.launches)
                _tel.inc("graph_replays")
                _tel.annotate(graph_pool_bytes=cap.pool_bytes)
                return cap.outs
            return self._warm_and_capture(key, flat)

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
        consts = _Consts(self.device)
        t0 = time.perf_counter()
        with _SYNCS.watch() as seen:
            with _TraceMode(inputs, consts):
                outs = self.fn(*inputs)
        if seen:
            raise HostRead(f"synchronisation in the trace: {seen[0]}")
        t1 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        mode = _TraceMode(inputs, consts, capture=True)
        current = torch.cuda.current_stream(self.device)
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(current)
        _capture_enter(self.device)
        try:
            r0 = torch.cuda.memory_reserved(self.device)
            failed: Optional[BaseException] = None
            with gk.recording_launches() as launched, \
                    torch.cuda.stream(stream):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    with mode:
                        static = self.fn(*inputs)
                except BaseException as e:
                    failed = e
                try:
                    graph.capture_end()
                except Exception:
                    if failed is None:
                        raise
                if failed is not None:
                    raise failed
            current.wait_stream(stream)
            r1 = torch.cuda.memory_reserved(self.device)
        finally:
            _capture_exit()
        cap = _Capture()
        cap.graph, cap.outs, cap.inputs = graph, static, inputs
        cap.consts, cap.hold = consts, mode.hold
        cap.launches = {k: v for k, v in launched.items() if v}
        cap.pool_bytes = max(r1 - r0, 0)
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
        _tel.inc("graph_captures")
        _tel.annotate(graph_pool_bytes=cap.pool_bytes,
                      graph_const_bytes=consts.nbytes(),
                      graph_warmup_ms=(t1 - t0) * 1e3,
                      graph_capture_ms=(time.perf_counter() - t1) * 1e3)
        return outs

    def _drop(self, key) -> None:
        self.captures.pop(key, None)
        with _lock:
            _LIVE.pop((self, key), None)

    def release(self) -> None:
        """Drop every capture (the program left the cache)."""
        for key in list(self.captures):
            self._drop(key)
