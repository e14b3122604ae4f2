"""Resilience: the error taxonomy, per-query deadlines, retries, the ladder.

The counterpart of ``dask_sql_tpu/runtime/resilience.py``.  A failure to
trace, capture or replay a program must not reach the user untyped, and a
query must not run past its budget:

**Taxonomy.**  Every failure is one of ``UserError`` (the query is wrong;
no retry helps), ``TransientError`` (the attempt failed, a retry or a
lower rung can succeed: device out-of-memory, I/O, injected faults),
``FatalError`` (the program is wrong: retrying is pointless) and its
subclass ``DeviceLost`` (a sticky CUDA error: the context is dead), plus
the supervision verdicts ``DeadlineExceeded`` and ``QueryCancelled``.
``classify`` maps raw exceptions into it.  It reads torch and CUDA errors
where the JAX package reads XLA's:

- ``torch.cuda.OutOfMemoryError`` (and "out of memory" in a CUDA error)
  is a transient ``oom``;
- a stream-capture error ("operation not permitted when stream is
  capturing", ``cudaErrorStreamCapture*``: codes 900-908) is fatal: the
  program cannot be captured, whatever the attempt;
- a sticky error (illegal address, launch failure, device-side assert,
  misaligned address, illegal instruction, ECC; codes 214, 700-719) is
  ``DeviceLost``: every later call on the context fails, so it is never
  retried and never degraded to eager: it surfaces;
- any other CUDA error (an invalid argument, a kernel image missing) is
  fatal.

**Deadlines.**  ``Context.sql(..., timeout=)`` (seconds) or
``DSQL_QUERY_TIMEOUT_MS`` opens a ``query_scope`` with a monotonic
deadline and a cancel event; ``check()`` at the layer checkpoints (compile
attempts, escalation iterations, stage scheduling, eager plan nodes)
raises the typed verdict.  Worker threads re-enter the scope with
``scoped``.

**Retries.**  ``retry_transient`` retries TransientErrors with bounded
exponential backoff (``DSQL_RETRY_MAX`` attempts, ``DSQL_RETRY_BASE_MS``
base), checking the deadline before every sleep.

**Ladder.**  ``LADDER`` is the compiled tier's policy
(``physical/compiled.py``): whole program, then stages, then eager, then
a typed failure; counters ``degradations``, ``retries`` and
``deadline_exceeded`` say that it ran.

**Admission verdicts.**  ``AdmissionRejected`` (with ``retry_after_s``)
and its subclasses are what the workload manager
(``runtime/scheduler.py``), tenancy (``runtime/tenancy.py``) and the
server's drain raise before a query takes a slot; the server maps them to
429 / 503 with ``Retry-After`` (``server/app.py`` ``ERROR_WIRE_MATRIX``).
``LoadShedRejected`` and ``IngestBackpressure`` keep their wire rows
although their modules (the event bus, ingest) are not ported.
"""
from __future__ import annotations

import logging
import os
import re
import threading
import time
from contextlib import contextmanager
from typing import Callable, Optional, Tuple

logger = logging.getLogger(__name__)

LADDER: Tuple[str, ...] = ("whole", "stages", "eager", "fail")


# ---------------------------------------------------------------------------
# taxonomy
# ---------------------------------------------------------------------------

class ResilienceError(RuntimeError):
    """Base of the typed taxonomy (Presto wire classification)."""

    error_type = "INTERNAL_ERROR"
    error_name = "GENERIC_INTERNAL_ERROR"
    error_code = 0x10000


class UserError(ResilienceError):
    """The query or its inputs are wrong; no retry can help."""

    error_type = "USER_ERROR"
    error_name = "GENERIC_USER_ERROR"
    error_code = 0x0


class TransientError(ResilienceError):
    """A retry, or a lower rung of the ladder, can succeed.  ``kind``:
    ``"oom"``, ``"io"``, ``"device"`` or ``"injected"``."""

    error_name = "TRANSIENT_ERROR"

    def __init__(self, message: str = "", kind: str = "device"):
        super().__init__(message)
        self.kind = kind
        if kind == "oom":
            self.error_type = "INSUFFICIENT_RESOURCES"
            self.error_name = "EXCEEDED_MEMORY_LIMIT"
            self.error_code = 0x20000


class FatalError(ResilienceError):
    """An engine invariant broke, or the program cannot run; never
    retried."""

    error_name = "GENERIC_INTERNAL_ERROR"


class DeviceLost(FatalError):
    """A sticky CUDA error: the context is dead, so neither a retry nor
    the eager tier can answer.  Always surfaces."""

    error_name = "DEVICE_LOST"


class DeadlineExceeded(ResilienceError):
    """The per-query time budget ran out (Trino EXCEEDED_TIME_LIMIT)."""

    error_type = "INSUFFICIENT_RESOURCES"
    error_name = "EXCEEDED_TIME_LIMIT"
    error_code = 0x20000


class QueryCancelled(UserError):
    """The client abandoned the query."""

    error_name = "USER_CANCELED"


class SchemaMismatch(UserError):
    """An appended batch does not fit the target table's schema (missing
    or extra columns, wrong arity, a value that does not cast): the server
    answers 400."""

    error_name = "SCHEMA_MISMATCH"


class AdmissionRejected(ResilienceError):
    """The workload manager refused the query at submit time: queue full,
    or the deadline would expire before a slot could free.  The server
    answers 429 with a ``Retry-After`` from ``retry_after_s``."""

    error_type = "INSUFFICIENT_RESOURCES"
    error_name = "QUERY_QUEUE_FULL"
    error_code = 0x20000

    def __init__(self, message: str = "", retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = max(float(retry_after_s), 0.0)


class AdmissionTimeout(AdmissionRejected):
    """The query waited in the admission queue past
    ``DSQL_QUEUE_TIMEOUT_MS`` without winning a slot."""

    error_name = "QUERY_QUEUE_TIMEOUT"


class ServerDraining(AdmissionRejected):
    """The process is draining (SIGTERM/SIGINT): in-flight queries finish,
    new admissions are refused with 503 + ``Retry-After``."""

    error_name = "SERVER_SHUTTING_DOWN"


class TenantQuotaExceeded(AdmissionRejected):
    """The tenant's rate (``DSQL_TENANT_QPS``) or concurrency
    (``DSQL_TENANT_CONCURRENT``) quota is spent: 429 + ``Retry-After``
    from the bucket's refill time."""

    error_name = "TENANT_QUOTA_EXCEEDED"


class TenantCircuitOpen(AdmissionRejected):
    """The tenant's circuit breaker is open (``DSQL_TENANT_BREAKER``
    consecutive fatal or timeout verdicts) until a half-open probe
    succeeds: 429 + ``Retry-After`` of the open window."""

    error_name = "TENANT_CIRCUIT_OPEN"


class LoadShedRejected(AdmissionRejected):
    """A background admission shed while a class burns its SLO error
    budget (the JAX package's event bus, not ported): 429."""

    error_name = "SLO_LOAD_SHED"


class IngestBackpressure(AdmissionRejected):
    """An ingest batch the memory broker cannot absorb
    (``runtime/ingest.py``): 429 with a ``Retry-After``."""

    error_name = "INGEST_BACKPRESSURE"


# exception type NAMES that are user mistakes by construction
_USER_ERROR_NAMES = frozenset({
    "ParsingException", "ValidationException", "BinderError",
})

# CUDA error codes: sticky (the context is dead after them) and stream
# capture (the program cannot be captured)
_STICKY_CODES = frozenset({214, 700, 702, 710, 714, 715, 716, 717, 718,
                           719})
_CAPTURE_CODES = frozenset(range(900, 909))
_STICKY_MARKERS = (
    "illegal memory access", "unspecified launch failure",
    "device-side assert", "misaligned address", "illegal instruction",
    "uncorrectable ecc", "hardware stack error", "invalid program counter",
    "launch timed out", "illegal address",
)
_CAPTURE_MARKERS = (
    "stream is capturing", "cudaerrorstreamcapture", "during capture",
    "capture sequence", "captured event",
)
_CODE_RE = re.compile(r"cuda error:? *\(?(\d+)\)?", re.IGNORECASE)


def _is_cuda_error(exc: BaseException) -> bool:
    accel = getattr(__import__("torch"), "AcceleratorError", None)
    if accel is not None and isinstance(exc, accel):
        return True
    return isinstance(exc, RuntimeError) and "cuda" in str(exc).lower()


def _cuda_code(exc: BaseException) -> Optional[int]:
    code = getattr(exc, "error_code", None)
    if isinstance(code, int):
        return code
    m = _CODE_RE.search(str(exc))
    return int(m.group(1)) if m else None


def classify(exc: BaseException, *, default=FatalError
             ) -> Optional[ResilienceError]:
    """Map a raw exception into the taxonomy: the original object when
    already typed, else a typed error whose ``__cause__`` is the original;
    None for control-flow exceptions the caller re-raises untouched.
    ``default`` is the bucket for unrecognized types."""
    if isinstance(exc, (KeyboardInterrupt, SystemExit, GeneratorExit)):
        return None
    if isinstance(exc, ResilienceError):
        return exc

    def wrap(cls, *args, **kw) -> ResilienceError:
        err = cls(*args, **kw)
        err.__cause__ = exc
        return err

    import torch

    msg = f"{type(exc).__name__}: {exc}"
    if isinstance(exc, (MemoryError, torch.cuda.OutOfMemoryError)):
        return wrap(TransientError, msg, kind="oom")
    if type(exc).__name__ in _USER_ERROR_NAMES:
        return wrap(UserError, str(exc))
    if _is_cuda_error(exc):
        text = str(exc).lower()
        code = _cuda_code(exc)
        if code in _STICKY_CODES or any(m in text for m in _STICKY_MARKERS):
            return wrap(DeviceLost, msg)
        if code in _CAPTURE_CODES or any(m in text
                                         for m in _CAPTURE_MARKERS):
            return wrap(FatalError, msg)
        if "out of memory" in text or code == 2:
            return wrap(TransientError, msg, kind="oom")
        return wrap(FatalError, msg)
    if isinstance(exc, (ConnectionError, TimeoutError, OSError)):
        return wrap(TransientError, msg, kind="io")
    return wrap(default, msg)


# ---------------------------------------------------------------------------
# per-query runtime: deadline + cancellation
# ---------------------------------------------------------------------------

def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


class QueryRuntime:
    """Deadline + cancel token that one query's threads share;
    ``backoff_s`` is the time it slept in retry backoff."""

    __slots__ = ("deadline_at", "cancel", "backoff_s")

    def __init__(self, timeout_s: Optional[float] = None,
                 cancel: Optional[threading.Event] = None):
        self.deadline_at = (None if timeout_s is None
                            else time.monotonic() + max(timeout_s, 0.0))
        self.cancel = cancel
        self.backoff_s = 0.0

    def remaining(self) -> Optional[float]:
        if self.deadline_at is None:
            return None
        return self.deadline_at - time.monotonic()

    def merged(self, timeout_s: Optional[float],
               cancel: Optional[threading.Event]) -> "QueryRuntime":
        """A nested scope only tightens: the sooner deadline wins and
        either cancel token aborts."""
        rt = QueryRuntime(timeout_s, cancel or self.cancel)
        if self.deadline_at is not None and (
                rt.deadline_at is None or self.deadline_at < rt.deadline_at):
            rt.deadline_at = self.deadline_at
        if rt.cancel is None:
            rt.cancel = self.cancel
        return rt


_tls = threading.local()


def current() -> Optional[QueryRuntime]:
    return getattr(_tls, "runtime", None)


@contextmanager
def scoped(rt: Optional[QueryRuntime]):
    """Install an existing runtime in THIS thread (worker-pool re-entry)."""
    prev = current()
    _tls.runtime = rt
    try:
        yield rt
    finally:
        _tls.runtime = prev


@contextmanager
def query_scope(timeout_s: Optional[float] = None,
                cancel: Optional[threading.Event] = None):
    """Open (or tighten) the per-query scope; ``timeout_s=None`` reads
    ``DSQL_QUERY_TIMEOUT_MS`` (unset or 0: no deadline)."""
    if timeout_s is None:
        ms = _env_int("DSQL_QUERY_TIMEOUT_MS", 0)
        timeout_s = ms / 1e3 if ms > 0 else None
    outer = current()
    rt = (QueryRuntime(timeout_s, cancel) if outer is None
          else outer.merged(timeout_s, cancel))
    with scoped(rt):
        yield rt


def _bump(key: str, n: int = 1) -> None:
    from . import telemetry as _tel
    _tel.inc(key, n)


def check(site: str = "") -> None:
    """Deadline/cancellation checkpoint; raises the typed verdict."""
    rt = current()
    if rt is None:
        return
    if rt.cancel is not None and rt.cancel.is_set():
        raise QueryCancelled(
            f"query cancelled{f' at {site}' if site else ''}")
    rem = rt.remaining()
    if rem is not None and rem <= 0:
        _bump("deadline_exceeded")
        raise DeadlineExceeded(
            f"query deadline exceeded{f' at {site}' if site else ''} "
            f"({-rem * 1e3:.0f} ms past)")


def interruptible_sleep(seconds: float, site: str = "") -> None:
    """Sleep in small slices so cancellation/deadline cut it short."""
    end = time.monotonic() + max(seconds, 0.0)
    while True:
        check(site)
        left = end - time.monotonic()
        if left <= 0:
            return
        time.sleep(min(left, 0.01))


# ---------------------------------------------------------------------------
# retry policy
# ---------------------------------------------------------------------------

def retry_max() -> int:
    return max(_env_int("DSQL_RETRY_MAX", 2), 0)


def backoff_s(attempt: int) -> float:
    """Exponential backoff for retry ``attempt`` (1-based), capped at 2 s."""
    base = _env_int("DSQL_RETRY_BASE_MS", 25) / 1e3
    return min(base * (2 ** (attempt - 1)), 2.0)


def backoff(attempt: int, site: str = "") -> None:
    """Sleep before retry ``attempt``, never past the deadline: when the
    budget cannot cover the sleep, raise DeadlineExceeded now."""
    from . import telemetry as _tel
    delay = backoff_s(attempt)
    rt = current()
    if rt is not None:
        rem = rt.remaining()
        if rem is not None and rem <= delay:
            _bump("deadline_exceeded")
            raise DeadlineExceeded(
                f"deadline cannot cover retry backoff at {site or 'site'} "
                f"({delay * 1e3:.0f} ms needed, {max(rem, 0) * 1e3:.0f} ms "
                "left)")
    t0 = time.monotonic()
    try:
        with _tel.span("retry_backoff", site=site, attempt=attempt):
            interruptible_sleep(delay, site)
    finally:
        if rt is not None:
            rt.backoff_s += time.monotonic() - t0


def retry_transient(fn: Callable, *, site: str,
                    passthrough: Tuple[type, ...] = ()):
    """Run ``fn``, retrying TransientErrors with bounded backoff;
    ``passthrough`` exceptions re-raise untouched, anything else as its
    classified type."""
    attempt = 0
    while True:
        check(site)
        try:
            return fn()
        except passthrough:
            raise
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as e:
            err = classify(e)
            if err is None:
                raise
            if not isinstance(err, TransientError):
                raise err if err is e else err from e
            attempt += 1
            if attempt > retry_max():
                raise err if err is e else err from e
            _bump("retries")
            logger.warning("transient failure at %s (%s); retry %d/%d",
                           site, str(err)[:200], attempt, retry_max())
            backoff(attempt, site)
