"""Named-site fault injection, deterministic or probabilistic.

The counterpart of ``dask_sql_tpu/runtime/faults.py``.  The degradation
ladder (``runtime/resilience.py``) is only trustworthy if tests and the
smoke script exercise it, and real faults (device out-of-memory, a failed
capture) cannot be scheduled.  Injection sites sit at the layer
boundaries, each calling ``maybe_fail(site)``, a no-op unless armed.  The
port places these of the JAX package's sites:

  ``compile``        a program's build and first call, inside the
                     quarantine watchdog (``physical/compiled.py``
                     ``_execute_single``)
  ``materialize``    decoding a run's outputs to a Table
                     (``physical/compiled.py`` ``_materialize``)
  ``stage_exec``     one attempt of one stage of a stage graph (fired
                     again by a replay)
  ``stage_replay``   a checkpointed stage replay, checked before
                     ``stage_exec``
  ``cache_populate`` storing a result or a stage output in the result
                     cache (``runtime/result_cache.py`` ``put``): a fired
                     fault skips the store, never the query
  ``admission``      the top of the workload manager's ``acquire``
                     (``runtime/scheduler.py``): the query fails typed
                     before it takes a slot
  ``drain``          the server's graceful drain (``server/app.py``),
                     which logs a fired fault and shuts down all the same
  ``spill``          each disk write and read of the spill store
                     (``runtime/spill.py``), under ``retry_transient``
  ``host_transfer``  a device chunk's copy to the host in the spill store
  ``result_spool``   spooling a large server result into pages
                     (``server/app.py``): a fired fault serves the result
                     unpaged
  ``autopilot``      the top of an autopilot tick
                     (``runtime/autopilot.py``): a fired fault makes the
                     tick a journaled no-op
  ``chunked_read``   uploading a host batch of a chunked table
                     (``io/chunked.py``) or of a spilled run
                     (``physical/morsel.py``)
  ``mv_refresh``     a view's incremental refresh
                     (``runtime/matview.py``): a fired fault recomputes
                     the view in full
  ``ingest``         the top of a logged batch's commit
                     (``runtime/ingest.py``): the batch is refused whole

``SITES`` is the JAX package's whole list, so a spec parses the same in
both packages, and every site on it is called in the port where the JAX
package calls it.

Arm via ``DSQL_FAULT_INJECT`` (comma-separated specs) or the ``inject``
context manager.  ``site:nth[+]`` fires on the nth call (``+``: and every
later one); ``site:p=P[:seed=N]`` fires each call with probability P from a
seeded stream.  Both take ``:sleep=MS`` (stall, in cancellable slices,
before raising) and ``:fatal`` (raise ``FatalFaultInjected``, a
FatalError, which reaches exile and quarantine).  A fired fault counts as
``fault_<site>``.  ``FaultInjected`` is a TransientError, so the ordinary
retry and degradation machinery handles it.
"""
from __future__ import annotations

import os
import random
import threading
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

from .resilience import FatalError, TransientError, interruptible_sleep

SITES = ("compile", "materialize", "stage_exec", "stage_replay",
         "chunked_read", "host_transfer", "cache_populate", "admission",
         "drain", "spill", "mv_refresh", "result_spool", "autopilot",
         "ingest")


class FaultInjected(TransientError):
    """An armed injection site fired (stands in for a production fault)."""

    error_name = "FAULT_INJECTED"

    def __init__(self, site: str, nth: int):
        super().__init__(f"injected fault at site {site!r} (call #{nth})",
                         kind="injected")
        self.site = site
        self.nth = nth


class FatalFaultInjected(FatalError):
    """An armed ``:fatal`` site fired: stands in for a crash verdict (the
    program is doomed, not the attempt), reaching the exile + quarantine
    paths that transient faults never touch."""

    error_name = "FAULT_INJECTED"

    def __init__(self, site: str, nth: int):
        super().__init__(
            f"injected FATAL fault at site {site!r} (call #{nth})")
        self.site = site
        self.nth = nth


class _Spec:
    __slots__ = ("site", "nth", "from_on", "prob", "rng", "sleep_ms",
                 "fatal")

    def __init__(self, site: str, nth: Optional[int], from_on: bool,
                 prob: Optional[float], seed: int,
                 sleep_ms: Optional[int], fatal: bool):
        self.site = site
        self.nth = nth
        self.from_on = from_on
        self.prob = prob
        # dedicated stream per spec: deterministic given (seed, call seq),
        # independent of any other random use in the process
        self.rng = random.Random(seed) if prob is not None else None
        self.sleep_ms = sleep_ms
        self.fatal = fatal

    def matches(self, count: int) -> bool:
        if self.prob is not None:
            return self.rng.random() < self.prob
        return count >= self.nth if self.from_on else count == self.nth


def parse_spec(raw: str) -> List[_Spec]:
    """Parse a DSQL_FAULT_INJECT value; unknown sites/shapes are rejected
    loudly — a typo must not silently disarm a fault test."""
    specs: List[_Spec] = []
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        if len(fields) < 2:
            raise ValueError(f"DSQL_FAULT_INJECT spec {part!r}: want "
                             "site:nth[+] or site:p=P[:seed=N]")
        site = fields[0]
        if site not in SITES:
            raise ValueError(f"DSQL_FAULT_INJECT: unknown site {site!r} "
                             f"(sites: {', '.join(SITES)})")
        arm = fields[1]
        nth: Optional[int] = None
        from_on = False
        prob: Optional[float] = None
        if arm.startswith("p="):
            prob = float(arm[len("p="):])
            if not 0.0 < prob <= 1.0:
                raise ValueError(
                    f"DSQL_FAULT_INJECT: probability {prob!r} outside (0, 1]")
        else:
            from_on = arm.endswith("+")
            nth = int(arm[:-1] if from_on else arm)
        seed = 0
        sleep_ms = None
        fatal = False
        for extra in fields[2:]:
            if extra.startswith("sleep="):
                sleep_ms = int(extra[len("sleep="):])
            elif extra.startswith("seed="):
                seed = int(extra[len("seed="):])
            elif extra == "fatal":
                fatal = True
            else:
                raise ValueError(
                    f"DSQL_FAULT_INJECT: unknown action {extra!r}")
        specs.append(_Spec(site, nth, from_on, prob, seed, sleep_ms, fatal))
    return specs


_lock = threading.Lock()
_counts: Dict[str, int] = {}
_override: Optional[List[_Spec]] = None      # inject() context manager
_env_cache: Tuple[Optional[str], List[_Spec]] = (None, [])


def _active_specs() -> List[_Spec]:
    global _env_cache
    if _override is not None:
        return _override
    raw = os.environ.get("DSQL_FAULT_INJECT")
    if not raw:
        return []
    if _env_cache[0] != raw:
        _env_cache = (raw, parse_spec(raw))
    return _env_cache[1]


def reset() -> None:
    """Zero all site counters (between tests / smoke queries)."""
    with _lock:
        _counts.clear()


def maybe_fail(site: str) -> None:
    """The injection site.  No-op unless a spec is armed for ``site``."""
    specs = _active_specs()
    if not specs:
        return
    with _lock:
        count = _counts.get(site, 0) + 1
        _counts[site] = count
        # probabilistic draws mutate the spec's rng; keep them under the
        # lock so the stream stays a deterministic function of the call
        # sequence
        hit = next((s for s in specs
                    if s.site == site and s.matches(count)), None)
    if hit is None:
        return
    from .resilience import _bump
    _bump(f"fault_{site}")
    if hit.sleep_ms:
        # a "hung program": stall in cancellable slices so deadline/cancel
        # supervision — not the fault itself — decides the outcome
        interruptible_sleep(hit.sleep_ms / 1e3, site)
    if hit.fatal:
        raise FatalFaultInjected(site, count)
    raise FaultInjected(site, count)


@contextmanager
def inject(spec: str):
    """Arm injection for a test body, e.g. ``inject("compile:1")`` or
    ``inject("stage_exec:1+")``; counters reset on entry AND exit so
    specs never leak across tests."""
    global _override
    parsed = parse_spec(spec)
    with _lock:
        prev = _override
    reset()
    _override = parsed
    try:
        yield
    finally:
        _override = prev
        reset()
