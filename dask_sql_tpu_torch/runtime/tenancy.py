"""Multi-tenant admission: identity, quotas, circuit breakers.

The counterpart of ``dask_sql_tpu/runtime/tenancy.py``.  Every query gets
a tenant identity, and three per-tenant policies are enforced at
admission, before the workload manager spends a slot or a queue position
on the query:

- **Identity.**  The server's ``X-DSQL-Tenant`` header or
  ``Context.sql(tenant=)``, sanitized to ``[A-Za-z0-9_-]`` and at most 64
  characters; anything else is the ``"default"`` tenant.
- **Rate.**  ``DSQL_TENANT_QPS`` tokens a second per tenant, a burst of
  one second; an empty bucket raises ``TenantQuotaExceeded`` (429) with a
  ``Retry-After`` from the refill time.
- **Concurrency.**  ``DSQL_TENANT_CONCURRENT`` outstanding queries per
  tenant, claimed at submission and released at completion.
- **Circuit breaker.**  ``DSQL_TENANT_BREAKER`` consecutive fatal or
  timeout verdicts open the tenant's breaker for
  ``DSQL_TENANT_BREAKER_TTL_S``: admissions raise ``TenantCircuitOpen``.
  On expiry it is half-open: one probe is admitted (the window moves out
  by ``DSQL_TENANT_BREAKER_PROBE_S``); a clean probe closes it, a failed
  one opens it again for the whole TTL.

Every quota defaults to off (0), so tenancy changes nothing until a knob
is set; ``DSQL_TENANCY=0`` keeps the module out of every path.
``admission()`` wraps ``Context._execute_query_plan``; the server claims
at POST time (``claim`` + ``grant_scope``) so a refused tenant gets its
429 before the query enters the pool, and ``admission()`` adopts that
claim once, like the workload manager's seats.
"""
from __future__ import annotations

import logging
import os
import string
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

from . import telemetry as _tel
from .resilience import (AdmissionTimeout, DeadlineExceeded, FatalError,
                         TenantCircuitOpen, TenantQuotaExceeded)

logger = logging.getLogger(__name__)

DEFAULT_TENANT = "default"

_TENANT_CHARS = frozenset(string.ascii_letters + string.digits + "_-")
_MAX_TENANT_LEN = 64


def enabled() -> bool:
    """``DSQL_TENANCY`` (default on); callers check ``gates.tenancy_on``
    before they import this module."""
    from .gates import tenancy_on
    return tenancy_on()


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


# env-read per call (like the scheduler's knobs) so tests and operators
# flip quotas without a restart; 0 = unlimited / breaker off
def qps_limit() -> float:
    return max(_env_float("DSQL_TENANT_QPS", 0.0), 0.0)


def concurrent_limit() -> int:
    return max(_env_int("DSQL_TENANT_CONCURRENT", 0), 0)


def breaker_threshold() -> int:
    return max(_env_int("DSQL_TENANT_BREAKER", 0), 0)


def breaker_ttl_s() -> float:
    return max(_env_float("DSQL_TENANT_BREAKER_TTL_S", 30.0), 0.1)


def breaker_probe_s() -> float:
    return max(_env_float("DSQL_TENANT_BREAKER_PROBE_S", 5.0), 0.1)


def sanitize_tenant(raw: Any) -> Optional[str]:
    """A safe tenant name ([A-Za-z0-9_-], ≤64 chars) or None: the name
    travels in response payloads, log lines and gauge names."""
    if raw is None:
        return None
    s = str(raw).strip()
    if not s or len(s) > _MAX_TENANT_LEN:
        return None
    if not all(c in _TENANT_CHARS for c in s):
        return None
    return s


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

class Grant:
    """One admitted claim against a tenant's quotas.  ``consumed`` flips
    when ``admission()`` adopts a server pre-claim (exactly once, like a
    scheduler seat); ``released`` makes release idempotent."""

    __slots__ = ("tenant", "probe", "consumed", "released")

    def __init__(self, tenant: str, probe: bool = False):
        self.tenant = tenant
        self.probe = probe
        self.consumed = False
        self.released = False


class _TenantState:
    __slots__ = ("name", "tokens", "stamp", "inflight", "consec",
                 "open_until", "probing", "submitted", "admitted",
                 "completed", "failed", "quota_rejects", "circuit_rejects",
                 "opens")

    def __init__(self, name: str):
        self.name = name
        self.tokens = max(qps_limit(), 1.0)   # start with a full bucket
        self.stamp = time.monotonic()
        self.inflight = 0
        self.consec = 0
        self.open_until: Optional[float] = None
        self.probing = False
        self.submitted = 0
        self.admitted = 0
        self.completed = 0
        self.failed = 0
        self.quota_rejects = 0
        self.circuit_rejects = 0
        self.opens = 0

    def circuit(self, now: float) -> str:
        if self.open_until is None:
            return "closed"
        if self.probing:
            return "half-open"
        return "open" if now < self.open_until else "half-open"


class TenantRegistry:
    """Process-global per-tenant state (one lock — claim/release are a
    few arithmetic ops; never held across I/O or other locks)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tenants: Dict[str, _TenantState] = {}

    def _state_locked(self, name: str) -> _TenantState:
        st = self._tenants.get(name)
        if st is None:
            st = _TenantState(name)
            self._tenants[name] = st
            _tel.REGISTRY.set_gauge("tenants_known", len(self._tenants))
        return st

    # -- admission ----------------------------------------------------------
    def claim(self, tenant: Optional[str]) -> Grant:
        """Claim one admission against ``tenant``'s quotas; raises the
        typed verdict (TenantCircuitOpen / TenantQuotaExceeded) or
        returns a Grant whose release the caller owes."""
        name = sanitize_tenant(tenant) or DEFAULT_TENANT
        now = time.monotonic()
        with self._lock:
            st = self._state_locked(name)
            st.submitted += 1
            _tel.inc("tenant_queries")
            # circuit breaker first: an open breaker rejects before any
            # token is spent, a half-open one admits exactly one probe
            probe = False
            if breaker_threshold() > 0 and st.open_until is not None:
                if now < st.open_until and not st.probing:
                    st.circuit_rejects += 1
                    _tel.inc("tenant_circuit_rejects")
                    raise TenantCircuitOpen(
                        f"tenant {name!r} circuit open "
                        f"({st.consec} consecutive failures); probing in "
                        f"{st.open_until - now:.1f} s",
                        retry_after_s=st.open_until - now)
                if st.probing:
                    # a probe is already in flight; keep rejecting until
                    # its verdict lands (quarantine half-open semantics)
                    st.circuit_rejects += 1
                    _tel.inc("tenant_circuit_rejects")
                    raise TenantCircuitOpen(
                        f"tenant {name!r} circuit half-open (probe in "
                        "flight)",
                        retry_after_s=max(st.open_until - now, 0.5))
                # expired: go half-open — this caller becomes THE probe,
                # the window is pushed out so concurrent claims reject
                st.open_until = now + breaker_probe_s()
                st.probing = True
                probe = True
                _tel.inc("tenant_circuit_probes")
            # token-bucket rate quota (burst = one second of tokens)
            qps = qps_limit()
            if qps > 0:
                cap = max(qps, 1.0)
                # max(elapsed, 0): a state created inside this call
                # stamped AFTER ``now`` was captured — the bucket must
                # not lose tokens to a negative refill
                st.tokens = min(st.tokens + max(now - st.stamp, 0.0) * qps,
                                cap)
                st.stamp = now
                if st.tokens < 1.0:
                    st.quota_rejects += 1
                    _tel.inc("tenant_quota_rejects")
                    raise TenantQuotaExceeded(
                        f"tenant {name!r} over rate quota "
                        f"({qps:g} qps)",
                        retry_after_s=(1.0 - st.tokens) / qps)
                st.tokens -= 1.0
            else:
                st.stamp = now
            # concurrency quota
            climit = concurrent_limit()
            if climit > 0 and st.inflight >= climit:
                st.quota_rejects += 1
                _tel.inc("tenant_quota_rejects")
                raise TenantQuotaExceeded(
                    f"tenant {name!r} at concurrency limit "
                    f"({st.inflight} >= {climit})", retry_after_s=1.0)
            st.inflight += 1
            st.admitted += 1
        return Grant(name, probe=probe)

    def release(self, grant: Optional[Grant],
                outcome: Optional[str] = None) -> None:
        """Return a grant.  ``outcome`` is ``"ok"`` / ``"fatal"`` /
        ``"timeout"`` / ``"error"`` for an executed query, or None for a
        claim that never executed a plan (DDL, pre-execution failure) —
        those feed neither the breaker nor the completion counts.
        Idempotent."""
        if grant is None or grant.released:
            return
        grant.released = True
        opened = False
        with self._lock:
            st = self._state_locked(grant.tenant)
            st.inflight = max(st.inflight - 1, 0)
            if outcome is None:
                return
            st.completed += 1
            if outcome == "ok":
                st.consec = 0
                if st.open_until is not None:
                    # clean probe (or a straggler admitted pre-trip that
                    # finished fine): close the breaker
                    st.open_until = None
                    st.probing = False
            elif outcome in ("fatal", "timeout"):
                st.failed += 1
                st.consec += 1
                thresh = breaker_threshold()
                if thresh > 0 and (grant.probe
                                   or (st.consec >= thresh
                                       and st.open_until is None)):
                    # trip (or re-arm after a failed probe) for the full
                    # TTL; the next claim past expiry goes half-open
                    st.open_until = time.monotonic() + breaker_ttl_s()
                    st.probing = False
                    st.opens += 1
                    opened = True
                    _tel.inc("tenant_circuit_opens")
            else:
                # user errors / transient verdicts do not trip (the
                # breaker watches fatal/timeout streaks), but a failed
                # probe of EITHER kind ends the probe window
                st.failed += 1
                if grant.probe:
                    st.probing = False
        if opened:
            logger.warning(
                "tenant %r circuit OPEN (%d consecutive fatal/timeout "
                "verdicts); rejecting for %.0f s", grant.tenant,
                breaker_threshold(), breaker_ttl_s())

    # -- introspection ------------------------------------------------------
    def rows(self) -> List[dict]:
        """One row per known tenant."""
        now = time.monotonic()
        with self._lock:
            return [{
                "tenant": st.name,
                "inflight": st.inflight,
                "tokens": round(st.tokens, 3),
                "submitted": st.submitted,
                "admitted": st.admitted,
                "completed": st.completed,
                "failed": st.failed,
                "quota_rejects": st.quota_rejects,
                "circuit_rejects": st.circuit_rejects,
                "circuit_opens": st.opens,
                "consecutive_failures": st.consec,
                "circuit": st.circuit(now),
            } for _, st in sorted(self._tenants.items())]

    def snapshot(self) -> dict:
        """Compact section for ``GET /v1/engine``."""
        now = time.monotonic()
        with self._lock:
            return {
                "enabled": True,
                "tenants": len(self._tenants),
                "inflight": sum(st.inflight
                                for st in self._tenants.values()),
                "open_circuits": sum(
                    1 for st in self._tenants.values()
                    if st.circuit(now) != "closed"),
            }

    def _reset_for_tests(self) -> None:
        with self._lock:
            self._tenants.clear()
            _tel.REGISTRY.set_gauge("tenants_known", 0)


_REGISTRY_LOCK = threading.Lock()
_REGISTRY: Optional[TenantRegistry] = None


def get_registry() -> TenantRegistry:
    global _REGISTRY
    with _REGISTRY_LOCK:
        if _REGISTRY is None:
            _REGISTRY = TenantRegistry()
        return _REGISTRY


def tenant_rows() -> List[dict]:
    return get_registry().rows()


# ---------------------------------------------------------------------------
# thread-local scopes + the one enforcement site
# ---------------------------------------------------------------------------

class _Tls(threading.local):
    tenant: Optional[str] = None     # explicit tenant name for this thread
    grant: Optional[Grant] = None    # server POST-time pre-claim
    active: bool = False             # an admission() scope is open


_tls = _Tls()


def current_tenant() -> Optional[str]:
    return _tls.tenant


@contextmanager
def tenant_scope(tenant: Optional[str]):
    """Install an explicit tenant name for this thread
    (``Context.sql(tenant=)``).  Invalid names raise ValueError — a user
    API must not silently coerce garbage into ``default``."""
    if tenant is not None and sanitize_tenant(tenant) is None:
        raise ValueError(
            f"invalid tenant name {tenant!r} (allowed: [A-Za-z0-9_-], "
            f"max {_MAX_TENANT_LEN} chars)")
    prev = _tls.tenant
    _tls.tenant = sanitize_tenant(tenant)
    try:
        yield
    finally:
        _tls.tenant = prev


@contextmanager
def grant_scope(grant: Optional[Grant]):
    """Install a server POST-time pre-claim for the worker thread;
    ``admission()`` consumes it exactly once (scheduler-seat pattern)."""
    prev_g, prev_t = _tls.grant, _tls.tenant
    _tls.grant = grant
    if grant is not None:
        _tls.tenant = grant.tenant
    try:
        yield
    finally:
        _tls.grant, _tls.tenant = prev_g, prev_t


def _classify_outcome(exc: BaseException) -> str:
    if isinstance(exc, FatalError):
        return "fatal"
    if isinstance(exc, (DeadlineExceeded, AdmissionTimeout)):
        return "timeout"
    return "error"


@contextmanager
def admission():
    """Enforce the tenant's quotas around one executing query plan — the
    single call site is ``Context._execute_query_plan``, wrapping the
    scheduler's admission (a tenant reject must not consume a scheduler
    slot or queue position).  Nested plans ride the outer claim; a server
    pre-claim (``grant_scope``) is adopted instead of re-claiming, so
    the POST-time token is the only token spent."""
    if _tls.active:
        yield None
        return
    grant, _tls.grant = _tls.grant, None    # consume the pre-claim once
    if grant is None:
        grant = get_registry().claim(_tls.tenant)   # may raise typed
    grant.consumed = True
    # stamp the tenant on the trace root (explicit tenants only) so the
    # QueryReport and the slow-query log carry it;
    # default-tenant queries leave every envelope byte-identical
    if grant.tenant != DEFAULT_TENANT:
        tr = _tel.current_trace()
        if tr is not None:
            tr.root.attrs.setdefault("tenant", grant.tenant)
    _tls.active = True
    outcome = "ok"
    try:
        yield grant
    except BaseException as e:
        outcome = _classify_outcome(e)
        raise
    finally:
        _tls.active = False
        get_registry().release(grant, outcome)
