"""Tenancy (``runtime/tenancy.py``) in the port, against the JAX package.

Every case of ``tests/unit/test_tenancy.py`` runs on both packages' modules
(``P.ten``, ``P.R``): identity sanitation, the token-bucket rate quota,
the concurrency quota, the circuit breaker's open / half-open / closed
cycle, ``admission()``'s single use of a server claim and its outcome
classes, and ``Context.sql(tenant=)`` on the report.  The wait for the
breaker's 0.1 s TTL sleeps in 0.05 s steps; the assertions are the JAX
package's, exact.
"""
from types import SimpleNamespace

import pytest

from dask_sql_tpu import Context as JaxContext
from dask_sql_tpu.runtime import resilience as jax_res
from dask_sql_tpu.runtime import tenancy as jax_ten
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.runtime import resilience as port_res
from dask_sql_tpu_torch.runtime import tenancy as port_ten

PKGS = {
    "jax": SimpleNamespace(ten=jax_ten, R=jax_res, Context=JaxContext,
                           kw={}),
    "port": SimpleNamespace(ten=port_ten, R=port_res, Context=Context,
                            kw={"device": "cpu"}),
}


@pytest.fixture(params=sorted(PKGS))
def P(request):
    pkg = PKGS[request.param]
    pkg.ten.get_registry()._reset_for_tests()
    yield pkg
    pkg.ten.get_registry()._reset_for_tests()


# ---------------------------------------------------------------------------
# identity
# ---------------------------------------------------------------------------

def test_sanitize_tenant_charset(P):
    assert P.ten.sanitize_tenant("acme-corp_01") == "acme-corp_01"
    # padding strips; the remainder is judged on its own
    assert P.ten.sanitize_tenant("  ok  ") == "ok"
    assert P.ten.sanitize_tenant("bad tenant") is None
    assert P.ten.sanitize_tenant("a/b") is None
    assert P.ten.sanitize_tenant("x" * 65) is None
    assert P.ten.sanitize_tenant("x" * 64) == "x" * 64
    assert P.ten.sanitize_tenant(None) is None
    assert P.ten.sanitize_tenant("") is None


def test_invalid_header_maps_to_default_tenant(P):
    g = P.ten.get_registry().claim("not a valid tenant!!")
    assert g.tenant == P.ten.DEFAULT_TENANT
    P.ten.get_registry().release(g)


def test_tenant_scope_rejects_garbage_loudly(P):
    with pytest.raises(ValueError):
        with P.ten.tenant_scope("no spaces allowed"):
            pass
    with P.ten.tenant_scope("fine-name"):
        assert P.ten.current_tenant() == "fine-name"
    assert P.ten.current_tenant() is None


# ---------------------------------------------------------------------------
# quotas
# ---------------------------------------------------------------------------

def test_unlimited_by_default(P):
    reg = P.ten.get_registry()
    grants = [reg.claim("t") for _ in range(50)]
    for g in grants:
        reg.release(g, "ok")
    rows = P.ten.tenant_rows()
    assert rows[0]["admitted"] == 50
    assert rows[0]["inflight"] == 0


def test_rate_quota_rejects_with_honest_retry_after(P, monkeypatch):
    monkeypatch.setenv("DSQL_TENANT_QPS", "2")
    reg = P.ten.get_registry()
    # burst = one second of tokens (2): the third claim in the same
    # instant must be over quota
    reg.release(reg.claim("r"), "ok")
    reg.release(reg.claim("r"), "ok")
    with pytest.raises(P.R.TenantQuotaExceeded) as ei:
        reg.claim("r")
    # the refill pace is 2 tokens/s -> a sub-second, non-zero hint
    assert 0.0 < ei.value.retry_after_s <= 0.5
    assert P.ten.tenant_rows()[0]["quota_rejects"] == 1


def test_rate_quota_is_per_tenant(P, monkeypatch):
    monkeypatch.setenv("DSQL_TENANT_QPS", "1")
    reg = P.ten.get_registry()
    reg.release(reg.claim("a"), "ok")
    with pytest.raises(P.R.TenantQuotaExceeded):
        reg.claim("a")
    # tenant b still has its own full bucket
    reg.release(reg.claim("b"), "ok")


def test_concurrency_quota(P, monkeypatch):
    monkeypatch.setenv("DSQL_TENANT_CONCURRENT", "2")
    reg = P.ten.get_registry()
    g1, g2 = reg.claim("c"), reg.claim("c")
    with pytest.raises(P.R.TenantQuotaExceeded):
        reg.claim("c")
    reg.release(g1, "ok")
    g3 = reg.claim("c")          # a released slot is claimable again
    reg.release(g2, "ok")
    reg.release(g3, "ok")
    assert P.ten.tenant_rows()[0]["inflight"] == 0


def test_release_is_idempotent(P):
    reg = P.ten.get_registry()
    g = reg.claim("i")
    reg.release(g, "ok")
    reg.release(g, "ok")
    assert P.ten.tenant_rows()[0]["inflight"] == 0
    assert P.ten.tenant_rows()[0]["completed"] == 1


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------

def _fail_n(reg, tenant, n, outcome="fatal"):
    for _ in range(n):
        reg.release(reg.claim(tenant), outcome)


def test_breaker_trips_on_consecutive_fatals(P, monkeypatch):
    monkeypatch.setenv("DSQL_TENANT_BREAKER", "3")
    monkeypatch.setenv("DSQL_TENANT_BREAKER_TTL_S", "30")
    reg = P.ten.get_registry()
    _fail_n(reg, "b", 3)
    row = P.ten.tenant_rows()[0]
    assert row["circuit"] == "open"
    assert row["circuit_opens"] == 1
    with pytest.raises(P.R.TenantCircuitOpen) as ei:
        reg.claim("b")
    assert ei.value.retry_after_s > 0
    assert P.ten.tenant_rows()[0]["circuit_rejects"] == 1


def test_breaker_needs_consecutive_failures(P, monkeypatch):
    monkeypatch.setenv("DSQL_TENANT_BREAKER", "3")
    reg = P.ten.get_registry()
    _fail_n(reg, "b", 2)
    reg.release(reg.claim("b"), "ok")      # streak broken
    _fail_n(reg, "b", 2)
    assert P.ten.tenant_rows()[0]["circuit"] == "closed"


def test_user_errors_do_not_trip(P, monkeypatch):
    monkeypatch.setenv("DSQL_TENANT_BREAKER", "2")
    reg = P.ten.get_registry()
    _fail_n(reg, "b", 5, outcome="error")
    assert P.ten.tenant_rows()[0]["circuit"] == "closed"


def test_breaker_half_open_single_probe_then_close(P, monkeypatch):
    """After the TTL the breaker goes half-open on the quarantine
    pattern: exactly ONE probe is admitted (concurrent claims keep
    rejecting while it is in flight); a clean probe closes the circuit,
    a failed one re-arms the full TTL."""
    monkeypatch.setenv("DSQL_TENANT_BREAKER", "2")
    monkeypatch.setenv("DSQL_TENANT_BREAKER_TTL_S", "0.1")
    monkeypatch.setenv("DSQL_TENANT_BREAKER_PROBE_S", "30")
    reg = P.ten.get_registry()
    _fail_n(reg, "h", 2)
    with pytest.raises(P.R.TenantCircuitOpen):
        reg.claim("h")
    import time
    for _ in range(3):                     # TTL expires -> half-open
        time.sleep(0.05)
    probe = reg.claim("h")                 # THE single probe
    assert probe.probe
    assert P.ten.tenant_rows()[0]["circuit"] == "half-open"
    with pytest.raises(P.R.TenantCircuitOpen):
        reg.claim("h")                     # probe in flight: still reject
    reg.release(probe, "ok")               # clean probe closes the circuit
    assert P.ten.tenant_rows()[0]["circuit"] == "closed"
    reg.release(reg.claim("h"), "ok")      # traffic flows again


def test_breaker_failed_probe_rearms(P, monkeypatch):
    monkeypatch.setenv("DSQL_TENANT_BREAKER", "2")
    monkeypatch.setenv("DSQL_TENANT_BREAKER_TTL_S", "0.1")
    monkeypatch.setenv("DSQL_TENANT_BREAKER_PROBE_S", "30")
    reg = P.ten.get_registry()
    _fail_n(reg, "h", 2)
    import time
    for _ in range(3):
        time.sleep(0.05)
    probe = reg.claim("h")
    monkeypatch.setenv("DSQL_TENANT_BREAKER_TTL_S", "60")
    reg.release(probe, "fatal")            # failed probe: full TTL again
    row = P.ten.tenant_rows()[0]
    assert row["circuit"] == "open"
    assert row["circuit_opens"] == 2
    with pytest.raises(P.R.TenantCircuitOpen):
        reg.claim("h")


def test_breaker_off_by_default(P):
    reg = P.ten.get_registry()
    _fail_n(reg, "never", 50)
    assert P.ten.tenant_rows()[0]["circuit"] == "closed"


# ---------------------------------------------------------------------------
# admission() scope
# ---------------------------------------------------------------------------

def test_admission_consumes_server_preclaim_exactly_once(P, monkeypatch):
    monkeypatch.setenv("DSQL_TENANT_QPS", "1")
    reg = P.ten.get_registry()
    grant = reg.claim("pre")               # spends the ONLY token
    with P.ten.grant_scope(grant):
        with P.ten.admission() as g:
            assert g is grant
            assert g.consumed
    # the pre-claim was adopted, not re-claimed: no second token spent,
    # and the grant was released with outcome "ok"
    row = P.ten.tenant_rows()[0]
    assert row["admitted"] == 1
    assert row["completed"] == 1
    assert row["inflight"] == 0


def test_admission_classifies_outcomes(P, monkeypatch):
    monkeypatch.setenv("DSQL_TENANT_BREAKER", "2")
    reg = P.ten.get_registry()

    def run(exc):
        with P.ten.tenant_scope("o"):
            with pytest.raises(type(exc)):
                with P.ten.admission():
                    raise exc

    run(P.R.FatalError("boom"))
    run(P.R.DeadlineExceeded("slow"))
    assert P.ten.tenant_rows()[0]["circuit"] == "open"
    reg._reset_for_tests()
    # user errors never feed the breaker
    run(ValueError("user"))
    run(ValueError("user"))
    run(ValueError("user"))
    assert P.ten.tenant_rows()[0]["circuit"] == "closed"
    assert P.ten.tenant_rows()[0]["failed"] == 3


def test_admission_nested_rides_outer_claim(P):
    with P.ten.tenant_scope("n"):
        with P.ten.admission():
            with P.ten.admission() as inner:
                assert inner is None       # nested: pass-through
    assert P.ten.tenant_rows()[0]["admitted"] == 1


def test_unconsumed_grant_release_feeds_nothing(P, monkeypatch):
    """A grant released without an outcome (DDL, pre-plan failure) frees
    its concurrency slot but neither completes nor fails the tenant."""
    monkeypatch.setenv("DSQL_TENANT_BREAKER", "1")
    reg = P.ten.get_registry()
    g = reg.claim("d")
    reg.release(g)                         # no outcome
    row = P.ten.tenant_rows()[0]
    assert row["inflight"] == 0
    assert row["completed"] == 0
    assert row["circuit"] == "closed"


def test_context_sql_tenant_stamps_report(P, monkeypatch):
    """Context.sql(tenant=...) flows the tenant onto the QueryReport (and
    from there the slow-query log / flight-recorder envelope); the
    default tenant stays OFF every envelope."""
    import pandas as pd

    c = P.Context(**P.kw)
    c.create_table("t", pd.DataFrame({"a": [1, 2, 3]}))
    c.sql("SELECT SUM(a) AS s FROM t", tenant="acme")
    assert c.last_report.tenant == "acme"
    assert c.last_report.to_dict()["tenant"] == "acme"
    c.sql("SELECT SUM(a) AS s FROM t")
    assert c.last_report.tenant is None
    rows = {r["tenant"]: r for r in P.ten.tenant_rows()}
    assert rows["acme"]["admitted"] == 1
    assert rows[P.ten.DEFAULT_TENANT]["admitted"] >= 1
