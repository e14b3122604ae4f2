"""The workload manager (``runtime/scheduler.py``) in the port, against the
JAX package.

- Every case of ``tests/unit/test_scheduler_unit.py`` on both packages'
  modules (``P.sched``, ``P.res``, ``P.rc``, ``P.tel``, ``P.faults``):
  admission bounds and counters, queue full and queue timeout, deadline
  and cancellation while queued, the deficit-weighted pick with aging,
  seats, the ledger with the result cache as its tenant, over-reservation,
  the estimator, nested admission, the ``admission`` fault site, the
  backoff-free hold-time EWMA and drain.  One wait that the JAX package's
  file sleeps in one 0.15 s step sleeps in 0.05 s steps here.
- One arrival script through ``_pick_locked`` at a fixed clock: the pick
  order equals the JAX manager's.
- ``estimate_plan_bytes`` and ``estimate_working_set`` (the heuristic and
  the statistics rungs) equal the JAX package's on TPC-H Q1-Q22 at SF
  0.003 over the same tables, byte for byte.
- ``Context.sql`` under a limit of 1: every query passes admission (a
  ``queued`` span, its priority on the report), and CTAS, EXECUTE and
  EXPLAIN ANALYZE, whose plans nest inside a statement, finish.
"""
import threading
import time
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest

from benchmarks.tpch import QUERIES, generate_tpch
from dask_sql_tpu import Context as JaxContext
from dask_sql_tpu.runtime import faults as jax_faults
from dask_sql_tpu.runtime import resilience as jax_res
from dask_sql_tpu.runtime import result_cache as jax_rc
from dask_sql_tpu.runtime import scheduler as jax_sched
from dask_sql_tpu.runtime import telemetry as jax_tel
from dask_sql_tpu.sql.parser import parse_sql as jax_parse
from dask_sql_tpu.table import Table as JaxTable
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.runtime import faults as port_faults
from dask_sql_tpu_torch.runtime import resilience as port_res
from dask_sql_tpu_torch.runtime import result_cache as port_rc
from dask_sql_tpu_torch.runtime import scheduler as port_sched
from dask_sql_tpu_torch.runtime import telemetry as port_tel
from dask_sql_tpu_torch.sql.parser import parse_sql as port_parse
from dask_sql_tpu_torch.table import Table as PortTable

PKGS = {
    "jax": SimpleNamespace(
        sched=jax_sched, res=jax_res, rc=jax_rc, tel=jax_tel,
        faults=jax_faults, Context=JaxContext, kw={}, parse=jax_parse,
        table=lambda data: JaxTable.from_pydict(data)),
    "port": SimpleNamespace(
        sched=port_sched, res=port_res, rc=port_rc, tel=port_tel,
        faults=port_faults, Context=Context, kw={"device": "cpu"},
        parse=port_parse,
        table=lambda data: PortTable.from_pydict(data, "cpu")),
}


@pytest.fixture(params=sorted(PKGS))
def P(request):
    return PKGS[request.param]


@pytest.fixture()
def mgr(P, monkeypatch):
    """A fresh manager: 1 slot, small queue, fast timeout, broker off."""
    monkeypatch.setenv("DSQL_MAX_CONCURRENT_QUERIES", "1")
    monkeypatch.setenv("DSQL_QUEUE_DEPTH", "2")
    monkeypatch.setenv("DSQL_QUEUE_TIMEOUT_MS", "60000")
    monkeypatch.setenv("DSQL_DEVICE_BUDGET_MB", "0")
    return P.sched.WorkloadManager()


def _table(P, n_rows: int):
    return P.table({"a": np.zeros(n_rows, dtype=np.int64)})


def _counter_delta(P, fn, *names):
    before = {n: P.tel.REGISTRY.get(n) for n in names}
    fn()
    return {n: P.tel.REGISTRY.get(n) - before[n] for n in names}


# ---------------------------------------------------------------------------
# enable/disable + basic admission
# ---------------------------------------------------------------------------

def test_disabled_at_zero(P, monkeypatch):
    monkeypatch.setenv("DSQL_MAX_CONCURRENT_QUERIES", "0")
    m = P.sched.WorkloadManager()
    assert not m.enabled()
    assert m.claim_seat("interactive") is None
    with m.admission() as ticket:
        assert ticket is None


def test_immediate_admission_and_release(P, mgr):
    t = mgr.acquire("interactive", 0)
    assert t.admitted and mgr.running_count() == 1
    assert t.queued_ms is not None and t.queued_ms >= 0
    mgr.release(t)
    assert mgr.running_count() == 0
    # double release is a no-op
    mgr.release(t)
    assert mgr.running_count() == 0


def test_admission_counters_reconcile(P, mgr):
    def run():
        t = mgr.acquire("batch", 0)
        mgr.release(t)
    d = _counter_delta(P, run, "sched_admitted_batch", "sched_rejected_batch",
                       "sched_timeout_batch")
    assert d == {"sched_admitted_batch": 1, "sched_rejected_batch": 0,
                 "sched_timeout_batch": 0}


def test_queue_full_rejects(P, mgr):
    holder = mgr.acquire("interactive", 0)
    admitted = []

    def wait(i):
        t = mgr.acquire("interactive", 0)
        admitted.append(i)
        mgr.release(t)         # pass the slot on so every waiter drains

    threads = [threading.Thread(target=wait, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    deadline = time.time() + 5
    while mgr.queue_depth() < 2 and time.time() < deadline:
        time.sleep(0.01)
    assert mgr.queue_depth() == 2
    # slot busy + depth(2) full -> immediate typed rejection
    with pytest.raises(P.res.AdmissionRejected) as exc:
        mgr.acquire("interactive", 0)
    assert exc.value.retry_after_s >= 0
    assert exc.value.error_type == "INSUFFICIENT_RESOURCES"
    mgr.release(holder)
    for t in threads:
        t.join(timeout=5)
    assert sorted(admitted) == [0, 1]
    assert mgr.running_count() == 0


def test_queue_timeout(P, mgr, monkeypatch):
    monkeypatch.setenv("DSQL_QUEUE_TIMEOUT_MS", "80")
    holder = mgr.acquire("interactive", 0)
    t0 = time.monotonic()
    with pytest.raises(P.res.AdmissionTimeout):
        mgr.acquire("interactive", 0)
    assert time.monotonic() - t0 < 5.0
    assert mgr.queue_depth() == 0        # the abandoned waiter left no ghost
    mgr.release(holder)


def test_timeout_counter_keeps_reconciliation(P, mgr, monkeypatch):
    monkeypatch.setenv("DSQL_QUEUE_TIMEOUT_MS", "50")
    holder = mgr.acquire("background", 0)

    def run():
        with pytest.raises(P.res.AdmissionTimeout):
            mgr.acquire("background", 0)

    d = _counter_delta(P, run, "sched_timeout_background",
                       "sched_admitted_background")
    assert d["sched_timeout_background"] == 1
    assert d["sched_admitted_background"] == 0
    mgr.release(holder)


def test_deadline_expiry_rejects_before_enqueue(P, mgr):
    holder = mgr.acquire("interactive", 0)
    # seed the hold-time EWMA: the only admitted query "ran" ~10 s
    mgr._run_ewma_s = 10.0
    with P.res.query_scope(timeout_s=0.2):
        with pytest.raises(P.res.AdmissionRejected) as exc:
            mgr.acquire("interactive", 0)
    assert "deadline" in str(exc.value)
    mgr.release(holder)


def test_no_deadline_rejection_without_history(P, mgr, monkeypatch):
    """Without an EWMA there is no estimate — never reject on a guess; the
    queued wait itself still honours the deadline via resilience.check."""
    monkeypatch.setenv("DSQL_QUEUE_TIMEOUT_MS", "60000")
    holder = mgr.acquire("interactive", 0)
    assert mgr._run_ewma_s is None
    with P.res.query_scope(timeout_s=0.1):
        with pytest.raises(P.res.DeadlineExceeded):
            mgr.acquire("interactive", 0)
    mgr.release(holder)


def test_queued_wait_honors_cancellation(P, mgr):
    holder = mgr.acquire("interactive", 0)
    cancel = threading.Event()
    err = []

    def wait():
        try:
            with P.res.query_scope(cancel=cancel):
                mgr.acquire("interactive", 0)
        except BaseException as e:   # noqa: BLE001 - recording the verdict
            err.append(e)

    t = threading.Thread(target=wait)
    t.start()
    deadline = time.time() + 5
    while mgr.queue_depth() < 1 and time.time() < deadline:
        time.sleep(0.01)
    cancel.set()
    t.join(timeout=5)
    assert err and isinstance(err[0], P.res.QueryCancelled)
    mgr.release(holder)


# ---------------------------------------------------------------------------
# priority ordering + aging
# ---------------------------------------------------------------------------

def _run_contended(mgr, submissions):
    """Occupy the single slot, enqueue ``submissions`` [(priority, tag)],
    then release and record admission order."""
    holder = mgr.acquire("background", 0)
    order, lock = [], threading.Lock()

    def go(priority, tag):
        t = mgr.acquire(priority, 0)
        with lock:
            order.append(tag)
        time.sleep(0.01)
        mgr.release(t)

    threads = []
    for priority, tag in submissions:
        th = threading.Thread(target=go, args=(priority, tag))
        th.start()
        threads.append(th)
        # deterministic enqueue order
        deadline = time.time() + 5
        while mgr.queue_depth() < len(threads) and time.time() < deadline:
            time.sleep(0.005)
    mgr.release(holder)
    for th in threads:
        th.join(timeout=10)
    return order


def test_interactive_beats_batch(P, mgr, monkeypatch):
    monkeypatch.setenv("DSQL_QUEUE_DEPTH", "8")
    order = _run_contended(mgr, [("batch", "b1"), ("batch", "b2"),
                                 ("interactive", "i1"),
                                 ("interactive", "i2")])
    assert len(order) == 4
    # the first grant after the slot frees goes to the interactive class
    # even though both batch queries enqueued first
    assert order[0] == "i1"


def test_weighted_interleave_serves_both(P, mgr, monkeypatch):
    monkeypatch.setenv("DSQL_QUEUE_DEPTH", "8")
    order = _run_contended(mgr, [("batch", "b1"), ("interactive", "i1"),
                                 ("batch", "b2"), ("interactive", "i2")])
    # deficit-weighted, not absolute: batch is served within the window,
    # not starved until interactive drains
    assert order.index("b1") < 3


def test_pick_is_starvation_free(P, mgr):
    """White-box DWRR check: under a standing interactive queue, the
    background head must still win within a bounded number of rounds
    (deficit carry + aging boost)."""
    now = time.monotonic()
    for _ in range(50):
        mgr._waiting["interactive"].append(
            P.sched.Ticket("interactive", 0, now))
    mgr._waiting["background"].append(P.sched.Ticket("background", 0, now))
    picks = [mgr._pick_locked() for _ in range(12)]
    assert "background" in picks
    # service is weighted: interactive dominates the window
    assert picks.count("interactive") > picks.count("background")
    for q in mgr._waiting.values():
        q.clear()


def test_aging_boost_promotes_old_waiter(P, mgr, monkeypatch):
    monkeypatch.setenv("DSQL_QUEUE_AGING_MS", "100")
    now = time.monotonic()
    # a background query that has waited 2 s (20 aging units) outranks a
    # fresh interactive arrival (weight 8) on the very first pick
    mgr._waiting["background"].append(
        P.sched.Ticket("background", 0, now - 2.0))
    mgr._waiting["interactive"].append(
        P.sched.Ticket("interactive", 0, now))
    assert mgr._pick_locked() == "background"
    for q in mgr._waiting.values():
        q.clear()


# ---------------------------------------------------------------------------
# seats (the server's POST-time pre-claims)
# ---------------------------------------------------------------------------

def test_seat_claim_bounds_and_release(P, mgr):
    holder = mgr.acquire("interactive", 0)
    s1 = mgr.claim_seat("interactive")
    s2 = mgr.claim_seat("interactive")
    assert mgr.queue_depth() == 2
    # 1 running + 0 waiting + 2 seats == limit(1) + depth(2): full
    with pytest.raises(P.res.AdmissionRejected):
        mgr.claim_seat("interactive")
    mgr.release_seat(s1)
    assert mgr.queue_depth() == 1
    # releasing twice is a no-op
    mgr.release_seat(s1)
    assert mgr.queue_depth() == 1
    mgr.release_seat(s2)
    mgr.release(holder)


def test_seat_transfers_enqueue_timestamp(P, mgr):
    seat = mgr.claim_seat("batch")
    time.sleep(0.05)
    t = mgr.acquire("batch", 0, seat=seat)
    assert seat.consumed
    assert mgr.queue_depth() == 0
    # queue time is measured from the seat claim, not the acquire call
    assert t.queued_ms >= 40
    mgr.release(t)


# ---------------------------------------------------------------------------
# memory broker: ledger arithmetic + cache tenancy
# ---------------------------------------------------------------------------

def test_ledger_reserve_release(P, monkeypatch):
    monkeypatch.setenv("DSQL_DEVICE_BUDGET_MB", "1")     # 1 MiB
    monkeypatch.setenv("DSQL_RESULT_CACHE_MB", "0")
    ledger = P.sched.MemoryLedger(cache_fn=P.rc.ResultCache)
    got = ledger.reserve(512 * 1024)
    assert got == 512 * 1024
    # over-reservation fails (queues at the manager) instead of going
    # negative
    assert ledger.reserve(768 * 1024) is None
    ledger.release(got)
    assert ledger.reserved_bytes() == 0
    # estimates larger than the whole budget clamp so a lone query runs
    assert ledger.reserve(10 * 2**20) == 2**20
    ledger.release(2**20)


def test_ledger_disabled_at_zero(P, monkeypatch):
    monkeypatch.setenv("DSQL_DEVICE_BUDGET_MB", "0")
    ledger = P.sched.MemoryLedger(cache_fn=P.rc.ResultCache)
    assert ledger.reserve(1 << 40) == 0      # admission-only mode
    assert ledger.reserved_bytes() == 0


def test_reservation_shrinks_cache_tenant(P, monkeypatch):
    monkeypatch.setenv("DSQL_DEVICE_BUDGET_MB", "1")
    monkeypatch.setenv("DSQL_RESULT_CACHE_MB", "1")
    monkeypatch.setenv("DSQL_RESULT_CACHE_HOST_MB", "4")
    cache = P.rc.ResultCache()
    ledger = P.sched.MemoryLedger(cache_fn=lambda: cache)
    # ~0.75 MiB resident in the cache's device tier
    cache.put(P.rc.CacheKey("k1", ()), _table(P, 48 * 1024))
    cache.put(P.rc.CacheKey("k2", ()), _table(P, 48 * 1024))
    resident = cache.device_bytes
    assert resident > 512 * 1024
    # a 0.75 MiB reservation cannot fit next to it: the cache must spill
    got = ledger.reserve(768 * 1024)
    assert got == 768 * 1024
    assert cache.device_bytes <= 2**20 - 768 * 1024
    # the displaced entries moved to host, they were not destroyed
    assert cache.host_bytes > 0
    assert cache.get(P.rc.CacheKey("k1", ())) is not None
    ledger.release(got)
    cache.clear()


def test_shrink_device_to_drops_when_host_full(P, monkeypatch):
    monkeypatch.setenv("DSQL_RESULT_CACHE_MB", "4")
    monkeypatch.setenv("DSQL_RESULT_CACHE_HOST_MB", "0")
    cache = P.rc.ResultCache()
    cache.put(P.rc.CacheKey("k1", ()), _table(P, 1024))
    assert cache.device_bytes > 0
    freed = cache.shrink_device_to(0)
    assert freed > 0
    assert cache.device_bytes == 0 and cache.host_bytes == 0


def test_cache_device_budget_is_ledger_tenant(P, monkeypatch):
    """With the global manager armed, the cache's effective device budget
    shrinks to the ledger headroom — but liveness (enabled) follows the
    BASE budget, so pressure never clears the whole cache."""
    monkeypatch.setenv("DSQL_MAX_CONCURRENT_QUERIES", "2")
    monkeypatch.setenv("DSQL_DEVICE_BUDGET_MB", "1")
    monkeypatch.setenv("DSQL_RESULT_CACHE_MB", "64")
    cache = P.rc.ResultCache()
    mgr = P.sched.get_manager()
    assert cache.device_budget() == 2**20         # min(64 MiB, 1 MiB free)
    got = mgr.ledger.reserve(512 * 1024)
    try:
        assert cache.device_budget() == 512 * 1024
        assert cache.enabled()
    finally:
        mgr.ledger.release(got)


def test_over_reservation_queues_until_release(P, mgr, monkeypatch):
    monkeypatch.setenv("DSQL_MAX_CONCURRENT_QUERIES", "2")
    monkeypatch.setenv("DSQL_DEVICE_BUDGET_MB", "1")
    t1 = mgr.acquire("interactive", 800 * 1024)
    assert t1.reserved_bytes == 800 * 1024
    admitted = []

    def wait():
        # fits the slot count (2) but not the ledger: must queue, not crash
        t2 = mgr.acquire("interactive", 800 * 1024)
        admitted.append(t2)

    th = threading.Thread(target=wait)
    th.start()
    for _ in range(3):
        time.sleep(0.05)
    assert not admitted and mgr.queue_depth() == 1
    mgr.release(t1)                     # frees the ledger -> dispatch
    th.join(timeout=5)
    assert admitted and admitted[0].reserved_bytes == 800 * 1024
    mgr.release(admitted[0])


# ---------------------------------------------------------------------------
# working-set estimator + admission context manager
# ---------------------------------------------------------------------------

def test_estimate_plan_bytes_scales_with_operators(P):
    import pandas as pd

    c = P.Context(**P.kw)
    c.create_table("t", pd.DataFrame({"a": np.arange(10_000),
                                      "b": np.arange(10_000) * 1.5}))

    def est(sql):
        plan = c._get_plan(P.parse(sql)[0].query, sql)
        return P.sched.estimate_plan_bytes(plan, c)

    floor = P.sched._MIN_ESTIMATE
    scan = est("SELECT a, b FROM t") - floor
    agg = est("SELECT a, SUM(b) FROM t GROUP BY a") - floor
    join = est("SELECT x.a FROM t x, t y WHERE x.a = y.a") - floor
    assert scan >= 10_000 * 16
    assert agg > scan            # aggregate multiplier
    assert join > 2 * scan       # two scans x join multiplier


def test_admission_nested_rides_outer_slot(P, mgr):
    with mgr.admission(priority="interactive") as outer:
        assert outer is not None
        assert mgr.running_count() == 1
        with mgr.admission(priority="interactive") as inner:
            assert inner is None          # nested plan: no second slot
            assert mgr.running_count() == 1
    assert mgr.running_count() == 0


def test_admission_fault_site(P, mgr):
    with P.faults.inject("admission:1"):
        with pytest.raises(P.faults.FaultInjected):
            with mgr.admission(priority="batch"):
                pass  # pragma: no cover - admission raised
    # the fault consumed no slot and the next admission works
    assert mgr.running_count() == 0 and mgr.queue_depth() == 0
    with mgr.admission(priority="batch") as t:
        assert t is not None


# ---------------------------------------------------------------------------
# telemetry contract additions
# ---------------------------------------------------------------------------

def test_sched_names_in_stable_contract(P):
    for name in ("sched_admitted_interactive", "sched_admitted_batch",
                 "sched_admitted_background", "sched_rejected_interactive",
                 "sched_rejected_batch", "sched_rejected_background",
                 "sched_timeout_interactive", "sched_timeout_batch",
                 "sched_timeout_background", "fault_admission",
                 "server_throttled"):
        assert name in P.tel.STABLE_COUNTERS
    for name in ("sched_queue_depth", "sched_running",
                 "sched_reserved_bytes"):
        assert name in P.tel.STABLE_GAUGES


def test_gauges_track_queue_and_running(P, mgr):
    t = mgr.acquire("interactive", 0)
    assert P.tel.REGISTRY.get_gauge("sched_running") == 1
    mgr.release(t)
    assert P.tel.REGISTRY.get_gauge("sched_running") == 0


# ---------------------------------------------------------------------------
# honest hold-time EWMA: retry/backoff sleep must not inflate the
# queue-wait estimate (and thereby trigger spurious deadline fast-rejects)
# ---------------------------------------------------------------------------

def test_release_subtracts_recorded_backoff(P, mgr):
    t = mgr.acquire("interactive", 0)
    time.sleep(0.05)
    # pretend nearly the whole hold was retry-backoff sleep
    t.backoff_s = 10.0
    mgr.release(t)
    assert mgr._run_ewma_s is not None
    assert mgr._run_ewma_s < 0.05, (
        f"EWMA {mgr._run_ewma_s} still counts backoff sleep")


def test_admission_threads_runtime_backoff_into_ewma(P, mgr, monkeypatch):
    """End-to-end through the real path: an in-rung retry backoff inside
    an admitted query's scope is recorded on the QueryRuntime
    (resilience.backoff) and subtracted at release."""
    monkeypatch.setenv("DSQL_RETRY_BASE_MS", "150")
    with P.res.query_scope():
        with mgr.admission(priority="interactive") as t:
            assert t is not None
            P.res.backoff(1, "test-site")       # ~150 ms asleep in the slot
    assert mgr._run_ewma_s is not None
    assert mgr._run_ewma_s < 0.1, (
        f"EWMA {mgr._run_ewma_s} inflated by retry backoff")


def test_backoff_outside_admission_does_not_leak(P, mgr, monkeypatch):
    """Backoff spent BEFORE admission (e.g. while a previous statement of
    the same query retried) must not be charged to this slot."""
    monkeypatch.setenv("DSQL_RETRY_BASE_MS", "80")
    with P.res.query_scope():
        P.res.backoff(1, "pre-admission")
        with mgr.admission(priority="batch") as t:
            time.sleep(0.05)
            assert t is not None
    # hold was ~50 ms of real work; pre-admission backoff not subtracted
    assert 0.02 < mgr._run_ewma_s < 0.5


# ---------------------------------------------------------------------------
# drain mode
# ---------------------------------------------------------------------------

def test_drain_rejects_new_admissions_typed(P, mgr):
    mgr.begin_drain()
    try:
        assert mgr.draining()
        assert P.tel.REGISTRY.get_gauge("server_draining") == 1
        with pytest.raises(P.res.ServerDraining) as exc:
            mgr.acquire("interactive", 0)
        assert exc.value.retry_after_s > 0
        with pytest.raises(P.res.ServerDraining):
            mgr.claim_seat("batch")
    finally:
        mgr.end_drain()
    assert not mgr.draining()
    assert P.tel.REGISTRY.get_gauge("server_draining") == 0
    # back to normal service
    t = mgr.acquire("interactive", 0)
    mgr.release(t)


def test_drain_rejections_reconcile_counters(P, mgr):
    mgr.begin_drain()
    try:
        def run():
            with pytest.raises(P.res.ServerDraining):
                mgr.acquire("background", 0)
        d = _counter_delta(P, run, "sched_rejected_background",
                           "sched_admitted_background")
        assert d["sched_rejected_background"] == 1
        assert d["sched_admitted_background"] == 0
    finally:
        mgr.end_drain()


def test_inflight_query_survives_drain(P, mgr):
    """Draining refuses NEW work; an already-admitted query keeps its slot
    and releases normally."""
    t = mgr.acquire("interactive", 0)
    mgr.begin_drain()
    try:
        assert mgr.running_count() == 1
        with pytest.raises(P.res.ServerDraining):
            mgr.acquire("interactive", 0)
        mgr.release(t)
        assert mgr.running_count() == 0
    finally:
        mgr.end_drain()


def test_drain_independent_of_enabled(P, monkeypatch):
    """A draining process refuses new work even with the scheduler
    subsystem off (the server's POST gate relies on this)."""
    monkeypatch.setenv("DSQL_MAX_CONCURRENT_QUERIES", "0")
    m = P.sched.WorkloadManager()
    m.begin_drain()
    try:
        assert m.draining()
        with pytest.raises(P.res.ServerDraining):
            m.claim_seat("interactive")
    finally:
        m.end_drain()


# ---------------------------------------------------------------------------
# one arrival script, both pickers
# ---------------------------------------------------------------------------

ARRIVALS = [("batch", 0.0), ("interactive", 0.1), ("background", 0.2),
            ("interactive", 0.3), ("batch", 0.4), ("interactive", 0.5),
            ("background", 0.6), ("interactive", 0.7), ("batch", 0.8),
            ("interactive", 0.9), ("interactive", 1.0), ("batch", 1.1)]


def _pick_order(P, monkeypatch):
    monkeypatch.setenv("DSQL_QUEUE_AGING_MS", "500")
    clock = SimpleNamespace(monotonic=lambda: 100.0)
    monkeypatch.setattr(P.sched, "time", clock)
    m = P.sched.WorkloadManager()
    for i, (priority, at) in enumerate(ARRIVALS):
        t = P.sched.Ticket(priority, 0, 100.0 - 5.0 + at)
        t.est_bytes = i
        m._waiting[priority].append(t)
    order = []
    while True:
        k = m._pick_locked()
        if k is None:
            break
        order.append(m._waiting[k].popleft().est_bytes)
        if not m._waiting[k]:
            m._deficit[k] = 0.0
    return order


def test_pick_order_equal_jax(monkeypatch):
    got = {name: _pick_order(P, monkeypatch) for name, P in PKGS.items()}
    assert got["port"] == got["jax"]
    assert sorted(got["port"]) == list(range(len(ARRIVALS)))


# ---------------------------------------------------------------------------
# the estimator on TPC-H, both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tpch_both():
    data = generate_tpch(0.003)
    jc, pc = JaxContext(), Context(device="cpu")
    for name, frame in data.items():
        jc.create_table(name, frame)
        pc.create_table(name, frame)
    return {"jax": jc, "port": pc}


@pytest.mark.parametrize("adaptive", ["0", "1"])
@pytest.mark.parametrize("qid", range(1, 23))
def test_estimates_equal_jax(tpch_both, monkeypatch, qid, adaptive):
    monkeypatch.setenv("DSQL_ADAPTIVE", adaptive)
    got = {}
    for name, P in PKGS.items():
        ctx = tpch_both[name]
        plan = ctx._get_plan(P.parse(QUERIES[qid])[0].query, QUERIES[qid])
        got[name] = (P.sched.estimate_plan_bytes(plan, ctx),
                     P.sched.estimate_working_set(plan, ctx))
    assert got["port"] == got["jax"]
    assert got["port"][1][1] == ("stats" if adaptive == "1"
                                 else "heuristic") or qid in (13, 15, 22)


# ---------------------------------------------------------------------------
# Context.sql through admission
# ---------------------------------------------------------------------------

def test_context_queries_pass_admission(monkeypatch):
    monkeypatch.setenv("DSQL_MAX_CONCURRENT_QUERIES", "1")
    ctx = Context(device="cpu")
    ctx.create_table("t", {"a": np.arange(10), "b": np.arange(10.0)})
    before = port_tel.REGISTRY.counters()
    ctx.sql("SELECT SUM(b) AS s FROM t")
    assert ctx.last_report.priority == "interactive"
    assert ctx.last_report.span_count("queued") == 1
    ctx.sql("SELECT SUM(b) AS s FROM t", priority="batch")
    assert ctx.last_report.priority == "batch"
    after = port_tel.REGISTRY.counters()
    assert after["sched_admitted_interactive"] - \
        before["sched_admitted_interactive"] == 1
    assert after["sched_admitted_batch"] - before["sched_admitted_batch"] == 1
    with pytest.raises(ValueError):
        ctx.sql("SELECT 1", priority="urgent")
    monkeypatch.setenv("DSQL_MAX_CONCURRENT_QUERIES", "0")
    ctx.sql("SELECT SUM(b) AS s FROM t")
    assert ctx.last_report.priority is None


def test_nested_plans_take_no_slot(monkeypatch):
    """Under one slot, the statements whose plan runs inside the statement
    (CTAS, EXECUTE, EXPLAIN ANALYZE) finish instead of waiting for a slot
    their own statement holds."""
    monkeypatch.setenv("DSQL_MAX_CONCURRENT_QUERIES", "1")
    monkeypatch.setenv("DSQL_QUEUE_TIMEOUT_MS", "5000")
    ctx = Context(device="cpu")
    ctx.create_table("t", {"a": np.arange(10), "b": np.arange(10.0)})
    out, err = [], []

    def run():
        try:
            ctx.sql("CREATE TABLE u AS SELECT a, b * 2 AS c FROM t")
            out.append(ctx.sql("SELECT SUM(c) AS s FROM u").to_pylist())
            ctx.sql("PREPARE p AS SELECT SUM(b) AS s FROM t WHERE a > ?")
            out.append(ctx.sql("EXECUTE p (4)").to_pylist())
            out.append(len(ctx.sql("EXPLAIN ANALYZE SELECT a FROM u")
                           .to_pylist()))
        except BaseException as e:   # noqa: BLE001 - reported below
            err.append(e)

    th = threading.Thread(target=run)
    th.start()
    th.join(timeout=60)
    assert not th.is_alive() and not err, err
    assert out[0] == [[90.0]] and out[1] == [[35.0]] and out[2] > 2
    assert port_sched.get_manager().running_count() == 0
