"""The compiled tier's failure handling in the port: the error taxonomy
(``runtime/resilience.py``), fault injection (``runtime/faults.py``),
deadlines, the compile-error ladder (whole program, then stages, then
eager) and the quarantine store with its watchdog
(``runtime/quarantine.py``), on the CPU.

- ``classify`` on torch and CUDA exceptions, and equal to the JAX
  package's on the exceptions both know; ``parse_spec`` equal to the JAX
  package's.
- Deadlines: ``Context.sql(timeout=)``, ``DSQL_QUERY_TIMEOUT_MS``, nested
  scopes, the eager executor's checkpoint.
- The ladder: transient retries in place, whole -> stages -> eager, a
  fatal verdict exiled, ``DSQL_EAGER_FALLBACK=0`` surfacing the typed
  error, a sticky CUDA error surfacing always, the compile backoff and
  the dedupe of concurrent builds.
- The three stage-replay cases and the three quarantine/watchdog cases of
  ``tests/integration/test_failure_domains.py``; the second process of
  the cross-process case is a subprocess.
"""
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pandas as pd
import pytest
import torch

import dask_sql_tpu.runtime.faults as jax_faults
import dask_sql_tpu.runtime.resilience as jax_res
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.physical import compiled
from dask_sql_tpu_torch.runtime import faults
from dask_sql_tpu_torch.runtime import quarantine as Q
from dask_sql_tpu_torch.runtime import resilience as R

ROOT = Path(__file__).resolve().parents[1]

AGG_Q = "SELECT user_id, SUM(b) AS sb FROM user_table_1 GROUP BY user_id"
JOIN_Q = ("SELECT u1.user_id, SUM(u2.c) AS s FROM user_table_1 u1 "
          "JOIN user_table_2 u2 ON u1.user_id = u2.user_id "
          "GROUP BY u1.user_id")
# two heavy nodes, each of which compiles as a stage of its own
DIM_Q = ("SELECT x.user_id, x.s, d.w FROM (SELECT user_id, SUM(b) AS s "
         "FROM user_table_1 GROUP BY user_id) x "
         "JOIN dim d ON x.user_id = d.user_id")


def _fresh_process():
    """Every in-memory verdict and program dies; files survive."""
    compiled._cache.clear()
    compiled._learned_caps.clear()
    compiled._runtime_eager.clear()


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    _fresh_process()
    faults.reset()
    monkeypatch.setenv("DSQL_RETRY_BASE_MS", "1")
    monkeypatch.delenv("DSQL_QUARANTINE_FILE", raising=False)
    monkeypatch.delenv("DSQL_COMPILE_WATCHDOG_S", raising=False)
    monkeypatch.delenv("DSQL_EAGER_FALLBACK", raising=False)
    yield
    faults.reset()


@pytest.fixture()
def c(user_table_1, user_table_2):
    ctx = Context(device="cpu")
    ctx.create_table("user_table_1", user_table_1)
    ctx.create_table("user_table_2", user_table_2)
    ctx.create_table("dim", pd.DataFrame({"user_id": [1, 2, 3, 4],
                                          "w": [10, 20, 30, 40]}))
    return ctx


def _eager(ctx, query) -> pd.DataFrame:
    os.environ["DSQL_COMPILE"] = "0"
    try:
        return ctx.sql(query, return_futures=False)
    finally:
        del os.environ["DSQL_COMPILE"]


def _same(got: pd.DataFrame, want: pd.DataFrame):
    cols = list(want.columns)
    pd.testing.assert_frame_equal(
        got.sort_values(cols, ignore_index=True),
        want.sort_values(cols, ignore_index=True), check_dtype=False)


def _tier(ctx) -> str:
    tier = None
    for s in ctx.last_report.root.walk():
        tier = s.attrs.get("tier", tier)
    return tier


def _delta(before: dict, *names) -> dict:
    return {k: compiled.stats.get(k, 0) - before.get(k, 0) for k in names}


# ---------------------------------------------------------------------------
# the taxonomy
# ---------------------------------------------------------------------------

CLASSIFIED = [
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                                 "2.00 GiB"), R.TransientError, "oom"),
    (RuntimeError("CUDA error: out of memory"), R.TransientError, "oom"),
    (MemoryError(), R.TransientError, "oom"),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     R.DeviceLost, None),
    (RuntimeError("CUDA error: unspecified launch failure"), R.DeviceLost,
     None),
    (RuntimeError("CUDA error: device-side assert triggered"), R.DeviceLost,
     None),
    (RuntimeError("segsum_fixedpoint launch failed: CUDA error 700"),
     R.DeviceLost, None),
    (RuntimeError("CUDA error: operation not permitted when stream is "
                  "capturing"), R.FatalError, None),
    (RuntimeError("CUDA error: cudaErrorStreamCaptureInvalidated"),
     R.FatalError, None),
    (RuntimeError("segsum_fixedpoint launch failed: CUDA error 901"),
     R.FatalError, None),
    (RuntimeError("CUDA error: invalid argument"), R.FatalError, None),
    (OSError("disk"), R.TransientError, "io"),
    (ConnectionError("reset"), R.TransientError, "io"),
    (ValueError("bad"), R.FatalError, None),
]


@pytest.mark.parametrize("exc,cls,kind", CLASSIFIED,
                         ids=[f"{type(e).__name__}-{i}"
                              for i, (e, _, _) in enumerate(CLASSIFIED)])
def test_classify_torch_exceptions(exc, cls, kind):
    err = R.classify(exc)
    assert type(err) is cls
    assert err.__cause__ is exc
    if kind is not None:
        assert err.kind == kind
    # a capture error is fatal for the program, not a lost device
    if "capturing" in str(exc) or "Capture" in str(exc) or "901" in str(exc):
        assert not isinstance(err, R.DeviceLost)


def test_classify_passes_typed_and_control_flow():
    typed = R.TransientError("x")
    assert R.classify(typed) is typed
    assert R.classify(KeyboardInterrupt()) is None
    assert R.classify(SystemExit()) is None
    assert isinstance(R.classify(type("ParsingException", (Exception,),
                                      {})("q")), R.UserError)
    assert isinstance(R.classify(ValueError("x"), default=R.UserError),
                      R.UserError)


@pytest.mark.parametrize("exc", [MemoryError(), OSError("x"),
                                 ConnectionError("x"), TimeoutError("x"),
                                 ValueError("x"), KeyError("x")])
def test_classify_equal_jax_on_host_exceptions(exc):
    got, want = R.classify(exc), jax_res.classify(exc)
    assert type(got).__name__ == type(want).__name__
    assert getattr(got, "kind", None) == getattr(want, "kind", None)
    assert got.error_name == want.error_name


SPECS = ["compile:1", "compile:2+", "compile:1:sleep=500",
         "compile:p=0.05:seed=7", "stage_exec:1+,stage_replay:1+",
         "compile:1+:fatal", "materialize:3:fatal:sleep=5"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_spec_equal_jax(spec):
    def fields(specs):
        return [tuple(getattr(s, f) for f in s.__slots__ if f != "rng")
                for s in specs]

    assert fields(faults.parse_spec(spec)) == fields(
        jax_faults.parse_spec(spec))


@pytest.mark.parametrize("spec", ["nosuch:1", "compile", "compile:p=2",
                                  "compile:1:explode"])
def test_parse_spec_rejects_like_jax(spec):
    with pytest.raises(ValueError):
        faults.parse_spec(spec)
    with pytest.raises(ValueError):
        jax_faults.parse_spec(spec)


# ---------------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------------

def test_query_scope_nests_to_the_sooner_deadline():
    with R.query_scope(timeout_s=100) as outer:
        with R.query_scope(timeout_s=0.5) as inner:
            assert inner.remaining() <= 0.5
        with R.query_scope(timeout_s=1000) as loose:
            assert loose.deadline_at == outer.deadline_at
    assert R.current() is None
    with R.query_scope(timeout_s=0):
        with pytest.raises(R.DeadlineExceeded):
            R.check("here")


def test_sql_timeout_cuts_a_stalled_build(c):
    before = dict(compiled.stats)
    with faults.inject("compile:1:sleep=2000"):
        with pytest.raises(R.DeadlineExceeded):
            c.sql(AGG_Q, timeout=0.2)
    assert _delta(before, "deadline_exceeded")["deadline_exceeded"] >= 1
    assert R.current() is None
    _same(c.sql(AGG_Q, return_futures=False), _eager(c, AGG_Q))


def test_env_timeout_and_eager_checkpoint(c, monkeypatch):
    monkeypatch.setenv("DSQL_QUERY_TIMEOUT_MS", "1000")
    with R.query_scope() as rt:
        assert 0 < rt.remaining() <= 1.0
    monkeypatch.setenv("DSQL_COMPILE", "0")
    with pytest.raises(R.DeadlineExceeded, match="at eager"):
        c.sql(AGG_Q, timeout=0)


def test_retry_transient_retries_then_surfaces():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return "ok"

    assert R.retry_transient(flaky, site="t") == "ok" and len(calls) == 3
    with pytest.raises(R.FatalError):
        R.retry_transient(lambda: (_ for _ in ()).throw(ValueError("x")),
                          site="t")
    with pytest.raises(KeyError):
        R.retry_transient(lambda: {}["k"], site="t", passthrough=(KeyError,))


# ---------------------------------------------------------------------------
# the ladder
# ---------------------------------------------------------------------------

LADDER = ("compile_errors", "retries", "degradations", "split_hints",
          "exiled", "compiles", "stage_graphs")


def test_transient_compile_fault_retries_in_place(c):
    before = dict(compiled.stats)
    with faults.inject("compile:1"):
        got = c.sql(AGG_Q, return_futures=False)
    assert _tier(c) == "compiled"
    d = _delta(before, *LADDER)
    assert d["compile_errors"] == 1 and d["retries"] == 1
    assert d["compiles"] == 1 and d["degradations"] == 0
    _same(got, _eager(c, AGG_Q))


@pytest.fixture()
def jax_ladder(user_table_1):
    """The JAX package's run of a query under a fault spec: its ladder
    counters and tier, from a fresh state."""
    import dask_sql_tpu.physical.compiled as jc
    from dask_sql_tpu import Context as JaxContext

    ctx = JaxContext()
    ctx.create_table("user_table_1", user_table_1)
    ctx.create_table("dim", pd.DataFrame({"user_id": [1, 2, 3, 4],
                                          "w": [10, 20, 30, 40]}))

    def run(spec, query):
        jc._cache.clear()
        jc._learned_caps.clear()
        jc._runtime_eager.clear()
        before = dict(jc.stats)
        with jax_faults.inject(spec):
            ctx.sql(query, return_futures=False)
        return ({k: jc.stats.get(k, 0) - before.get(k, 0) for k in LADDER},
                _tier(ctx))

    return run


def test_fatal_whole_program_degrades_to_stages(c, jax_ladder):
    before = dict(compiled.stats)
    with faults.inject("compile:1:fatal"):
        got = c.sql(DIM_Q, return_futures=False)
    d = _delta(before, *LADDER)
    assert d["split_hints"] == 1 and d["degradations"] == 1
    assert d["stage_graphs"] == 1 and d["exiled"] == 0
    assert _tier(c) == "compiled"
    assert (d, "compiled") == jax_ladder("compile:1:fatal", DIM_Q)
    _same(got, _eager(c, DIM_Q))


def test_every_rung_failing_ends_eager(c, jax_ladder):
    before = dict(compiled.stats)
    with faults.inject("compile:1+"):
        got = c.sql(DIM_Q, return_futures=False)
    d = _delta(before, *LADDER)
    assert d["split_hints"] == 1 and d["degradations"] >= 2
    assert d["retries"] >= 2 * R.retry_max() and d["exiled"] == 0
    assert _tier(c) == "eager"
    assert (d, "eager") == jax_ladder("compile:1+", DIM_Q)
    _same(got, _eager(c, DIM_Q))
    # transient: nothing exiled, the next call builds
    before = dict(compiled.stats)
    c.sql(DIM_Q)
    assert _delta(before, "compiles")["compiles"] >= 1


def test_fatal_single_program_is_exiled(c):
    before = dict(compiled.stats)
    with faults.inject("compile:1+:fatal"):
        got = c.sql(AGG_Q, return_futures=False)
    assert _delta(before, "exiled")["exiled"] == 1
    assert _tier(c) == "eager"
    _same(got, _eager(c, AGG_Q))
    before = dict(compiled.stats)
    c.sql(AGG_Q)
    assert _delta(before, "unsupported", "compiles") == {"unsupported": 1,
                                                        "compiles": 0}


def test_no_eager_fallback_surfaces_the_typed_error(c, monkeypatch):
    monkeypatch.setenv("DSQL_EAGER_FALLBACK", "0")
    with faults.inject("compile:1+:fatal"):
        with pytest.raises(faults.FatalFaultInjected):
            c.sql(AGG_Q)
    _fresh_process()   # the fatal verdict exiled the program
    with faults.inject("materialize:1+"):
        with pytest.raises(faults.FaultInjected):
            c.sql(AGG_Q)


def test_sticky_cuda_error_surfaces(c, monkeypatch):
    def lost(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setattr(compiled, "_build", lost)
    before = dict(compiled.stats)
    with pytest.raises(R.DeviceLost):
        c.sql(AGG_Q)
    assert _delta(before, "retries", "degradations") == {"retries": 0,
                                                         "degradations": 0}


def test_materialize_transient_retries(c):
    c.sql(AGG_Q)
    before = dict(compiled.stats)
    with faults.inject("materialize:1"):
        got = c.sql(AGG_Q, return_futures=False)
    assert _delta(before, "retries", "hits") == {"retries": 1, "hits": 1}
    _same(got, _eager(c, AGG_Q))


def test_compile_failures_halve_the_workers(monkeypatch):
    monkeypatch.setenv("DSQL_COMPILE_WORKERS", "8")
    monkeypatch.setenv("DSQL_COMPILE_BACKOFF_AFTER", "2")
    monkeypatch.setattr(compiled, "_compile_fail_streak", 0)
    before = dict(compiled.stats)
    assert compiled._compile_workers() == 8
    for _ in range(4):
        compiled._note_compile_result(False)
    assert compiled._compile_workers() == 2
    assert compiled._compile_workers(1) == 1
    assert _delta(before, "compile_backoffs")["compile_backoffs"] == 2
    compiled._note_compile_result(True)
    assert compiled._compile_workers() == 8


def test_concurrent_callers_share_one_build(c, monkeypatch):
    real = compiled._build
    gate = threading.Event()

    def slow_build(*a, **k):
        gate.wait(5)
        return real(*a, **k)

    monkeypatch.setattr(compiled, "_build", slow_build)
    before = dict(compiled.stats)
    out, errors = [], []

    def run():
        try:
            out.append(c.sql(AGG_Q, return_futures=False))
        except Exception as exc:   # reported below
            errors.append(exc)

    threads = [threading.Thread(target=run) for _ in range(3)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 30
    while not compiled._inflight and time.monotonic() < deadline:
        time.sleep(0.001)
    gate.set()
    for t in threads:
        t.join()
    assert not errors
    assert _delta(before, "compiles", "hits") == {"compiles": 1, "hits": 2}
    for got in out:
        _same(got, out[0])


# ---------------------------------------------------------------------------
# stage replay (test_failure_domains.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tpch():
    from benchmarks.tpch import generate_tpch
    data = generate_tpch(0.002)
    ctx = Context(device="cpu")
    for name, frame in data.items():
        ctx.create_table(name, frame)
    return ctx, data


def test_stage_replay_reexecutes_exactly_one_stage(tpch, monkeypatch):
    from benchmarks.pandas_tpch import q3 as pandas_q3
    from benchmarks.tpch import QUERIES
    from tests.conftest import assert_eq

    ctx, data = tpch
    monkeypatch.setenv("DSQL_STAGE_HEAVY", "1")
    monkeypatch.setenv("DSQL_COMPILE_WORKERS", "1")
    before = dict(compiled.stats)
    with faults.inject("stage_exec:2"):
        got = ctx.sql(QUERIES[3], return_futures=False)
    assert_eq(got, pandas_q3(data), check_row_order=False)
    d = _delta(before, "stage_graphs", "stage_execs", "fault_stage_exec",
               "stage_replays", "stage_replay_saved_stages", "degradations")
    assert d["stage_graphs"] >= 1
    assert d["fault_stage_exec"] == 1 and d["stage_replays"] == 1
    assert d["stage_execs"] - 1 >= 3
    assert d["stage_replay_saved_stages"] == 1
    assert d["degradations"] == 0


def test_stage_replay_of_root_saves_all_materialized_deps(c, monkeypatch):
    monkeypatch.setenv("DSQL_STAGE_HEAVY", "1")
    monkeypatch.setenv("DSQL_COMPILE_WORKERS", "1")
    expected = _eager(c, JOIN_Q)
    before = dict(compiled.stats)
    with faults.inject("stage_exec:2"):
        got = c.sql(JOIN_Q, return_futures=False)
    _same(got, expected)
    assert _delta(before, "stage_replays", "stage_replay_saved_stages") == {
        "stage_replays": 1, "stage_replay_saved_stages": 1}
    sch = c.schema.get("__split__")
    assert sch is None or not sch.tables, "leaked __split__ tables"


def test_sabotaged_replay_still_degrades_cleanly(c, monkeypatch):
    monkeypatch.setenv("DSQL_STAGE_HEAVY", "1")
    expected = _eager(c, JOIN_Q)
    before = dict(compiled.stats)
    with faults.inject("stage_exec:1+,stage_replay:1+"):
        got = c.sql(JOIN_Q, return_futures=False)
    _same(got, expected)
    d = _delta(before, "degradations", "fault_stage_replay")
    assert d["degradations"] >= 1 and d["fault_stage_replay"] >= 1


# ---------------------------------------------------------------------------
# quarantine and the watchdog (test_failure_domains.py)
# ---------------------------------------------------------------------------

_SECOND_PROCESS = """
import json, sys
import pandas as pd
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.physical import compiled
c = Context(device="cpu")
c.create_table("user_table_1", pd.DataFrame(json.loads(sys.argv[1])))
got = c.sql(sys.argv[2], return_futures=False)
print(json.dumps({"rows": got.sort_values("user_id").to_dict("list"),
                  "compiles": compiled.stats.get("compiles", 0),
                  "quarantine_skips": compiled.stats.get("quarantine_skips",
                                                         0)}))
"""


def test_fatal_compile_quarantines_across_processes(c, user_table_1,
                                                    tmp_path, monkeypatch):
    qfile = str(tmp_path / "quarantine.json")
    monkeypatch.setenv("DSQL_QUARANTINE_FILE", qfile)
    monkeypatch.setenv("DSQL_QUARANTINE_TTL_S", "3600")
    expected = _eager(c, AGG_Q)

    # process A: the build fails fatally; answered eager, exiled, marked
    before = dict(compiled.stats)
    with faults.inject("compile:1+:fatal"):
        got = c.sql(AGG_Q, return_futures=False)
    _same(got, expected)
    assert _delta(before, "exiled", "quarantine_marks") == {
        "exiled": 1, "quarantine_marks": 1}
    entries = Q.QuarantineStore(qfile).entries()
    assert entries and all(v["verdict"] == "fatal" for v in entries.values())

    # process B, a real one sharing the file, the fault gone: no build
    out = subprocess.run(
        [sys.executable, "-c", _SECOND_PROCESS,
         user_table_1.to_json(orient="columns"), AGG_Q],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True,
        env={**os.environ, "DSQL_QUARANTINE_FILE": qfile})
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    assert seen["compiles"] == 0 and seen["quarantine_skips"] == 1
    assert seen["rows"] == expected.sort_values("user_id").to_dict("list")

    # after expiry one half-open probe builds, and success lifts the mark
    data = json.loads(Path(qfile).read_text())
    for v in data.values():
        v["expires_at"] = 0.0
    Path(qfile).write_text(json.dumps(data))
    _fresh_process()
    before = dict(compiled.stats)
    _same(c.sql(AGG_Q, return_futures=False), expected)
    assert _delta(before, "compiles", "quarantine_probes") == {
        "compiles": 1, "quarantine_probes": 1}
    assert Q.QuarantineStore(qfile).entries() == {}
    before = dict(compiled.stats)
    _same(c.sql(AGG_Q, return_futures=False), expected)
    assert _delta(before, "hits")["hits"] == 1


def test_transient_compile_failure_never_quarantines(c, tmp_path,
                                                     monkeypatch):
    qfile = str(tmp_path / "quarantine.json")
    monkeypatch.setenv("DSQL_QUARANTINE_FILE", qfile)
    with faults.inject("compile:1+"):
        c.sql(AGG_Q, return_futures=False)
    assert Q.QuarantineStore(qfile).entries() == {}


def test_watchdog_marks_wedged_compile(c, tmp_path, monkeypatch):
    qfile = str(tmp_path / "quarantine.json")
    monkeypatch.setenv("DSQL_QUARANTINE_FILE", qfile)
    monkeypatch.setenv("DSQL_QUARANTINE_TTL_S", "3600")
    monkeypatch.setenv("DSQL_COMPILE_WATCHDOG_S", "0.2")
    monkeypatch.setenv("DSQL_RETRY_MAX", "0")
    expected = _eager(c, AGG_Q)
    before = dict(compiled.stats)
    with faults.inject("compile:1+:sleep=900"):
        got = c.sql(AGG_Q, return_futures=False)
    _same(got, expected)
    assert _delta(before, "watchdog_trips")["watchdog_trips"] >= 1
    entries = Q.QuarantineStore(qfile).entries()
    assert entries and any(v["verdict"] == "hang" for v in entries.values())
    _fresh_process()
    before = dict(compiled.stats)
    _same(c.sql(AGG_Q, return_futures=False), expected)
    assert _delta(before, "compiles")["compiles"] == 0


def test_device_fingerprint_and_program_key():
    assert Q.device_fingerprint() == "cpu"
    k1 = Q.program_key(("fp", "inputs", False, "cpu"))
    assert k1 == Q.program_key(("fp", "inputs", False, "cpu"))
    assert k1 != Q.program_key(("fp2", "inputs", False, "cpu"))
