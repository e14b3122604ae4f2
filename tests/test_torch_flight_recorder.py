"""The port's flight recorder (``runtime/flight_recorder.py``) against the
JAX package's.

It mirrors ``tests/unit/test_flight_recorder.py``,
``tests/unit/test_scheduler_history.py`` and
``tests/integration/test_engine_endpoint.py``: the JSONL ring (single-write
appends, newest-half truncation, torn and corrupt lines skipped, two
writer processes), the EWMA statistics file and its pruning, query and
error envelopes, the live-query registry, the estimate ladder's
``history`` rung and ``GET /v1/engine``'s sections.  The file formats are
the JAX package's: a history or statistics file written by either package
is read by the other with equal records.  Values are compared exactly
(the EWMA folds are the same float arithmetic in both packages); walls
and timestamps only by type.

TPC-H at SF 0.001 (every query's plan fingerprint is the same in both
packages: the canonical text of the parameterized plan, with no table
uids) shows the ladder's ``est_source`` equal in both packages before and
after the port has recorded a run of each query; the JAX package only
plans them, since its eager CPU run takes seconds per query.
"""
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from benchmarks.tpch import QUERIES, generate_tpch
from dask_sql_tpu import Context as JaxContext
from dask_sql_tpu.runtime import flight_recorder as jax_fr
from dask_sql_tpu.runtime import scheduler as jax_sched
from dask_sql_tpu.runtime import statistics as jax_stats
from dask_sql_tpu.sql.parser import parse_sql as jax_parse
from dask_sql_tpu_torch import Context, run_server
from dask_sql_tpu_torch.runtime import flight_recorder as fr
from dask_sql_tpu_torch.runtime import scheduler as sched
from dask_sql_tpu_torch.runtime import statistics as stats
from dask_sql_tpu_torch.runtime import telemetry as tel
from dask_sql_tpu_torch.sql.parser import parse_sql

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
BOTH = {"jax": jax_fr, "port": fr}


@pytest.fixture()
def hist(tmp_path, monkeypatch):
    path = str(tmp_path / "hist.jsonl")
    monkeypatch.setenv("DSQL_HISTORY_FILE", path)
    return path


def _tiny():
    return {"k": np.array([1, 2, 1, 3], dtype=np.int64),
            "x": np.array([1.0, 2.0, 3.0, 4.0])}


def _plan(ctx, sql, jax=False):
    if jax:
        return ctx._get_plan(jax_parse(sql)[0].query, sql)
    return ctx._get_plan(parse_sql(sql)[0].query, sql)


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", sorted(BOTH))
def test_append_read_and_corrupt_lines(hist, pkg):
    mod = BOTH[pkg]
    mod._append(hist, {"kind": "query", "i": 1})
    mod._append(hist, {"kind": "stage", "i": 2})
    with open(hist, "ab") as f:
        f.write(b"this is not json\n")
        f.write(b'{"kind": "query", "torn": tru')   # torn mid-write
        f.write(b"\n[1, 2, 3]\n")                   # json, not a dict
    mod._append(hist, {"kind": "query", "i": 3})
    for reader in BOTH.values():
        assert [e["i"] for e in reader.read_events()] == [1, 2, 3]
        assert [e["i"] for e in reader.read_events(kind="query")] == [1, 3]
        assert [e["i"] for e in reader.read_events(kind="query",
                                                   limit=1)] == [3]


def test_ring_truncation_writes_the_same_bytes(tmp_path, monkeypatch):
    """Both packages keep the same newest half of the same records."""
    monkeypatch.setenv("DSQL_HISTORY_MB", "0.001")   # the 4096-byte floor
    assert fr.history_limit_bytes() == jax_fr.history_limit_bytes() == 4096
    before = tel.REGISTRY.get("history_truncations")
    pad = "x" * 100
    paths = {}
    for pkg, mod in BOTH.items():
        paths[pkg] = str(tmp_path / f"{pkg}.jsonl")
        monkeypatch.setenv("DSQL_HISTORY_FILE", paths[pkg])
        for i in range(100):
            mod._append(paths[pkg], {"kind": "query", "i": i, "pad": pad})
    data = {pkg: open(p, "rb").read() for pkg, p in paths.items()}
    assert data["port"] == data["jax"]
    assert len(data["port"]) <= 4096
    assert tel.REGISTRY.get("history_truncations") > before
    events = fr.read_events()
    assert events[-1]["i"] == 99 and events[0]["i"] > 0


def test_history_limit_and_disabled(monkeypatch):
    monkeypatch.delenv("DSQL_HISTORY_MB", raising=False)
    monkeypatch.delenv("DSQL_HISTORY_FILE", raising=False)
    assert fr.history_limit_bytes() == 16 * 2**20
    for raw, want in (("2", 2 * 2**20), ("not-a-number", 16 * 2**20)):
        monkeypatch.setenv("DSQL_HISTORY_MB", raw)
        assert fr.history_limit_bytes() == want == \
            jax_fr.history_limit_bytes()
    assert fr.read_events() == [] and fr.history_path() is None
    assert not fr.enabled()


def test_missing_file_reads_empty(hist):
    assert fr.read_events() == []


def test_concurrent_appends_from_two_processes(hist, monkeypatch):
    monkeypatch.setenv("DSQL_HISTORY_MB", "10")
    code = (
        "import os\n"
        "from dask_sql_tpu_torch.runtime import flight_recorder as fr\n"
        "p = os.environ['DSQL_HISTORY_FILE']\n"
        "tag = os.environ['FR_TAG']\n"
        "for i in range(150):\n"
        "    fr._append(p, {'kind': 'query', 'tag': tag, 'i': i})\n")
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                              env=dict(os.environ, FR_TAG=tag),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for tag in ("a", "b")]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err.decode()
    with open(hist, "rb") as f:
        events = [json.loads(raw) for raw in f.readlines()]
    assert len(events) == 300
    for tag in ("a", "b"):
        assert [e["i"] for e in events if e["tag"] == tag] == \
            list(range(150))


# ---------------------------------------------------------------------------
# the EWMA statistics
# ---------------------------------------------------------------------------

def _strip(entry):
    return {k: v for k, v in (entry or {}).items() if k != "updated"}


def test_ewma_folds_equal_and_cross_read(tmp_path, monkeypatch):
    """The same observations fold to the same entries, and each package's
    statistics file reads back in the other."""
    seq = [dict(nbytes=1000, rows=10, ms=5.0), dict(nbytes=2000),
           dict(cost_bytes=7.5, cost_flops=3.0), dict()]
    got = {}
    for pkg, mod in BOTH.items():
        monkeypatch.setenv("DSQL_HISTORY_FILE", str(tmp_path / f"{pkg}.h"))
        for obs in seq:
            mod._observe_stat("fp1", **obs)
        got[pkg] = mod.get_stats("fp1")
        other = BOTH["jax" if pkg == "port" else "port"]
        assert _strip(other.get_stats("fp1")) == _strip(got[pkg])
    assert _strip(got["port"]) == _strip(got["jax"])
    e = got["port"]
    assert e["bytes"] == pytest.approx(0.3 * 2000 + 0.7 * 1000)
    assert e["rows"] == 10.0 and e["n"] == 4
    assert fr.get_stats("missing") is None


def test_plan_history_bytes_headroom(hist, monkeypatch):
    c = Context(device=CPU)
    c.create_table("t", {"a": np.arange(3)})
    plan = _plan(c, "SELECT SUM(a) AS s FROM t")
    fp = fr.plan_fingerprint(plan, c)
    assert fp is not None
    assert fr.plan_history_bytes(plan, c) is None     # never measured
    fr._observe_stat(fp, nbytes=1000)
    assert fr.plan_history_bytes(plan, c) == 1500     # 1.5x headroom
    monkeypatch.setenv("DSQL_HISTORY_HEADROOM", "2.0")
    assert fr.plan_history_bytes(plan, c) == 2000
    monkeypatch.setenv("DSQL_HISTORY_HEADROOM", "0.5")
    assert fr.plan_history_bytes(plan, c) == 1000     # clamped to >= 1


def test_fingerprints_stable_across_literals_not_across_shapes(hist):
    """Stable across contexts and runs, shared by literal variants (the
    plan is parameterized first), different across shapes, and equal to
    the JAX package's."""
    pc, jc = Context(device=CPU), JaxContext()
    for c in (pc, jc):
        c.create_table("t", _tiny())
    sqls = ["SELECT k FROM t WHERE x > 1.5", "SELECT k FROM t WHERE x > 2.5",
            "SELECT k, SUM(x) AS s FROM t GROUP BY k"]
    p = [fr.plan_fingerprint(_plan(pc, s), pc) for s in sqls]
    j = [jax_fr.plan_fingerprint(_plan(jc, s, jax=True), jc) for s in sqls]
    assert p == j
    assert p[0] == p[1] != p[2]
    again = Context(device=CPU)
    again.create_table("t", _tiny())
    assert fr.plan_fingerprint(_plan(again, sqls[2]), again) == p[2]


def test_stats_sidecar_bounded_under_churn(hist, monkeypatch):
    monkeypatch.setenv("DSQL_HISTORY_MB", "0.001")
    monkeypatch.setenv("DSQL_HISTORY_STATS_MAX", "20")
    assert fr.stats_max_entries() == 20
    pad = "x" * 120
    for i in range(200):
        fr._observe_stat(f"churn-fp-{i}", nbytes=1000 + i)
        fr._append(hist, {"kind": "query", "i": i, "pad": pad})
    per_cycle = fr.history_limit_bytes() // 2 // 120
    assert len(fr._STATS.read()) <= 20 + per_cycle
    fr._prune_stats()
    kept = fr._STATS.read()
    assert len(kept) <= 20 and "churn-fp-199" in kept
    assert "churn-fp-0" not in kept


def test_stats_sidecar_ttl_prune(hist, monkeypatch):
    monkeypatch.setenv("DSQL_HISTORY_STATS_TTL_S", "60")
    fr._observe_stat("fresh-fp", nbytes=100)
    data = dict(fr._STATS.read())
    data["stale-fp"] = {"bytes": 1.0, "n": 1, "updated": time.time() - 3600}
    data["no-timestamp-fp"] = {"bytes": 1.0, "n": 1}
    fr._STATS.write(data)
    fr._prune_stats()
    assert set(fr._STATS.read()) == {"fresh-fp"}
    monkeypatch.setenv("DSQL_HISTORY_STATS_TTL_S", "junk")
    assert fr.stats_ttl_s() == jax_fr.stats_ttl_s() == 7 * 86400.0


# ---------------------------------------------------------------------------
# envelopes through real queries
# ---------------------------------------------------------------------------

ENV_SQL = "SELECT k, SUM(x) AS s FROM t GROUP BY k"


@pytest.fixture(scope="module")
def jax_envelopes(tmp_path_factory):
    """The JAX package's envelopes of one query and one error (its own
    history file; the scheduler on, as in production)."""
    path = str(tmp_path_factory.mktemp("jaxhist") / "hist.jsonl")
    mp = pytest.MonkeyPatch()
    # module scope: set up before the conftest's per-test pins
    mp.setenv("DSQL_HISTORY_FILE", path)
    mp.setenv("DSQL_MAX_CONCURRENT_QUERIES", "2")
    mp.setenv("DSQL_ADAPTIVE", "0")
    try:
        c = JaxContext()
        c.create_table("t", _tiny())
        c.sql(ENV_SQL, return_futures=False)
        with pytest.raises(Exception):
            c.sql("SELECT nosuchcolumn FROM t")
        return jax_fr.read_events(kind="query")
    finally:
        mp.undo()


def test_envelopes_equal_the_jax_packages(hist, monkeypatch, jax_envelopes):
    """The same query and the same failing query: the same fields with the
    same types, and equal values wherever they do not measure time or
    memory (the plan fingerprint included)."""
    monkeypatch.setenv("DSQL_MAX_CONCURRENT_QUERIES", "2")
    c = Context(device=CPU)
    c.create_table("t", _tiny())
    c.sql(ENV_SQL)
    with pytest.raises(Exception):
        c.sql("SELECT nosuchcolumn FROM t")
    got = fr.read_events(kind="query")
    assert len(got) == len(jax_envelopes) == 2
    for p, j in zip(got, jax_envelopes):
        assert list(p) == list(j)
        assert {k: type(v) for k, v in p.items()} == \
            {k: type(v) for k, v in j.items()}
        for k in ("kind", "query", "outcome", "cache_hit", "cache_tier",
                  "rows_out", "priority", "plan_fp", "skew_ratio",
                  "collective_bytes", "est_source", "operators"):
            assert p[k] == j[k], k
    ok, err = got
    assert ok["outcome"] == "ok" and ok["error"] == "" and ok["rows_out"] == 3
    assert ok["pid"] == os.getpid() and ok["wall_ms"] > 0
    assert ok["measured_bytes"] > 0 and ok["tier"] == "compiled"
    assert fr.get_stats(ok["plan_fp"])["n"] == 1
    assert err["outcome"] == "error" and err["error"]


def test_history_rung_on_repeat_run(hist, monkeypatch):
    """tests/unit/test_scheduler_history.py: the first run reserves the
    heuristic, the repeat the measured history (x 1.5), far tighter."""
    monkeypatch.setenv("DSQL_MAX_CONCURRENT_QUERIES", "2")
    c = Context(device=CPU)
    c.create_table("t", {"a": np.arange(64, dtype=np.int64),
                         "b": np.arange(64, dtype=np.float64)})
    sql = "SELECT a, SUM(b) AS s FROM t GROUP BY a"
    before = tel.REGISTRY.get("estimate_from_history")
    c.sql(sql)
    assert tel.REGISTRY.get("estimate_from_history") == before
    ev1 = fr.read_events(kind="query")[-1]
    assert ev1["est_source"] == "heuristic" and ev1["measured_bytes"] > 0
    c.sql(sql)
    assert tel.REGISTRY.get("estimate_from_history") == before + 1
    ev2 = fr.read_events(kind="query")[-1]
    assert ev2["est_source"] == "history"
    assert ev2["measured_bytes"] <= ev2["est_bytes"] < ev1["est_bytes"]
    plan = _plan(c, "SELECT SUM(a) AS s FROM t")
    est, src = sched.estimate_working_set(plan, c)
    assert (est, src) == (sched.estimate_plan_bytes(plan, c), "heuristic")
    fr._observe_stat(fr.plan_fingerprint(plan, c), nbytes=10 * 2**20)
    assert sched.estimate_working_set(plan, c) == (15 * 2**20, "history")


@pytest.fixture(scope="module")
def tpch_pair():
    data = generate_tpch(0.001)
    pc, jc = Context(device=CPU), JaxContext()
    for name, df in data.items():
        pc.create_table(name, df)
        jc.create_table(name, df)
    mp = pytest.MonkeyPatch()
    mp.setenv("DSQL_ADAPTIVE", "0")      # as the conftest pins each test
    try:
        plans = {q: (_plan(pc, QUERIES[q]),
                     _plan(jc, QUERIES[q], jax=True))
                 for q in sorted(QUERIES)}
    finally:
        mp.undo()
    return pc, jc, plans


def test_tpch_est_source_equal_before_and_after_the_ports_runs(
        hist, monkeypatch, tpch_pair):
    """With the recorder armed, Q1-Q22's estimate rung is the same in both
    packages before any run, and again after the port ran each query once
    into the shared history: the JAX package reads the port's statistics
    file and reserves the same bytes wherever history answers (a query
    with an empty result measures no bytes and keeps its heuristic)."""
    monkeypatch.setenv("DSQL_MAX_CONCURRENT_QUERIES", "2")
    pc, jc, plans = tpch_pair

    def sources():
        out = {}
        for q, (pp, jp) in plans.items():
            pe, ps = sched.estimate_working_set(pp, pc)
            je, js = jax_sched.estimate_working_set(jp, jc)
            assert ps == js, (q, ps, js)
            if ps == "history":
                assert pe == je, q
            out[q] = ps
        return out

    assert "history" not in sources().values()
    for q in sorted(QUERIES):
        pc.sql(QUERIES[q])
    after = sources()
    assert sum(s == "history" for s in after.values()) >= 15, after
    envs = fr.read_events(kind="query")
    assert len(envs) == 22 and jax_fr.read_events(kind="query") == envs


def test_history_written_by_jax_read_by_the_port(hist, monkeypatch):
    """The other direction: the JAX package's envelopes and statistics read
    back in the port with equal records and equal measured rows, and the
    measured rows order the joins the same way in both (EXPLAIN equal)."""
    monkeypatch.setenv("DSQL_ADAPTIVE", "1")
    rng = np.random.RandomState(3)
    tables = {
        "a": {"ka": np.arange(400, dtype=np.int64) % 40,
              "va": rng.rand(400)},
        "b": {"kb": np.arange(40, dtype=np.int64),
              "kc": np.arange(40, dtype=np.int64) % 8},
        "c": {"kc": np.arange(8, dtype=np.int64), "vc": rng.rand(8)},
    }
    jc, pc = JaxContext(), Context(device=CPU)
    for c in (jc, pc):
        for n, t in tables.items():
            c.create_table(n, t)
    jc.sql("SELECT COUNT(*) AS n FROM c", return_futures=False)
    assert fr.read_events() == jax_fr.read_events()
    (env,) = fr.read_events(kind="query")
    assert fr.get_stats(env["plan_fp"]) == jax_fr.get_stats(env["plan_fp"])
    # measured rows of each join input, written by the JAX package
    sql = ("SELECT SUM(va * vc) AS s FROM a JOIN b ON a.ka = b.kb "
           "JOIN c ON b.kc = c.kc WHERE a.va > 0.1")
    jplan, pplan = _plan(jc, sql, jax=True), _plan(pc, sql)

    def inputs(rel, out):
        for i in rel.inputs:
            out.append(i)
            inputs(i, out)
        return out

    for rows, (jr, pr) in enumerate(zip(inputs(jplan, []),
                                        inputs(pplan, []))):
        fp = jax_fr.plan_fingerprint(jr, jc)
        assert fr.plan_fingerprint(pr, pc) == fp
        if fp is not None:
            jax_fr._observe_stat(fp, rows=3 + 5 * rows)
        assert stats.measured_rows(pr, pc) == \
            jax_stats.measured_rows(jr, jc)
    assert pc.explain(sql) == jc.explain(sql)


def test_active_registry_and_disabled_path(hist, monkeypatch):
    c = Context(device=CPU)
    c.create_table("t", _tiny())
    with tel.trace_scope("SELECT live FROM t"):
        (row,) = [a for a in fr.active_snapshot()
                  if a["query"] == "SELECT live FROM t"]
        assert row["pid"] == os.getpid() and row["elapsedMillis"] >= 0
    assert not [a for a in fr.active_snapshot()
                if a["query"] == "SELECT live FROM t"]
    # unarmed: no lock, no append, no statistics, no registration

    class _Tripwire:
        def __enter__(self):
            raise AssertionError("the unarmed path took the recorder lock")

        def __exit__(self, *a):
            return False

        def __call__(self, *a, **k):
            raise AssertionError("the unarmed path called the recorder")

    monkeypatch.delenv("DSQL_HISTORY_FILE")
    for name in ("_LOCK", "_append", "_observe_stat", "begin_query"):
        monkeypatch.setattr(fr, name, _Tripwire())
    before = tel.REGISTRY.get("history_records")
    assert c.sql("SELECT SUM(x) AS s FROM t").to_pylist() == [[10.0]]
    assert fr._ACTIVE == {}
    assert tel.REGISTRY.get("history_records") == before


def test_child_process_history_reads_here(hist):
    code = ("import numpy as np\n"
            "from dask_sql_tpu_torch import Context\n"
            "c = Context(device='cpu')\n"
            "c.create_table('t', {'a': np.arange(3)})\n"
            "for q in ('SUM(a) AS s', 'COUNT(*) AS n', 'MAX(a) AS m'):\n"
            "    c.sql(f'SELECT {q} FROM t')\n")
    env = dict(os.environ, DSQL_TIERED="0", DSQL_MAX_CONCURRENT_QUERIES="0",
               DSQL_RESULT_CACHE_MB="0", CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, timeout=300)
    assert proc.returncode == 0, proc.stderr.decode()[-2000:]
    child = fr.read_events(kind="query")
    assert len(child) == 3 and all(e["pid"] != os.getpid() for e in child)
    assert jax_fr.read_events(kind="query") == child


# ---------------------------------------------------------------------------
# GET /v1/engine (tests/integration/test_engine_endpoint.py)
# ---------------------------------------------------------------------------

def _get(url):
    with urllib.request.urlopen(url) as r:
        return json.loads(r.read())


def test_engine_snapshot_reports_history_and_a_query_in_flight(hist):
    c = Context(device=CPU)
    c.create_table("t", {"a": np.arange(8, dtype=np.int64)})
    release = threading.Event()

    def slow_fn(x):
        release.set()
        time.sleep(1.0)
        return x.astype(np.float64)

    c.register_function(slow_fn, "slow_fn", [("x", np.int64)], np.float64)
    srv = run_server(context=c, host="127.0.0.1", port=0, blocking=False)
    base = f"http://127.0.0.1:{srv.server_port}"
    try:
        snap = _get(f"{base}/v1/engine")
        for key in ("pid", "active", "serverQueries", "scheduler", "memory",
                    "cache", "quarantine", "programStore",
                    "backgroundCompiles", "history"):
            assert key in snap, key
        assert snap["history"]["enabled"] is True
        assert snap["history"]["file"].endswith("hist.jsonl")
        req = urllib.request.Request(
            f"{base}/v1/statement",
            data=b"SELECT SUM(slow_fn(a)) AS s FROM t", method="POST")
        with urllib.request.urlopen(req) as r:
            payload = json.loads(r.read())
        assert release.wait(timeout=60), "the UDF never started"
        live = [a for a in _get(f"{base}/v1/engine")["active"]
                if "slow_fn" in a["query"]]
        assert live and live[0]["elapsedMillis"] >= 0
        deadline = time.time() + 60
        while "nextUri" in payload and time.time() < deadline:
            time.sleep(0.05)
            payload = _get(payload["nextUri"])
        assert payload["data"] == [[28.0]]
        snap = _get(f"{base}/v1/engine")
        assert not [a for a in snap["active"] if "slow_fn" in a["query"]]
        assert snap["history"]["records"] >= 1
    finally:
        srv.shutdown()
        srv.server_close()
