"""The port's event bus (``runtime/events.py``) against the JAX package's.

It mirrors ``tests/unit/test_events.py`` and
``tests/integration/test_events_trace.py`` (on the port's own server,
which needs no fastapi): the bounded ring and its cursor, the long poll,
trace ids (minting, sanitizing, resolution, the span tree, the
``X-DSQL-Trace`` round trip and ``DSQL_TRACE_ID`` across processes), the
JSONL file ring in the JAX package's format (a file written by either
package reads back in the other with equal records), the SLO monitor's
burn rates and its breach edge, anomaly flags, ``GET /v1/events`` and the
``slo`` section of ``GET /v1/engine``.  Fed the same fixed series of
latencies, both packages' monitors give equal rows (burn rates exactly:
the same float arithmetic) and both workload managers shed the same
background admission.  A query publishes the same sequence of event
types in both packages.
"""
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from dask_sql_tpu import Context as JaxContext
from dask_sql_tpu.runtime import events as jax_ev
from dask_sql_tpu.runtime import scheduler as jax_sched
from dask_sql_tpu.runtime import telemetry as jax_tel
from dask_sql_tpu.runtime.resilience import LoadShedRejected as JaxShed
from dask_sql_tpu_torch import Context, run_server
from dask_sql_tpu_torch.runtime import events as ev
from dask_sql_tpu_torch.runtime import scheduler as sched
from dask_sql_tpu_torch.runtime import telemetry as tel
from dask_sql_tpu_torch.runtime.resilience import LoadShedRejected

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture()
def armed(monkeypatch):
    """The bus armed, a fresh bus and monitor in both packages."""
    monkeypatch.setenv("DSQL_EVENTS", "1")
    ev._reset_for_tests()
    jax_ev._reset_for_tests()
    yield ev
    ev._reset_for_tests()
    jax_ev._reset_for_tests()


# ---------------------------------------------------------------------------
# the bus
# ---------------------------------------------------------------------------

def test_publish_and_cursor(armed):
    before = tel.REGISTRY.get("events_published")
    for i, t in enumerate(("a.one", "a.two", "a.three")):
        ev.publish(t, x=i)
    assert tel.REGISTRY.get("events_published") == before + 3
    evs, nxt = ev.read_since(0)
    assert [e["type"] for e in evs] == ["a.one", "a.two", "a.three"]
    assert nxt == evs[-1]["seq"]
    assert ev.read_since(nxt) == ([], nxt)
    ev.publish("a.four")
    assert [e["type"] for e in ev.read_since(nxt)[0]] == ["a.four"]
    evs4, n4 = ev.read_since(0, limit=2)
    assert len(evs4) == 2 and n4 == evs4[-1]["seq"]


def test_ring_is_bounded(armed, monkeypatch):
    monkeypatch.setenv("DSQL_EVENTS_RING", "16")
    ev._reset_for_tests()
    for i in range(100):
        ev.publish("tick", i=i)
    snap = ev.get_bus().snapshot()
    assert [e["i"] for e in snap] == list(range(84, 100))
    assert [e["i"] for e in ev.read_since(0, limit=1000)[0]] == \
        list(range(84, 100))


def test_long_poll_wakes_on_publish(armed):
    cur = ev.get_bus().last_seq()
    got = []
    t = threading.Thread(
        target=lambda: got.extend(ev.read_since(cur, timeout_s=5.0)[0]))
    t.start()
    time.sleep(0.05)
    ev.publish("wake.up")
    t.join(timeout=5)
    assert not t.is_alive()
    assert [e["type"] for e in got] == ["wake.up"]


def test_publish_never_raises_and_strips_core_fields(armed, monkeypatch):
    rec = ev.publish("t", seq=999, pid=-1, unix=-1.0, type="fake", x=7)
    assert rec["type"] == "t" and rec["pid"] == os.getpid()
    assert rec["x"] == 7 and rec["seq"] != 999
    before = tel.REGISTRY.get("events_dropped")

    def boom(rec):
        raise RuntimeError("bus on fire")

    monkeypatch.setattr(ev.get_bus(), "append", boom)
    assert ev.publish("doomed") is None
    assert tel.REGISTRY.get("events_dropped") == before + 1


# ---------------------------------------------------------------------------
# trace ids
# ---------------------------------------------------------------------------

def test_mint_and_sanitize_equal_the_jax_packages(armed):
    tid = ev.mint_trace_id()
    assert len(tid) == 16 and ev.sanitize_trace_id(tid) == tid
    assert ev.mint_trace_id() != tid
    for raw in ("abc-DEF_123", "  padded  ", "x" * 64, "x" * 65,
                "inj\nected", "semi;colon", "", None, 42, "bad id!"):
        assert ev.sanitize_trace_id(raw) == jax_ev.sanitize_trace_id(raw)
    assert ev.sanitize_trace_id("  padded  ") == "padded"


def test_trace_id_resolution_order(armed, monkeypatch):
    assert ev.current_trace_id() is None
    monkeypatch.setenv("DSQL_TRACE_ID", "from-env")
    assert ev.current_trace_id() == "from-env"
    with ev.trace_id_scope("from-scope"):
        assert ev.current_trace_id() == "from-scope"
        assert ev.publish("inside")["trace"] == "from-scope"
    assert ev.current_trace_id() == "from-env"
    monkeypatch.setenv("DSQL_TRACE_ID", "bad id!")
    assert ev.current_trace_id() is None


def test_trace_rides_the_span_tree_into_the_report(armed):
    with tel.trace_scope("SELECT 1") as trace:
        tid = trace.root.attrs.get("trace_id")
        assert tid and ev.sanitize_trace_id(tid) == tid
    report = tel.last_report()
    assert report.trace_id == tid and report.to_dict()["trace_id"] == tid
    assert report.to_chrome_trace()["otherData"]["trace_id"] == tid
    done = [e for e in ev.get_bus().snapshot() if e["type"] == "query.done"]
    assert done and done[-1]["trace"] == tid


def test_a_query_publishes_the_jax_packages_event_types(armed, monkeypatch):
    """One query with the workload manager on (as in production): the
    same event types in the same order, with the same trace id on each,
    in both packages."""
    monkeypatch.setenv("DSQL_MAX_CONCURRENT_QUERIES", "2")
    # a first (compiling) run of the JAX package may pass the 1 s
    # objective; a breach is not what this compares
    monkeypatch.setenv("DSQL_SLO_INTERACTIVE_MS", "600000")
    data = {"k": np.arange(40, dtype=np.int64) % 4,
            "x": np.arange(40, dtype=np.float64)}
    sql = "SELECT k, SUM(x) AS s FROM t GROUP BY k"
    got = {}
    for pkg, mod, ctx in (("jax", jax_ev, JaxContext()),
                          ("port", ev, Context(device=CPU))):
        ctx.create_table("t", data)
        with mod.trace_id_scope(f"seq-{pkg}"):
            ctx.sql(sql)
        recs = [e for e in mod.get_bus().snapshot()
                if e["trace"] == f"seq-{pkg}"]
        got[pkg] = [e["type"] for e in recs]
        assert got[pkg] and all(e["pid"] == os.getpid() for e in recs)
    assert got["port"] == got["jax"]
    assert got["port"][0] == "query.begin" and \
        got["port"][-1] == "query.done"


# ---------------------------------------------------------------------------
# the JSONL file ring
# ---------------------------------------------------------------------------

def test_file_ring_truncates_to_the_same_bytes(armed, tmp_path, monkeypatch):
    monkeypatch.setenv("DSQL_EVENTS_MB", "0.001")
    assert ev.file_limit_bytes() == jax_ev.file_limit_bytes() == 4096
    pad = "x" * 100
    recs = [{"seq": i, "unix": 1.0, "pid": 1, "trace": "", "type": "churn",
             "i": i, "pad": pad} for i in range(200)]
    data = {}
    for pkg, mod in (("jax", jax_ev), ("port", ev)):
        path = str(tmp_path / f"{pkg}.jsonl")
        for r in recs:
            mod._append_file(path, dict(r))
        data[pkg] = open(path, "rb").read()
    assert data["port"] == data["jax"] and len(data["port"]) <= 4096
    got = ev._read_file(str(tmp_path / "port.jsonl"))
    assert got[-1]["i"] == 199 and got[0]["i"] > 0


def test_file_written_by_each_reads_in_the_other(armed, tmp_path,
                                                 monkeypatch):
    path = str(tmp_path / "events.jsonl")
    monkeypatch.setenv("DSQL_EVENTS_FILE", path)
    ev.publish("good", i=1)
    with open(path, "ab") as f:
        f.write(b"not json\n")
        f.write(b'{"torn": tru')
        f.write(b"\n[1, 2, 3]\n")
    jax_ev.publish("good", i=2)
    assert [r["i"] for r in ev._read_file(path)] == [1, 2]
    assert ev._read_file(path) == jax_ev._read_file(path)
    assert ev.events_rows() == jax_ev.events_rows()


def test_events_rows_compact_extras(armed):
    ev.publish("shape.test", zeta=1, alpha="two")
    jax_ev.publish("shape.test", zeta=1, alpha="two")
    row, jrow = ev.events_rows()[-1], jax_ev.events_rows()[-1]
    assert json.loads(row["detail"]) == {"alpha": "two", "zeta": 1}
    assert set(row) == set(jrow) == {"seq", "unix", "pid", "trace", "type",
                                     "detail"}
    assert row["detail"] == jrow["detail"]


# ---------------------------------------------------------------------------
# the SLO monitor and the load shed
# ---------------------------------------------------------------------------

def test_slo_knobs_equal_the_jax_packages(armed, monkeypatch):
    for cls, ms in (("interactive", 1000.0), ("batch", 10000.0),
                    ("background", 60000.0)):
        assert ev.objective_ms(cls) == jax_ev.objective_ms(cls) == ms
    for raw, want in (("250", 250.0),):
        monkeypatch.setenv("DSQL_SLO_INTERACTIVE_MS", raw)
        assert ev.objective_ms("interactive") == want
    for raw, want in (("2.0", 0.9999), ("not-a-number", 0.99),
                      ("0.95", 0.95)):
        monkeypatch.setenv("DSQL_SLO_TARGET", raw)
        assert ev.slo_target() == jax_ev.slo_target() == want


#: a fixed series of (class, wall ms): breaches in interactive and
#: background, batch clean
SERIES = ([("interactive", 10.0)] * 6 + [("interactive", 5000.0)] * 2
          + [("batch", 50.0)] * 3 + [("background", 90000.0)]
          + [(None, 1.0), ("mystery", 2000.0)])


def test_burn_rates_on_a_fixed_series_equal_the_jax_packages(armed):
    b0 = tel.REGISTRY.get("slo_breaches")
    for mod in (ev, jax_ev):
        mon = mod.get_monitor()
        for cls, ms in SERIES:
            mon.observe(cls, ms)
    rows = ev.slo_rows()
    assert rows == jax_ev.slo_rows()
    by = {r["class"]: r for r in rows}
    # interactive: 3 breaches of 10 (one unknown class maps there)
    assert by["interactive"]["total"] == 10
    assert by["interactive"]["breaches"] == 3
    assert by["interactive"]["burn_fast"] == pytest.approx(0.3 / 0.01)
    assert by["batch"]["burn_fast"] == 0.0 and by["batch"]["breach"] is False
    assert by["background"]["breach"] is True
    assert tel.REGISTRY.gauges()["slo_attainment_interactive"] == \
        pytest.approx(0.7)
    # edge-triggered: one breach each for interactive and background
    assert tel.REGISTRY.get("slo_breaches") == b0 + 2
    assert [e["cls"] for e in ev.get_bus().snapshot()
            if e["type"] == "slo.breach"] == \
        [e["cls"] for e in jax_ev.get_bus().snapshot()
         if e["type"] == "slo.breach"]
    assert sorted(ev.get_monitor().burning_classes()) == \
        sorted(jax_ev.get_monitor().burning_classes()) == \
        ["background", "interactive"]


def test_load_shed_on_a_fixed_series_equals_the_jax_packages(armed,
                                                              monkeypatch):
    """While a class burns, both workload managers refuse a background
    seat with LoadShedRejected (counted shed and rejected, ``slo.shed`` on
    the edge) and admit interactive and batch; with ``DSQL_SLO_SHED=0``
    nothing is shed.  The shed lifts when the burn falls."""
    monkeypatch.setenv("DSQL_MAX_CONCURRENT_QUERIES", "2")
    outcomes = {}
    for pkg, mod, s, shed, reg in (
            ("jax", jax_ev, jax_sched, JaxShed, jax_tel.REGISTRY),
            ("port", ev, sched, LoadShedRejected, tel.REGISTRY)):
        mgr = s.WorkloadManager()
        got = [mgr.claim_seat("background") is not None]
        for cls, ms in SERIES:
            mod.get_monitor().observe(cls, ms)
        s0 = reg.get("sched_shed_background")
        with pytest.raises(shed) as e:
            mgr.claim_seat("background")
        assert e.value.retry_after_s == 5.0
        assert reg.get("sched_shed_background") == s0 + 1
        got.append(type(e.value).__name__)
        for pr in ("interactive", "batch"):
            seat = mgr.claim_seat(pr)
            got.append(seat is not None)
            mgr.release_seat(seat)
        monkeypatch.setenv("DSQL_SLO_SHED", "0")
        got.append(mgr.claim_seat("background") is not None)
        monkeypatch.delenv("DSQL_SLO_SHED")
        # the burn falls: the windows forget the breaching samples
        monkeypatch.setenv("DSQL_SLO_FAST_S", "0.1")
        monkeypatch.setenv("DSQL_SLO_SLOW_S", "0.1")
        time.sleep(0.15)
        got.append(mgr.claim_seat("background") is not None)
        monkeypatch.delenv("DSQL_SLO_FAST_S")
        monkeypatch.delenv("DSQL_SLO_SLOW_S")
        got.append([e["active"] for e in mod.get_bus().snapshot()
                    if e["type"] == "slo.shed"])
        outcomes[pkg] = got
    assert outcomes["port"] == outcomes["jax"] == [
        True, "LoadShedRejected", True, True, True, True, [True, False]]


def test_anomaly_flags_and_engine_section(armed):
    ev._sample_counters(time.time() - 1.0)
    tel.inc("compile_errors", 5)
    tel.inc("spill_demotions", 40)
    kinds = {f["kind"]: f for f in ev.anomalies()}
    assert kinds["compile_error_spike"]["errors"] >= 5
    assert kinds["spill_thrash"]["moves"] >= 40
    sec = ev.engine_section()
    assert sec["enabled"] is True and isinstance(sec["anomalies"], list)
    assert {r["class"] for r in sec["classes"]} == \
        {"interactive", "batch", "background"}
    assert sec["bus"]["ring"] == ev.ring_len()
    assert set(sec) == set(jax_ev.engine_section())


# ---------------------------------------------------------------------------
# the server (tests/integration/test_events_trace.py)
# ---------------------------------------------------------------------------

@pytest.fixture()
def server(armed, tmp_path, monkeypatch):
    monkeypatch.setenv("DSQL_EVENTS_FILE", str(tmp_path / "events.jsonl"))
    monkeypatch.setenv("DSQL_HISTORY_FILE", str(tmp_path / "hist.jsonl"))
    c = Context(device=CPU)
    c.create_table("t", {"a": np.arange(8, dtype=np.int64)})
    srv = run_server(context=c, host="127.0.0.1", port=0, blocking=False)
    yield f"http://127.0.0.1:{srv.server_port}", str(tmp_path)
    srv.shutdown()
    srv.server_close()


def _req(url, body=None, headers=None, method=None):
    req = urllib.request.Request(
        url, data=body.encode() if body is not None else None,
        headers=headers or {}, method=method)
    with urllib.request.urlopen(req) as r:
        return json.loads(r.read() or b"null"), dict(r.headers)


def _finish(payload):
    deadline = time.time() + 120
    while "nextUri" in payload and time.time() < deadline:
        time.sleep(0.02)
        payload, headers = _req(payload["nextUri"])
    return payload


def test_trace_id_minted_and_correlated(server):
    from dask_sql_tpu.runtime import flight_recorder as jax_fr
    from dask_sql_tpu_torch.runtime import flight_recorder as fr

    base, tmp = server
    payload, headers = _req(f"{base}/v1/statement",
                            "SELECT SUM(a) AS s FROM t")
    tid = headers.get("X-DSQL-Trace")
    assert tid and len(tid) == 16
    final = _finish(payload)
    assert final["data"] == [[28]] and final["stats"]["traceId"] == tid
    (env,) = [e for e in fr.read_events(kind="query")
              if e.get("trace") == tid]
    assert env["outcome"] == "ok"
    assert jax_fr.read_events(kind="query") == fr.read_events(kind="query")
    types = {e["type"] for e in jax_ev._read_file(
        os.path.join(tmp, "events.jsonl")) if e.get("trace") == tid}
    assert {"query.begin", "query.done"} <= types


@pytest.mark.parametrize("sent,kept", [
    ("client-chosen-42", True), ("bad id;DROP", False)])
def test_client_trace_id_round_trip(server, sent, kept):
    base, _ = server
    payload, headers = _req(f"{base}/v1/statement", "SELECT 1 AS one",
                            headers={"X-DSQL-Trace": sent})
    tid = headers.get("X-DSQL-Trace")
    assert (tid == sent) is kept and len(tid) == (len(sent) if kept else 16)
    assert _finish(payload)["stats"]["traceId"] == tid


def test_error_path_carries_the_trace_header(server):
    base, _ = server
    payload, headers = _req(f"{base}/v1/statement",
                            "SELECT nosuchcolumn FROM t",
                            headers={"X-DSQL-Trace": "err-trace-1"})
    assert headers.get("X-DSQL-Trace") == "err-trace-1"
    assert "error" in _finish(payload)
    with pytest.raises(urllib.error.HTTPError) as e:
        _req(f"{base}/v1/status/not-a-real-id")
    assert e.value.code == 404
    assert e.value.headers.get("X-DSQL-Trace") is None


def test_events_endpoint_streams_with_a_cursor(server):
    base, _ = server
    payload, headers = _req(f"{base}/v1/statement", "SELECT MAX(a) FROM t")
    _finish(payload)
    tid = headers["X-DSQL-Trace"]
    with urllib.request.urlopen(f"{base}/v1/events?cursor=0&limit=1000") \
            as r:
        assert r.headers["Content-Type"] == "application/x-ndjson"
        cursor = int(r.headers["X-DSQL-Cursor"])
        lines = [json.loads(ln) for ln in r.read().splitlines() if ln]
    assert cursor > 0 and all(e["seq"] <= cursor for e in lines)
    assert [e["type"] for e in lines if e["trace"] == tid][-1] == \
        "query.done"
    with urllib.request.urlopen(f"{base}/v1/events?cursor={cursor}") as r:
        assert r.read() == b""
        assert int(r.headers["X-DSQL-Cursor"]) == cursor
    snap, _ = _req(f"{base}/v1/engine")
    classes = {r["class"]: r for r in snap["slo"]["classes"]}
    assert classes["interactive"]["total"] >= 1
    assert snap["slo"]["bus"]["seq"] > 0


def test_trace_correlates_across_processes(server):
    """A child process runs a query under DSQL_TRACE_ID against the shared
    history and event files; this process joins both on that id."""
    from dask_sql_tpu_torch.runtime import flight_recorder as fr

    _, tmp = server
    code = ("import numpy as np\n"
            "from dask_sql_tpu_torch import Context\n"
            "c = Context(device='cpu')\n"
            "c.create_table('t', {'a': np.array([10, 20, 30])})\n"
            "assert c.sql('SELECT SUM(a) AS s FROM t').to_pylist()"
            " == [[60]]\n")
    env = dict(os.environ, DSQL_TIERED="0", DSQL_MAX_CONCURRENT_QUERIES="0",
               DSQL_RESULT_CACHE_MB="0", DSQL_TRACE_ID="xproc-trace-7",
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, timeout=300)
    assert proc.returncode == 0, proc.stderr.decode()[-2000:]
    (env_rec,) = [e for e in fr.read_events(kind="query")
                  if e.get("trace") == "xproc-trace-7"]
    assert env_rec["pid"] != os.getpid()
    recs = [e for e in ev._read_file(os.path.join(tmp, "events.jsonl"))
            if e.get("trace") == "xproc-trace-7"]
    assert {"query.begin", "query.done"} <= {e["type"] for e in recs}
    assert all(e["pid"] != os.getpid() for e in recs)


def test_unarmed_server_has_no_trace_surface(monkeypatch):
    monkeypatch.delenv("DSQL_EVENTS", raising=False)
    c = Context(device=CPU)
    c.create_table("t", {"a": np.arange(4, dtype=np.int64)})
    srv = run_server(context=c, host="127.0.0.1", port=0, blocking=False)
    base = f"http://127.0.0.1:{srv.server_port}"
    try:
        payload, headers = _req(f"{base}/v1/statement",
                                "SELECT SUM(a) AS s FROM t",
                                headers={"X-DSQL-Trace": "ignored"})
        assert "X-DSQL-Trace" not in headers
        final = _finish(payload)
        assert final["data"] == [[6]] and "traceId" not in final["stats"]
        with pytest.raises(urllib.error.HTTPError) as e:
            _req(f"{base}/v1/events")
        assert e.value.code == 404
        snap, _ = _req(f"{base}/v1/engine")
        assert snap["slo"] == {"enabled": False}
        assert snap["profile"] == {"enabled": False}
    finally:
        srv.shutdown()
        srv.server_close()

