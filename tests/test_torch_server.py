"""The port's Presto-wire server (``dask_sql_tpu_torch/server/app.py``) on
the CPU, against the JAX package's server.

- The same SQL on the same data through both servers: the finished
  payloads' columns and types, rows (ints, strings, timestamps and dates
  exact; doubles rtol 1e-12), error shape (errorType, errorName with the
  package's module path read as one, errorCode, errorLocation, message)
  and the keys of ``stats`` are equal.  One difference is named: a NULL
  double is ``null`` on the port's wire and ``NaN`` (not JSON) on the JAX
  server's, which ``Column.to_pylist`` keeps.
- Paging: a result over ``DSQL_RESULT_PAGE_ROWS`` pages through
  ``/v1/result`` in both, with the same page count, reassembling to the
  direct ``Context.sql`` answer; a collected page answers 410.
- Cancel, 429 with ``Retry-After`` on a full queue, 503 while draining
  with the query in flight finishing, ``/v1/empty``, ``/metrics`` (every
  stable counter and gauge) and ``/v1/engine`` (the same sections and
  keys; the devices section names CUDA cards, so it is empty on the CPU)
  in both.
- ``ERROR_WIRE_MATRIX``: every row the JAX package has is equal, and every
  row maps its class's instance to that status, errorType, errorName and
  errorCode in the port (the port adds ``DeviceLost``).
"""
import json
import math
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest

from dask_sql_tpu import Context as JaxContext
from dask_sql_tpu.runtime import faults as jax_faults
from dask_sql_tpu.runtime import resilience as jax_res
from dask_sql_tpu.runtime import scheduler as jax_sched
from dask_sql_tpu.runtime import spill as jax_spill
from dask_sql_tpu.runtime import telemetry as jax_tel
from dask_sql_tpu.server import app as jax_app
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.runtime import faults as port_faults
from dask_sql_tpu_torch.runtime import resilience as port_res
from dask_sql_tpu_torch.runtime import scheduler as port_sched
from dask_sql_tpu_torch.runtime import spill as port_spill
from dask_sql_tpu_torch.runtime import telemetry as port_tel
from dask_sql_tpu_torch.server import app as port_app

PKGS = {
    "jax": SimpleNamespace(app=jax_app, R=jax_res, F=jax_faults,
                           S=jax_spill, sched=jax_sched, tel=jax_tel,
                           Context=JaxContext, kw={}, module="dask_sql_tpu"),
    "port": SimpleNamespace(app=port_app, R=port_res, F=port_faults,
                            S=port_spill, sched=port_sched, tel=port_tel,
                            Context=Context, kw={"device": "cpu"},
                            module="dask_sql_tpu_torch"),
}


def _frame():
    return pd.DataFrame({
        "a": [3, 1, 2, 1, 5, 4, 6, 2, 7, 3],
        "b": ["x", "y", None, "x", "z", "y", "x", "w", "z", "y"],
        "f": [1.5, np.nan, 2.25, 0.5, 4.0, -1.0, 3.5, np.nan, 8.0, 0.125],
        "ts": pd.to_datetime(["2020-01-01 10:00", "2020-01-02", "2020-02-29",
                              "2021-03-04 05:06:07", "2019-12-31",
                              "2020-06-15 12:30", "2020-01-01", "2022-02-02",
                              "2023-07-07 07:07", "2020-10-10"],
                             format="ISO8601"),
    })


def _start(P):
    ctx = P.Context(**P.kw)
    ctx.create_table("df", _frame())
    srv = P.app.run_server(context=ctx, host="127.0.0.1", port=0,
                           blocking=False)
    return SimpleNamespace(ctx=ctx, srv=srv,
                           url=f"http://127.0.0.1:{srv.server_port}")


def _stop(s):
    try:
        s.srv.shutdown()
        s.srv.server_close()
    except Exception:
        pass
    s.srv.app_state.drained.set()


@pytest.fixture(scope="module")
def servers():
    out = {name: _start(P) for name, P in PKGS.items()}
    yield out
    for s in out.values():
        _stop(s)


def _post(url, body, headers=None):
    req = urllib.request.Request(url, data=body.encode(), method="POST",
                                 headers=headers or {})
    with urllib.request.urlopen(req) as r:
        return json.loads(r.read())


def _get(url):
    with urllib.request.urlopen(url) as r:
        return json.loads(r.read())


def _poll(payload, timeout=60):
    deadline = time.time() + timeout
    while "nextUri" in payload and "/v1/status/" in payload["nextUri"] \
            and time.time() < deadline:
        time.sleep(0.02)
        payload = _get(payload["nextUri"])
    return payload


def _run(base, sql):
    return _poll(_post(f"{base}/v1/statement", sql))


def _null_nan(v):
    return None if isinstance(v, float) and math.isnan(v) else v


def _assert_rows_equal(got, want):
    assert len(got) == len(want)
    for g_row, w_row in zip(got, want):
        assert len(g_row) == len(w_row)
        for g, w in zip(g_row, w_row):
            w = _null_nan(w)
            if isinstance(w, float) and g is not None:
                assert g == pytest.approx(w, rel=1e-12), (g_row, w_row)
            else:
                assert g == w, (g_row, w_row)


SQL = {
    "select": "SELECT * FROM df ORDER BY a, ts",
    "group": "SELECT b, SUM(a) AS s, AVG(f) AS m, COUNT(*) AS n FROM df "
             "GROUP BY b ORDER BY b",
    "literal": "SELECT 1 + 1 AS x",
    "nulls": "SELECT a, b, ts FROM df WHERE f IS NULL ORDER BY a",
    "dates": "SELECT CAST(ts AS DATE) AS d, a * 0.5 AS h FROM df "
             "ORDER BY d, h",
    "empty": "SELECT a FROM df WHERE a > 100",
}

ERRORS = {
    "missing_table": "SELECT * FROM missing_table",
    "parse": "SELECT 1 + ",
    "binder": "SELECT nope FROM df\nWHERE boom",
}


@pytest.mark.parametrize("key", sorted(SQL))
def test_payload_equal_jax(servers, key):
    got = {name: _run(s.url, SQL[key]) for name, s in servers.items()}
    port, jax = got["port"], got["jax"]
    assert port["stats"]["state"] == jax["stats"]["state"] == "FINISHED"
    assert port.get("columns") == jax.get("columns")
    _assert_rows_equal(port.get("data", []), jax.get("data", []))
    assert set(port["stats"]) == set(jax["stats"])
    assert port["stats"]["processedRows"] == jax["stats"]["processedRows"]
    assert "nextUri" not in port and "error" not in port


def _normalized_error(P, payload):
    err = dict(payload["error"])
    err["errorName"] = err["errorName"].replace(P.module + ".",
                                                "<package>.")
    return err


@pytest.mark.parametrize("key", sorted(ERRORS))
def test_error_payload_equal_jax(servers, key):
    got = {name: _normalized_error(PKGS[name], _run(s.url, ERRORS[key]))
           for name, s in servers.items()}
    assert got["port"] == got["jax"]
    assert "errorLocation" in got["port"]


def test_direct_answer_equals_wire(servers):
    s = servers["port"]
    payload = _run(s.url, SQL["group"])
    direct = s.ctx.sql(SQL["group"]).to_pylist()
    assert payload["data"] == direct


def test_float_null_is_json_null(servers):
    raw = {}
    for name, s in servers.items():
        p = _post(f"{s.url}/v1/statement", "SELECT f FROM df ORDER BY a, ts")
        while "nextUri" in p:
            time.sleep(0.02)
            with urllib.request.urlopen(p["nextUri"]) as r:
                body = r.read().decode()
            p = json.loads(body)
        raw[name] = body
    assert "NaN" not in raw["port"] and "null" in raw["port"]
    assert "NaN" in raw["jax"]


def test_empty_equal_jax(servers):
    got = {name: _get(f"{s.url}/v1/empty") for name, s in servers.items()}
    for name, s in servers.items():
        assert got[name].pop("infoUri") == s.url
    assert got["port"] == got["jax"]


def test_unknown_routes_404(servers):
    for s in servers.values():
        for path in ("/v1/status/nope", "/v1/events", "/v1/fleet",
                     "/v1/result/nope/1"):
            with pytest.raises(urllib.error.HTTPError) as exc:
                _get(f"{s.url}{path}")
            assert exc.value.code == 404, path
        req = urllib.request.Request(f"{s.url}/v1/ingest", data=b"{}",
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req)
        assert exc.value.code == 404


# ---------------------------------------------------------------------------
# paging
# ---------------------------------------------------------------------------

def _collect_pages(base, sql):
    payload = _poll(_post(f"{base}/v1/statement", sql))
    rows, pages, seen = list(payload.get("data", [])), 1, []
    while "nextUri" in payload:
        seen.append(payload["nextUri"])
        payload = _get(payload["nextUri"])
        rows.extend(payload.get("data", []))
        pages += 1
    return rows, pages, seen


def test_paging_equal_jax_and_direct(servers, monkeypatch):
    monkeypatch.setenv("DSQL_RESULT_PAGE_ROWS", "3")
    sql = "SELECT a, b, ts FROM df ORDER BY a, ts"
    got = {name: _collect_pages(s.url, sql) for name, s in servers.items()}
    assert got["port"][1] == got["jax"][1] == 5   # 4 data pages + the end
    assert got["port"][0] == got["jax"][0]
    assert got["port"][0] == [[_cell(v) for v in row] for row in
                              servers["port"].ctx.sql(sql).to_pylist()]
    # pages free as fetched: a collected page is gone
    with pytest.raises(urllib.error.HTTPError) as exc:
        _get(got["port"][2][0])
    assert exc.value.code in (404, 410)


def test_result_spool_fault_serves_unpaged(servers, monkeypatch):
    monkeypatch.setenv("DSQL_RESULT_PAGE_ROWS", "3")
    for name, s in servers.items():
        with PKGS[name].F.inject("result_spool:1"):
            payload = _run(s.url, "SELECT a FROM df ORDER BY a")
        assert len(payload["data"]) == 10 and "nextUri" not in payload


# ---------------------------------------------------------------------------
# cancel, 429, drain
# ---------------------------------------------------------------------------

def test_cancel_equal_jax(servers):
    for s in servers.values():
        payload = _post(f"{s.url}/v1/statement", "SELECT SUM(a) FROM df")
        req = urllib.request.Request(payload["partialCancelUri"],
                                     method="DELETE")
        with urllib.request.urlopen(req) as r:
            assert r.status == 200
        with pytest.raises(urllib.error.HTTPError) as exc:
            _get(payload["nextUri"])
        assert exc.value.code == 404
        req = urllib.request.Request(f"{s.url}/v1/cancel/nope",
                                     method="DELETE")
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req)
        assert exc.value.code == 404


def _429(P, base):
    mgr = P.sched.get_manager()
    holder = mgr.acquire("interactive", 0)
    try:
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(f"{base}/v1/statement", "SELECT 1 + 1",
                  headers={"X-DSQL-Priority": "batch"})
    finally:
        mgr.release(holder)
    body = json.loads(exc.value.read())
    return (exc.value.code, int(exc.value.headers["Retry-After"]) >= 1,
            body["error"]["errorName"], body["error"]["errorType"])


def test_full_queue_answers_429_equal_jax(servers, monkeypatch):
    monkeypatch.setenv("DSQL_MAX_CONCURRENT_QUERIES", "1")
    monkeypatch.setenv("DSQL_QUEUE_DEPTH", "0")
    got = {name: _429(PKGS[name], s.url) for name, s in servers.items()}
    assert got["port"] == got["jax"] == (
        429, True, "QUERY_QUEUE_FULL", "INSUFFICIENT_RESOURCES")


def _drain(P, monkeypatch):
    """A query waits for the one slot; the server drains: a new POST is
    503, the query in flight finishes once the slot frees, and the server
    stops after its result is collected."""
    monkeypatch.setenv("DSQL_MAX_CONCURRENT_QUERIES", "1")
    monkeypatch.setenv("DSQL_DRAIN_TIMEOUT_S", "20")
    s = _start(P)
    mgr = P.sched.get_manager()
    holder = mgr.acquire("interactive", 0)
    try:
        first = _post(f"{s.url}/v1/statement", "SELECT SUM(a) AS s FROM df")
        deadline = time.time() + 30
        while not mgr.waiting_snapshot() and time.time() < deadline:
            time.sleep(0.01)          # the query waits for the slot
        s.srv.drain_async()
        deadline = time.time() + 5
        while not mgr.draining() and time.time() < deadline:
            time.sleep(0.01)
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(f"{s.url}/v1/statement", "SELECT 1 + 1")
        code = exc.value.code
        retry = int(exc.value.headers["Retry-After"]) >= 1
        name = json.loads(exc.value.read())["error"]["errorName"]
    finally:
        mgr.release(holder)
    done = _poll(first)
    stopped = s.srv.drained_event.wait(10)
    mgr.end_drain()
    _stop(s)
    return code, retry, name, done["data"], stopped


def test_drain_equal_jax(monkeypatch):
    got = {name: _drain(P, monkeypatch) for name, P in PKGS.items()}
    assert got["port"] == got["jax"] == (
        503, True, "SERVER_SHUTTING_DOWN", [[34]], True)


# ---------------------------------------------------------------------------
# /metrics, /v1/engine
# ---------------------------------------------------------------------------

def test_metrics_carry_every_stable_name(servers):
    for name, s in servers.items():
        _run(s.url, SQL["literal"])
        with urllib.request.urlopen(f"{s.url}/metrics") as r:
            assert r.headers["Content-Type"].startswith("text/plain")
            text = r.read().decode()
        series = {line.split(" ")[0] for line in text.splitlines()
                  if line and not line.startswith("#")}
        for k in port_tel.STABLE_COUNTERS:
            assert f"dsql_{k}_total" in series, (name, k)
        for k in port_tel.STABLE_GAUGES:
            assert f"dsql_{k}" in series, (name, k)
        assert 'dsql_query_wall_ms_bucket{le="+Inf"}' in series
    assert set(port_tel.STABLE_COUNTERS) == set(jax_tel.STABLE_COUNTERS)
    assert set(port_tel.STABLE_GAUGES) == set(jax_tel.STABLE_GAUGES)
    assert port_tel.STABLE_HISTOGRAMS == jax_tel.STABLE_HISTOGRAMS


def _shape(v):
    if isinstance(v, dict):
        return {k: _shape(x) for k, x in v.items()}
    return type(v).__name__


def test_engine_sections_equal_jax(servers):
    got = {name: _get(f"{s.url}/v1/engine") for name, s in servers.items()}
    port, jax = got["port"], got["jax"]
    assert set(port) == set(jax)
    for section in set(port) - {"devices", "active", "serverQueries",
                                "pid"}:
        assert _shape(port[section]) == _shape(jax[section]), section
    assert port["devices"] == []       # no CUDA card here
    for section in ("programStore", "history", "profile", "slo"):
        assert port[section]["enabled"] is False


# ---------------------------------------------------------------------------
# the wire matrix
# ---------------------------------------------------------------------------

def _instance(P, name: str):
    if name in ("FaultInjected", "FatalFaultInjected"):
        return getattr(P.F, name)("compile", 1)
    if name.startswith("Spill"):
        return getattr(P.S, name)("boom")
    return getattr(P.R, name)("boom")


def test_wire_matrix_rows_equal_jax():
    shared = {k: v for k, v in port_app.ERROR_WIRE_MATRIX.items()
              if k in jax_app.ERROR_WIRE_MATRIX}
    assert shared == jax_app.ERROR_WIRE_MATRIX
    assert set(port_app.ERROR_WIRE_MATRIX) - set(shared) == {"DeviceLost"}


@pytest.mark.parametrize("name,expected",
                         sorted(port_app.ERROR_WIRE_MATRIX.items()))
def test_wire_matrix_row(name, expected):
    status, error_type, error_name = expected
    rows = {}
    for pkg, P in PKGS.items():
        if name not in P.app.ERROR_WIRE_MATRIX:
            continue
        exc = _instance(P, name)
        err = P.app._error_payload(str(exc), "uid-1", exc=exc)["error"]
        rows[pkg] = (P.app.submit_status(exc), err["errorType"],
                     err["errorName"], err["errorCode"] == exc.error_code)
    assert rows["port"] == (status, error_type, error_name, True)
    assert rows.get("jax", rows["port"]) == rows["port"]


def test_matrix_covers_every_taxonomy_class():
    mapped = set(port_app.ERROR_WIRE_MATRIX)

    def walk(cls):
        yield cls
        for sub in cls.__subclasses__():
            yield from walk(sub)

    for cls in walk(port_res.ResilienceError):
        if cls is port_res.ResilienceError or cls.__name__ in mapped:
            continue
        anc = next((a for a in cls.__mro__[1:] if a.__name__ in mapped),
                   None)
        assert anc is not None, f"unmapped taxonomy class {cls.__name__}"
        for attr in ("error_type", "error_name", "error_code"):
            assert getattr(cls, attr) == getattr(anc, attr), cls.__name__


def test_tenant_quota_answers_429(servers, monkeypatch):
    monkeypatch.setenv("DSQL_TENANT_CONCURRENT", "1")
    from dask_sql_tpu.runtime import tenancy as jax_ten
    from dask_sql_tpu_torch.runtime import tenancy as port_ten

    got = {}
    for name, ten in (("jax", jax_ten), ("port", port_ten)):
        ten.get_registry()._reset_for_tests()
        grant = ten.get_registry().claim("crowded")
        try:
            with pytest.raises(urllib.error.HTTPError) as exc:
                _post(f"{servers[name].url}/v1/statement", "SELECT 1 + 1",
                      headers={"X-DSQL-Tenant": "crowded"})
        finally:
            ten.get_registry().release(grant)
            ten.get_registry()._reset_for_tests()
        got[name] = (exc.value.code, int(exc.value.headers["Retry-After"]),
                     json.loads(exc.value.read())["error"]["errorName"])
    assert got["port"] == got["jax"] == (429, 1, "TENANT_QUOTA_EXCEEDED")


def test_concurrent_clients(servers, monkeypatch):
    """Eight clients at once through the admission manager at its default
    width: every answer equals the direct one."""
    monkeypatch.setenv("DSQL_MAX_CONCURRENT_QUERIES", "4")
    s = servers["port"]
    sql = [SQL["group"], SQL["select"], SQL["dates"], SQL["nulls"]] * 2
    want = [s.ctx.sql(q).to_pylist() for q in sql]
    got = [None] * len(sql)

    def client(i):
        got[i] = _run(s.url, sql[i])["data"]

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(sql))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    for g, w in zip(got, want):
        _assert_rows_equal(g, [[_cell(v) for v in row] for row in w])


def _cell(v):
    if hasattr(v, "isoformat"):
        return v.isoformat(sep=" ") if hasattr(v, "date") else v.isoformat()
    return v


def test_slow_query_log_and_chrome_trace_equal_jax(monkeypatch, tmp_path):
    """``DSQL_SLOW_QUERY_MS`` counts and logs a slow query and
    ``DSQL_CHROME_TRACE_DIR`` writes its span tree, in both packages: the
    same counter step, one file each, the same span names."""
    monkeypatch.setenv("DSQL_SLOW_QUERY_MS", "0")
    got = {}
    for name, P in PKGS.items():
        monkeypatch.setenv("DSQL_CHROME_TRACE_DIR", str(tmp_path / name))
        ctx = P.Context(**P.kw)
        ctx.create_table("df", _frame())
        before = P.tel.REGISTRY.counters()["slow_queries"]
        monkeypatch.setenv("DSQL_COMPILE", "0")
        ctx.sql("SELECT b, SUM(a) AS s FROM df GROUP BY b")
        slow = P.tel.REGISTRY.counters()["slow_queries"] - before
        files = sorted((tmp_path / name).iterdir())
        events = json.loads(files[-1].read_text())["traceEvents"]
        got[name] = (slow, len(files), sorted({e["name"] for e in events}),
                     sorted(ctx.last_report.to_dict()))
    assert got["port"][:3] == got["jax"][:3]
    assert set(got["port"][3]) <= set(got["jax"][3])
    assert got["port"][0] == 1 and "parse" in got["port"][2]
