"""The port's fleet plane (``runtime/fleet.py``) against the JAX package's.

It mirrors ``tests/unit/test_fleet.py`` and
``tests/integration/test_fleet_plane.py``: replica ids, arming (the ring
redirection through ``os.environ.setdefault``), heartbeats with TTL
expiry and corrupt files skipped, the merged event and envelope streams
and the composite ``replica:seq;...`` cursor, and the server's surface
(``/v1/fleet``, ``/v1/events?fleet=1``, the ``replica`` label on
``/metrics``, the ``fleet`` section of ``/v1/engine``; 404 and no label
disarmed).  Real replicas share one directory: two port processes
(``device="cpu"``) and one JAX process each arm the fleet, run a query and
publish events under one trace id, and both packages' readers give equal
registries, merged rows and cursor walks over the mixed directory.

Arming sets ``DSQL_EVENTS``, ``DSQL_EVENTS_FILE``, ``DSQL_HISTORY_FILE``
and ``DSQL_REPLICA_ID`` in ``os.environ`` with ``setdefault``, which
monkeypatch does not see: every fixture here removes them and resets the
fleet and event modules of both packages afterwards.
"""
import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch

from dask_sql_tpu.runtime import events as jax_ev
from dask_sql_tpu.runtime import fleet as jax_fleet
from dask_sql_tpu_torch import Context, run_server
from dask_sql_tpu_torch.runtime import events as ev
from dask_sql_tpu_torch.runtime import fleet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
BOTH = {"jax": jax_fleet, "port": fleet}
#: what arming writes into os.environ
ARMED_VARS = ("DSQL_EVENTS", "DSQL_EVENTS_FILE", "DSQL_HISTORY_FILE",
              "DSQL_REPLICA_ID")


def _reset_all() -> None:
    for mod in (fleet, jax_fleet, ev, jax_ev):
        mod._reset_for_tests()


@pytest.fixture()
def armed(tmp_path, monkeypatch):
    """The fleet directory set for both packages, neither armed yet."""
    monkeypatch.setenv("DSQL_FLEET_DIR", str(tmp_path))
    monkeypatch.setenv("DSQL_FLEET_BEAT_S", "0.1")
    for key in ARMED_VARS:
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("DSQL_REPLICA_ID", "r-a")
    _reset_all()
    yield tmp_path
    _reset_all()
    for key in ARMED_VARS:
        os.environ.pop(key, None)


# ---------------------------------------------------------------------------
# identity and arming
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("raw", ["ok-Name_1.x", "bad id/../../etc", ""])
def test_replica_id_equals_the_jax_packages(armed, monkeypatch, raw):
    if raw:
        monkeypatch.setenv("DSQL_REPLICA_ID", raw)
    else:
        monkeypatch.delenv("DSQL_REPLICA_ID")
    _reset_all()
    rid = fleet.replica_id()
    assert rid == jax_fleet.replica_id()
    assert "/" not in rid and " " not in rid
    if raw == "ok-Name_1.x":
        assert rid == raw
    elif not raw:
        assert rid.endswith(f"-{os.getpid()}")


def test_ensure_armed_installs_the_ring_redirection(armed):
    assert fleet.ensure_armed() is True
    assert os.environ["DSQL_EVENTS"] == "1"
    assert os.environ["DSQL_EVENTS_FILE"] == fleet.events_path("r-a") \
        == jax_fleet.events_path("r-a") == str(armed / "events-r-a.jsonl")
    assert os.environ["DSQL_HISTORY_FILE"] == fleet.history_path("r-a") \
        == jax_fleet.history_path("r-a")
    assert fleet.heartbeat_path() == jax_fleet.heartbeat_path()
    assert os.path.exists(fleet.heartbeat_path())
    assert fleet.ensure_armed() is True          # idempotent


def test_ensure_armed_is_a_no_op_unset(armed, monkeypatch):
    monkeypatch.delenv("DSQL_FLEET_DIR")
    _reset_all()
    assert fleet.ensure_armed() is False
    assert "DSQL_EVENTS" not in os.environ


@pytest.mark.parametrize("name", ["beat", "ttl"])
def test_knobs_equal_the_jax_packages(armed, monkeypatch, name):
    for beat, ttl in (("", ""), ("0.01", ""), ("3", "1"), ("x", "y")):
        monkeypatch.setenv("DSQL_FLEET_BEAT_S", beat)
        monkeypatch.setenv("DSQL_FLEET_TTL_S", ttl)
        fn = "beat_interval_s" if name == "beat" else "ttl_s"
        assert getattr(fleet, fn)() == getattr(jax_fleet, fn)()


# ---------------------------------------------------------------------------
# heartbeats
# ---------------------------------------------------------------------------

def test_a_dead_replica_expires_by_its_ttl(armed):
    fleet.ensure_armed()
    stale = {"replica": "r-dead", "pid": 99999, "host": "gone",
             "started": time.time() - 100, "beat": time.time() - 100}
    with open(fleet.heartbeat_path("r-dead"), "w") as f:
        json.dump(stale, f)
    reps = {r["replica"]: r for r in fleet.read_replicas()}
    assert reps["r-a"]["alive"] is True
    assert reps["r-dead"]["alive"] is False
    assert reps["r-dead"]["age_s"] > fleet.ttl_s()
    snap = fleet.snapshot()
    assert snap["totals"]["replicas"] == 2 and snap["totals"]["alive"] == 1


def test_corrupt_and_torn_heartbeats_are_skipped(armed):
    fleet.ensure_armed()
    rd = fleet.replicas_dir()
    for name, text in (("torn.json", '{"replica": "r-torn", "pid"'),
                       ("scalar.json", "42"), ("empty.json", ""),
                       ("anon.json", json.dumps({"pid": 1}))):
        with open(os.path.join(rd, name), "w") as f:
            f.write(text)
    assert [r["replica"] for r in fleet.read_replicas()] == ["r-a"]
    assert [r["replica"] for r in jax_fleet.read_replicas()] == ["r-a"]


def test_heartbeat_has_the_jax_packages_sections(armed, monkeypatch):
    import dask_sql_tpu_torch.runtime as runtime_pkg

    # another test of this process may have armed the store and imported
    # it: take it out of the process, so that an import by the heartbeat
    # shows below
    name = "dask_sql_tpu_torch.runtime.program_store"
    if name in sys.modules:
        monkeypatch.delitem(sys.modules, name)
    if hasattr(runtime_pkg, "program_store"):
        monkeypatch.delattr(runtime_pkg, "program_store")
    fleet.ensure_armed()
    hb = fleet.collect_heartbeat()
    jhb = jax_fleet.collect_heartbeat()
    assert set(hb) == set(jhb)
    assert set(hb["counters"]) == set(jhb["counters"])
    assert hb["replica"] == "r-a" and hb["pid"] == os.getpid()
    # the program store unarmed: disabled, zeros, nothing imported
    assert hb["programStore"] == {"enabled": False, "entries": 0,
                                  "bytes": 0, "hits": 0, "misses": 0,
                                  "hitRate": 0.0}
    assert name not in sys.modules


def test_a_context_arms_the_fleet_and_stamps_its_reports(armed):
    c = Context(device=CPU)
    assert os.path.exists(fleet.heartbeat_path("r-a"))
    c.create_table("t", {"a": np.arange(4)})
    assert c.sql("SELECT SUM(a) AS s FROM t").to_pylist() == [[6]]
    assert c.last_report.replica == "r-a"
    assert c.last_report.to_dict()["replica"] == "r-a"
    # the history and the bus went to this replica's rings
    (rec,) = [r for r in fleet.merged_query_rows()
              if r["query"] == "SELECT SUM(a) AS s FROM t"]
    assert rec["replica"] == "r-a"
    types = {r["type"] for r in fleet.merged_events_rows()}
    assert {"query.begin", "query.done"} <= types


# ---------------------------------------------------------------------------
# merged streams, written by hand
# ---------------------------------------------------------------------------

def _write_ring(path, recs):
    with open(path, "a") as f:
        for rec in recs:
            f.write(json.dumps(rec) + "\n")


def test_merged_events_in_timestamp_order_equal_the_jax_packages(armed):
    fleet.ensure_armed()
    base = time.time()
    _write_ring(fleet.events_path("r-b"), [
        {"seq": 1, "unix": base + 0.2, "pid": 2, "trace": "t1",
         "type": "b.first"},
        {"seq": 2, "unix": base + 0.4, "pid": 2, "trace": "t1",
         "type": "b.second", "extra": 5}])
    _write_ring(fleet.events_path("r-c"), [
        {"seq": 1, "unix": base + 0.1, "pid": 3, "trace": "t1",
         "type": "c.first"},
        {"seq": 2, "unix": base + 0.3, "pid": 3, "trace": "t2",
         "type": "c.second"}])
    rows = [r for r in fleet.merged_events_rows()
            if r["replica"] in ("r-b", "r-c")]
    assert [r["type"] for r in rows] == [
        "c.first", "b.first", "c.second", "b.second"]
    assert {r["replica"] for r in rows if r["trace"] == "t1"} == \
        {"r-b", "r-c"}
    assert fleet.merged_events_rows() == jax_fleet.merged_events_rows()


def test_composite_cursor_is_monotonic_and_lossless(armed):
    fleet.ensure_armed()
    base = time.time()
    _write_ring(fleet.events_path("r-b"), [
        {"seq": i, "unix": base + i * 0.1, "pid": 2, "type": f"b.{i}"}
        for i in range(1, 6)])
    _write_ring(fleet.events_path("r-c"), [
        {"seq": i, "unix": base + i * 0.1 + 0.05, "pid": 3,
         "type": f"c.{i}"} for i in range(1, 6)])
    walks = {}
    for pkg, mod in BOTH.items():
        seen, cursor = [], ""
        for _ in range(20):
            batch, nxt = mod.read_merged_since(cursor, limit=3)
            if not batch:
                assert nxt == cursor       # never regresses when idle
                break
            seen.extend(batch)
            cursor = nxt
        walks[pkg] = seen
    seen = [r for r in walks["port"] if r["replica"] in ("r-b", "r-c")]
    assert [r["type"] for r in seen if r["replica"] == "r-b"] == \
        [f"b.{i}" for i in range(1, 6)]
    assert len(seen) == 10
    assert [r["unix"] for r in seen] == sorted(r["unix"] for r in seen)
    assert walks["port"] == walks["jax"]


@pytest.mark.parametrize("pkg", sorted(BOTH))
def test_cursor_round_trip_is_tolerant(pkg):
    mod = BOTH[pkg]
    assert mod.parse_cursor(None) == {}
    assert mod.parse_cursor("garbage") == {}
    assert mod.parse_cursor("r-a:zzz;r-b:3") == {"r-b": 3}
    cur = {"r-a": 7, "r-b": 3}
    assert mod.parse_cursor(mod.encode_cursor(cur)) == cur
    assert fleet.encode_cursor(cur) == jax_fleet.encode_cursor(cur)


def test_merged_query_rows_stamp_the_replica(armed):
    fleet.ensure_armed()
    _write_ring(fleet.history_path("r-b"), [
        {"kind": "query", "unix": time.time(), "query": "SELECT 1",
         "wall_ms": 3.0},
        {"kind": "stage", "unix": time.time()}])
    rows = [r for r in fleet.merged_query_rows() if r["replica"] == "r-b"]
    assert len(rows) == 1 and rows[0]["query"] == "SELECT 1"
    assert fleet.merged_query_rows() == jax_fleet.merged_query_rows()
    assert fleet.merged_slo()["classes"] == jax_fleet.merged_slo()["classes"]


# ---------------------------------------------------------------------------
# real replicas: two port processes and a JAX one share a directory
# ---------------------------------------------------------------------------

_CHILD = """
import os, sys
import numpy as np
pkg, n, trace = sys.argv[1], int(sys.argv[2]), sys.argv[3]
if pkg == "jax":
    from dask_sql_tpu import Context
    from dask_sql_tpu.runtime import events, fleet
    c = Context()
else:
    from dask_sql_tpu_torch import Context
    from dask_sql_tpu_torch.runtime import events, fleet
    c = Context(device="cpu")
c.create_table("t", {"a": np.arange(4, dtype=np.int64)})
assert c.sql("SELECT SUM(a) AS s FROM t").to_pylist() == [[6]]
for i in range(n):
    events.publish("child.tick", trace=trace, detail={"i": i})
fleet.write_heartbeat_now()
print(fleet.replica_id())
"""
CHILDREN = (("r-one", "port"), ("r-two", "port"), ("r-jax", "jax"))


@pytest.fixture(scope="module")
def replicas(tmp_path_factory):
    """Three replica processes, started together, in one directory."""
    d = tmp_path_factory.mktemp("fleet")
    procs = []
    for rid, pkg in CHILDREN:
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("DSQL_")}
        env.update(DSQL_FLEET_DIR=str(d), DSQL_REPLICA_ID=rid,
                   DSQL_FLEET_BEAT_S="0.2", DSQL_TIERED="0",
                   DSQL_RESULT_CACHE_MB="0",
                   DSQL_MAX_CONCURRENT_QUERIES="0", JAX_PLATFORMS="cpu",
                   CUDA_VISIBLE_DEVICES="")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _CHILD, pkg, "5", "trace-x"], cwd=ROOT,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    for (rid, _), p in zip(CHILDREN, procs):
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err.decode()[-3000:]
        assert out.decode().split()[-1] == rid
    return d


@pytest.fixture()
def shared(replicas, monkeypatch):
    """This process reads the replicas' directory, unarmed."""
    monkeypatch.setenv("DSQL_FLEET_DIR", str(replicas))
    monkeypatch.setenv("DSQL_FLEET_BEAT_S", "0.2")
    for key in ARMED_VARS:
        monkeypatch.delenv(key, raising=False)
    _reset_all()
    yield replicas
    _reset_all()
    for key in ARMED_VARS:
        os.environ.pop(key, None)


def test_replicas_of_both_packages_merge_in_either(shared):
    rows = fleet.merged_events_rows()
    assert len(rows) >= 15
    assert [r["unix"] for r in rows] == sorted(r["unix"] for r in rows)
    ticks = [r for r in rows if r["type"] == "child.tick"]
    assert len(ticks) == 15
    assert {r["replica"] for r in ticks if r["trace"] == "trace-x"} == \
        {"r-one", "r-two", "r-jax"}
    for rid, _ in CHILDREN:
        seqs = [r["seq"] for r in rows if r["replica"] == rid]
        assert seqs == sorted(seqs)
    assert rows == jax_fleet.merged_events_rows()
    queries = fleet.merged_query_rows()
    assert sorted(r["replica"] for r in queries) == ["r-jax", "r-one",
                                                      "r-two"]
    assert queries == jax_fleet.merged_query_rows()
    regs = {pkg: {r["replica"]: r for r in mod.read_replicas()}
            for pkg, mod in BOTH.items()}
    assert set(regs["port"]) == set(regs["jax"]) == {"r-one", "r-two",
                                                      "r-jax"}
    for rid in regs["port"]:
        a, b = dict(regs["port"][rid]), dict(regs["jax"][rid])
        for r in (a, b):
            r.pop("age_s")
            r.pop("alive")
        assert a == b
    # the JAX replica's heartbeat reads its store as the port's does
    assert regs["port"]["r-one"]["programStore"]["enabled"] is False


def test_the_composite_cursor_walks_the_replicas_once(shared):
    rows = fleet.merged_events_rows()
    walks = {}
    for pkg, mod in BOTH.items():
        seen, cursor = [], ""
        while True:
            batch, cursor = mod.read_merged_since(cursor, limit=4)
            if not batch:
                break
            seen.extend(batch)
        walks[pkg] = [(r["replica"], r["seq"]) for r in seen]
    assert walks["port"] == [(r["replica"], r["seq"]) for r in rows]
    assert walks["port"] == walks["jax"]


def test_system_tables_read_the_merged_fleet(shared):
    c = Context(device=CPU)
    reps = c.sql("SELECT replica FROM system.replicas").to_pylist()
    assert {r[0] for r in reps} >= {"r-one", "r-two", "r-jax"}
    ticks = c.sql("SELECT replica, seq FROM system.events "
                  "WHERE type = 'child.tick'").to_pylist()
    assert len(ticks) == 15
    qs = c.sql("SELECT replica FROM system.queries "
               "WHERE query = 'SELECT SUM(a) AS s FROM t'").to_pylist()
    assert {r[0] for r in qs} == {"r-one", "r-two", "r-jax"}


def test_dead_replicas_age_out(shared):
    """The children exited: past the TTL each reads as dead, without a
    file being removed."""
    deadline = time.time() + 3 * fleet.ttl_s() + 5
    while time.time() < deadline:
        rows = {r["replica"]: r for r in fleet.read_replicas()}
        if not any(rows[rid]["alive"] for rid, _ in CHILDREN):
            break
        time.sleep(0.1)
    assert not any(rows[rid]["alive"] for rid, _ in CHILDREN)
    assert len(os.listdir(fleet.replicas_dir())) >= 3


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------

@pytest.fixture()
def fleet_server(armed, monkeypatch):
    monkeypatch.setenv("DSQL_REPLICA_ID", "r-parent")
    _reset_all()
    c = Context(device=CPU)
    c.create_table("t", {"a": np.arange(8, dtype=np.int64)})
    srv = run_server(context=c, host="127.0.0.1", port=0, blocking=False)
    yield f"http://127.0.0.1:{srv.server_port}", armed
    srv.shutdown()
    srv.server_close()


def _get(url):
    with urllib.request.urlopen(url) as r:
        return json.loads(r.read())


def test_v1_fleet_snapshot_agrees_with_the_engine(fleet_server):
    base, d = fleet_server
    snap = _get(f"{base}/v1/fleet")
    for key in ("dir", "replica", "replicas", "totals", "slo", "anomalies"):
        assert key in snap, key
    assert snap["replica"] == "r-parent"
    rows = {r["replica"]: r for r in snap["replicas"]}
    assert rows["r-parent"]["alive"] is True
    assert snap["totals"]["warmServes"] == 0
    engine = _get(f"{base}/v1/engine")
    assert engine["fleet"] == {"replica": "r-parent", "dir": str(d)}
    assert rows["r-parent"]["pid"] == engine["pid"]
    assert "autopilot" not in engine


def test_v1_events_fleet_mode_uses_the_composite_cursor(fleet_server):
    base, _ = fleet_server
    ev.publish("srv.alpha", trace="t-s")
    ev.publish("srv.beta", trace="t-s")
    with urllib.request.urlopen(f"{base}/v1/events?fleet=1&limit=1") as r:
        lines = [json.loads(x) for x in r.read().splitlines() if x]
        cur1 = r.headers["X-DSQL-Cursor"]
    assert len(lines) == 1 and lines[0]["replica"] == "r-parent"
    assert ":" in cur1
    with urllib.request.urlopen(
            f"{base}/v1/events?fleet=1&cursor={urllib.parse.quote(cur1)}"
    ) as r:
        lines2 = [json.loads(x) for x in r.read().splitlines() if x]
        cur2 = r.headers["X-DSQL-Cursor"]
    types = [x["type"] for x in lines2]
    assert lines[0]["type"] not in types and "srv.beta" in types
    assert fleet.parse_cursor(cur2)["r-parent"] > \
        fleet.parse_cursor(cur1)["r-parent"]


def test_metrics_carry_the_replica_label(fleet_server):
    base, _ = fleet_server
    with urllib.request.urlopen(f"{base}/metrics") as r:
        body = r.read().decode()
    lines = [ln for ln in body.splitlines() if ln and not ln.startswith("#")]
    assert lines and all('replica="r-parent"' in ln for ln in lines)


@pytest.fixture()
def plain_server(monkeypatch):
    monkeypatch.delenv("DSQL_FLEET_DIR", raising=False)
    c = Context(device=CPU)
    c.create_table("t", {"a": np.arange(4, dtype=np.int64)})
    srv = run_server(context=c, host="127.0.0.1", port=0, blocking=False)
    yield f"http://127.0.0.1:{srv.server_port}"
    srv.shutdown()
    srv.server_close()


def test_disarmed_server_has_no_fleet_surface(plain_server):
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(f"{plain_server}/v1/fleet")
    assert exc.value.code == 404
    with urllib.request.urlopen(f"{plain_server}/metrics") as r:
        assert 'replica="' not in r.read().decode()
    assert "fleet" not in _get(f"{plain_server}/v1/engine")
