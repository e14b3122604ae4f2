"""The port's ``system`` schema (``runtime/system_tables.py`` and
``Context._resolve_system_table``) against the JAX package's.

It mirrors ``tests/unit/test_system_tables.py``: every one of the 18
tables binds and runs on an empty engine, with and without the flight
recorder, with the JAX package's column names and SQL types; after the
same statements in both packages (queries twice through the result
cache, a materialized view refreshed after an append, PREPARE / EXECUTE,
a quarantine verdict) the rows of ten tables are equal, with timings,
pids and the process-global counters' values masked; ``system`` reads are
never cached, a user schema named ``system`` shadows the builtin, an
unknown name fails in both packages, and ``system.active`` shows a query
while it runs.  ``system.programs`` is empty while ``DSQL_PROGRAM_STORE``
is unset and lists the stored build records armed.  ``system.devices``
and ``system.mesh`` hold one ``cpu`` row here where the JAX package has 8
virtual CPU devices: their schemas and per-row values are compared, not
their row counts.
"""
import os
import threading
import time

import numpy as np
import pytest
import torch

import dask_sql_tpu.native as jax_native
from dask_sql_tpu import Context as JaxContext
from dask_sql_tpu.runtime import events as jax_ev
from dask_sql_tpu.runtime import quarantine as jax_quar
from dask_sql_tpu.runtime import system_tables as jax_st
from dask_sql_tpu.runtime import telemetry as jax_tel
from dask_sql_tpu.runtime import tenancy as jax_ten
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.parallel.mesh import Mesh
from dask_sql_tpu_torch.runtime import events as ev
from dask_sql_tpu_torch.runtime import flight_recorder as fr
from dask_sql_tpu_torch.runtime import quarantine as quar
from dask_sql_tpu_torch.runtime import system_tables as st
from dask_sql_tpu_torch.runtime import telemetry as tel
from dask_sql_tpu_torch.runtime import tenancy as ten
from dask_sql_tpu_torch.sql.parser import parse_sql

CPU = torch.device("cpu")


def _schema(table) -> list:
    return [(n, str(c.stype)) for n, c in zip(table.names, table.columns)]


@pytest.fixture()
def hist(tmp_path, monkeypatch):
    path = str(tmp_path / "hist.jsonl")
    monkeypatch.setenv("DSQL_HISTORY_FILE", path)
    return path


def test_the_port_has_the_jax_packages_eighteen_names():
    assert st.TABLE_NAMES == jax_st.TABLE_NAMES
    assert len(st.TABLE_NAMES) == 18


@pytest.mark.parametrize("recorder", ["recorder", "no_recorder"])
@pytest.mark.parametrize("name", st.TABLE_NAMES)
def test_every_table_binds_and_runs_on_an_empty_engine(name, recorder,
                                                       tmp_path,
                                                       monkeypatch):
    if recorder == "recorder":
        monkeypatch.setenv("DSQL_HISTORY_FILE", str(tmp_path / "h.jsonl"))
    else:
        monkeypatch.delenv("DSQL_HISTORY_FILE", raising=False)
    c = Context(device=CPU)  # no user tables at all
    out = c.sql(f"SELECT * FROM system.{name}")
    assert out.num_columns > 0
    want = _schema(jax_st.build(name, JaxContext()))
    assert _schema(out) == want
    assert _schema(st.build(name, c)) == want


def test_no_recorder_leaves_the_queries_table_empty(monkeypatch):
    monkeypatch.delenv("DSQL_HISTORY_FILE", raising=False)
    c = Context(device=CPU)
    assert c.sql("SELECT count(*) AS n FROM system.queries"
                 ).to_pylist() == [[0]]


# ---------------------------------------------------------------------------
# rows after the same statements in both packages
# ---------------------------------------------------------------------------

STATEMENTS = (
    "SELECT k, SUM(x) AS s FROM t GROUP BY k",
    "SELECT k, SUM(x) AS s FROM t GROUP BY k",
    "CREATE MATERIALIZED VIEW mv AS SELECT k, SUM(x) AS s, COUNT(*) AS n "
    "FROM t GROUP BY k",
    "PREPARE p AS SELECT SUM(x) AS s FROM t WHERE k = ?",
    "EXECUTE p (2)",
    "SELECT COUNT(*) AS n FROM t WHERE x > 10",
)
COMPARED = ("queries", "metrics", "table_stats", "matviews",
            "view_candidates", "prepared", "tenants", "slo", "cache",
            "quarantine")
#: per table, the columns whose values are timings, pids, timestamps or
#: process-global counters (compared by type only)
MASKED = {
    "queries": ("unix", "pid", "wall_ms", "queued_ms"),
    "metrics": ("value",),
    "table_stats": ("collected_ms",),
    "matviews": ("staleness_s", "last_refresh"),
    "view_candidates": ("ewma_ms", "score"),
    # the objectives and windows are equal; the breaches follow the walls
    "slo": ("breaches", "attainment", "burn_fast", "burn_slow", "breach"),
    "cache": ("key",),
    "quarantine": ("at", "expires_at"),
}


@pytest.fixture(scope="module")
def after_statements(tmp_path_factory):
    """Each package runs STATEMENTS on the same table, with its own
    history, event bus, quarantine file and result cache, then appends a
    row and reads the view; the ten tables are built right after."""
    d = tmp_path_factory.mktemp("system_rows")
    mp = pytest.MonkeyPatch()
    # a module fixture runs before tests/conftest.py's per-test pins: the
    # same pins, set here
    for var, value in (("DSQL_TIERED", "0"), ("DSQL_ADAPTIVE", "0"),
                       ("DSQL_MAX_CONCURRENT_QUERIES", "0"),
                       ("DSQL_MESH", "0")):
        mp.setenv(var, value)
    mp.setenv("DSQL_RESULT_CACHE_MB", "64")
    mp.setenv("DSQL_EVENTS", "1")
    # the JAX package's native grammar has no PREPARE: its Python parser
    mp.setattr(jax_native, "_lib", None)
    mp.setattr(jax_native, "_load_attempted", True)
    k = np.array([1, 2, 3, 1, 2, 3] * 20, dtype=np.int64)
    x = np.arange(120, dtype=np.float64)
    out = {}
    try:
        for pkg, make, mod, q, bus, tenants in (
                ("jax", JaxContext, jax_st, jax_quar, jax_ev, jax_ten),
                ("port", lambda: Context(device=CPU), st, quar, ev, ten)):
            mp.setenv("DSQL_HISTORY_FILE", str(d / f"{pkg}.jsonl"))
            mp.setenv("DSQL_QUARANTINE_FILE", str(d / f"{pkg}-q.json"))
            bus._reset_for_tests()
            # the tenant registry counts every query of the process
            tenants.get_registry()._reset_for_tests()
            c = make()
            c.create_table("t", {"k": k, "x": x})
            for sql in STATEMENTS:
                c.sql(sql)
            q.get_store().mark("stage-key", "exiled", "a test verdict")
            c.append_rows("t", {"k": np.array([1], dtype=np.int64),
                                "x": np.array([5.0])})
            c.sql("SELECT * FROM mv")
            out[pkg] = {name: mod.build(name, c) for name in COMPARED}
    finally:
        ev._reset_for_tests()
        jax_ev._reset_for_tests()
        mp.undo()
    return out


def _masked_rows(table, name: str) -> list:
    masked = [i for i, n in enumerate(table.names)
              if n in MASKED.get(name, ())]
    rows = []
    for row in table.to_pylist():
        row = list(row)
        for i in masked:
            row[i] = type(row[i]).__name__
        rows.append(row)
    return rows


@pytest.mark.parametrize("name", COMPARED)
def test_rows_after_the_same_statements_equal_the_jax_packages(
        after_statements, name):
    jt, pt = after_statements["jax"][name], after_statements["port"][name]
    assert _schema(pt) == _schema(jt)
    want, got = _masked_rows(jt, name), _masked_rows(pt, name)
    if name == "metrics":
        # the registries are process-global: the stable names and kinds
        # are compared, not what earlier tests of this process counted
        stable = set(jax_tel.STABLE_COUNTERS) | set(jax_tel.STABLE_GAUGES)
        want = [r for r in want if r[0] in stable]
        got = [r for r in got if r[0] in stable]
        assert len(want) > 100
    if name == "view_candidates":
        # ranked by hits x EWMA wall: equal hits tie on a timing
        want, got = sorted(want, key=repr), sorted(got, key=repr)
    assert got == want
    assert len(got) > 0


def test_queries_reflect_executed_queries(hist):
    c = Context(device=CPU)
    c.create_table("t", {"a": np.array([1, 2, 3])})
    c.sql("SELECT SUM(a) AS s FROM t")
    rows = c.sql("SELECT query, outcome, rows_out FROM system.queries"
                 ).to_pylist()
    assert ["SELECT SUM(a) AS s FROM t", "ok", 1] in rows


def test_metrics_table_carries_the_registry(hist):
    c = Context(device=CPU)
    rows = c.sql("SELECT name, kind, value FROM system.metrics").to_pylist()
    names = {r[0] for r in rows}
    assert "queries" in names and "history_records" in names
    assert {r[1] for r in rows} <= {"counter", "gauge"}


# ---------------------------------------------------------------------------
# never cached, shadowing, unknown names
# ---------------------------------------------------------------------------

def test_system_reads_are_never_cached(hist, monkeypatch):
    monkeypatch.setenv("DSQL_RESULT_CACHE_MB", "64")
    c = Context(device=CPU)
    before = tel.REGISTRY.get("result_cache_hits")
    n1 = c.sql("SELECT count(*) AS n FROM system.queries").to_pylist()[0][0]
    n2 = c.sql("SELECT count(*) AS n FROM system.queries").to_pylist()[0][0]
    # the first count recorded its own envelope: an uncached second read
    # sees one more row, a cached one would repeat n1
    assert n2 == n1 + 1
    assert tel.REGISTRY.get("result_cache_hits") == before


def test_plan_key_is_volatile_for_system_scans(hist):
    from dask_sql_tpu_torch.runtime import result_cache as rc

    c = Context(device=CPU)
    sql = "SELECT * FROM system.metrics"
    plan = c._get_plan(parse_sql(sql)[0].query, sql)
    _text, volatile, _scans = rc.canonical_plan(plan, c)
    assert volatile


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_user_schema_named_system_shadows_the_builtin(hist, pkg):
    c = JaxContext() if pkg == "jax" else Context(device=CPU)
    c.sql("CREATE SCHEMA system")
    with pytest.raises(Exception):
        c.sql("SELECT * FROM system.queries")
    c.sql("DROP SCHEMA system")
    assert c.sql("SELECT * FROM system.metrics").num_rows > 0


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_unknown_system_table_fails(hist, pkg):
    c = JaxContext() if pkg == "jax" else Context(device=CPU)
    with pytest.raises(Exception, match="nosuchtable"):
        c.sql("SELECT * FROM system.nosuchtable")


def test_active_shows_a_live_query(hist):
    """A sleeping column UDF holds one query open on a worker thread while
    this thread reads ``system.active`` through SQL."""
    c = Context(device=CPU)
    c.create_table("t", {"a": np.arange(8, dtype=np.int64)})
    started = threading.Event()

    def slow_fn(x):
        started.set()
        time.sleep(1.0)
        return x.astype(np.float64)

    c.register_function(slow_fn, "slow_fn", [("x", np.int64)], np.float64)
    result = {}

    def run():
        result["rows"] = c.sql("SELECT SUM(slow_fn(a)) AS s FROM t"
                               ).to_pylist()

    worker = threading.Thread(target=run)
    worker.start()
    try:
        assert started.wait(timeout=60), "the UDF never started"
        rows = c.sql("SELECT state, query, phase FROM system.active"
                     ).to_pylist()
        running = [r for r in rows if "slow_fn" in r[1]]
        assert running and running[0][0] == "running", rows
    finally:
        worker.join(timeout=60)
    assert result["rows"] == [[28.0]]
    rows = c.sql("SELECT query FROM system.active").to_pylist()
    assert not any("slow_fn" in r[0] for r in rows)
    assert len(fr._ACTIVE) <= 1  # only this read may still be open


# ---------------------------------------------------------------------------
# the tables that read devices, and the program store's
# ---------------------------------------------------------------------------

def test_programs_is_empty_unarmed_and_raises_armed(tmp_path, monkeypatch):
    """Empty with the JAX package's schema while ``DSQL_PROGRAM_STORE`` is
    unset; armed, one row per stored build record (the name is the one
    the test had while the store was not ported and arming it raised)."""
    monkeypatch.delenv("DSQL_PROGRAM_STORE", raising=False)
    c = Context(device=CPU)
    out = c.sql("SELECT * FROM system.programs")
    assert out.num_rows == 0
    assert _schema(out) == _schema(jax_st.build("programs"))
    monkeypatch.setenv("DSQL_PROGRAM_STORE", str(tmp_path / "store"))
    c.create_table("p", {"a": np.arange(50) % 7, "b": np.arange(50) * 0.5})
    c.sql("SELECT a, SUM(b) AS s FROM p GROUP BY a")
    from dask_sql_tpu_torch.runtime import program_store
    index = program_store.get_store().entries()
    out = c.sql("SELECT * FROM system.programs")
    assert _schema(out) == _schema(jax_st.build("programs"))
    rows = out.to_pylist()
    assert len(index) >= 1 and [r[0] for r in rows] == sorted(index)
    for digest, nbytes, used_at, stored_at, flops, nb in rows:
        assert nbytes == index[digest]["bytes"] > 0
        assert used_at >= stored_at > 0 and flops == nb == 0.0


def test_devices_report_the_cpu_row_of_zeros():
    c = Context(device=CPU)
    rows = c.sql("SELECT * FROM system.devices").to_pylist()
    assert rows == [[0, "cpu", "cpu", 0, 0, 0]]
    # every JAX CPU device reports the same zeros under its own name
    jrows = jax_st.build("devices").to_pylist()
    assert jrows and {tuple(r[1:]) for r in jrows} == {
        ("cpu", "cpu", 0, 0, 0)}


@pytest.mark.parametrize("mesh", ["none", "virtual4"])
def test_mesh_rows_hold_the_contexts_placement(mesh):
    if mesh == "none":
        c = Context(device=CPU)
        jc = JaxContext()
    else:
        c = Context(device=CPU, mesh=Mesh(["cpu"] * 4))
        from dask_sql_tpu.parallel.mesh import default_mesh
        jc = JaxContext(mesh=default_mesh())
    rows = c.sql("SELECT * FROM system.mesh").to_pylist()
    jrows = jax_st.build("mesh", jc).to_pylist()
    assert len(rows) == 1 and rows[0][:4] == [0, "cpu", "cpu", 0]
    # in_mesh, mesh_axes (the axis and the size), mesh_size, spmd_enabled
    # (DSQL_MESH=0 in this module): the JAX package's with its size
    size = 4 if mesh == "virtual4" else 0
    jsize = len(jrows) if mesh == "virtual4" else 0
    want = [[r[4], r[5].replace(f":{jsize}", f":{size}"),
             r[6] and size, r[7]] for r in jrows]
    assert {tuple(w) for w in want} == {tuple(rows[0][4:])}
