"""The port's materialized views (``runtime/matview.py``) against the JAX
package's.

Every test sends the same statements and appends to a
``dask_sql_tpu.Context`` and a ``dask_sql_tpu_torch.Context(device="cpu")``
over the same seeded tables, and compares the answers (ints, strings and
NULLs exactly, doubles at rtol 1e-9), the movements of the refresh
counters (``mv_refresh_incremental``, ``mv_refresh_full``,
``mv_deltas_recorded``, ``mv_serves``), the registries' state and the
full-recompute reasons.  They mirror the JAX package's
``tests/integration/test_matview.py`` and ``tests/unit/test_matview_unit.py``;
its ``system.matviews`` reads become the port's ``matview_rows`` (the
system tables are not ported), and its flight-recorder candidates are
left out with the recorder.
"""
import math

import numpy as np
import pandas as pd
import pytest
import torch

from dask_sql_tpu import Context as JaxContext
from dask_sql_tpu.runtime import faults as jax_faults
from dask_sql_tpu.runtime import matview as jax_mv
from dask_sql_tpu.runtime import result_cache as jax_rc
from dask_sql_tpu.runtime import telemetry as jax_tel
from dask_sql_tpu.runtime.resilience import UserError as JaxUserError
from dask_sql_tpu.sql.parser import parse_sql as jax_parse
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.runtime import faults as port_faults
from dask_sql_tpu_torch.runtime import matview as port_mv
from dask_sql_tpu_torch.runtime import result_cache as port_rc
from dask_sql_tpu_torch.runtime import telemetry as port_tel
from dask_sql_tpu_torch.runtime.resilience import UserError
from dask_sql_tpu_torch.sql.parser import parse_sql

CPU = torch.device("cpu")

COUNTERS = ("mv_refresh_incremental", "mv_refresh_full",
            "mv_deltas_recorded", "mv_serves")


@pytest.fixture(autouse=True)
def _cache_on(monkeypatch):
    # the maintained state is a tenant of the result cache
    monkeypatch.setenv("DSQL_RESULT_CACHE_MB", "64")
    yield


def _mk(n=60, seed=0):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "k": rng.choice(["a", "b", "c", None], n).astype(object),
        "x": np.round(rng.random(n) * 10, 3),
        "y": rng.integers(0, 100, n),
    })


AGG_SQL = ("SELECT k, SUM(x) AS sx, COUNT(*) AS n, COUNT(y) AS ny, "
           "AVG(y) AS ay, MIN(x) AS mn, MAX(x) AS mx FROM t GROUP BY k")


def _cell(v):
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return None
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (pd.Timestamp, np.datetime64)):
        return str(pd.Timestamp(v))
    return v


def _rows(df) -> list:
    rows = [tuple(_cell(v) for v in r) for r in df.itertuples(index=False)]
    return sorted(rows, key=lambda r: tuple(
        (v is None, f"{v:.6g}" if isinstance(v, float) else str(v))
        for v in r))


def assert_same(got, want):
    assert list(got.columns) == list(want.columns)
    g, w = _rows(got), _rows(want)
    assert len(g) == len(w), (g, w)
    for rg, rw in zip(g, w):
        for a, b in zip(rg, rw):
            if isinstance(a, float) or isinstance(b, float):
                assert a is not None and b is not None, (rg, rw)
                assert math.isclose(a, b, rel_tol=1e-9, abs_tol=1e-12), \
                    (rg, rw)
            else:
                assert a == b, (rg, rw)


class Pair:
    """The same statements on both packages' contexts."""

    def __init__(self, **tables):
        self.j, self.p = JaxContext(), Context(device=CPU)
        for name, df in tables.items():
            self.create(name, df)

    def create(self, name, df, **kw):
        self.j.create_table(name, df, **kw)
        self.p.create_table(name, df, **kw)

    def run(self, sql):
        self.j.sql(sql)
        self.p.sql(sql)

    def same(self, sql):
        got = self.p.sql(sql, return_futures=False)
        assert_same(got, self.j.sql(sql, return_futures=False))
        return got

    def append(self, name, rows, **kw):
        nj = self.j.append_rows(name, rows, **kw)
        assert self.p.append_rows(name, rows, **kw) == nj
        return nj

    def raises(self, sql, jax_exc, port_exc):
        with pytest.raises(jax_exc) as ej:
            self.j.sql(sql)
        with pytest.raises(port_exc) as ep:
            self.p.sql(sql)
        assert str(ep.value) == str(ej.value)


class Counters:
    """Both packages' counter movements since it was made."""

    def __init__(self):
        self.j0, self.p0 = self._snap()

    @staticmethod
    def _snap():
        j, p = jax_tel.REGISTRY.counters(), port_tel.REGISTRY.counters()
        return ({n: j.get(n, 0) for n in COUNTERS},
                {n: p.get(n, 0) for n in COUNTERS})

    def moved(self) -> dict:
        j1, p1 = self._snap()
        dj = {n: j1[n] - self.j0[n] for n in COUNTERS}
        dp = {n: p1[n] - self.p0[n] for n in COUNTERS}
        assert dp == dj
        return dp


def _registries(pair):
    return pair.j._matview_registry, pair.p._matview_registry


def _views(pair):
    """The registries' per-view state, equal in both packages."""
    rj, rp = _registries(pair)
    out = []
    for reg in (rj, rp):
        out.append({k: (v.maintainable, v.reason,
                        v.shape.kind if v.shape else None,
                        v.refresh_incremental, v.refresh_full, v.serves,
                        v.last_refresh_reason)
                    for k, v in reg.views.items()})
    assert out[0] == out[1]
    return out[1]


def _system_row_fields(pair):
    """The JAX package's system.matviews rows against the port's
    ``matview_rows`` (fields that do not depend on time)."""
    keep = ("schema", "name", "rows", "maintainable", "reason",
            "base_tables", "pending_deltas", "pending_rows", "serves",
            "refresh_incremental", "refresh_full", "last_refresh",
            "fingerprint")
    want = [{k: r[k] for k in keep} for r in jax_mv.matview_rows(pair.j)]
    got = [{k: r[k] for k in keep} for r in port_mv.matview_rows(pair.p)]
    # the fingerprints digest each package's canonical plan text
    for r in want + got:
        r.pop("fingerprint")
    assert got == want
    return got


# ---------------------------------------------------------------------------
# answers and counters across appends (test_matview.py)
# ---------------------------------------------------------------------------

def test_parity_multi_append_and_overwrite():
    pair = Pair(t=_mk())
    pair.run(f"CREATE MATERIALIZED VIEW v AS {AGG_SQL}")
    moved = Counters()
    pair.same("SELECT * FROM v")
    for i in range(3):
        pair.append("t", _mk(9, seed=10 + i))
        pair.same("SELECT * FROM v")
        pair.same(AGG_SQL)
    assert moved.moved() == {"mv_refresh_incremental": 3,
                             "mv_refresh_full": 0, "mv_deltas_recorded": 3,
                             "mv_serves": 4}
    # an overwrite: a full recompute, never a stale view
    base = _mk()
    pair.create("t", base[base.k != "b"].reset_index(drop=True))
    moved = Counters()
    pair.same("SELECT * FROM v")
    assert moved.moved()["mv_refresh_full"] == 1
    _views(pair)


def test_stale_view_never_served_after_overwrite():
    pair = Pair(t=pd.DataFrame({"k": ["a", "b"], "x": [1.0, 2.0]}))
    pair.run("CREATE MATERIALIZED VIEW v AS SELECT k, SUM(x) AS s FROM t "
             "GROUP BY k")
    pair.append("t", [("a", 10.0)])
    pair.create("t", pd.DataFrame({"k": ["z"], "x": [9.0]}))
    got = pair.same("SELECT * FROM v")
    assert list(got["k"]) == ["z"] and float(got["s"][0]) == 9.0


def test_insert_into_values_and_select_refreshes():
    pair = Pair(t=pd.DataFrame({"k": ["a"], "x": [1.0]}),
                src=pd.DataFrame({"k": ["b", "c"], "x": [2.0, 3.0]}))
    pair.run("CREATE MATERIALIZED VIEW v AS SELECT SUM(x) AS s FROM t")
    moved = Counters()
    pair.run("INSERT INTO t VALUES ('d', 4.0), ('e', NULL)")
    pair.run("INSERT INTO t SELECT * FROM src")
    got = pair.same("SELECT * FROM v")
    assert float(got["s"][0]) == pytest.approx(10.0)
    assert moved.moved()["mv_refresh_incremental"] == 1


def test_projection_pipeline_view_appends():
    pair = Pair(t=_mk(40))
    pair.run("CREATE MATERIALIZED VIEW vp AS SELECT k, x * 2 AS x2 FROM t "
             "WHERE y >= 50")
    moved = Counters()
    for i in range(2):
        pair.append("t", _mk(11, seed=33 + i))
        pair.same("SELECT * FROM vp")
        pair.same("SELECT k, x * 2 AS x2 FROM t WHERE y >= 50")
    assert moved.moved()["mv_refresh_incremental"] == 2
    assert _views(pair)[("root", "vp")][2] == "append"


def test_refresh_after_drop_and_recreate():
    pair = Pair(t=pd.DataFrame({"k": ["a"], "x": [1.0]}))
    pair.run("CREATE MATERIALIZED VIEW v AS SELECT SUM(x) AS s FROM t")
    pair.run("DROP MATERIALIZED VIEW v")
    with pytest.raises(Exception):
        pair.j.sql("SELECT * FROM v")
    with pytest.raises(Exception):
        pair.p.sql("SELECT * FROM v")
    pair.append("t", [("b", 5.0)])
    pair.run("CREATE MATERIALIZED VIEW v AS SELECT SUM(x) AS s FROM t")
    moved = Counters()
    pair.run("REFRESH MATERIALIZED VIEW v")  # fresh: nothing to do
    got = pair.same("SELECT * FROM v")
    assert float(got["s"][0]) == 6.0
    assert moved.moved()["mv_refresh_full"] == 0


def test_explicit_refresh_applies_pending_deltas():
    pair = Pair(t=pd.DataFrame({"k": ["a"], "x": [1.0]}))
    pair.run("CREATE MATERIALIZED VIEW v AS SELECT SUM(x) AS s FROM t")
    moved = Counters()
    pair.append("t", [("b", 2.0)])
    pair.run("REFRESH MATERIALIZED VIEW v")
    assert moved.moved()["mv_refresh_incremental"] == 1
    got = pair.same("SELECT * FROM v")   # fresh: no second refresh
    assert float(got["s"][0]) == 3.0
    assert moved.moved()["mv_refresh_incremental"] == 1


def test_drop_table_on_matview_cleans_registry():
    pair = Pair(t=pd.DataFrame({"k": ["a"], "x": [1.0]}))
    pair.run("CREATE MATERIALIZED VIEW v AS SELECT SUM(x) AS s FROM t")
    pair.run("DROP TABLE v")
    pair.append("t", [("b", 2.0)])
    for reg in _registries(pair):
        assert ("root", "v") not in reg.views
        assert ("root", "t") not in reg.deltas


def test_non_maintainable_view_recomputes_with_its_reason():
    pair = Pair(t=pd.DataFrame({"k": ["a", "a", "b"], "x": [1.0, 1.0, 2.0]}))
    pair.run("CREATE MATERIALIZED VIEW vd AS SELECT COUNT(DISTINCT k) AS n, "
             "SUM(x) AS s FROM t")
    moved = Counters()
    pair.append("t", [("c", 3.0)])
    got = pair.same("SELECT * FROM vd")
    assert int(got["n"][0]) == 3 and float(got["s"][0]) == 7.0
    assert moved.moved()["mv_refresh_full"] == 1
    (row,) = _system_row_fields(pair)
    assert row["maintainable"] == "full" and "DISTINCT" in row["reason"]


def test_fault_mv_refresh_falls_back_to_full_recompute():
    pair = Pair(t=pd.DataFrame({"k": ["a", "b"], "x": [1.0, 2.0]}))
    pair.run("CREATE MATERIALIZED VIEW v AS SELECT k, SUM(x) AS s FROM t "
             "GROUP BY k")
    pair.append("t", [("a", 10.0)])
    moved = Counters()
    f0 = (jax_tel.REGISTRY.get("fault_mv_refresh", 0),
          port_tel.REGISTRY.get("fault_mv_refresh", 0))
    with jax_faults.inject("mv_refresh:1"):
        want = pair.j.sql("SELECT * FROM v", return_futures=False)
    with port_faults.inject("mv_refresh:1"):
        got = pair.p.sql("SELECT * FROM v", return_futures=False)
    assert_same(got, want)
    assert sorted(got["s"]) == [2.0, 11.0]   # wrong never
    assert moved.moved()["mv_refresh_full"] == 1
    assert (jax_tel.REGISTRY.get("fault_mv_refresh", 0) - f0[0]
            == port_tel.REGISTRY.get("fault_mv_refresh", 0) - f0[1] == 1)


def test_state_eviction_downgrades_to_full():
    pair = Pair(t=pd.DataFrame({"k": ["a", "b"], "x": [1.0, 2.0]}))
    pair.run("CREATE MATERIALIZED VIEW v AS SELECT k, SUM(x) AS s FROM t "
             "GROUP BY k")
    jax_rc.get_cache().clear()   # stands in for eviction under pressure
    port_rc.get_cache().clear()
    moved = Counters()
    pair.append("t", [("a", 10.0)])
    got = pair.same("SELECT * FROM v")
    assert sorted(got["s"]) == [2.0, 11.0]
    assert moved.moved()["mv_refresh_full"] == 1
    _views(pair)


def test_kill_switch_baseline(monkeypatch):
    monkeypatch.setenv("DSQL_MV", "0")
    pair = Pair(t=_mk(30))
    pair.raises(f"CREATE MATERIALIZED VIEW v AS {AGG_SQL}", JaxUserError,
                UserError)
    moved = Counters()
    pair.same(AGG_SQL)
    pair.append("t", [("a", 1.0, 1)])
    pair.same(AGG_SQL)
    assert moved.moved() == dict.fromkeys(COUNTERS, 0)


def test_disable_after_create_serves_without_refresh(monkeypatch):
    pair = Pair(t=pd.DataFrame({"k": ["a"], "x": [1.0]}))
    pair.run("CREATE MATERIALIZED VIEW v AS SELECT SUM(x) AS s FROM t")
    monkeypatch.setenv("DSQL_MV", "0")
    moved = Counters()
    pair.append("t", [("b", 5.0)])
    got = pair.same("SELECT * FROM v")
    assert float(got["s"][0]) == 1.0   # frozen at creation, by contract
    assert moved.moved()["mv_serves"] == 0


def test_matview_rows_reconcile():
    pair = Pair(t=pd.DataFrame({"k": ["a", "b"], "x": [1.0, 2.0]}))
    pair.run("CREATE MATERIALIZED VIEW v AS SELECT k, SUM(x) AS s FROM t "
             "GROUP BY k")
    pair.append("t", [("a", 1.0)])
    (row,) = _system_row_fields(pair)
    assert row["pending_deltas"] == 1 and row["pending_rows"] == 1
    pair.same("SELECT * FROM v")
    pair.same("SELECT COUNT(*) AS n FROM v")
    (row,) = _system_row_fields(pair)
    assert row["name"] == "v" and row["base_tables"] == "root.t"
    assert row["maintainable"] == "incremental:agg"
    assert (row["refresh_incremental"], row["refresh_full"],
            row["serves"], row["pending_deltas"]) == (1, 1, 2, 0)


def test_matview_in_secondary_schema():
    pair = Pair()
    pair.j.create_schema("s2")
    pair.p.create_schema("s2")
    pair.create("t", pd.DataFrame({"x": [1.0, 2.0]}), schema_name="s2")
    pair.run("CREATE MATERIALIZED VIEW s2.v AS SELECT SUM(x) AS s FROM s2.t")
    pair.append("t", [(3.0,)], schema_name="s2")
    got = pair.same("SELECT * FROM s2.v")
    assert float(got["s"][0]) == 6.0
    pair.run("DROP MATERIALIZED VIEW s2.v")


def test_view_over_view_chain_stays_fresh():
    pair = Pair(t=pd.DataFrame({"k": ["a", "b"], "x": [1.0, 2.0]}))
    pair.run("CREATE MATERIALIZED VIEW v1 AS SELECT k, SUM(x) AS s FROM t "
             "GROUP BY k")
    pair.run("CREATE MATERIALIZED VIEW v2 AS SELECT MAX(s) AS m FROM v1")
    moved = Counters()
    pair.append("t", [("a", 10.0)])
    got = pair.same("SELECT * FROM v2")
    assert float(got["m"][0]) == 11.0
    moved.moved()
    _views(pair)


def test_view_survives_schema_and_table_renames():
    """ALTER and DROP SCHEMA discard the views they move or drop, in
    both packages."""
    pair = Pair(t=pd.DataFrame({"k": ["a", "b"], "x": [1.0, 2.0]}))
    pair.run("CREATE MATERIALIZED VIEW v AS SELECT k, SUM(x) AS s FROM t "
             "GROUP BY k")
    for c in (pair.j, pair.p):
        c.alter_table("v", "w")
    assert _views(pair) == {}
    pair.same("SELECT * FROM w")
    for c in (pair.j, pair.p):
        c.create_schema("s3")
    pair.create("u", pd.DataFrame({"x": [1.0]}), schema_name="s3")
    pair.run("CREATE MATERIALIZED VIEW s3.mu AS SELECT SUM(x) AS s FROM s3.u")
    for c in (pair.j, pair.p):
        c.drop_schema("s3")
    assert _views(pair) == {}


# ---------------------------------------------------------------------------
# analysis, the registry's seams, statements (test_matview_unit.py)
# ---------------------------------------------------------------------------

def _tiny():
    return pd.DataFrame({"k": ["a", "b", "a"], "x": [1.0, 2.0, 3.0],
                         "y": [1, 2, 3]})


def _shapes(pair, sql):
    jplan = pair.j._get_plan(jax_parse(sql)[0].query, sql)
    pplan = pair.p._get_plan(parse_sql(sql)[0].query, sql)
    js, jr = jax_mv._analyze(jplan, pair.j)
    ps, pr = port_mv._analyze(pplan, pair.p)
    assert pr == jr
    assert (ps is None) == (js is None)
    if ps is not None:
        assert ps.kind == js.kind
        assert len(ps.above) == len(js.above)
    return ps, pr


@pytest.mark.parametrize("query,kind", [
    ("SELECT k, SUM(x) AS s FROM t GROUP BY k", "agg"),
    ("SELECT k, AVG(y) AS a, COUNT(*) AS n FROM t GROUP BY k", "agg"),
    ("SELECT MIN(x) AS mn, MAX(x) AS mx FROM t", "agg"),
    ("SELECT k, x FROM t WHERE y > 1", "append"),
    ("SELECT UPPER(k) AS ku FROM t", "append"),
    ("SELECT k, SUM(x) AS s FROM t GROUP BY k HAVING SUM(x) > 1", "agg"),
    ("SELECT k, SUM(x) AS s FROM t GROUP BY k ORDER BY k", "agg"),
])
def test_analyze_maintainable(query, kind):
    shape, reason = _shapes(Pair(t=_tiny()), query)
    assert shape is not None, reason
    assert shape.kind == kind


@pytest.mark.parametrize("query,needle", [
    ("SELECT COUNT(DISTINCT k) AS n, SUM(x) AS s FROM t", "DISTINCT"),
    ("SELECT a.k FROM t a LEFT JOIN t b ON a.k = b.k", "INNER"),
    ("SELECT k, x FROM t ORDER BY x LIMIT 2", "ORDER BY"),
    ("SELECT k FROM (SELECT k, SUM(x) AS s FROM t GROUP BY k) "
     "GROUP BY k", "nested aggregates"),
    ("SELECT k, RANK() OVER (ORDER BY x) AS r FROM t", "requires full"),
])
def test_analyze_full_recompute_with_reason(query, needle):
    shape, reason = _shapes(Pair(t=_tiny()), query)
    assert shape is None
    assert needle.lower() in reason.lower()


def test_chunked_base_is_not_delta_tracked():
    pair = Pair()
    pair.create("big", pd.DataFrame({"a": np.arange(100)}), chunked=True,
                batch_rows=32)
    shape, reason = _shapes(pair, "SELECT SUM(a) AS s FROM big")
    assert shape is None and "chunked" in reason
    pair.run("CREATE MATERIALIZED VIEW vb AS SELECT SUM(a) AS s FROM big")
    got = pair.same("SELECT * FROM vb")
    assert int(got["s"][0]) == 4950


def test_delta_recorded_only_with_dependent_views():
    pair = Pair(t=_tiny())
    for c in (pair.j, pair.p):
        assert c.__dict__.get("_matview_registry") is None
    pair.run("CREATE MATERIALIZED VIEW v AS SELECT k, SUM(x) AS s FROM t "
             "GROUP BY k")
    pair.append("t", [("z", 9.0, 9)])
    pair.create("u", pd.DataFrame({"a": [1]}))
    pair.append("u", [(2,)])
    for reg in _registries(pair):
        assert len(reg.deltas[("root", "t")]) == 1
        assert ("root", "u") not in reg.deltas


def test_overwrite_tombstones_and_clears_deltas():
    pair = Pair(t=_tiny())
    pair.run("CREATE MATERIALIZED VIEW v AS SELECT k, SUM(x) AS s FROM t "
             "GROUP BY k")
    pair.append("t", [("z", 9.0, 9)])
    pair.create("t", pd.DataFrame({"k": ["q"], "x": [0.0], "y": [0]}))
    for c, reg in zip((pair.j, pair.p), _registries(pair)):
        assert ("root", "t") not in reg.deltas
        assert reg.tombstones[("root", "t")] == c.table_epoch("root", "t")


def test_delta_log_overflow_compacts_before_tombstoning(monkeypatch):
    monkeypatch.setattr(jax_mv, "MAX_DELTAS", 3)
    monkeypatch.setattr(port_mv, "MAX_DELTAS", 3)
    pair = Pair(t=_tiny())
    pair.run("CREATE MATERIALIZED VIEW v AS SELECT k, SUM(x) AS s FROM t "
             "GROUP BY k")
    c0 = (jax_tel.REGISTRY.get("mv_delta_compactions", 0),
          port_tel.REGISTRY.get("mv_delta_compactions", 0))
    for i in range(5):
        pair.append("t", [("z", float(i), i)])
    assert (jax_tel.REGISTRY.get("mv_delta_compactions", 0) - c0[0]
            == port_tel.REGISTRY.get("mv_delta_compactions", 0) - c0[1] > 0)
    rj, rp = _registries(pair)
    assert ("root", "t") not in rp.tombstones
    assert [(r.epoch > 0, r.rows) for r in rp.deltas[("root", "t")]] == \
        [(r.epoch > 0, r.rows) for r in rj.deltas[("root", "t")]]
    pair.same("SELECT SUM(s) AS tot FROM v")


def test_delta_log_overflow_degrades_to_tombstone(monkeypatch):
    monkeypatch.setattr(jax_mv, "MAX_DELTAS", 1)
    monkeypatch.setattr(port_mv, "MAX_DELTAS", 1)
    pair = Pair(t=_tiny())
    pair.run("CREATE MATERIALIZED VIEW v1 AS SELECT k, SUM(x) AS s FROM t "
             "GROUP BY k")
    pair.run("CREATE MATERIALIZED VIEW v2 AS SELECT k, SUM(y) AS s FROM t "
             "GROUP BY k")
    pair.append("t", [("z", 9.0, 9)])
    pair.run("REFRESH MATERIALIZED VIEW v1")   # v1 consumes; v2 lags
    pair.append("t", [("w", 8.0, 8)])           # full, tail unmergeable
    for reg in _registries(pair):
        assert reg.tombstones[("root", "t")] > 0
    moved = Counters()
    pair.same("SELECT SUM(s) AS tot FROM v2")
    pair.same("SELECT SUM(s) AS tot FROM v1")
    assert moved.moved()["mv_refresh_full"] == 2


def test_kill_switch_rejects_statements_and_degrades_deltas(monkeypatch):
    pair = Pair(t=_tiny())
    pair.run("CREATE MATERIALIZED VIEW v AS SELECT k, SUM(x) AS s FROM t "
             "GROUP BY k")
    monkeypatch.setenv("DSQL_MV", "0")
    for sql in ("CREATE MATERIALIZED VIEW w AS SELECT k FROM t",
                "REFRESH MATERIALIZED VIEW v", "DROP MATERIALIZED VIEW v"):
        pair.raises(sql, JaxUserError, UserError)
    pair.append("t", [("z", 9.0, 9)])
    for reg in _registries(pair):
        assert ("root", "t") not in reg.deltas
        assert reg.tombstones[("root", "t")] > 0


@pytest.mark.parametrize("sql", [
    "CREATE MATERIALIZED VIEW v AS SELECT k, CURRENT_DATE AS d FROM t",
    "CREATE MATERIALIZED VIEW v AS SELECT CURRENT_TIME AS ts",
    "CREATE MATERIALIZED VIEW v AS SELECT RAND() AS r",
])
def test_volatile_query_rejected_with_typed_error(sql):
    pair = Pair(t=_tiny())
    pair.raises(sql, jax_mv.MatViewError, port_mv.MatViewError)
    assert pair.p.resolve_table(["v"]) is None


def test_duplicate_name_checks():
    pair = Pair(t=_tiny())
    pair.run("CREATE MATERIALIZED VIEW v AS SELECT k FROM t")
    pair.raises("CREATE MATERIALIZED VIEW v AS SELECT x FROM t",
                JaxUserError, UserError)
    pair.run("CREATE MATERIALIZED VIEW IF NOT EXISTS v AS SELECT x FROM t")
    pair.run("CREATE OR REPLACE MATERIALIZED VIEW v AS SELECT x FROM t")
    got = pair.same("SELECT * FROM v")
    assert list(got.columns) == ["x"]
    pair.raises("DROP MATERIALIZED VIEW nope", JaxUserError, UserError)
    pair.run("DROP MATERIALIZED VIEW IF EXISTS nope")
    pair.raises("REFRESH MATERIALIZED VIEW nope", JaxUserError, UserError)


def test_events_armed_refuses_the_refresh(monkeypatch):
    """The JAX package publishes each refresh on its event bus; the port
    has no bus and refuses an armed DSQL_EVENTS where it would publish."""
    c = Context(device=CPU)
    c.create_table("t", _tiny())
    c.sql("CREATE MATERIALIZED VIEW v AS SELECT SUM(x) AS s FROM t")
    c.append_rows("t", [("z", 9.0, 9)])
    monkeypatch.setenv("DSQL_EVENTS", "1")
    # the refresh itself (a query would be refused by its trace first)
    with pytest.raises(NotImplementedError, match="runtime/events.py"):
        port_mv.refresh_matview(c, ["v"])
