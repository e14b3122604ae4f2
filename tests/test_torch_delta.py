"""The port's delta maintenance (``runtime/delta.py``) against the JAX
package's: the join and COUNT(DISTINCT) analyses and their incremental
refreshes, each checked against the JAX package's answers and counters
and against the same query run directly (mirrors the JAX package's
``tests/unit/test_delta_maintenance.py``).
"""
import math

import numpy as np
import pandas as pd
import pytest
import torch

from dask_sql_tpu import Context as JaxContext
from dask_sql_tpu.runtime import matview as jax_mv
from dask_sql_tpu.runtime import telemetry as jax_tel
from dask_sql_tpu.sql.parser import parse_sql as jax_parse
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.runtime import matview as port_mv
from dask_sql_tpu_torch.runtime import telemetry as port_tel
from dask_sql_tpu_torch.sql.parser import parse_sql

CPU = torch.device("cpu")

COUNTERS = ("mv_refresh_incremental", "mv_refresh_full",
            "mv_deltas_recorded", "mv_serves")


@pytest.fixture(autouse=True)
def _cache_on(monkeypatch):
    # the maintained state (partials, refcounts) is a result-cache tenant
    monkeypatch.setenv("DSQL_RESULT_CACHE_MB", "64")
    yield


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


def _pair():
    return Pair(t1=pd.DataFrame({"k": ["a", "b", "c"], "x": [1.0, 2.0, 3.0]}),
                t2=pd.DataFrame({"k": ["a", "a", "b"], "y": [10, 20, 30]}))


def _shapes(pair, sql):
    jplan = pair.j._get_plan(jax_parse(sql)[0].query, sql)
    pplan = pair.p._get_plan(parse_sql(sql)[0].query, sql)
    js, jr = jax_mv._analyze(jplan, pair.j)
    ps, pr = port_mv._analyze(pplan, pair.p)
    assert pr == jr
    assert (ps is None) == (js is None)
    if ps is not None:
        assert ps.kind == js.kind
        assert len(ps.scans) == len(js.scans)
        assert ps.cd_arg == js.cd_arg
    return ps, pr


def _oracle(pair, view_sql, view_name):
    """The view equals the JAX package's view and its own query run
    directly."""
    got = pair.same(f"SELECT * FROM {view_name}")
    assert_same(got, pair.p.sql(view_sql, return_futures=False))


@pytest.mark.parametrize("query,kind", [
    ("SELECT a.k, a.x, b.y FROM t1 a INNER JOIN t2 b ON a.k = b.k",
     "join"),
    ("SELECT a.k FROM t1 a, t1 b WHERE a.k = b.k", "join"),
    ("SELECT a.x, b.y FROM t1 a JOIN t2 b ON a.k = b.k "
     "WHERE b.y > 5", "join"),
    ("SELECT COUNT(DISTINCT k) AS n FROM t1", "cdistinct"),
    ("SELECT k, COUNT(DISTINCT y) AS n FROM t2 GROUP BY k", "cdistinct"),
    ("SELECT DISTINCT k FROM t2", "agg"),
])
def test_analyze_maintainable_shapes(query, kind):
    shape, reason = _shapes(_pair(), query)
    assert shape is not None, reason
    assert shape.kind == kind


@pytest.mark.parametrize("query,needle", [
    ("SELECT a.k, SUM(b.y) AS s FROM t1 a JOIN t2 b ON a.k = b.k "
     "GROUP BY a.k", "aggregates over joins"),
    ("SELECT a.x, b.y FROM t1 a JOIN t2 b ON a.k = b.k "
     "ORDER BY b.y LIMIT 2", "ORDER BY"),
    ("SELECT COUNT(DISTINCT k) AS n, COUNT(*) AS m FROM t1", "DISTINCT"),
    ("SELECT k, COUNT(DISTINCT k) AS n FROM t2 GROUP BY k", "grouping"),
    ("SELECT a.k FROM t1 a WHERE a.k IN (SELECT k FROM t2)", "full"),
    ("SELECT a.k, b.y FROM t1 a FULL JOIN t2 b ON a.k = b.k", "INNER"),
])
def test_analyze_refusals_keep_reason(query, needle):
    shape, reason = _shapes(_pair(), query)
    assert shape is None
    assert needle.lower() in reason.lower()


VIEW_JOIN = ("SELECT a.k AS k, a.x AS x, b.y AS y "
             "FROM t1 a INNER JOIN t2 b ON a.k = b.k")


def test_join_view_maintains_across_appends():
    pair = _pair()
    pair.run(f"CREATE MATERIALIZED VIEW vj AS {VIEW_JOIN}")
    moved = Counters()
    pair.append("t1", [("a", 4.0), ("z", 5.0)])     # left side only
    _oracle(pair, VIEW_JOIN, "vj")
    pair.append("t2", [("c", 40), ("a", 50)])       # right side only
    _oracle(pair, VIEW_JOIN, "vj")
    # both sides pending in one refresh: the appended 'q' rows only
    # match each other (the delta-delta term)
    pair.append("t1", [("q", 6.0)])
    pair.append("t2", [("q", 60)])
    _oracle(pair, VIEW_JOIN, "vj")
    assert moved.moved() == {"mv_refresh_incremental": 3,
                             "mv_refresh_full": 0, "mv_deltas_recorded": 4,
                             "mv_serves": 3}


def test_self_join_view_maintains():
    view = ("SELECT a.k AS k, a.x AS xa, b.x AS xb "
            "FROM t1 a, t1 b WHERE a.k = b.k")
    pair = _pair()
    pair.run(f"CREATE MATERIALIZED VIEW vs AS {view}")
    moved = Counters()
    pair.append("t1", [("a", 9.0)])
    _oracle(pair, view, "vs")
    assert moved.moved()["mv_refresh_incremental"] == 1


def test_join_view_filter_below_join_maintains():
    view = ("SELECT a.k AS k, b.y AS y FROM t1 a "
            "INNER JOIN t2 b ON a.k = b.k WHERE b.y > 15")
    pair = _pair()
    pair.run(f"CREATE MATERIALIZED VIEW vf AS {view}")
    moved = Counters()
    pair.append("t2", [("b", 5), ("b", 99)])   # one filtered, one kept
    _oracle(pair, view, "vf")
    assert moved.moved()["mv_refresh_incremental"] == 1


def test_join_view_over_seeded_tables():
    """Seeded rows appended to both sides of a string-keyed join
    with a projection above it."""

    def side(n, seed, col):
        r = np.random.default_rng(seed)
        return pd.DataFrame({"k": r.choice(list("abcdefg"), n).astype(object),
                             col: r.integers(0, 1000, n)})

    pair = Pair(l=side(200, 1, "u"), r=side(150, 2, "w"))
    view = ("SELECT l.k AS k, l.u + r.w AS s FROM l JOIN r ON l.k = r.k "
            "WHERE r.w > 100")
    pair.run(f"CREATE MATERIALIZED VIEW vj AS {view}")
    moved = Counters()
    pair.append("l", side(16, 10, "u"))
    pair.append("r", side(16, 20, "w"))
    _oracle(pair, view, "vj")
    assert moved.moved()["mv_refresh_incremental"] == 1


def test_cdistinct_global_maintains():
    view = "SELECT COUNT(DISTINCT k) AS n FROM t2"
    pair = _pair()
    pair.run(f"CREATE MATERIALIZED VIEW vd AS {view}")
    moved = Counters()
    pair.append("t2", [("a", 70)])   # a value seen before: no change
    got = pair.same("SELECT n FROM vd")
    assert int(got["n"][0]) == 2
    pair.append("t2", [("z", 80), ("z", 90)])
    got = pair.same("SELECT n FROM vd")
    assert int(got["n"][0]) == 3
    assert moved.moved()["mv_refresh_incremental"] == 2


def test_cdistinct_grouped_maintains_and_skips_nulls():
    view = "SELECT k, COUNT(DISTINCT y) AS n FROM t2 GROUP BY k"
    pair = _pair()
    pair.run(f"CREATE MATERIALIZED VIEW vg AS {view}")
    moved = Counters()
    pair.append("t2", [("a", 10), ("b", 31), ("c", 1), ("c", None)])
    _oracle(pair, view, "vg")
    got = pair.same("SELECT n FROM vg WHERE k = 'c'")
    assert int(got["n"][0]) == 1
    assert moved.moved()["mv_refresh_incremental"] == 1


def test_staleness_columns_track_pending_deltas():
    pair = _pair()
    pair.run("CREATE MATERIALIZED VIEW vp AS SELECT k, SUM(x) AS s FROM t1 "
             "GROUP BY k")
    pair.append("t1", [("a", 1.0), ("b", 1.0)])
    (row,) = port_mv.matview_rows(pair.p)
    assert row["pending_rows"] == 2 and row["staleness_s"] >= 0.0
    pair.same("SELECT * FROM vp")
    (row,) = port_mv.matview_rows(pair.p)
    assert row["pending_rows"] == 0
    assert port_tel.REGISTRY.gauges().get("mv_pending_rows", -1) == 0


def test_join_view_recomputes_when_a_base_is_overwritten():
    pair = _pair()
    pair.run(f"CREATE MATERIALIZED VIEW vj AS {VIEW_JOIN}")
    pair.append("t1", [("b", 7.0)])
    pair.create("t2", pd.DataFrame({"k": ["b", "c"], "y": [1, 2]}))
    moved = Counters()
    _oracle(pair, VIEW_JOIN, "vj")
    assert moved.moved()["mv_refresh_full"] == 1
