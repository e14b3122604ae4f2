"""Tiered execution in the port's compiled tier (``DSQL_TIERED``, on by
default; ``tests/conftest.py`` pins it off for every module whose name
lacks ``tiered``), on the CPU.

- A cold plan's first arrival is answered by the eager executor
  (``tier`` = ``eager-compiling``) while its program builds on a
  background thread with a trace of its own; the next arrival runs
  compiled, with the same answer.
- ``tier_probe``'s four answers: ``eager``, ``compiled``,
  ``eager-compiling`` and ``compiled-cold``; and the EXPLAIN ANALYZE tier
  line, which calls it.
- ``DSQL_EAGER_FALLBACK=0`` leaves no eager tier to serve from: the
  first arrival builds synchronously.
- A stage graph is ready when its leaf stages are built.
"""
import os
import time

import numpy as np
import pandas as pd
import pytest

from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.physical import compiled
from dask_sql_tpu_torch.runtime import telemetry as tel
from dask_sql_tpu_torch.sql.parser import parse_sql


@pytest.fixture(autouse=True)
def _tiered(monkeypatch):
    monkeypatch.delenv("DSQL_TIERED", raising=False)
    monkeypatch.delenv("DSQL_EAGER_FALLBACK", raising=False)
    yield
    _wait_for_builds()


@pytest.fixture()
def c():
    rng = np.random.default_rng(3)
    n = 2000
    ctx = Context(device="cpu")
    ctx.create_table("t", pd.DataFrame({"a": rng.integers(0, 100, n),
                                        "b": rng.random(n)}))
    ctx.create_table("d", pd.DataFrame({"a": np.arange(100),
                                        "w": np.arange(100) * 10}))
    return ctx


def _wait_for_builds(limit_s: float = 60.0) -> None:
    t0 = time.monotonic()
    while compiled.inflight_background_compiles():
        assert time.monotonic() - t0 < limit_s, "background build hangs"
        time.sleep(0.005)


def _tier(ctx) -> str:
    tier = None
    for s in ctx.last_report.root.walk():
        tier = s.attrs.get("tier", tier)
    return tier


def _plan(ctx, sql):
    return ctx._get_plan(parse_sql(sql)[0].query)


def _eager(ctx, sql):
    os.environ["DSQL_COMPILE"] = "0"
    try:
        return ctx.sql(sql, return_futures=False)
    finally:
        del os.environ["DSQL_COMPILE"]


def _delta(before: dict, *names) -> dict:
    return {k: compiled.stats.get(k, 0) - before.get(k, 0) for k in names}


BG = ("background_compiles_done", "background_compile_errors",
      "served_eager_while_compiling", "compiles")


def test_first_arrival_eager_then_compiled(c):
    q = "SELECT a % 7 AS k, SUM(b) AS s FROM t WHERE a > 10 GROUP BY a % 7"
    before = dict(compiled.stats)
    first = c.sql(q, return_futures=False)
    assert _tier(c) == "eager-compiling"
    _wait_for_builds()
    assert _delta(before, *BG) == {
        "background_compiles_done": 1, "background_compile_errors": 0,
        "served_eager_while_compiling": 1, "compiles": 1}
    report = tel.BACKGROUND_REPORTS[-1]
    assert report.root.name == "background_compile"
    assert "error" not in report.root.attrs
    second = c.sql(q, return_futures=False)
    assert _tier(c) == "compiled"
    assert _delta(before, "hits")["hits"] == 1
    for got in (first, second):
        pd.testing.assert_frame_equal(
            got.sort_values("k", ignore_index=True),
            _eager(c, q).sort_values("k", ignore_index=True))


def test_tier_probe_four_answers(c, monkeypatch):
    q = "SELECT a, COUNT(*) AS n FROM t WHERE b < 0.5 GROUP BY a"
    plan = _plan(c, q)
    assert compiled.tier_probe(plan, c) == "eager-compiling"
    monkeypatch.setenv("DSQL_TIERED", "0")
    assert compiled.tier_probe(plan, c) == "compiled-cold"
    monkeypatch.setenv("DSQL_COMPILE", "0")
    assert compiled.tier_probe(plan, c) == "eager"
    monkeypatch.delenv("DSQL_COMPILE")
    c.sql(q)
    assert compiled.tier_probe(plan, c) == "compiled"
    # another literal shares the program: ready as well
    assert compiled.tier_probe(_plan(c, q.replace("0.5", "0.25")),
                               c) == "compiled"
    # a plan outside the compiled subset
    c.register_function(lambda x: x + 1, "plus_one", [("x", np.int64)],
                        np.int64)
    assert compiled.tier_probe(_plan(c, "SELECT plus_one(a) AS p FROM t"),
                               c) == "eager"


def test_explain_analyze_tier_line(c):
    q = "SELECT a, SUM(b) AS s FROM t WHERE b > 0.3 GROUP BY a"

    def tier_line():
        lines = list(c.sql("EXPLAIN ANALYZE " + q,
                           return_futures=False)["PLAN"])
        return [line for line in lines if line.startswith("-- tier: ")]

    assert tier_line() == ["-- tier: eager-compiling"]
    c.sql(q)
    _wait_for_builds()
    assert tier_line() == ["-- tier: compiled"]
    os.environ["DSQL_COMPILE"] = "0"
    try:
        assert tier_line() == ["-- tier: eager"]
    finally:
        del os.environ["DSQL_COMPILE"]


def test_no_eager_fallback_builds_synchronously(c, monkeypatch):
    monkeypatch.setenv("DSQL_EAGER_FALLBACK", "0")
    q = "SELECT a, MAX(b) AS m FROM t GROUP BY a"
    plan = _plan(c, q)
    assert compiled.tier_probe(plan, c) == "compiled-cold"
    before = dict(compiled.stats)
    c.sql(q)
    assert _tier(c) == "compiled"
    assert _delta(before, *BG)["served_eager_while_compiling"] == 0
    assert compiled.inflight_background_compiles() == []


def test_stage_graph_ready_at_its_leaf_stages(c, monkeypatch):
    monkeypatch.setenv("DSQL_STAGE_HEAVY", "1")
    q = ("SELECT x.a, x.s, d.w FROM (SELECT a, SUM(b) AS s FROM t "
         "GROUP BY a) x JOIN d ON x.a = d.a")
    plan = _plan(c, q)
    assert compiled.tier_probe(plan, c) == "eager-compiling"
    c.sql(q)
    assert _tier(c) == "eager-compiling"
    _wait_for_builds()
    assert compiled.tier_probe(plan, c) == "compiled"
    before = dict(compiled.stats)
    got = c.sql(q, return_futures=False)
    assert _tier(c) == "compiled"
    assert _delta(before, "stage_graphs", "stage_hits") == {
        "stage_graphs": 1, "stage_hits": 2}
    pd.testing.assert_frame_equal(
        got.sort_values("a", ignore_index=True),
        _eager(c, q).sort_values("a", ignore_index=True))
