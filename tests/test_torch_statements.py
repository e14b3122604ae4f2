"""The port's statement layer against the JAX package's.

Schemas, CREATE TABLE / VIEW ... AS, DROP, SHOW / DESCRIBE, PREPARE /
EXECUTE / DEALLOCATE, ``sql(params=)`` and EXPLAIN ANALYZE run through both
packages' ``Context`` on the same frames (TPC-H at SF 0.001 and a few small
tables); results, errors and the analyzed trees' node lines with their
``rows=`` counts (not their times) are equal.  The JAX package's native
grammar refuses PREPARE / EXECUTE / DEALLOCATE, so it runs those with its
native library switched off by patching the loader's cache (its Python
parser then takes every statement).  Each statement the port does not
have yet raises ``NotImplementedError`` naming itself.
"""
import re

import numpy as np
import pandas as pd
import pytest
import torch

import dask_sql_tpu.native as jax_native
from benchmarks.tpch import QUERIES, generate_tpch
from dask_sql_tpu import Context as JaxContext
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.runtime import telemetry as port_tel

CPU = torch.device("cpu")

SMALL = {
    "t": pd.DataFrame({"a": [1, 2, 3, 1, 2, 1], "k": [10, 20, 30, 10, 20, 30],
                       "x": [0.5, 1.5, 2.5, 3.5, 4.5, 5.5]}),
    "u": pd.DataFrame({"k": [10, 20, 30], "name": list("xyz")}),
}


@pytest.fixture(scope="module")
def tpch():
    return generate_tpch(0.001)


@pytest.fixture
def contexts(tpch):
    jc, pc = JaxContext(), Context(device=CPU)
    for frames in (tpch, SMALL):
        for name, df in frames.items():
            jc.create_table(name, df)
            pc.create_table(name, df)
    return jc, pc


@pytest.fixture
def jax_python_parser(monkeypatch):
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_load_attempted", True)


def _rows(df) -> list:
    """A result frame as rows of comparable cells (doubles to 10 digits)."""
    out = []
    for row in df.itertuples(index=False):
        out.append(tuple(
            None if v is None or (isinstance(v, float) and np.isnan(v))
            else float(f"{v:.10g}") if isinstance(v, (float, np.floating))
            else str(v) for v in row))
    return out


def _same(jc, pc, sql, **kw):
    got = pc.sql(sql, return_futures=False, **kw)
    want = jc.sql(sql, return_futures=False, **kw)
    assert list(got.columns) == list(want.columns), sql
    assert _rows(got) == _rows(want), sql
    return got


def _both(jc, pc, sql):
    for c in (jc, pc):
        c.sql(sql)


def _both_raise(jc, pc, sql, exc):
    for c in (jc, pc):
        with pytest.raises(exc):
            c.sql(sql)


# ---------------------------------------------------------------------------
# schemas
# ---------------------------------------------------------------------------

def test_schemas(contexts):
    jc, pc = contexts
    _both(jc, pc, "CREATE SCHEMA s1")
    _both(jc, pc, "CREATE SCHEMA IF NOT EXISTS s1")
    _both_raise(jc, pc, "CREATE SCHEMA s1", RuntimeError)
    _both(jc, pc, "CREATE SCHEMA other")
    _same(jc, pc, "SHOW SCHEMAS")
    _same(jc, pc, "SHOW SCHEMAS LIKE 's%'")
    # one string, three statements, on the native grammar
    _both(jc, pc, "USE SCHEMA s1; CREATE TABLE w AS (SELECT 1 AS one)")
    assert pc.schema_name == jc.schema_name == "s1"
    _same(jc, pc, "SHOW TABLES")
    _same(jc, pc, "SELECT * FROM w")
    _same(jc, pc, "SELECT COUNT(*) AS n FROM root.lineitem")
    _both(jc, pc, "USE SCHEMA root")
    _same(jc, pc, "SHOW TABLES FROM s1")
    _same(jc, pc, "SELECT one + 1 AS two FROM s1.w")
    _both(jc, pc, "DROP SCHEMA other")
    _both(jc, pc, "DROP SCHEMA IF EXISTS other")
    _both_raise(jc, pc, "DROP SCHEMA other", RuntimeError)
    _both_raise(jc, pc, "USE SCHEMA other", RuntimeError)
    for c in (jc, pc):
        with pytest.raises(RuntimeError, match="cannot be deleted"):
            c.drop_schema("root")
    _both(jc, pc, "USE SCHEMA s1; DROP SCHEMA s1")
    assert pc.schema_name == jc.schema_name == "root"
    _same(jc, pc, "SHOW SCHEMAS")


def test_alter_and_epochs(contexts):
    jc, pc = contexts
    e0 = pc.table_epoch("root", "t")
    for c in (jc, pc):
        c.alter_table("t", "t2")
    assert pc.table_epoch("root", "t2") > e0
    _same(jc, pc, "SELECT a, k FROM t2 ORDER BY x")
    _both_raise(jc, pc, "SELECT * FROM t", Exception)
    for c in (jc, pc):
        c.create_schema("s")
        c.alter_schema("s", "s_new")
    assert pc.fqn("s_new.v") == jc.fqn("s_new.v") == ("s_new", "v")
    assert pc.fqn(["q"]) == jc.fqn(["q"]) == ("root", "q")
    epoch = pc.table_epoch("root", "t2")
    pc.drop_table("t2")
    assert pc.table_epoch("root", "t2") > epoch
    assert pc.catalog_entry("root", "u").table is not None


# ---------------------------------------------------------------------------
# CREATE TABLE / VIEW ... AS, DROP TABLE
# ---------------------------------------------------------------------------

def test_create_table_as(contexts):
    jc, pc = contexts
    _both(jc, pc, f"CREATE TABLE q1 AS ({QUERIES[1]})")
    for c in (jc, pc):
        assert c.schema["root"].tables["q1"].stats is None
    _same(jc, pc, "SELECT * FROM q1")
    _same(jc, pc, "SELECT l_returnflag, sum_qty FROM q1 WHERE count_order > 10")
    assert pc.explain("SELECT * FROM q1 WHERE sum_qty > 0") == \
        jc.explain("SELECT * FROM q1 WHERE sum_qty > 0")
    _both_raise(jc, pc, "CREATE TABLE q1 AS (SELECT 1 AS a)", RuntimeError)
    _both(jc, pc, "CREATE TABLE IF NOT EXISTS q1 AS (SELECT 1 AS a)")
    _same(jc, pc, "SELECT COUNT(*) AS n FROM q1")
    _both(jc, pc, "CREATE OR REPLACE TABLE q1 AS (SELECT a, 2 * x AS y FROM t)")
    _same(jc, pc, "SELECT * FROM q1 ORDER BY y")
    _both(jc, pc, "DROP TABLE q1")
    _both(jc, pc, "DROP TABLE IF EXISTS q1")
    _both_raise(jc, pc, "DROP TABLE q1", RuntimeError)


def test_views(contexts):
    jc, pc = contexts
    _both(jc, pc, "CREATE VIEW big AS (SELECT l_orderkey, l_quantity, "
                  "l_extendedprice FROM lineitem WHERE l_quantity > 40)")
    for c in (jc, pc):
        entry = c.schema["root"].tables["big"]
        assert entry.table is None and entry.plan is not None
    for _ in range(2):
        _same(jc, pc, "SELECT COUNT(*) AS n, SUM(l_extendedprice) AS s FROM big")
    _same(jc, pc, "DESCRIBE big")
    # a view sees its base table replaced
    _both(jc, pc, "CREATE VIEW tv AS (SELECT a + 1 AS a1 FROM t)")
    _both(jc, pc, "CREATE OR REPLACE TABLE t AS (SELECT 10 AS a, 1.0 AS x)")
    _same(jc, pc, "SELECT * FROM tv")
    _both(jc, pc, "CREATE OR REPLACE VIEW tv AS SELECT name FROM u")
    _same(jc, pc, "SELECT * FROM tv ORDER BY name")


def test_show_and_describe(contexts):
    jc, pc = contexts
    _same(jc, pc, "SHOW TABLES")
    _same(jc, pc, "SHOW COLUMNS FROM lineitem")
    _same(jc, pc, "SHOW COLUMNS FROM root.u")
    _same(jc, pc, "DESCRIBE orders")
    _both_raise(jc, pc, "DESCRIBE missing", AttributeError)
    _both_raise(jc, pc, "SHOW TABLES FROM missing", AttributeError)


# ---------------------------------------------------------------------------
# PREPARE / EXECUTE / DEALLOCATE and params=
# ---------------------------------------------------------------------------

Q6_PREPARED = (
    "PREPARE q6 AS SELECT SUM(l_extendedprice * l_discount) AS revenue "
    "FROM lineitem WHERE l_shipdate >= DATE '1994-01-01' "
    "AND l_shipdate < DATE '1995-01-01' AND l_discount BETWEEN ? AND ? "
    "AND l_quantity < ?")


def _q6_inline(lo, hi, qty):
    return (
        "SELECT SUM(l_extendedprice * l_discount) AS revenue FROM lineitem "
        "WHERE l_shipdate >= DATE '1994-01-01' "
        f"AND l_shipdate < DATE '1995-01-01' AND l_discount BETWEEN {lo} "
        f"AND {hi} AND l_quantity < {qty}")


def test_prepare_execute(contexts, jax_python_parser):
    jc, pc = contexts
    _both(jc, pc, Q6_PREPARED)
    for params in ((0.05, 0.07, 24), (0.01, 0.09, 40)):
        got = _same(jc, pc, "EXECUTE q6 ({}, {}, {})".format(*params))
        inline = pc.sql(_q6_inline(*params), return_futures=False)
        assert _rows(got) == _rows(inline)
        assert pc.last_report.counters.get("planner_native") == 1
    before = port_tel.REGISTRY.counters().get("prepared_executes", 0)
    pc.sql("EXECUTE q6 (0.05, 0.07, 24)")
    assert port_tel.REGISTRY.counters()["prepared_executes"] == before + 1
    for c in (jc, pc):
        with pytest.raises(RuntimeError, match="requires 3 parameters"):
            c.sql("EXECUTE q6 (0.05, 0.07)")
    _both(jc, pc, "PREPARE p2 AS SELECT a FROM t WHERE k = $1 ORDER BY x")
    _same(jc, pc, "EXECUTE p2 (20)")
    _both(jc, pc, "DEALLOCATE q6")
    _both_raise(jc, pc, "EXECUTE q6 (0.05, 0.07, 24)", RuntimeError)
    _both_raise(jc, pc, "DEALLOCATE q6", RuntimeError)
    _both(jc, pc, "DEALLOCATE ALL")
    assert pc._prepared == jc._prepared == {}


def test_params_api(contexts):
    """``?`` markers number left to right.  The JAX package's native grammar
    gives every marker index 0, so there the second marker takes the first
    value; its Python parser (and the port) number them."""
    jc, pc = contexts
    sql = "SELECT a, x FROM t WHERE x > ? AND k <> ? ORDER BY x"
    got = pc.sql(sql, return_futures=False, params=[1.0, 30])
    inline = "SELECT a, x FROM t WHERE x > {} AND k <> {} ORDER BY x"
    assert _rows(got) == _rows(pc.sql(inline.format(1.0, 30),
                                      return_futures=False))
    assert _rows(jc.sql(sql, return_futures=False, params=[1.0, 30])) == \
        _rows(jc.sql(inline.format(1.0, 1.0), return_futures=False)) != \
        _rows(got)
    _same(jc, pc, "SELECT a FROM t WHERE k = ? ORDER BY x", params=[20])


def test_params_api_matches_jax_python_parser(contexts, jax_python_parser):
    jc, pc = contexts
    _same(jc, pc, "SELECT a, x FROM t WHERE x > ? AND k <> ? ORDER BY x",
          params=[1.0, 30])


# ---------------------------------------------------------------------------
# EXPLAIN ANALYZE
# ---------------------------------------------------------------------------

ANALYZED = {
    "q1": QUERIES[1],
    "q3": QUERIES[3],
    "join_groupby": "SELECT name, SUM(a) AS s FROM t JOIN u ON t.k = u.k "
                    "GROUP BY name",
    "window": "SELECT k, ROW_NUMBER() OVER (PARTITION BY k ORDER BY x) AS r "
              "FROM t",
}

_TIMES = re.compile(r" time=[0-9.]+ms self=[0-9.]+ms")


def _analyze(c, sql) -> list:
    return list(c.sql("EXPLAIN ANALYZE " + sql, return_futures=False)["PLAN"])


@pytest.mark.parametrize("name", list(ANALYZED))
def test_explain_analyze(contexts, name):
    jc, pc = contexts
    sql = ANALYZED[name]
    got, want = _analyze(pc, sql), _analyze(jc, sql)
    nodes = [_TIMES.sub("", line) for line in got if not line.startswith("--")]
    assert nodes == [_TIMES.sub("", line) for line in want
                     if not line.startswith("--")]
    assert all("[rows=" in line for line in nodes)
    rows_out = pc.sql(sql).num_rows
    assert nodes[0].endswith(f"[rows={rows_out}]")
    trailer = [line for line in got if line.startswith("--")]
    assert trailer[0].startswith("-- analyzed: wall=")
    assert f"rows_out={rows_out} nodes={len(nodes)}" in trailer[0]
    assert trailer[1] == "-- cache: disabled"
    assert "-- tier: eager" in trailer
    assert trailer[-1] == "-- tier: eager" or \
        trailer[-1].startswith("-- counters: ")
    assert all(line.startswith("-- operator: ")
               for line in trailer[2:trailer.index("-- tier: eager")])


def test_explain_analyze_lists_the_choices_it_took(contexts, monkeypatch):
    _, pc = contexts
    monkeypatch.delenv("DSQL_ADAPTIVE", raising=False)
    got = _analyze(pc, QUERIES[1])
    assert "-- operator: groupby=static" in got
    assert any("operator_choice_groupby_static=+1" in line for line in got)
    plain = list(pc.sql("EXPLAIN " + QUERIES[1], return_futures=False)["PLAN"])
    assert not any("[rows=" in line for line in plain)


# ---------------------------------------------------------------------------
# what is not ported yet
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sql,name", [
    ("CREATE TABLE z WITH (location = 'z.csv', format = 'csv')",
     "CREATE TABLE ... WITH (location=...)"),
    ("ANALYZE TABLE t COMPUTE STATISTICS FOR ALL COLUMNS", "ANALYZE TABLE"),
    ("CREATE MATERIALIZED VIEW mv AS SELECT a FROM t",
     "CREATE MATERIALIZED VIEW"),
    ("DROP MATERIALIZED VIEW mv", "DROP MATERIALIZED VIEW"),
    ("REFRESH MATERIALIZED VIEW mv", "REFRESH MATERIALIZED VIEW"),
    ("INSERT INTO t VALUES (1, 10, 0.5)", "INSERT INTO"),
    ("SHOW MODELS", "SHOW MODELS"),
    ("DESCRIBE MODEL m", "DESCRIBE MODEL"),
    ("CREATE MODEL m WITH (model_class = 'x.Y', target_column = 'a') AS "
     "(SELECT a, x FROM t)", "CREATE MODEL"),
    ("DROP MODEL m", "DROP MODEL"),
    ("CREATE EXPERIMENT e WITH (automl_class = 'x.Y') AS (SELECT a FROM t)",
     "CREATE EXPERIMENT"),
    ("EXPORT MODEL m WITH (format = 'pickle', location = 'm.pkl')",
     "EXPORT MODEL"),
    ("EXPLAIN PROFILE SELECT a FROM t", "EXPLAIN PROFILE"),
])
def test_unported_statements_name_themselves(sql, name):
    pc = Context(device=CPU)
    pc.create_table("t", SMALL["t"])
    with pytest.raises(NotImplementedError, match=re.escape(name)):
        pc.sql(sql)
