"""The port's statistics-driven dispatch against the JAX package's.

The module name contains "adaptive", so the conftest's adaptive pin
(``DSQL_ADAPTIVE=0`` everywhere else) leaves the production default on;
each test sets exactly the variables it asserts.  The JAX package's
operators are called directly; its answers to whole queries come from its
default (compiled) tier, which its own tests hold equal to its eager one:
its eager executor compiles each operator on first use and takes 20-30 s
per TPC-H query on a CPU.

- ``group_codes`` under each of ``hash``, ``sorted`` and ``dense``:
  codes, first rows, G and the variant that ran equal the JAX package's
  (NULL keys, negative and date keys, several key columns, float keys,
  a stale and a wide domain hint).
- ``_dense_join_codes`` equals the JAX package's, and a join pairs the
  same rows in the same order under ``dense`` as under ``hash`` (inner,
  left, SEMI, ANTI, and ``null_equal``; ``tests/test_torch_join.py``
  holds the ``hash`` joins to the JAX package's).
- TPC-H Q3, Q5, Q9 and Q18 with adaptive on equal the JAX package's
  answers (ints and strings exact, doubles rtol 1e-12); a GROUP BY on a
  DATE column takes the dense codes.  (TPC-H's dates ingest from numpy
  ``datetime64`` as TIMESTAMP microseconds in both packages, a domain far
  above the dense cap, so no TPC-H query groups by a dense date.)
- The aggregates EVERY/BOOL_AND, BOOL_OR/ANY, ANY_VALUE, SINGLE_VALUE,
  FIRST_VALUE, LAST_VALUE, BIT_AND/OR/XOR and LISTAGG, grouped and
  whole-table, with NULLs and FILTER, equal the JAX package's.
- ``DSQL_ADAPTIVE=0`` and ``DSQL_FORCE_GROUPBY`` take precedence as in
  ``tests/test_adaptive_dispatch.py``.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp
from benchmarks.tpch import QUERIES, generate_tpch
from dask_sql_tpu import Context as JaxContext
from dask_sql_tpu.ops import groupby as jax_groupby
from dask_sql_tpu.ops import kernels as jax_kernels
from dask_sql_tpu.table import Column as JaxColumn, Table as JaxTable
from dask_sql_tpu.types import parse_type_name
from dask_sql_tpu_torch import Context, convert
from dask_sql_tpu_torch.ops import groupby as port_groupby
from dask_sql_tpu_torch.ops import join as port_join
from dask_sql_tpu_torch.ops import kernels as port_kernels
from dask_sql_tpu_torch.runtime import telemetry as port_tel

CPU = torch.device("cpu")
SF = 0.003


@pytest.fixture(autouse=True)
def _adaptive_default(monkeypatch):
    monkeypatch.delenv("DSQL_ADAPTIVE", raising=False)
    monkeypatch.delenv("DSQL_FORCE_GROUPBY", raising=False)


def _pair(specs):
    """The same physical columns as a JAX and a port table."""
    jt = JaxTable([s[0] for s in specs],
                  [JaxColumn(jnp.asarray(d), parse_type_name(t),
                             None if m is None else jnp.asarray(m), dic)
                   for _, t, d, m, dic in specs])
    return jt, convert.table_from_columns(specs, CPU)


def _list(x):
    return np.asarray(x).tolist()


def _in_threads(cache: dict, keys, fn) -> dict:
    """``cache`` filled with ``fn(key)`` for every key on the first call,
    in threads: the JAX package compiles each of its operators on first
    use, and that is most of this file's time; the compiles overlap."""
    if not cache:
        keys = list(keys)
        with ThreadPoolExecutor(min(8, len(keys))) as pool:
            cache.update(zip(keys, pool.map(fn, keys)))
    return cache


# ---------------------------------------------------------------------------
# group codes
# ---------------------------------------------------------------------------

def _key_table():
    rng = np.random.RandomState(3)
    n = 400
    return _pair([
        ("i", "BIGINT", rng.randint(-50, 50, n), rng.rand(n) < 0.85, None),
        ("neg", "BIGINT", rng.randint(-9000, -8990, n), None, None),
        ("d", "DATE", rng.randint(9000, 9040, n).astype(np.int32), None, None),
        ("s", "VARCHAR", rng.randint(0, 4, n).astype(np.int32),
         rng.rand(n) < 0.9, np.array(["q", "b", "z", "a"], dtype=object)),
        ("f", "DOUBLE", np.round(rng.randn(n), 1), rng.rand(n) < 0.9, None),
    ])


GROUP_CASES = {
    "null_int": (["i"], None), "negative": (["neg"], None),
    "date": (["d"], None), "multi": (["s", "i"], None),
    "float": (["f"], None),
    "stale_hint": (["i"], (-10, 10)), "wide_hint": (["neg"], (-9100, -8000)),
}


GROUP_VARIANTS = ("hash", "sorted", "dense")
_jax_codes: dict = {}


def _jax_group_codes(jt, case: str, variant: str):
    """The JAX package's ``group_codes`` for one case (all cases are
    computed on the first call)."""
    def run(key):
        names, hint = GROUP_CASES[key[0]]
        return jax_groupby.group_codes([jt.column(n) for n in names],
                                       key[1], hint)
    return _in_threads(_jax_codes, [(c, v) for c in GROUP_CASES
                                    for v in GROUP_VARIANTS], run)[
        case, variant]


@pytest.mark.parametrize("variant", GROUP_VARIANTS)
@pytest.mark.parametrize("case", sorted(GROUP_CASES))
def test_group_codes_match_jax(case, variant):
    jt, pt = _key_table()
    names, hint = GROUP_CASES[case]
    want = _jax_group_codes(jt, case, variant)
    got = port_groupby.group_codes([pt.column(n) for n in names], variant,
                                   hint)
    assert got[3] == want[3]
    assert got[2] == want[2]
    assert _list(got[0]) == _list(want[0])
    assert _list(got[1]) == _list(want[1])
    expected = {"dense": {"null_int", "negative", "date", "stale_hint",
                          "wide_hint"},
                "sorted": {"null_int", "negative", "date", "stale_hint",
                           "wide_hint", "multi"}}
    if variant != "hash":
        assert (got[3] == variant) == (case in expected[variant])


# ---------------------------------------------------------------------------
# join key codes and pairs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sides():
    rng = np.random.RandomState(5)
    nl, nr = 300, 200
    left = _pair([
        ("k", "BIGINT", rng.randint(-20, 30, nl), rng.rand(nl) < 0.9, None),
        ("x", "DOUBLE", rng.randn(nl), None, None),
        ("kk", "INTEGER", rng.randint(0, 40, nl).astype(np.int32), None, None),
        ("s", "VARCHAR", rng.randint(0, 3, nl).astype(np.int32), None,
         np.array(["p", "q", "r"], dtype=object)),
    ])
    right = _pair([
        ("k2", "BIGINT", rng.randint(-30, 20, nr), rng.rand(nr) < 0.9, None),
        ("y", "BIGINT", rng.randint(-100, 100, nr), None, None),
        ("kk2", "INTEGER", rng.randint(10, 60, nr).astype(np.int32), None,
         None),
        ("s2", "VARCHAR", rng.randint(0, 2, nr).astype(np.int32), None,
         np.array(["q", "t"], dtype=object)),
    ])
    return left, right


JOIN_KEYS = {"nullable": ([0], [0]), "plain": ([2], [2]),
             "multi": ([0, 2], [0, 2]), "string": ([3], [3])}


@pytest.mark.parametrize("null_equal", [False, True])
@pytest.mark.parametrize("keys", sorted(JOIN_KEYS))
def test_dense_join_codes_match_jax(sides, keys, null_equal):
    (jl, pl), (jr, pr) = sides
    lk, rk = JOIN_KEYS[keys]
    want = jax_kernels._dense_join_codes([jl.columns[i] for i in lk],
                                         [jr.columns[i] for i in rk],
                                         null_equal)
    got = port_kernels._dense_join_codes([pl.columns[i] for i in lk],
                                         [pr.columns[i] for i in rk],
                                         null_equal)
    assert (got is None) == (want is None) == (keys in ("multi", "string"))
    if want is not None:
        for g, w in zip(got, want):
            assert _list(g) == _list(w)


def test_dense_join_codes_edge_cases():
    rng = np.random.RandomState(2)
    cases = {
        "all_null_left": (("a", "BIGINT", rng.randint(0, 5, 6), np.zeros(6, bool), None),
                          ("b", "BIGINT", rng.randint(0, 5, 4), None, None)),
        "all_null_both": (("a", "BIGINT", rng.randint(0, 5, 6), np.zeros(6, bool), None),
                          ("b", "BIGINT", rng.randint(0, 5, 4), np.zeros(4, bool), None)),
        "empty_right": (("a", "BIGINT", rng.randint(0, 5, 6), None, None),
                        ("b", "BIGINT", np.zeros(0, np.int64), None, None)),
        "float": (("a", "DOUBLE", rng.randn(6), None, None),
                  ("b", "DOUBLE", rng.randn(4), None, None)),
        "huge_spread": (("a", "BIGINT", np.array([-2**62, 0]), None, None),
                        ("b", "BIGINT", np.array([2**62 - 1]), None, None)),
    }
    for name, (lspec, rspec) in cases.items():
        (jl, pl), (jr, pr) = _pair([lspec]), _pair([rspec])
        for null_equal in (False, True):
            want = jax_kernels._dense_join_codes(jl.columns, jr.columns,
                                                 null_equal)
            got = port_kernels._dense_join_codes(pl.columns, pr.columns,
                                                 null_equal)
            assert (got is None) == (want is None), name
            if want is not None:
                assert [_list(g) for g in got] == [_list(w) for w in want]


def _values(table):
    return {n: [None if (isinstance(v, float) and np.isnan(v)) else v
                for v in np.asarray(c.to_numpy()).tolist()]
            for n, c in zip(table.names, table.columns)}


@pytest.mark.parametrize("null_equal", [False, True])
@pytest.mark.parametrize("join_type", ["INNER", "LEFT", "SEMI", "ANTI"])
@pytest.mark.parametrize("keys", ["nullable", "plain"])
def test_join_pairs_equal_under_both_variants(sides, keys, join_type,
                                              null_equal):
    """Row for row: the port's dense join equals its hash join (the
    stable sort of ``key - lo`` keeps the pair order of the hash codes)."""
    (_, pl), (_, pr) = sides
    lk, rk = JOIN_KEYS[keys]
    got = {v: _values(port_join.join_tables(pl, pr, lk, rk, join_type,
                                            null_equal=null_equal,
                                            variant=v)[0])
           for v in ("hash", "dense")}
    assert got["dense"] == got["hash"]
    codes = {v: port_kernels.join_key_codes([pl.columns[lk[0]]],
                                            [pr.columns[rk[0]]], null_equal, v)
             for v in ("hash", "dense")}
    pairs = {v: port_join._expand_matches(*c) for v, c in codes.items()}
    for a, b in zip(pairs["hash"], pairs["dense"]):
        assert a.tolist() == b.tolist()


# ---------------------------------------------------------------------------
# TPC-H with adaptive on
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tpch_contexts():
    data = generate_tpch(SF)
    jc, pc = JaxContext(), Context(device=CPU)
    for name, df in data.items():
        jc.create_table(name, df)
        jt = jc.schema["root"].tables[name].table
        pc.create_table(name, convert.table_from_columns(
            [(n, str(c.stype), np.asarray(c.data),
              None if c.mask is None else np.asarray(c.mask), c.dictionary)
             for n, c in zip(jt.names, jt.columns)], CPU))
    return jc, pc


def _assert_same_frame(got: pd.DataFrame, want: pd.DataFrame, rtol: float):
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for col in want.columns:
        g, w = got[col].to_numpy(), want[col].to_numpy()
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g.astype(np.float64), w, rtol=rtol,
                                       err_msg=col)
        else:
            assert g.tolist() == w.tolist(), col


TPCH_QIDS = (3, 5, 9, 18)
_jax_answers: dict = {}


def _jax_tpch_answer(jc, qid: int) -> pd.DataFrame:
    """The JAX package's answer to one of TPCH_QIDS (all four are run on
    the first call)."""
    return _in_threads(_jax_answers, TPCH_QIDS, lambda q: jc.sql(
        QUERIES[q], return_futures=False))[qid]


@pytest.mark.parametrize("qid", TPCH_QIDS)
def test_tpch_adaptive_answers_match_jax(tpch_contexts, qid, monkeypatch):
    jc, pc = tpch_contexts
    want = _jax_tpch_answer(jc, qid)
    # the variants are the eager executor's (the compiled tier's hash
    # joins report none)
    monkeypatch.setenv("DSQL_COMPILE", "0")
    got = pc.sql(QUERIES[qid], return_futures=False)
    _assert_same_frame(got, want, 1e-12)
    ops = pc.last_report.operators
    assert any(o.startswith("join=dense") for o in ops), ops


@pytest.fixture(scope="module")
def date_contexts():
    """A table with a DATE column (int32 days, a 2,500-day domain: dense)."""
    rng = np.random.RandomState(4)
    n = 5000
    jt, pt = _pair([
        ("d", "DATE", rng.randint(8000, 10500, n).astype(np.int32),
         rng.rand(n) < 0.97, None),
        ("v", "DOUBLE", np.round(rng.rand(n) * 100, 2), None, None),
    ])
    jc, pc = JaxContext(), Context(device=CPU)
    jc.create_table("ev", jt)
    pc.create_table("ev", pt)
    return jc, pc


DATE_Q = "SELECT d, COUNT(*) AS n, SUM(v) AS s FROM ev GROUP BY d"


def test_date_group_by_takes_dense_codes(date_contexts, monkeypatch):
    # the JAX package's eager tier numbers groups as the port does (its
    # compiled tier emits them in another order, as SQL allows)
    monkeypatch.setenv("DSQL_COMPILE", "0")
    jc, pc = date_contexts
    assert pc.schema["root"].tables["ev"].stats.cols["d"].dense
    before = port_tel.REGISTRY.counters()
    got = pc.sql(DATE_Q, return_futures=False)
    assert _delta(before, "operator_choice_groupby_dense") == 1
    ndv = pc.schema["root"].tables["ev"].stats.cols["d"].ndv
    assert pc.last_report.operators == [f"groupby=dense ndv={ndv} rows=5000"]
    _assert_same_frame(got, jc.sql(DATE_Q, return_futures=False), 1e-12)


def test_query_report(tpch_contexts, monkeypatch):
    _, pc = tpch_contexts
    monkeypatch.setenv("DSQL_COMPILE", "0")   # the eager executor's choices
    pc.sql(QUERIES[5])
    rep = pc.last_report
    assert set(rep.phases) >= {"parse", "plan", "execute"}
    assert rep.rows_out == len(pc.sql(QUERIES[5]).columns[0])
    assert rep.counters["operator_choice_join_dense"] == 4
    assert rep.counters["operator_choice_groupby_static"] == 1


# ---------------------------------------------------------------------------
# the remaining aggregates
# ---------------------------------------------------------------------------

NEW_AGGS = ("EVERY", "BOOL_AND", "BOOL_OR", "ANY", "ANY_VALUE",
            "SINGLE_VALUE", "FIRST_VALUE", "LAST_VALUE", "BIT_AND",
            "BIT_OR", "BIT_XOR", "LISTAGG")


def _agg_frame():
    rng = np.random.RandomState(9)
    n = 60
    return _pair([
        ("g", "BIGINT", rng.randint(0, 6, n), None, None),
        ("flag", "BOOLEAN", rng.rand(n) < 0.7, rng.rand(n) < 0.8, None),
        ("i", "BIGINT", rng.randint(-40, 2**40, n), rng.rand(n) < 0.8, None),
        ("j", "INTEGER", rng.randint(-9, 99, n).astype(np.int32),
         rng.rand(n) < 0.8, None),
        ("s", "VARCHAR", rng.randint(0, 4, n).astype(np.int32),
         rng.rand(n) < 0.8, np.array(["k", "e", "y", "w"], dtype=object)),
        ("x", "DOUBLE", np.round(rng.randn(n), 3), rng.rand(n) < 0.8, None),
        ("keep", "BOOLEAN", rng.rand(n) < 0.6, None, None),
    ])


BOOL_AGGS = ("EVERY", "BOOL_AND", "BOOL_OR", "ANY")


def _args(op):
    if op in BOOL_AGGS:
        return ["flag"]
    if op.startswith("BIT_"):
        return ["i", "j"]
    return ["i", "s", "x", "flag"]


def _col_values(col):
    return [None if (isinstance(v, float) and np.isnan(v)) else v
            for v in np.asarray(col.to_numpy()).tolist()]


def _out_type(op, col):
    if op == "LISTAGG":
        return parse_type_name("VARCHAR")
    if op in BOOL_AGGS:
        return parse_type_name("BOOLEAN")
    return col.stype


_jax_aggs: dict = {}


def _jax_aggregate(jt, op: str, grouped: bool, arg: str, use_filter: bool):
    """The JAX package's grouped (``segment_aggregate`` over the codes of
    ``g``) or whole-table (its one-group form) aggregate, all cases
    computed on the first call."""
    n = jt.num_rows
    codes, _, num_groups = jax_kernels.factorize_columns([jt.column("g")])

    def run(key):
        op, grouped, arg, use_filter = key
        return _col_values(jax_groupby.segment_aggregate(
            op, jt.column(arg), codes if grouped else None,
            num_groups if grouped else 1, _out_type(op, jt.column(arg)),
            jt.column("keep").data if use_filter else None, n))
    return _in_threads(_jax_aggs, [
        (o, g, a, f) for o in NEW_AGGS for g in (True, False)
        for a in _args(o) for f in (False, True)], run)[
        op, grouped, arg, use_filter]


@pytest.mark.parametrize("grouped", [True, False])
@pytest.mark.parametrize("op", NEW_AGGS)
def test_new_aggregates_match_jax(op, grouped):
    """Each aggregate through ``segment_aggregate`` (grouped) and
    ``whole_table_aggregate`` (the port) or the one-group segment form
    (the JAX eager executor's whole-table path), with and without a
    FILTER mask."""
    jt, pt = _agg_frame()
    n = pt.num_rows
    pcodes, _, pg = port_kernels.factorize_columns([pt.column("g")])
    for arg in _args(op):
        out_type = _out_type(op, pt.column(arg))
        for use_filter in (False, True):
            pmask = pt.column("keep").data if use_filter else None
            if grouped:
                got = port_groupby.segment_aggregate(
                    op, pt.column(arg), pcodes, pg, out_type, pmask, n)
            else:
                got = port_groupby.whole_table_aggregate(
                    op, pt.column(arg), pmask, out_type, n, CPU)
            assert _col_values(got) == _jax_aggregate(
                jt, op, grouped, arg, use_filter), (arg, use_filter)


AGG_SQL = ("EVERY(flag) AS e, BOOL_AND(flag) AS ba, BOOL_OR(flag) AS bo, "
           "ANY_VALUE(i) AS av, SINGLE_VALUE(s) AS sv, BIT_AND(i) AS band, "
           "BIT_OR(j) AS bor, BIT_XOR(i) FILTER (WHERE keep) AS bx, "
           "LISTAGG(s) AS la, LISTAGG(x) FILTER (WHERE keep) AS lx, "
           "BOOL_OR(flag) FILTER (WHERE keep) AS bof")


@pytest.mark.parametrize("grouped", [True, False])
def test_new_aggregates_through_sql_match_jax(grouped):
    jt, pt = _agg_frame()
    jc, pc = JaxContext(), Context(device=CPU)
    jc.create_table("t", jt)
    pc.create_table("t", pt)
    q = (f"SELECT g, {AGG_SQL} FROM t GROUP BY g" if grouped
         else f"SELECT {AGG_SQL} FROM t")
    got = pc.sql(q)
    want = jc.sql(q)
    assert got.names == want.names
    for g, w in zip(got.columns, want.columns):
        assert _col_values(g) == _col_values(w)


def test_new_aggregates_on_an_empty_table():
    jt, pt = _agg_frame()
    empty = pt.slice(0, 0)
    for op in NEW_AGGS:
        out = port_groupby.whole_table_aggregate(
            op, empty.column("i"), None,
            parse_type_name("VARCHAR") if op == "LISTAGG"
            else empty.column("i").stype, 0, CPU)
        assert len(out) == 1 and _col_values(out) == [None], op


@pytest.mark.parametrize("sql", [
    "SELECT MIN(s), MAX(s) FROM t WHERE k > 10",
    "SELECT MAX(s2) FROM u WHERE k > 100",
])
def test_string_min_max_over_no_rows(sql):
    """MIN/MAX of a string over no row answer one NULL row, as the JAX
    package does (the reduction used to run over zero elements)."""
    frames = {"t": pd.DataFrame({"k": [1, 2, 3], "s": ["b", "a", "c"]}),
              "u": pd.DataFrame({"k": [1, 2, 3], "s2": [None, "x", None]})}
    jc, pc = JaxContext(), Context(device=CPU)
    for name, df in frames.items():
        jc.create_table(name, df)
        pc.create_table(name, df)
    got, want = pc.sql(sql), jc.sql(sql)
    assert got.num_rows == want.num_rows == 1
    assert [_col_values(c) for c in got.columns] == \
        [_col_values(c) for c in want.columns] == [[None]] * want.num_columns


# ---------------------------------------------------------------------------
# precedence of the environment variables
# ---------------------------------------------------------------------------

ADAPTIVE_KEYS = ("operator_choice_groupby_dense",
                 "operator_choice_groupby_sorted",
                 "operator_choice_join_dense",
                 "operator_choice_join_order_stats")


def _delta(before, key):
    return port_tel.REGISTRY.counters().get(key, 0) - before.get(key, 0)


def test_adaptive_off_restores_baseline(tpch_contexts, date_contexts,
                                        monkeypatch):
    """DSQL_ADAPTIVE=0: no adaptive counter moves, no EXPLAIN trailer,
    the same answers as with adaptive on (Q9's join order changes, so its
    doubles may differ in the last bits)."""
    _, pc = tpch_contexts
    _, dc = date_contexts
    runs = [(pc, QUERIES[5]), (pc, QUERIES[9]), (dc, DATE_Q)]
    on = [ctx.sql(q, return_futures=False) for ctx, q in runs]
    monkeypatch.setenv("DSQL_ADAPTIVE", "0")
    before = port_tel.REGISTRY.counters()
    for (ctx, q), want in zip(runs, on):
        _assert_same_frame(ctx.sql(q, return_futures=False), want, 1e-12)
    for key in ADAPTIVE_KEYS:
        assert _delta(before, key) == 0, key
    text = pc.sql("EXPLAIN " + QUERIES[5]).to_pandas()["PLAN"].tolist()
    assert not any(line.startswith("-- operator:") for line in text)


def test_forced_beats_kill_switch(tpch_contexts, date_contexts, monkeypatch):
    """DSQL_FORCE_GROUPBY works with DSQL_ADAPTIVE=0; it pins the codes of
    a GROUP BY outside the static-domain route, and leaves that route
    (Q1's, which launches kernel 1 on the card) first, as the JAX
    package's static route ignores it.  EXPLAIN states the forced eager
    variant, as the JAX package's does."""
    monkeypatch.setenv("DSQL_ADAPTIVE", "0")
    monkeypatch.setenv("DSQL_FORCE_GROUPBY", "dense")
    monkeypatch.setenv("DSQL_COMPILE", "0")   # the eager executor's choices
    _, pc = tpch_contexts
    _, dc = date_contexts
    before = port_tel.REGISTRY.counters()
    dense = dc.sql(DATE_Q, return_futures=False)
    assert _delta(before, "operator_choice_groupby_dense") == 1
    monkeypatch.setenv("DSQL_FORCE_GROUPBY", "hash")
    _assert_same_frame(dense, dc.sql(DATE_Q, return_futures=False), 0)
    monkeypatch.delenv("DSQL_FORCE_GROUPBY")
    static = pc.sql(QUERIES[1], return_futures=False)
    monkeypatch.setenv("DSQL_FORCE_GROUPBY", "sorted")
    before = port_tel.REGISTRY.counters()
    _assert_same_frame(pc.sql(QUERIES[1], return_futures=False), static,
                       1e-12)
    assert _delta(before, "operator_choice_groupby_static") == 1
    assert _delta(before, "operator_choice_groupby_sorted") == 0
    before = port_tel.REGISTRY.counters()
    sorted_q3 = pc.sql(QUERIES[3], return_futures=False)
    assert _delta(before, "operator_choice_groupby_sorted") == 1
    text = pc.sql("EXPLAIN " + QUERIES[1]).to_pandas()["PLAN"].tolist()
    assert text[-1] == "-- operator: groupby=sorted forced=1"
    monkeypatch.delenv("DSQL_FORCE_GROUPBY")
    _assert_same_frame(sorted_q3, pc.sql(QUERIES[3], return_futures=False),
                       1e-12)
