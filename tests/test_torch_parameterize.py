"""Parameterized plans (``plan/parameterize.py`` and the compiled tier's
``P{i}`` identity) in the port, against the JAX package.

- The cases of ``tests/unit/test_parameterize.py``, each run on both
  packages: hoisting eligibility, idempotence, the ``DSQL_PARAM_PLANS``
  kill switch, fingerprints shared across literals, the canonical text.
- TPC-H Q1-Q22 (SF 0.003): the hoisted counts and the ``P{i}``
  fingerprints of ``_fp_plan`` equal the JAX package's.
- On the CPU: one program for many literals, the kill switch's value-baked
  keys, ``params=`` and PREPARE/EXECUTE sharing the inline literal's
  program, and the comparisons whose types torch promotes otherwise than
  jax (an int32 column against a value past 2**31, a float32 column
  against a DOUBLE, DECIMAL, a DATE against a TIMESTAMP column): the
  parameterized answer equals the baked literal's, the eager executor's
  and the JAX package's.
"""
import os
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest

import dask_sql_tpu.physical.compiled as jax_compiled
import dask_sql_tpu.plan.nodes as jax_nodes
import dask_sql_tpu.plan.parameterize as jax_param
import dask_sql_tpu.runtime.result_cache as jax_rc
import dask_sql_tpu.runtime.statistics as jax_stats
import dask_sql_tpu.types as jax_types
from dask_sql_tpu import Context as JaxContext
from dask_sql_tpu.sql.parser import parse_sql as jax_parse

import dask_sql_tpu_torch.physical.compiled as port_compiled
import dask_sql_tpu_torch.plan.nodes as port_nodes
import dask_sql_tpu_torch.plan.parameterize as port_param
import dask_sql_tpu_torch.runtime.result_cache as port_rc
import dask_sql_tpu_torch.runtime.statistics as port_stats
import dask_sql_tpu_torch.types as port_types
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.sql.parser import parse_sql as port_parse

PKGS = {
    "jax": SimpleNamespace(Context=JaxContext, kw={}, N=jax_nodes,
                           P=jax_param, rc=jax_rc, compiled=jax_compiled,
                           stats=jax_stats, types=jax_types,
                           parse=jax_parse),
    "port": SimpleNamespace(Context=Context, kw={"device": "cpu"},
                            N=port_nodes, P=port_param, rc=port_rc,
                            compiled=port_compiled, stats=port_stats,
                            types=port_types, parse=port_parse),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


@pytest.fixture()
def ctx(pkg):
    c = pkg.Context(**pkg.kw)
    c.create_table("t", pd.DataFrame({
        "a": range(20), "b": [float(i) * 0.5 for i in range(20)],
        "s": [f"v{i % 3}" for i in range(20)]}))
    return c


def _plan(pkg, ctx, sql):
    return ctx._get_plan(pkg.parse(sql)[0].query, sql)


def _rex_kinds(pkg, plan):
    """Every expression node's class name in the plan (recursive)."""
    N = pkg.N
    out = []

    def rex(r):
        out.append(type(r).__name__)
        if isinstance(r, (N.RexCall, N.RexUdf)):
            for o in r.operands:
                rex(o)
        elif isinstance(r, N.RexScalarSubquery):
            rel(r.plan)

    def rel(node):
        if isinstance(node, N.LogicalProject):
            for e in node.exprs:
                rex(e)
        elif isinstance(node, N.LogicalFilter):
            rex(node.condition)
        elif isinstance(node, N.LogicalJoin) and node.condition is not None:
            rex(node.condition)
        for k in node.inputs:
            rel(k)

    rel(plan)
    return out


# ---------------------------------------------------------------------------
# the JAX package's unit cases, on both packages
# ---------------------------------------------------------------------------

def test_comparison_literals_hoist(pkg, ctx):
    plan = _plan(pkg, ctx, "SELECT a FROM t WHERE a > 5 AND b <= 7.5")
    new, n = pkg.P.parameterize_plan(plan)
    assert n == 2
    params = pkg.P.collect_params(new)
    assert [p.value for p in params] == [5, 7.5]
    assert [p.slot for p in params] == [0, 1]
    assert pkg.P.collect_params(plan) == []


def test_string_bool_null_literals_stay_baked(pkg, ctx):
    _, n = pkg.P.parameterize_plan(
        _plan(pkg, ctx, "SELECT a FROM t WHERE s = 'v1'"))
    assert n == 0
    new, _ = pkg.P.parameterize_plan(
        _plan(pkg, ctx, "SELECT a FROM t WHERE (a > 3) = TRUE"))
    assert all(not (isinstance(p, pkg.N.RexParam)
                    and isinstance(p.value, bool))
               for p in pkg.P.collect_params(new))


def test_both_scalar_comparison_not_hoisted(pkg, ctx):
    new, n = pkg.P.parameterize_plan(
        _plan(pkg, ctx, "SELECT a FROM t WHERE 1 < 2 AND a > 5"))
    assert n == 1
    assert [p.value for p in pkg.P.collect_params(new)] == [5]


def test_in_list_arity_stays_structural(pkg, ctx):
    n2, _ = pkg.P.parameterize_plan(
        _plan(pkg, ctx, "SELECT a FROM t WHERE a IN (1, 2)"))
    n3, _ = pkg.P.parameterize_plan(
        _plan(pkg, ctx, "SELECT a FROM t WHERE a IN (1, 2, 3)"))
    assert (pkg.rc.canonical_plan(n2, ctx, shape=True)[0]
            != pkg.rc.canonical_plan(n3, ctx, shape=True)[0])


def test_volatile_expressions_never_hoisted(pkg, ctx):
    new, n = pkg.P.parameterize_plan(_plan(
        pkg, ctx, "SELECT a FROM t WHERE b > RAND(1) AND RAND(2) < 0.5"))
    assert n == 0
    assert pkg.P.collect_params(new) == []


def test_values_rows_stay_baked(pkg, ctx):
    new, n = pkg.P.parameterize_plan(_plan(
        pkg, ctx, "SELECT * FROM (VALUES (1, 2.0), (3, 4.0)) AS v(x, y)"))
    assert n == 0
    other = _plan(pkg, ctx,
                  "SELECT * FROM (VALUES (9, 2.0), (3, 4.0)) AS v(x, y)")
    assert (pkg.rc.canonical_plan(new, ctx)[0]
            != pkg.rc.canonical_plan(other, ctx)[0])


def test_scalar_subquery_body_stays_baked_but_canonicalized(pkg, ctx):
    q = "SELECT a FROM t WHERE b > (SELECT AVG(b) FROM t WHERE a > {k})"
    p5 = _plan(pkg, ctx, q.format(k=5))
    p9 = _plan(pkg, ctx, q.format(k=9))
    n5, h5 = pkg.P.parameterize_plan(p5)
    pkg.P.parameterize_plan(p9)
    assert len([k for k in _rex_kinds(pkg, n5) if k == "RexParam"]) == h5
    assert (pkg.rc.canonical_plan(p5, ctx)[0]
            != pkg.rc.canonical_plan(p9, ctx)[0])


def test_idempotent(pkg, ctx):
    plan = _plan(pkg, ctx, "SELECT a FROM t WHERE a > 5")
    once, n1 = pkg.P.parameterize_plan(plan)
    twice, n2 = pkg.P.parameterize_plan(once)
    assert n1 == 1 and n2 == 0
    assert twice is once


def test_kill_switch(pkg, monkeypatch):
    monkeypatch.setenv("DSQL_PARAM_PLANS", "0")
    assert not pkg.P.param_plans_enabled()
    monkeypatch.setenv("DSQL_PARAM_PLANS", "1")
    assert pkg.P.param_plans_enabled()
    monkeypatch.delenv("DSQL_PARAM_PLANS")
    assert pkg.P.param_plans_enabled()


def _fp(pkg, ctx, plan):
    params = []
    return pkg.compiled._fp_plan(plan, ctx, [], params), params


def test_shape_fingerprint_shared_across_literals(pkg, ctx):
    a = pkg.P.parameterize_plan(_plan(pkg, ctx,
                                      "SELECT a FROM t WHERE a > 5"))[0]
    b = pkg.P.parameterize_plan(_plan(pkg, ctx,
                                      "SELECT a FROM t WHERE a > 17"))[0]
    fa, pa = _fp(pkg, ctx, a)
    fb, pb = _fp(pkg, ctx, b)
    assert fa == fb
    assert [p.value for p in pa] == [5]
    assert [p.value for p in pb] == [17]
    assert "P0:INTEGER" in fa


def test_unparameterized_fingerprints_stay_distinct(pkg, ctx):
    fa, _ = _fp(pkg, ctx, _plan(pkg, ctx, "SELECT a FROM t WHERE a > 5"))
    fb, _ = _fp(pkg, ctx, _plan(pkg, ctx, "SELECT a FROM t WHERE a > 17"))
    assert fa != fb


def test_canon_default_is_value_bearing(pkg, ctx):
    a = pkg.P.parameterize_plan(_plan(pkg, ctx,
                                      "SELECT a FROM t WHERE a > 5"))[0]
    b = pkg.P.parameterize_plan(_plan(pkg, ctx,
                                      "SELECT a FROM t WHERE a > 17"))[0]
    ta, va, _ = pkg.rc.canonical_plan(a, ctx)
    tb, vb, _ = pkg.rc.canonical_plan(b, ctx)
    assert not va and not vb
    assert ta != tb
    assert "P0:INTEGER=5" in ta and "P0:INTEGER=17" in tb


def test_canon_shape_mode_is_value_free(pkg, ctx):
    a = pkg.P.parameterize_plan(_plan(pkg, ctx,
                                      "SELECT a FROM t WHERE a > 5"))[0]
    b = pkg.P.parameterize_plan(_plan(pkg, ctx,
                                      "SELECT a FROM t WHERE a > 17"))[0]
    assert (pkg.rc.canonical_plan(a, ctx, shape=True)[0]
            == pkg.rc.canonical_plan(b, ctx, shape=True)[0])


def test_shape_text_shared_across_literals(pkg, ctx):
    """The JAX package's flight-recorder case: the parameterized plan's
    shape text (what its ``plan_fingerprint`` digests; the port keeps no
    flight recorder) is shared by literal variants and differs for
    another shape."""
    def shape(sql):
        plan = pkg.P.parameterize_plan(_plan(pkg, ctx, sql))[0]
        return pkg.rc.canonical_plan(plan, ctx, shape=True)[0]

    fa = shape("SELECT a FROM t WHERE a > 5")
    assert fa == shape("SELECT a FROM t WHERE a > 17")
    assert fa != shape("SELECT a FROM t WHERE b > 1.0")


def test_statistics_use_param_values(pkg):
    p = pkg.N.RexParam(0, 42, pkg.types.INTEGER)
    assert pkg.stats._literal_value(p) == 42.0


# ---------------------------------------------------------------------------
# TPC-H: hoisted counts and fingerprints equal the JAX package's
# ---------------------------------------------------------------------------

#: ``parameterize_plan``'s hoisted count on Q1-Q22 in the JAX package
JAX_HOISTED = [1, 1, 2, 2, 2, 5, 2, 2, 0, 2, 0, 2, 0, 2, 2, 0, 0, 1, 10, 2,
               2, 0]


@pytest.fixture(scope="module")
def tpch_both():
    from benchmarks.tpch import generate_tpch
    data = generate_tpch(0.003)
    jc, pc = JaxContext(), Context(device="cpu")
    for name, frame in data.items():
        jc.create_table(name, frame)
        pc.create_table(name, frame)
    return jc, pc


@pytest.mark.parametrize("qid", range(1, 23))
def test_tpch_hoisting_and_fingerprints_equal_jax(qid, tpch_both):
    from benchmarks.tpch import QUERIES

    out = {}
    for (name, pkg), c in zip(sorted(PKGS.items()), tpch_both):
        plan = _plan(pkg, c, QUERIES[qid])
        new, hoisted = pkg.P.parameterize_plan(plan)
        fp, params = _fp(pkg, c, new)
        out[name] = (hoisted, fp, [(p.value, p.stype.name) for p in params])
    assert out["port"] == out["jax"]
    assert out["port"][0] == JAX_HOISTED[qid - 1]
    assert out["port"][1].count("P") >= len(out["port"][2])


# ---------------------------------------------------------------------------
# the port's compiled tier: one program per shape
# ---------------------------------------------------------------------------

def _delta(before: dict, names) -> dict:
    return {k: port_compiled.stats.get(k, 0) - before.get(k, 0)
            for k in names}


def _eager(c, sql, **kw):
    os.environ["DSQL_COMPILE"] = "0"
    try:
        return c.sql(sql, return_futures=False, **kw)
    finally:
        del os.environ["DSQL_COMPILE"]


@pytest.fixture()
def pc():
    rng = np.random.default_rng(16)
    n = 3000
    c = Context(device="cpu")
    c.create_table("m", pd.DataFrame({"k": rng.integers(0, 40, n),
                                      "x": rng.random(n),
                                      "q": rng.integers(1, 50, n)}))
    return c


COUNTERS = ("compiles", "hits", "param_plans", "param_literals_hoisted",
            "param_plan_hits", "param_plan_misses")
LITERALS_Q = ("SELECT k, SUM(x) AS s, COUNT(*) AS n FROM m "
              "WHERE x > {} AND q < {} GROUP BY k ORDER BY k")


def test_one_program_for_many_literals(pc):
    variants = [(0.1, 10), (0.25, 24), (0.5, 25), (0.75, 40), (0.9, 49)]
    before = dict(port_compiled.stats)
    got = [pc.sql(LITERALS_Q.format(*v), return_futures=False)
           for v in variants]
    assert _delta(before, COUNTERS) == {
        "compiles": 1, "hits": 4, "param_plans": 5,
        "param_literals_hoisted": 10, "param_plan_hits": 4,
        "param_plan_misses": 1}
    for v, g in zip(variants, got):
        pd.testing.assert_frame_equal(g, _eager(pc, LITERALS_Q.format(*v)))


def test_kill_switch_bakes_values_into_keys(pc, monkeypatch):
    monkeypatch.setenv("DSQL_PARAM_PLANS", "0")
    variants = [(0.2, 11), (0.3, 12)]
    before = dict(port_compiled.stats)
    baked = [pc.sql(LITERALS_Q.format(*v), return_futures=False)
             for v in variants]
    assert _delta(before, COUNTERS) == {
        "compiles": 2, "hits": 0, "param_plans": 0,
        "param_literals_hoisted": 0, "param_plan_hits": 0,
        "param_plan_misses": 0}
    monkeypatch.delenv("DSQL_PARAM_PLANS")
    for v, b in zip(variants, baked):
        pd.testing.assert_frame_equal(
            pc.sql(LITERALS_Q.format(*v), return_futures=False), b)


def test_params_api_shares_program_with_inline_literals(pc):
    q = "SELECT k, x FROM m WHERE q > {} ORDER BY x"
    before = dict(port_compiled.stats)
    inline = pc.sql(q.format(30), return_futures=False)
    marked = pc.sql(q.format("?"), params=[40], return_futures=False)
    pc.sql("PREPARE pq AS " + q.format("?"))
    prepared = pc.sql("EXECUTE pq (45)", return_futures=False)
    assert _delta(before, ("compiles", "hits")) == {"compiles": 1,
                                                    "hits": 2}
    for lit, got in ((30, inline), (40, marked), (45, prepared)):
        pd.testing.assert_frame_equal(got, _eager(pc, q.format(lit)))


# ---------------------------------------------------------------------------
# type promotion: a 0-d parameter compares as the baked literal does
# ---------------------------------------------------------------------------

def _promo_frame() -> pd.DataFrame:
    rng = np.random.default_rng(4)
    n = 64
    f32 = rng.random(n).astype(np.float32)
    f32[:4] = np.float32([0.1, 0.30000001, 0.3, 0.25])   # on the edges
    return pd.DataFrame({
        "i32": rng.integers(-2**31, 2**31 - 1, n).astype(np.int32),
        "f32": f32,
        "d": pd.to_datetime("1995-01-01")
        + pd.to_timedelta(rng.integers(0, 1000, n), unit="D"),
        "ts": pd.to_datetime("1995-01-01")
        + pd.to_timedelta(rng.integers(0, 10**9, n), unit="s"),
        "v": rng.random(n) * 100})


PROMOTIONS = {
    "int32_vs_past_2_31": "SELECT COUNT(*) AS n FROM p WHERE i32 < 3000000000",
    "int32_vs_2_31": "SELECT COUNT(*) AS n FROM p WHERE i32 <> 2147483648",
    "int32_vs_small": "SELECT COUNT(*) AS n FROM p WHERE i32 > 5",
    "float32_vs_double": "SELECT COUNT(*) AS n FROM p WHERE f32 <= 0.1",
    "float32_vs_double_edge":
        "SELECT COUNT(*) AS n FROM p WHERE f32 >= 0.30000001",
    "decimal": "SELECT COUNT(*) AS n, SUM(CAST(v AS DECIMAL(12, 2))) AS s "
               "FROM p WHERE CAST(v AS DECIMAL(12, 2)) < 50.25",
    "timestamp_vs_date":
        "SELECT COUNT(*) AS n FROM p WHERE ts < DATE '1996-01-01'",
    "date_vs_timestamp": "SELECT COUNT(*) AS n FROM p "
                         "WHERE d < TIMESTAMP '1996-01-01 12:00:00'",
}


@pytest.fixture(scope="module")
def promo_contexts():
    frame = _promo_frame()
    jc, pc = JaxContext(), Context(device="cpu")
    jc.create_table("p", frame)
    pc.create_table("p", frame)
    return jc, pc


@pytest.mark.parametrize("case", sorted(PROMOTIONS))
def test_parameter_promotes_as_the_baked_literal(case, promo_contexts,
                                                 monkeypatch):
    jc, pc = promo_contexts
    q = PROMOTIONS[case]
    before = dict(port_compiled.stats)
    param = pc.sql(q, return_futures=False)
    assert _delta(before, ("param_plans",))["param_plans"] == 1
    monkeypatch.setenv("DSQL_PARAM_PLANS", "0")
    baked = pc.sql(q, return_futures=False)
    monkeypatch.delenv("DSQL_PARAM_PLANS")
    eager = _eager(pc, q)
    want = jc.sql(q, return_futures=False)
    for got in (baked, eager):
        pd.testing.assert_frame_equal(param, got)
    assert param.to_numpy().tolist() == want.to_numpy().tolist()
