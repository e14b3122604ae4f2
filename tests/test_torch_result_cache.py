"""The result cache (``runtime/result_cache.py``) in the port, against the
JAX package.

- The cases of ``tests/unit/test_result_cache_unit.py`` on both packages
  (``P.rc``, ``P.tel``, ``P.Context``): byte accounting, LRU order, the
  spill ladder and its round trip, host overflow, oversized entries, the
  zero budget, isolation from caller mutation, invalidation, plan keys
  (stable, distinct, epochs and uids folded in, volatile operators and
  UDFs refused), epochs on every mutation path, stage boundary names.
- TPC-H Q1-Q22 (SF 0.003) and RAND / NOW queries: ``plan_key`` refuses
  the same plans, scans the same tables, and digests its canonical text
  with the same epoch and uid suffixes in both packages.
- One sequence of put, get, invalidate, spill, promote and shrink on a
  fresh cache of each package: equal ``result_cache_*`` counter deltas,
  ``stats()`` and entry tiers.
- EXPLAIN ANALYZE's ``-- cache:`` line (disabled, miss, hit, uncacheable)
  equal in both packages.
- Q8 and Q21 as stage graphs, run again with the full-query lookup
  bypassed (``_rc_bypass``): ``result_cache_subplan_hits`` equal to the
  JAX tier's, answers equal.
- ``Context.sql`` at the defaults: a repeated query is a hit that runs no
  tier (no compile, no replay, no eager plan node); a mutation misses;
  ``DSQL_RESULT_CACHE_MB=0`` restores the uncached path.

The cache is on here by this module's own ``monkeypatch`` (the test pins
in ``conftest.py`` turn it off for every module whose name lacks
``test_result_cache``).  Answers compare exactly (ints, strings) and with
rtol 1e-12 (doubles).
"""
import hashlib
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest
import torch

import dask_sql_tpu.physical.compiled as jax_compiled
import dask_sql_tpu.runtime.result_cache as jax_rc
import dask_sql_tpu.runtime.telemetry as jax_tel
from benchmarks.tpch import QUERIES, generate_tpch
from dask_sql_tpu import Context as JaxContext
from dask_sql_tpu.sql.parser import parse_sql as jax_parse
from dask_sql_tpu.table import Table as JaxTable

import dask_sql_tpu_torch.physical.compiled as port_compiled
import dask_sql_tpu_torch.runtime.result_cache as port_rc
import dask_sql_tpu_torch.runtime.telemetry as port_tel
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.sql.parser import parse_sql as port_parse
from dask_sql_tpu_torch.table import Column as PortColumn, Table as PortTable

CPU = torch.device("cpu")


def _jax_table(data, mask):
    t = JaxTable.from_pydict(data)
    if mask is not None:
        import jax.numpy as jnp
        t.columns[0] = t.columns[0].with_mask(jnp.asarray(mask))
    return t


def _port_table(data, mask):
    t = PortTable.from_pydict(data, CPU)
    if mask is not None:
        c = t.columns[0]
        t.columns[0] = PortColumn(c.data, c.stype, torch.from_numpy(mask),
                                  c.dictionary)
    return t


PKGS = {
    "jax": SimpleNamespace(rc=jax_rc, tel=jax_tel, Context=JaxContext,
                           kw={}, parse=jax_parse, compiled=jax_compiled,
                           make=_jax_table),
    "port": SimpleNamespace(rc=port_rc, tel=port_tel, Context=Context,
                            kw={"device": "cpu"}, parse=port_parse,
                            compiled=port_compiled, make=_port_table),
}


@pytest.fixture(params=sorted(PKGS))
def P(request):
    return PKGS[request.param]


@pytest.fixture()
def cache(P, monkeypatch):
    """A fresh, generously budgeted cache for each test."""
    monkeypatch.setenv("DSQL_RESULT_CACHE_MB", "64")
    monkeypatch.setenv("DSQL_RESULT_CACHE_HOST_MB", "64")
    c = P.rc.ResultCache()
    yield c
    c.clear()


@pytest.fixture(autouse=True)
def _clear_global_caches():
    yield
    jax_rc.get_cache().clear()
    port_rc.get_cache().clear()


def _table(P, n_rows: int, fill: int = 0, with_mask: bool = False,
           with_strings: bool = False):
    data = {"a": np.full(n_rows, fill, dtype=np.int64)}
    if with_strings:
        data["s"] = np.array(["ab", "cd"] * (n_rows // 2), dtype=object)
    mask = (np.arange(n_rows) % 2 == 0) if with_mask else None
    return P.make(data, mask)


def _key(P, name: str, tables=()):
    return P.rc.CacheKey(name, tuple(tables))


# ---------------------------------------------------------------------------
# byte accounting + LRU + the eviction ladder
# ---------------------------------------------------------------------------

def test_byte_accounting_accuracy(P, cache):
    t1 = _table(P, 1024)                      # 8 KiB of int64
    t2 = _table(P, 2048, with_mask=True)      # 16 KiB data + 2 KiB mask
    assert cache.put(_key(P, "k1"), t1)
    assert cache.put(_key(P, "k2"), t2)
    expected = P.rc._table_nbytes(t1) + P.rc._table_nbytes(t2)
    assert cache.device_bytes == expected
    assert cache.host_bytes == 0
    # gauge mirrors the accounting
    assert P.tel.REGISTRY.get_gauge("result_cache_bytes") == expected
    # replacing a key re-accounts instead of double-counting
    assert cache.put(_key(P, "k1"), _table(P, 512))
    assert cache.device_bytes == P.rc._table_nbytes(_table(P, 512)) + \
        P.rc._table_nbytes(t2)


def test_lru_order_under_budget_pressure(P, cache, monkeypatch):
    # budget fits two 8 KiB entries; host tier off => evictions DROP
    monkeypatch.setenv("DSQL_RESULT_CACHE_MB", str(20 / 1024))
    monkeypatch.setenv("DSQL_RESULT_CACHE_HOST_MB", "0")
    cache.put(_key(P, "a"), _table(P, 1024))
    cache.put(_key(P, "b"), _table(P, 1024))
    assert cache.get(_key(P, "a")) is not None   # touch: a becomes MRU
    cache.put(_key(P, "c"), _table(P, 1024))        # over budget: LRU (b) drops
    assert cache.probe(_key(P, "b")) is None
    assert cache.probe(_key(P, "a")) == "device"
    assert cache.probe(_key(P, "c")) == "device"
    assert cache.device_bytes <= cache.device_budget()


def test_spill_ladder_and_round_trip_equality(P, cache, monkeypatch):
    monkeypatch.setenv("DSQL_RESULT_CACHE_MB", str(20 / 1024))
    monkeypatch.setenv("DSQL_RESULT_CACHE_HOST_MB", "1")
    spills0 = P.tel.REGISTRY.get("result_cache_spills")
    orig = _table(P, 1024, fill=7, with_mask=True, with_strings=True)
    expected = orig.to_pandas()
    cache.put(_key(P, "a"), orig)
    cache.put(_key(P, "b"), _table(P, 1024))
    cache.put(_key(P, "c"), _table(P, 1024))
    # the ladder spilled (not dropped) the LRU device entries to host
    assert cache.probe(_key(P, "a")) == "host"
    assert P.tel.REGISTRY.get("result_cache_spills") > spills0
    assert cache.host_bytes > 0
    # host hit: re-uploaded, bit-identical, and promoted back to device
    got, tier = cache.get(_key(P, "a"))
    assert tier == "host"
    pd.testing.assert_frame_equal(got.to_pandas(), expected, check_dtype=False)
    assert cache.probe(_key(P, "a")) == "device"


def test_host_budget_overflow_drops(P, cache, monkeypatch):
    monkeypatch.setenv("DSQL_RESULT_CACHE_MB", str(10 / 1024))
    monkeypatch.setenv("DSQL_RESULT_CACHE_HOST_MB", str(10 / 1024))
    ev0 = P.tel.REGISTRY.get("result_cache_evictions")
    cache.put(_key(P, "a"), _table(P, 1024))
    cache.put(_key(P, "b"), _table(P, 1024))   # a spills to host
    cache.put(_key(P, "c"), _table(P, 1024))   # b spills; host over budget: a drops
    assert cache.probe(_key(P, "a")) is None
    assert P.tel.REGISTRY.get("result_cache_evictions") > ev0
    assert cache.host_bytes <= cache.host_budget()


def test_oversized_entry_is_not_stored(P, cache, monkeypatch):
    monkeypatch.setenv("DSQL_RESULT_CACHE_MB", str(4 / 1024))
    assert not cache.put(_key(P, "big"), _table(P, 1024))
    assert cache.stats()["entries"] == 0


def test_zero_budget_disables_cleanly(P, cache, monkeypatch):
    cache.put(_key(P, "a"), _table(P, 128))
    assert cache.stats()["entries"] == 1
    monkeypatch.setenv("DSQL_RESULT_CACHE_MB", "0")
    assert not cache.enabled()
    # disabling released what was held, and get/put are no-ops
    assert cache.stats()["entries"] == 0
    assert cache.get(_key(P, "a")) is None
    assert not cache.put(_key(P, "a"), _table(P, 128))


def test_cached_table_is_isolated_from_caller_mutation(P, cache):
    t = _table(P, 64)
    cache.put(_key(P, "a"), t)
    t.names[0] = "mutated"                   # caller vandalizes its copy
    got, _ = cache.get(_key(P, "a"))
    assert got.names == ["a"]
    got.names[0] = "other"                   # hit copies are private too
    again, _ = cache.get(_key(P, "a"))
    assert again.names == ["a"]


def test_invalidate_table_drops_referencing_entries(P, cache):
    inv0 = P.tel.REGISTRY.get("result_cache_invalidations")
    cache.put(_key(P, "a", tables=[("root", "t1")]), _table(P, 64))
    cache.put(_key(P, "b", tables=[("root", "t1"), ("root", "t2")]), _table(P, 64))
    cache.put(_key(P, "c", tables=[("root", "t2")]), _table(P, 64))
    assert cache.invalidate_table("root", "t1") == 2
    assert cache.probe(_key(P, "a")) is None
    assert cache.probe(_key(P, "b")) is None
    assert cache.probe(_key(P, "c")) == "device"
    assert P.tel.REGISTRY.get("result_cache_invalidations") == inv0 + 2


# ---------------------------------------------------------------------------
# plan keys: canonicalization, epochs, volatility
# ---------------------------------------------------------------------------

def _plan(P, ctx, sql):
    return ctx._get_plan(P.parse(sql)[0].query, sql)


@pytest.fixture()
def ctx(P):
    c = P.Context(**P.kw)
    c.create_table("t", pd.DataFrame({"a": [1, 2, 3], "b": [1.0, 2.0, 3.0]}))
    return c


def test_plan_key_stable_and_distinct(P, ctx):
    k1 = P.rc.plan_key(_plan(P, ctx, "SELECT a FROM t"), ctx)
    k2 = P.rc.plan_key(_plan(P, ctx, "SELECT a FROM t"), ctx)
    k3 = P.rc.plan_key(_plan(P, ctx, "SELECT b FROM t"), ctx)
    assert k1.digest == k2.digest
    assert k1.digest != k3.digest
    assert k1.tables == (("root", "t"),)


def test_plan_key_distinguishes_values_rows(P, ctx):
    # RelNode.explain() elides VALUES contents; the canonical serializer
    # must not (this also guards the stage-boundary digest)
    k1 = P.rc.plan_key(_plan(P, ctx, "SELECT * FROM (VALUES (1), (2)) AS v(x)"),
                     ctx)
    k2 = P.rc.plan_key(_plan(P, ctx, "SELECT * FROM (VALUES (3), (4)) AS v(x)"),
                     ctx)
    assert k1.digest != k2.digest


def test_plan_key_folds_epoch_and_uid(P, ctx):
    k1 = P.rc.plan_key(_plan(P, ctx, "SELECT SUM(a) AS s FROM t"), ctx)
    ctx.create_table("t", pd.DataFrame({"a": [9], "b": [9.0]}))
    k2 = P.rc.plan_key(_plan(P, ctx, "SELECT SUM(a) AS s FROM t"), ctx)
    assert k1.digest != k2.digest


def test_plan_key_volatile_ops_refuse(P, ctx):
    assert P.rc.plan_key(_plan(P, ctx, "SELECT RAND() AS r FROM t"), ctx) is None
    assert P.rc.plan_key(
        _plan(P, ctx, "SELECT CURRENT_TIMESTAMP AS ts FROM t"), ctx) is None


def test_plan_key_udf_refuses(P, ctx):
    ctx.register_function(lambda x: x + 1, "f", [("x", np.int64)], np.int64)
    assert P.rc.plan_key(_plan(P, ctx, "SELECT f(a) AS y FROM t"), ctx) is None


def test_epoch_bumps_on_every_mutation_path(P, ctx):
    e0 = ctx.table_epoch("root", "t")
    ctx.create_table("t", pd.DataFrame({"a": [1], "b": [1.0]}))
    e1 = ctx.table_epoch("root", "t")
    assert e1 > e0
    ctx.sql("CREATE TABLE u AS SELECT a FROM t")
    assert ctx.table_epoch("root", "u") > 0
    ctx.alter_table("u", "u2")
    assert ctx.table_epoch("root", "u2") > ctx.table_epoch("root", "u") > e1
    ctx.drop_table("u2")
    e_drop = ctx.table_epoch("root", "u2")
    assert e_drop > e1
    ctx.create_schema("s2")
    ctx.create_table("x", pd.DataFrame({"a": [1]}), schema_name="s2")
    ex = ctx.table_epoch("s2", "x")
    ctx.alter_schema("s2", "s3")
    assert ctx.table_epoch("s3", "x") > ex
    ctx.drop_schema("s3")
    assert ctx.table_epoch("s3", "x") > ex


def test_stage_table_name_uses_canonical_shape(P, ctx):
    """Two subplans differing only in VALUES contents must get distinct
    stage-boundary digests (the subplan cache replays by that name)."""
    compiled = P.compiled
    p1 = _plan(P, ctx, "SELECT * FROM (VALUES (1), (2)) AS v(x)")
    p2 = _plan(P, ctx, "SELECT * FROM (VALUES (3), (4)) AS v(x)")
    assert compiled._stage_table_name(p1, ctx) != \
        compiled._stage_table_name(p2, ctx)


# ---------------------------------------------------------------------------
# TPC-H plan keys equal the JAX package's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tpch_both():
    data = generate_tpch(0.003)
    jc, pc = JaxContext(), Context(device="cpu")
    for name, frame in data.items():
        jc.create_table(name, frame)
        pc.create_table(name, frame)
    return {"jax": jc, "port": pc}


VOLATILE_SQL = {
    "rand": "SELECT n_name, RAND() AS r FROM nation",
    "now": "SELECT n_name, CURRENT_TIMESTAMP AS t FROM nation",
    "seeded_sample": "SELECT COUNT(*) AS n FROM lineitem "
                     "TABLESAMPLE SYSTEM (50) REPEATABLE (3)",
}


def _expected_digest(text, tables, ctx):
    h = hashlib.blake2b(text.encode(), digest_size=16)
    for schema_name, table_name in tables:
        entry = ctx.schema[schema_name].tables[table_name]
        h.update(f"|{schema_name}.{table_name}"
                 f":e{ctx.table_epoch(schema_name, table_name)}"
                 f":u{entry.table.uid}".encode())
    return h.hexdigest()


@pytest.mark.parametrize("sql", [QUERIES[q] for q in range(1, 23)]
                         + list(VOLATILE_SQL.values()),
                         ids=[f"Q{q}" for q in range(1, 23)]
                         + list(VOLATILE_SQL))
def test_plan_key_equal_jax(tpch_both, sql):
    got = {}
    for name, P in PKGS.items():
        ctx = tpch_both[name]
        plan = _plan(P, ctx, sql)
        text, volatile, scans = P.rc.canonical_plan(plan, ctx)
        key = P.rc.plan_key(plan, ctx)
        if key is not None:
            assert key.digest == _expected_digest(text, scans, ctx)
        got[name] = (text, volatile, key is None,
                     None if key is None else key.tables)
    assert got["port"] == got["jax"]


# ---------------------------------------------------------------------------
# one sequence, both caches
# ---------------------------------------------------------------------------

def _sequence(P, monkeypatch):
    monkeypatch.setenv("DSQL_RESULT_CACHE_MB", str(20 / 1024))
    monkeypatch.setenv("DSQL_RESULT_CACHE_HOST_MB", str(40 / 1024))
    cache = P.rc.ResultCache()
    before = P.tel.REGISTRY.counters()
    seen = []
    t = [("root", "t")]
    cache.put(_key(P, "a", t), _table(P, 1024, fill=1, with_mask=True))
    cache.put(_key(P, "b"), _table(P, 1024, fill=2))
    seen.append(cache.get(_key(P, "a"))[1])      # a becomes MRU
    cache.put(_key(P, "c"), _table(P, 1024, fill=3))   # b spills
    seen.append(cache.probe(_key(P, "b")))
    got = cache.get(_key(P, "b"))                       # host hit: promote
    seen.append(got[1])
    seen.append(int(np.asarray(got[0].columns[0].to_numpy()).sum()))
    seen.append(cache.get(_key(P, "missing")))
    seen.append(cache.invalidate_table("root", "t"))
    seen.append(cache.shrink_device_to(0))              # all to host
    seen.append(sorted((e["key"], e["tier"], e["nbytes"], e["hits"])
                       for e in cache.entries_snapshot()))
    seen.append(cache.get(_key(P, "c"))[1])
    stats = cache.stats()
    after = P.tel.REGISTRY.counters()
    deltas = {k: after[k] - before.get(k, 0) for k in after
              if k.startswith("result_cache") and after[k] != before.get(k, 0)}
    cache.clear()
    return seen, stats, deltas


def test_cache_sequence_equal_jax(monkeypatch):
    got = {name: _sequence(P, monkeypatch) for name, P in PKGS.items()}
    assert got["port"] == got["jax"]
    seen, _, deltas = got["port"]
    assert seen[:3] == ["device", "host", "host"]
    assert deltas["result_cache_spills"] >= 2


def test_cache_populate_fault_skips_the_store(P, cache):
    faults = (jax_compiled._faults if P is PKGS["jax"]
              else port_compiled._faults)
    with faults.inject("cache_populate:1"):
        assert not cache.put(_key(P, "a"), _table(P, 8))
        assert cache.put(_key(P, "a"), _table(P, 8))


# ---------------------------------------------------------------------------
# EXPLAIN ANALYZE's cache line
# ---------------------------------------------------------------------------

def _cache_lines(P, monkeypatch):
    ctx = P.Context(**P.kw)
    ctx.create_table("t", pd.DataFrame({"k": [1, 2, 1], "v": [1.0, 2.0, 4.0]}))
    q = "SELECT k, SUM(v) AS s FROM t GROUP BY k"

    def line(sql):
        rows = ctx.sql("EXPLAIN ANALYZE " + sql, return_futures=False)
        return [r for r in rows["PLAN"] if r.startswith("-- cache:")]

    monkeypatch.setenv("DSQL_RESULT_CACHE_MB", "0")
    out = [line(q)]
    monkeypatch.setenv("DSQL_RESULT_CACHE_MB", "64")
    out.append(line(q))            # a miss; the analyzed run stores it
    out.append(line(q))            # now a hit
    ctx.sql(q)
    out.append(ctx.last_report.cache["hit"])
    out.append(line("SELECT k, RAND() AS r FROM t"))
    return out


def test_explain_analyze_cache_line_equal_jax(monkeypatch):
    got = {name: _cache_lines(P, monkeypatch) for name, P in PKGS.items()}
    assert got["port"] == got["jax"]
    assert got["port"][:3] == [["-- cache: disabled"], ["-- cache: miss"],
                               ["-- cache: hit tier=device"]]


# ---------------------------------------------------------------------------
# the subplan cache on stage graphs
# ---------------------------------------------------------------------------

def _frame_equal(got: pd.DataFrame, want: pd.DataFrame):
    assert list(got.columns) == list(want.columns) and len(got) == len(want)
    for col in want.columns:
        g, w = got[col].to_numpy(), want[col].to_numpy()
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g.astype(np.float64), w, rtol=1e-12)
        else:
            assert g.tolist() == w.tolist(), col


@pytest.mark.parametrize("qid", [8, 21])
def test_subplan_hits_equal_jax(tpch_both, monkeypatch, qid):
    monkeypatch.setenv("DSQL_RESULT_CACHE_MB", "64")
    got, answers = {}, {}
    for name, P in PKGS.items():
        ctx = tpch_both[name]
        P.rc.get_cache().clear()
        first = ctx.sql(QUERIES[qid], return_futures=False)
        before = P.tel.REGISTRY.counters()
        ctx._rc_bypass = True
        try:
            again = ctx.sql(QUERIES[qid], return_futures=False)
        finally:
            ctx._rc_bypass = False
        after = P.tel.REGISTRY.counters()
        _frame_equal(again, first)
        got[name] = {k: after.get(k, 0) - before.get(k, 0)
                     for k in ("result_cache_subplan_hits", "stage_graphs")}
        answers[name] = first
        P.rc.get_cache().clear()
    assert got["port"] == got["jax"]
    assert got["port"]["stage_graphs"] == 1
    assert got["port"]["result_cache_subplan_hits"] >= 1
    _frame_equal(answers["port"], answers["jax"])


# ---------------------------------------------------------------------------
# Context.sql at the defaults
# ---------------------------------------------------------------------------

def test_repeated_query_is_a_hit_that_runs_no_tier(monkeypatch):
    monkeypatch.delenv("DSQL_RESULT_CACHE_MB", raising=False)
    ctx = Context(device="cpu")
    ctx.create_table("t", {"k": np.array([1, 2, 1]), "v": np.arange(3.0)})
    q = "SELECT k, SUM(v) AS s FROM t GROUP BY k"
    first = ctx.sql(q).to_pylist()
    assert ctx.last_report.cache["stored"]
    before = port_tel.REGISTRY.counters()
    again = ctx.sql(q).to_pylist()
    after = port_tel.REGISTRY.counters()
    delta = {k: after[k] - before.get(k, 0) for k in after
             if after[k] != before.get(k, 0)}
    assert again == first
    assert ctx.last_report.cache["hit"] and ctx.last_report.tier is None
    assert delta["result_cache_hits"] == 1
    for name in ("compiles", "hits", "graph_replays", "result_cache_misses"):
        assert delta.get(name, 0) == 0, name
    ctx.create_table("t", {"k": np.array([5]), "v": np.array([1.0])})
    assert ctx.sql(q).to_pylist() == [[5, 1.0]]
    assert not ctx.last_report.cache["hit"]
    monkeypatch.setenv("DSQL_RESULT_CACHE_MB", "0")
    ctx.sql(q)
    ctx.sql(q)
    assert not ctx.last_report.cache["hit"]
    assert not ctx.last_report.cache["stored"]
