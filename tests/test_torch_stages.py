"""Stage graphs (``physical/stages.py`` and the compiled tier's stage
execution) in the port, against the JAX package.

- The cases of ``tests/unit/test_stages.py``, each run on both packages:
  heavy counts, deterministic and ancestor-independent partitions, the
  per-stage bound, the budget's environment variables.
- TPC-H Q1-Q22 (SF 0.003): ``result_cache.canonical_plan`` text equals the
  JAX package's, and so do the partitions at budgets 1, 2 and 6 (stage
  count, dependencies, heavy weights and the boundary names, which digest
  the canonical text; the scanned tables' uids, counters that differ
  between two packages' catalogs, are read as table names on both sides).
- The port's Q2, Q8 and Q21 stage at the default budget and answer as the
  eager executor does, with one worker and with four; no boundary table
  outlives its query.  (Their stage counters are held against the JAX
  tier's in ``test_torch_compiled.py::test_tpch_compiled``.)
"""
import os
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest

import dask_sql_tpu.physical.compiled as jax_compiled
import dask_sql_tpu.physical.stages as jax_stages
import dask_sql_tpu.plan.nodes as jax_nodes
import dask_sql_tpu.runtime.result_cache as jax_rc
from dask_sql_tpu import Context as JaxContext
from dask_sql_tpu.sql.parser import parse_sql as jax_parse

import dask_sql_tpu_torch.physical.compiled as port_compiled
import dask_sql_tpu_torch.physical.stages as port_stages
import dask_sql_tpu_torch.plan.nodes as port_nodes
import dask_sql_tpu_torch.runtime.result_cache as port_rc
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.sql.parser import parse_sql as port_parse

PKGS = {
    "jax": SimpleNamespace(Context=JaxContext, kw={}, S=jax_stages,
                           N=jax_nodes, rc=jax_rc, compiled=jax_compiled,
                           parse=jax_parse),
    "port": SimpleNamespace(Context=Context, kw={"device": "cpu"},
                            S=port_stages, N=port_nodes, rc=port_rc,
                            compiled=port_compiled, parse=port_parse),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


@pytest.fixture()
def ctx(pkg):
    c = pkg.Context(**pkg.kw)
    c.create_table("f", pd.DataFrame({"k": [1, 2, 3, 1],
                                      "v": [1.0, 2.0, 3.0, 4.0]}))
    c.create_table("d", pd.DataFrame({"k": [1, 2, 3], "w": [10, 20, 30]}))
    c.create_table("e", pd.DataFrame({"k": [1, 2], "z": [5, 6]}))
    return c


def _plan(pkg, c, sql):
    return c._get_plan(pkg.parse(sql)[0].query)


THREE_HEAVY = ("SELECT x.k, x.s, d.w, e.z FROM "
               "(SELECT k, SUM(v) AS s FROM f GROUP BY k) x "
               "JOIN d ON x.k = d.k JOIN e ON x.k = e.k")


def _counting_namer(pkg):
    names = {}

    def make_scan(sub):
        name = f"s{len(names)}"
        names[name] = sub
        return pkg.N.LogicalTableScan(
            schema_name="__split__", table_name=name,
            schema=[pkg.N.Field(f"c{i}", f.stype)
                    for i, f in enumerate(sub.schema)])

    return make_scan


# ---------------------------------------------------------------------------
# the JAX package's unit cases, on both packages
# ---------------------------------------------------------------------------

def test_heavy_count_and_node_weight(pkg, ctx):
    assert pkg.S.heavy_count(_plan(pkg, ctx, THREE_HEAVY)) == 3
    assert pkg.S.heavy_count(_plan(pkg, ctx,
                                   "SELECT k FROM f WHERE k > 1")) == 0


def test_heavy_count_deterministic(pkg, ctx):
    assert (pkg.S.heavy_count(_plan(pkg, ctx, THREE_HEAVY))
            == pkg.S.heavy_count(_plan(pkg, ctx, THREE_HEAVY)))


def test_partition_deterministic(pkg, ctx):
    plan = _plan(pkg, ctx, THREE_HEAVY)
    g1 = pkg.S.partition(plan, 1, _counting_namer(pkg))
    g2 = pkg.S.partition(plan, 1, _counting_namer(pkg))
    assert len(g1.stages) == len(g2.stages)
    for a, b in zip(g1.stages, g2.stages):
        assert a.deps == b.deps
        assert a.heavy == b.heavy
        assert a.plan.explain() == b.plan.explain()


def test_partition_bounds_and_topology(pkg, ctx):
    plan = _plan(pkg, ctx, THREE_HEAVY)
    for budget in (1, 2, 3):
        g = pkg.S.partition(plan, budget, _counting_namer(pkg))
        total = 0
        for i, st in enumerate(g.stages):
            assert st.heavy <= max(budget, 2)
            assert all(d < i for d in st.deps)
            assert not isinstance(st.plan, pkg.N.LogicalTableScan)
            total += st.heavy
        assert total == pkg.S.heavy_count(plan)
        assert g.root is g.stages[-1] and g.root.scan is None
        if budget >= 3:
            assert len(g.stages) == 1


def test_partition_shared_subtree_is_ancestor_independent(pkg, ctx):
    qa = ("SELECT x.k, x.s, d.w FROM "
          "(SELECT k, SUM(v) AS s FROM f GROUP BY k) x "
          "JOIN d ON x.k = d.k")
    qb = ("SELECT x.k, x.s * 2 AS s2, d.w FROM "
          "(SELECT k, SUM(v) AS s FROM f GROUP BY k) x "
          "JOIN d ON x.k = d.k WHERE d.w > 15")
    ga = pkg.S.partition(_plan(pkg, ctx, qa), 1, _counting_namer(pkg))
    gb = pkg.S.partition(_plan(pkg, ctx, qb), 1, _counting_namer(pkg))
    assert ga.stages[0].plan.explain() == gb.stages[0].plan.explain()


def test_stage_budget_env(pkg, monkeypatch):
    S = pkg.S
    monkeypatch.delenv("DSQL_STAGE_HEAVY", raising=False)
    monkeypatch.delenv("DSQL_SPLIT_HEAVY", raising=False)
    assert S.stage_budget() == S.DEFAULT_STAGE_HEAVY == 6
    assert S.stage_budget(3) == 3
    monkeypatch.setenv("DSQL_SPLIT_HEAVY", "4")
    assert S.stage_budget() == 4
    monkeypatch.setenv("DSQL_STAGE_HEAVY", "2")
    assert S.stage_budget() == 2
    assert S.stage_budget(1) == 1


# ---------------------------------------------------------------------------
# TPC-H: canonical text and partitions equal the JAX package's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tpch_both():
    from benchmarks.tpch import generate_tpch
    data = generate_tpch(0.003)
    jc, pc = JaxContext(), Context(device="cpu")
    for name, frame in data.items():
        jc.create_table(name, frame)
        pc.create_table(name, frame)
    return {"jax": jc, "port": pc}


def _tpch_plans(tpch_both, qid):
    from benchmarks.tpch import QUERIES
    return {name: _plan(PKGS[name], c, QUERIES[qid])
            for name, c in tpch_both.items()}


@pytest.mark.parametrize("qid", range(1, 23))
def test_tpch_canonical_plan_equal_jax(qid, tpch_both):
    plans = _tpch_plans(tpch_both, qid)
    for shape in (False, True):
        texts = {name: PKGS[name].rc.canonical_plan(
                     plans[name], tpch_both[name], shape=shape)[:2]
                 for name in PKGS}
        assert texts["port"] == texts["jax"]


def _uids_as_names(monkeypatch, pkg, c):
    """Read each scanned table's uid as its name in the boundary digests."""
    names = {str(e.table.uid): f"{schema}.{tname}"
             for schema, sch in c.schema.items()
             for tname, e in sch.tables.items()}
    real = pkg.compiled._scan_uids
    monkeypatch.setattr(pkg.compiled, "_scan_uids", lambda rel, ctx: [
        names.get(u, u) for u in real(rel, ctx)])


@pytest.mark.parametrize("qid", range(1, 23))
def test_tpch_partitions_equal_jax(qid, tpch_both, monkeypatch):
    plans = _tpch_plans(tpch_both, qid)
    for name, pkg in PKGS.items():
        _uids_as_names(monkeypatch, pkg, tpch_both[name])
    for budget in (1, 2, 6):
        got = {}
        for name, pkg in PKGS.items():
            graph = pkg.compiled._partition_plan(plans[name], budget,
                                                 tpch_both[name])
            got[name] = [(st.deps, st.heavy,
                          None if st.scan is None else st.scan.table_name,
                          pkg.rc.canonical_plan(st.plan, tpch_both[name])[0])
                         for st in graph.stages]
        assert got["port"] == got["jax"], (qid, budget)


# ---------------------------------------------------------------------------
# the port's stage graphs at work
# ---------------------------------------------------------------------------

def _eager(c, sql):
    os.environ["DSQL_COMPILE"] = "0"
    try:
        return c.sql(sql, return_futures=False)
    finally:
        del os.environ["DSQL_COMPILE"]


def _assert_frames_close(got: pd.DataFrame, want: pd.DataFrame):
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for col in want.columns:
        g, w = got[col].to_numpy(), want[col].to_numpy()
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g.astype(np.float64), w, rtol=1e-12)
        else:
            assert g.tolist() == w.tolist(), col


@pytest.mark.parametrize("workers", ["1", "4"])
@pytest.mark.parametrize("qid", [2, 8, 21])
def test_tpch_stage_graph_matches_eager(qid, workers, tpch_both,
                                        monkeypatch):
    from benchmarks.tpch import QUERIES

    monkeypatch.delenv("DSQL_STAGE_HEAVY", raising=False)
    monkeypatch.setenv("DSQL_COMPILE_WORKERS", workers)
    pc = tpch_both["port"]
    q = QUERIES[qid]
    assert port_stages.heavy_count(_plan(PKGS["port"], pc, q)) > 6
    before = dict(port_compiled.stats)
    got = pc.sql(q, return_futures=False)
    d = {k: port_compiled.stats.get(k, 0) - before.get(k, 0)
         for k in ("stage_graphs", "stage_execs", "fallbacks",
                   "degradations")}
    assert d["stage_graphs"] == 1 and d["stage_execs"] >= 2, d
    assert d["fallbacks"] == d["degradations"] == 0, d
    _assert_frames_close(got, _eager(pc, q))
    sch = pc.schema.get("__split__")
    assert sch is None or not sch.tables


def test_pad_capacity_rounds_to_a_power_of_two():
    pc = Context(device="cpu")
    pc.create_table("r", pd.DataFrame({"x": np.arange(100.0)}))
    table = pc.schema["root"].tables["r"].table
    padded, valid = port_compiled._pad_capacity(table)
    assert padded.num_rows == 128 and int(valid.sum()) == 100
    assert padded.columns[0].data[:100].tolist() == list(np.arange(100.0))
    small, valid = port_compiled._pad_capacity(table.slice(0, 3))
    assert small.num_rows == 64 and int(valid.sum()) == 3


def test_boundary_build_side_runtime_verdict_equals_jax(monkeypatch):
    """A stage's INNER join probes its heavier side: a boundary counts its
    materialized rows, fewer than the aggregate it joins, so it becomes the
    build side, and its repeated keys fail the unique-build check.  The
    whole program (which weighs the boundary's subtree by its scan) builds
    on the aggregate and compiles; the stage graph goes to eager, in both
    packages alike (ROADMAP Queue 3; TPC-H Q2 from SF 0.1 on)."""
    rng = np.random.default_rng(0)
    frames = {"f": pd.DataFrame({"k": rng.integers(0, 200, 4000),
                                 "v": rng.random(4000)}),
              "d": pd.DataFrame({"k": np.arange(200),
                                 "w": np.arange(200) * 2}),
              "g": pd.DataFrame({"k": rng.integers(0, 200, 1000),
                                 "x": rng.random(1000)})}
    q = ("SELECT b.k, b.v, a.s FROM (SELECT f.k, f.v FROM f JOIN d "
         "ON f.k = d.k WHERE f.v < 0.02) b JOIN (SELECT k, SUM(x) AS s "
         "FROM g GROUP BY k) a ON b.k = a.k")
    names = ("compiles", "fallbacks", "stage_graphs", "stage_execs")
    seen = {}
    for name, pkg in PKGS.items():
        c = pkg.Context(**pkg.kw)
        for t, frame in frames.items():
            c.create_table(t, frame)
        for budget in ("99", "1"):
            monkeypatch.setenv("DSQL_STAGE_HEAVY", budget)
            comp = pkg.compiled
            comp._cache.clear()
            comp._learned_caps.clear()
            comp._runtime_eager.clear()
            before = dict(comp.stats)
            got = c.sql(q, return_futures=False)
            tier = [s.attrs["tier"] for s in c.last_report.root.walk()
                    if "tier" in s.attrs]
            seen[name, budget] = (
                {k: comp.stats.get(k, 0) - before.get(k, 0) for k in names},
                tier, got.sort_values(["k", "v"], ignore_index=True))
    for budget, want in (("99", ({"compiles": 1, "fallbacks": 0,
                                  "stage_graphs": 0, "stage_execs": 0},
                                 ["compiled"])),
                         ("1", ({"compiles": 3, "fallbacks": 1,
                                 "stage_graphs": 1, "stage_execs": 3},
                                ["eager"]))):
        assert seen["port", budget][:2] == seen["jax", budget][:2] == want
        _assert_frames_close(seen["port", budget][2], seen["jax", "99"][2])
