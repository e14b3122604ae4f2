"""The port's ingest statistics, estimates and EXPLAIN against the JAX
package's.

The module name contains "statistic", so the conftest's adaptive pin
(``DSQL_ADAPTIVE=0`` everywhere else) leaves the production default on;
each test clears ``DSQL_ADAPTIVE`` and ``DSQL_FORCE_GROUPBY`` itself.

- ``TableStats`` of every TPC-H table at SF 0.003, each package ingesting
  the same pandas frames on its own, equal field for field; and of edge
  cases built from the same physical arrays (an all-NULL column, NaN and
  +-Inf floats, a bool column, an empty table, an integer domain above
  2**20 and a float column long enough for the strided sample, a
  dictionary string with NULLs).
- ``estimate_rows`` at every node and ``selectivity`` of every filter of
  the 22 TPC-H plans equal the JAX package's, as do the plans.
- ``EXPLAIN`` of the 22 queries (plan text and ``-- operator:`` lines)
  equals the JAX package's.  The JAX package runs its native optimizer
  when its library loads, the port the Python pipeline; for these 22
  queries the two pipelines give the same plans.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from benchmarks.tpch import QUERIES, generate_tpch
from dask_sql_tpu import Context as JaxContext
from dask_sql_tpu.plan import nodes as JN
from dask_sql_tpu.runtime import statistics as jax_stats
from dask_sql_tpu.table import Column as JaxColumn, Table as JaxTable
from dask_sql_tpu.types import parse_type_name
from dask_sql_tpu_torch import Context, convert
from dask_sql_tpu_torch.plan import nodes as PN
from dask_sql_tpu_torch.runtime import statistics as port_stats

SF = 0.003
CPU = torch.device("cpu")
FIELDS = ("name", "ndv", "min", "max", "null_frac", "is_int", "dense",
          "domain")


@pytest.fixture(autouse=True)
def _adaptive_default(monkeypatch):
    monkeypatch.setenv("DSQL_COMPILE", "0")
    monkeypatch.delenv("DSQL_ADAPTIVE", raising=False)
    monkeypatch.delenv("DSQL_FORCE_GROUPBY", raising=False)


@pytest.fixture(scope="module")
def contexts():
    data = generate_tpch(SF)
    jc, pc = JaxContext(), Context(device=CPU)
    for name, df in data.items():
        jc.create_table(name, df)
        pc.create_table(name, df)
    return jc, pc


def _assert_stats_equal(got, want, where: str):
    assert got is not None and want is not None, where
    assert got.rows == want.rows, where
    assert list(got.cols) == list(want.cols), where
    for name, w in want.cols.items():
        g = got.cols[name]
        for f in FIELDS:
            assert getattr(g, f) == getattr(w, f), f"{where}.{name}.{f}"
            assert type(getattr(g, f)) is type(getattr(w, f)), \
                f"{where}.{name}.{f} type"


def test_tpch_ingest_stats_match_jax(contexts):
    jc, pc = contexts
    for name, jentry in jc.schema["root"].tables.items():
        _assert_stats_equal(pc.schema["root"].tables[name].stats,
                            jentry.stats, name)


def _edge_columns(rng):
    n = 70_000          # above the 65,536-row sample
    f = rng.randn(n) * 1e3
    f[rng.rand(n) < 0.05] = np.nan
    f[:3] = [np.inf, -np.inf, np.nan]
    small = rng.randn(500)
    small[[0, 7]] = [np.nan, np.nan]
    few_wide = rng.randint(-2**40, 2**40, 100, dtype=np.int64)
    word = rng.randint(0, 5, n).astype(np.int32)
    return [
        ("i_all_null", "BIGINT", rng.randint(0, 9, n), np.zeros(n, bool), None),
        ("f_sampled", "DOUBLE", f, None, None),
        ("f_small_nan", "DOUBLE", np.resize(small, n), None, None),
        ("f_inf", "DOUBLE", np.where(np.arange(n) % 2, np.inf, 1.5), None, None),
        ("b", "BOOLEAN", rng.rand(n) < 0.3, rng.rand(n) < 0.9, None),
        ("b_one", "BOOLEAN", np.ones(n, bool), None, None),
        ("i_wide", "BIGINT", rng.randint(-2**40, 2**40, n, dtype=np.int64),
         rng.rand(n) < 0.95, None),
        ("i_wide_few", "BIGINT", rng.choice(few_wide, n), None, None),
        ("i_neg", "INTEGER", rng.randint(-3000, -1000, n).astype(np.int32),
         None, None),
        ("d", "DATE", rng.randint(8000, 10500, n).astype(np.int32), None, None),
        ("s", "VARCHAR", word, rng.rand(n) < 0.8,
         np.array(["x", "y", "z", "w", "v"], dtype=object)),
    ]


def _jax_table(specs):
    cols = [JaxColumn(jnp.asarray(data), parse_type_name(t),
                      None if mask is None else jnp.asarray(mask), dictionary)
            for _, t, data, mask, dictionary in specs]
    return JaxTable([s[0] for s in specs], cols)


@pytest.mark.parametrize("case", ["columns", "empty"])
def test_edge_case_stats_match_jax(case):
    rng = np.random.RandomState(11)
    specs = _edge_columns(rng)
    if case == "empty":
        specs = [(n, t, d[:0], None if m is None else m[:0], dic)
                 for n, t, d, m, dic in specs]
    want = jax_stats.collect_table_stats(_jax_table(specs))
    got = port_stats.collect_table_stats(convert.table_from_columns(specs, CPU))
    _assert_stats_equal(got, want, case)
    if case == "columns":
        # the cases reach the branches they are meant to
        assert got.cols["i_all_null"].ndv == 0
        assert got.cols["f_sampled"].min is None
        assert got.cols["i_wide"].domain > 2 ** 20
        assert got.cols["i_wide_few"].ndv == 100      # the sample's own count
        assert got.cols["d"].dense and got.cols["i_neg"].dense
        assert got.cols["s"].ndv == 5


def _plan_pairs(jc, pc, qid):
    from dask_sql_tpu.sql.parser import parse_sql as jax_parse
    from dask_sql_tpu_torch.sql.parser import parse_sql as port_parse

    q = QUERIES[qid]
    return (jc._get_plan(jax_parse(q)[0].query, q),
            pc._get_plan(port_parse(q)[0].query, q))


def _walk_together(jrel, prel):
    assert type(jrel).__name__ == type(prel).__name__
    yield jrel, prel
    assert len(jrel.inputs) == len(prel.inputs)
    for ji, pi in zip(jrel.inputs, prel.inputs):
        yield from _walk_together(ji, pi)


@pytest.mark.parametrize("qid", sorted(QUERIES))
def test_estimates_match_jax(contexts, qid):
    jc, pc = contexts
    jplan, pplan = _plan_pairs(jc, pc, qid)
    assert pplan.explain() == jplan.explain()
    for jrel, prel in _walk_together(jplan, pplan):
        assert port_stats.estimate_rows(prel, pc) \
            == jax_stats.estimate_rows(jrel, jc), type(prel).__name__
        if isinstance(prel, PN.LogicalFilter):
            assert isinstance(jrel, JN.LogicalFilter)
            assert port_stats.selectivity(prel.condition, prel.input, pc) \
                == jax_stats.selectivity(jrel.condition, jrel.input, jc)
        if isinstance(prel, PN.LogicalAggregate) and prel.group_keys:
            assert port_stats.groupby_decision(prel, pc) \
                == jax_stats.groupby_decision(jrel, jc)


def _explain(ctx, q):
    return ctx.sql("EXPLAIN " + q).to_pandas()["PLAN"].tolist()


@pytest.mark.parametrize("qid", sorted(QUERIES))
def test_explain_matches_jax(contexts, qid):
    jc, pc = contexts
    got = _explain(pc, QUERIES[qid])
    assert got == _explain(jc, QUERIES[qid])
    # Q6 is the one query with neither a GROUP BY nor a join
    assert any(line.startswith("-- operator:") for line in got) == (qid != 6)
