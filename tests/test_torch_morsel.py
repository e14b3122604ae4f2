"""The port's grace-hash join (``dask_sql_tpu_torch/physical/morsel.py``)
against the JAX package's (``dask_sql_tpu/physical/morsel.py``).

The cases of ``tests/integration/test_morsel.py`` run on both packages
over the same two chunked tables, each held to a pandas oracle and the
two answers to each other; every spill run is freed after each query.
``partition_codes`` equals the JAX package's on the same host columns:
int and float keys, NULL keys, and strings from two dictionaries."""
import numpy as np
import pandas as pd
import pytest
import torch

from dask_sql_tpu import Context as JaxContext
from dask_sql_tpu.physical import morsel as jax_morsel
from dask_sql_tpu.physical.streaming import \
    StreamingUnsupported as JaxUnsupported
from dask_sql_tpu.runtime import spill as jax_spill
from dask_sql_tpu.runtime import telemetry as jax_tel
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.physical import morsel
from dask_sql_tpu_torch.physical.streaming import StreamingUnsupported
from dask_sql_tpu_torch.runtime import spill as spill_mod
from dask_sql_tpu_torch.runtime import telemetry as tel

CPU = torch.device("cpu")
N_FACT = 20_000
N_DIM = 6_000
BATCH = 2_048  # 20000 % 2048 != 0: the short last batch is always there


def _norm(df: pd.DataFrame) -> pd.DataFrame:
    out = df.copy()
    for col in out.columns:
        if out[col].dtype.kind in "iuf":
            out[col] = out[col].astype("float64").round(6)
    return (out.sort_values(list(out.columns), na_position="last")
               .reset_index(drop=True))


def _assert_frames(got, want):
    pd.testing.assert_frame_equal(_norm(got), _norm(want),
                                  check_dtype=False, rtol=1e-6, atol=1e-9)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    key = rng.integers(0, N_DIM, N_FACT).astype("float64")
    key[rng.random(N_FACT) < 0.03] = np.nan  # NULL join keys on the fact
    fact = pd.DataFrame({
        "fk": key,
        "val": np.round(rng.random(N_FACT) * 100, 3),
        "tag": rng.choice(["r", "g", "b"], N_FACT),
    })
    dim = pd.DataFrame({
        "dk": np.arange(N_DIM),  # int64 vs the fact's float64 keys
        "grp": rng.choice(["north", "south", "east", "west"], N_DIM),
        "w": np.round(rng.random(N_DIM) * 10, 3),
    })
    return fact, dim


def _reset_stores():
    spill_mod.reset_store()
    jax_spill.reset_store()


def _store_empty():
    for store in (spill_mod.get_store(), jax_spill.get_store()):
        stats = store.stats()
        assert stats["runs"] == 0
        assert stats["host_bytes"] == 0 and stats["disk_bytes"] == 0


@pytest.fixture
def ooc(monkeypatch, tmp_path):
    monkeypatch.setenv("DSQL_SPILL_MB", "64")
    monkeypatch.setenv("DSQL_SPILL_DIR", str(tmp_path))
    _reset_stores()
    fact, dim = _data()
    ctx = Context(device=CPU)
    jctx = JaxContext()
    for c in (ctx, jctx):
        c.create_table("fact", fact, chunked=True, batch_rows=BATCH)
        c.create_table("dim", dim, chunked=True, batch_rows=BATCH)
    yield ctx, jctx, fact, dim
    _reset_stores()


def _both(ctx, jctx, q):
    c0, j0 = tel.REGISTRY.counters(), jax_tel.REGISTRY.counters()
    got = ctx.sql(q, return_futures=False)
    c1 = tel.REGISTRY.counters()
    jgot = jctx.sql(q, return_futures=False)
    j1 = jax_tel.REGISTRY.counters()
    _assert_frames(got, jgot)
    _store_empty()
    delta = {k: c1.get(k, 0) - c0.get(k, 0) for k in c1}
    jdelta = {k: j1.get(k, 0) - j0.get(k, 0) for k in j1}
    return got, delta, jdelta


def test_two_chunked_join_group_by(ooc):
    ctx, jctx, fact, dim = ooc
    got, d, jd = _both(
        ctx, jctx,
        "SELECT dim.grp AS grp, SUM(fact.val * dim.w) AS s, COUNT(*) AS n "
        "FROM fact JOIN dim ON fact.fk = dim.dk GROUP BY dim.grp")
    j = fact.merge(dim, left_on="fk", right_on="dk")  # NaN keys dropped
    want = (j.assign(x=j.val * j.w)
             .groupby("grp", as_index=False)
             .agg(s=("x", "sum"), n=("x", "size")))
    _assert_frames(got, want)
    assert d["morsel_joins"] == jd["morsel_joins"] == 1
    assert d["morsel_pairs"] == jd["morsel_pairs"] > 0
    assert d["spill_partitions"] == jd["spill_partitions"] > 0
    assert d["stream_batches"] == jd["stream_batches"]


def test_join_without_group_by(ooc):
    ctx, jctx, fact, dim = ooc
    got, _, _ = _both(
        ctx, jctx,
        "SELECT fact.tag AS tag, dim.grp AS grp, fact.val AS val "
        "FROM fact JOIN dim ON fact.fk = dim.dk WHERE dim.w > 9.0")
    j = fact.merge(dim, left_on="fk", right_on="dk")
    _assert_frames(got, j[j.w > 9.0][["tag", "grp", "val"]])


def test_table_sized_output_reenters_streaming(ooc, monkeypatch):
    """An output above the partial budget re-registers as a spill-backed
    chunked source, and the GROUP BY above streams it."""
    from dask_sql_tpu.physical import streaming as jax_stream
    from dask_sql_tpu_torch.physical import streaming as sm

    ctx, jctx, fact, dim = ooc
    monkeypatch.setattr(sm, "PARTIAL_BYTES_BUDGET", 4096)
    monkeypatch.setattr(jax_stream, "PARTIAL_BYTES_BUDGET", 4096)
    got, d, jd = _both(
        ctx, jctx,
        "SELECT fact.tag AS tag, SUM(dim.w) AS s, COUNT(*) AS n "
        "FROM fact JOIN dim ON fact.fk = dim.dk GROUP BY fact.tag")
    j = fact.merge(dim, left_on="fk", right_on="dk")
    _assert_frames(got, j.groupby("tag", as_index=False).agg(
        s=("w", "sum"), n=("w", "size")))
    assert d["stream_batches"] == jd["stream_batches"]


def test_string_equi_key(monkeypatch, tmp_path):
    # string join keys hash by VALUE: the two tables' dictionaries differ
    monkeypatch.setenv("DSQL_SPILL_MB", "64")
    monkeypatch.setenv("DSQL_SPILL_DIR", str(tmp_path))
    _reset_stores()
    rng = np.random.default_rng(3)
    left = pd.DataFrame({"s": rng.choice(["aa", "bb", "cc", "dd"], 5000),
                         "v": rng.random(5000)})
    right = pd.DataFrame({"s": rng.choice(["bb", "cc", "dd", "ee", "ff"],
                                          3000),
                          "u": rng.random(3000)})
    ctx, jctx = Context(device=CPU), JaxContext()
    for c in (ctx, jctx):
        c.create_table("l", left, chunked=True, batch_rows=700)
        c.create_table("r", right, chunked=True, batch_rows=700)
    got, d, _ = _both(ctx, jctx,
                      "SELECT l.s AS s, SUM(l.v + r.u) AS t FROM l "
                      "JOIN r ON l.s = r.s GROUP BY l.s")
    j = left.merge(right, on="s")
    _assert_frames(got, j.assign(t=j.v + j.u).groupby(
        "s", as_index=False).agg(t=("t", "sum")))
    assert d["morsel_joins"] == 1
    _reset_stores()


def test_aggregate_side_defers_to_iterative(ooc):
    # TPC-H Q17's shape: a join side with an AGGREGATE over a chunked scan
    # is not row-local, so the grace path declines
    ctx, jctx, fact, dim = ooc
    got, d, jd = _both(
        ctx, jctx,
        "SELECT SUM(fact.val) AS s FROM fact JOIN "
        "(SELECT tag AS t, AVG(val) AS a FROM fact GROUP BY tag) AS sub "
        "ON fact.tag = sub.t WHERE fact.val < sub.a")
    avg = fact.groupby("tag")["val"].transform("mean")
    _assert_frames(got, pd.DataFrame({"s": [fact.val[fact.val < avg].sum()]}))
    assert d.get("morsel_joins", 0) == jd.get("morsel_joins", 0) == 0


def test_spilled_marker_on_query_report(ooc):
    ctx, jctx, _, _ = ooc
    ctx.sql("SELECT COUNT(*) AS n FROM fact JOIN dim ON fact.fk = dim.dk")
    report = ctx.last_report
    assert report is not None and report.spilled
    assert report.to_dict()["spilled"] is True
    _store_empty()
    # a plain chunked scan does not carry the marker
    ctx.sql("SELECT SUM(val) AS s FROM fact")
    assert not ctx.last_report.spilled


def test_spill_disabled_restores_unsupported(monkeypatch, tmp_path):
    monkeypatch.setenv("DSQL_SPILL_MB", "0")
    monkeypatch.setenv("DSQL_SPILL_DIR", str(tmp_path))
    _reset_stores()
    fact, dim = _data()
    ctx, jctx = Context(device=CPU), JaxContext()
    for c in (ctx, jctx):
        c.create_table("fact", fact, chunked=True, batch_rows=BATCH)
        c.create_table("dim", dim, chunked=True, batch_rows=BATCH)
    q = "SELECT COUNT(*) AS n FROM fact JOIN dim ON fact.fk = dim.dk"
    c0 = tel.REGISTRY.counters()
    with pytest.raises(JaxUnsupported) as want:
        jctx.sql(q)
    with pytest.raises(StreamingUnsupported) as got:
        ctx.sql(q)
    assert str(got.value) == str(want.value)
    # single-chunked streaming is untouched by the kill switch
    got = ctx.sql("SELECT tag, SUM(val) AS s FROM fact GROUP BY tag",
                  return_futures=False)
    _assert_frames(got, fact.groupby("tag", as_index=False).agg(
        s=("val", "sum")))
    c1 = tel.REGISTRY.counters()
    assert c1.get("spill_partitions", 0) == c0.get("spill_partitions", 0)
    _reset_stores()


def test_tiny_host_budget_disk_round_trip(monkeypatch, tmp_path):
    # a 1 MB host budget and ~2.5 MB of partitions: runs round-trip through
    # the disk tier mid-join
    monkeypatch.setenv("DSQL_SPILL_MB", "1")
    monkeypatch.setenv("DSQL_SPILL_DIR", str(tmp_path))
    _reset_stores()
    rng = np.random.default_rng(9)
    n = 50_000
    fact = pd.DataFrame({"fk": rng.integers(0, N_DIM, n),
                         "val": rng.random(n), "e1": rng.random(n),
                         "e2": rng.random(n), "e3": rng.random(n)})
    _, dim = _data(seed=9)
    ctx, jctx = Context(device=CPU), JaxContext()
    for c in (ctx, jctx):
        c.create_table("fact", fact, chunked=True, batch_rows=8192)
        c.create_table("dim", dim, chunked=True, batch_rows=BATCH)
    got, d, _ = _both(
        ctx, jctx,
        "SELECT dim.grp AS grp, SUM(fact.val) AS s, SUM(fact.e1) AS s1 "
        "FROM fact JOIN dim ON fact.fk = dim.dk GROUP BY dim.grp")
    j = fact.merge(dim, left_on="fk", right_on="dk")
    _assert_frames(got, j.groupby("grp", as_index=False).agg(
        s=("val", "sum"), s1=("e1", "sum")))
    assert d["spill_flushes"] > 0
    _reset_stores()


def test_runs_freed_on_failure(ooc):
    """A query that fails mid-join still frees every run it opened."""
    from dask_sql_tpu_torch.runtime import faults

    ctx, _, _, _ = ooc
    with faults.inject("host_transfer:1+:fatal"):
        with pytest.raises(Exception):
            ctx.sql("SELECT COUNT(*) AS n FROM fact "
                    "JOIN dim ON fact.fk = dim.dk")
    assert spill_mod.get_store().stats()["runs"] == 0


def _host_cols(rng, n, kind, dictionary=None):
    from dask_sql_tpu_torch.types import BIGINT, DOUBLE, VARCHAR

    mask = rng.random(n) > 0.1
    if kind == "int":
        return (rng.integers(-1000, 1000, n), mask, BIGINT, None)
    if kind == "float":
        data = rng.integers(-1000, 1000, n).astype(np.float64)
        data[:5] = [-0.0, 0.5, np.nan, 1e300, 7.0]
        return (data, None, DOUBLE, None)
    return (rng.integers(0, len(dictionary), n).astype(np.int32), mask,
            VARCHAR, dictionary)


@pytest.mark.parametrize("kinds", [("int",), ("float",), ("str",),
                                   ("int", "str"), ("float", "int")])
@pytest.mark.parametrize("n_parts", [1, 7, 64])
def test_partition_codes_equal_jax(kinds, n_parts):
    rng = np.random.default_rng(len(kinds) * 100 + n_parts)
    d1 = np.array(["apple", "fig", "kiwi", "pear"], dtype=object)
    d2 = np.array(["fig", "kiwi", "lime"], dtype=object)
    for d in (d1, d2):  # strings from two dictionaries
        cols = [_host_cols(rng, 4000, k, d) for k in kinds]
        cols.append((rng.random(4000), None,
                     cols[0][2], None))
        keys = list(range(len(kinds)))
        got = morsel.partition_codes(cols, keys, n_parts)
        want = jax_morsel.partition_codes(cols, keys, n_parts)
        np.testing.assert_array_equal(got, want)
        assert got.min() >= -1 and got.max() < n_parts
    # equal VALUES route alike whatever their dictionary or dtype
    a = [(np.array([1, 2], dtype=np.int32), None, cols[0][2], d1)]
    b = [(np.array([0, 1], dtype=np.int32), None, cols[0][2], d2)]
    np.testing.assert_array_equal(morsel.partition_codes(a, [0], 64),
                                  morsel.partition_codes(b, [0], 64))
    i = [(np.array([5, -3], dtype=np.int64), None, cols[0][2], None)]
    f = [(np.array([5.0, -3.0]), None, cols[0][2], None)]
    np.testing.assert_array_equal(morsel.partition_codes(i, [0], 64),
                                  morsel.partition_codes(f, [0], 64))


def test_equi_key_pairs_and_canonical_keys_equal_jax(ooc):
    ctx, jctx, _, _ = ooc
    q = ("SELECT COUNT(*) AS n FROM fact JOIN dim "
         "ON fact.fk = dim.dk AND fact.val > dim.w")
    from dask_sql_tpu.sql.parser import parse_sql as jparse
    from dask_sql_tpu_torch.sql.parser import parse_sql

    def join_of(plan):
        while type(plan).__name__ != "LogicalJoin":
            plan = plan.inputs[0]
        return plan

    pj = join_of(ctx._get_plan(parse_sql(q)[0].query, q))
    jj = join_of(jctx._get_plan(jparse(q)[0].query, q))
    assert morsel.equi_key_pairs(pj) == jax_morsel.equi_key_pairs(jj)
    assert morsel.grace_applicable(pj, ctx) == \
        jax_morsel.grace_applicable(jj, jctx) is True
    data = np.array([0.0, -0.0, 2.5, np.nan, 1e19, -7.0, 3.0])
    np.testing.assert_array_equal(morsel._canonical_int_keys(data),
                                  jax_morsel._canonical_int_keys(data))
