"""The port's streaming executor (``dask_sql_tpu_torch/physical/streaming.py``)
against the JAX package's (``dask_sql_tpu/physical/streaming.py``).

``lineitem`` of TPC-H at SF 0.01 registers chunked (``batch_rows=16384``,
four batches, the last one short) in both packages: every query's chunked
answer equals the JAX package's chunked answer and the port's resident
one (doubles rtol 1e-5, atol 1e-6, as the JAX package's own test), with
the same number of streamed batches.  Then the distinct aggregate, NULL
group keys, the refusals with the JAX package's messages, the host merge
(the JAX package's pandas merge against the port's numpy one), windows,
the scalar subquery, EXPLAIN ANALYZE, the result cache and the
scheduler's ``chunked`` rung, the eager per-batch path and threads."""
import logging
import threading

import numpy as np
import pandas as pd
import pytest
import torch

from benchmarks.tpch import QUERIES, generate_tpch
from dask_sql_tpu import Context as JaxContext
from dask_sql_tpu.physical import streaming as jax_stream
from dask_sql_tpu.runtime import telemetry as jax_tel
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.physical import compiled
from dask_sql_tpu_torch.physical import streaming as sm
from dask_sql_tpu_torch.physical.streaming import StreamingUnsupported
from dask_sql_tpu_torch.runtime import telemetry as tel

CPU = torch.device("cpu")
BATCH = 16384


@pytest.fixture(scope="module")
def tpch():
    """(port resident, port chunked, JAX chunked, data)."""
    data = generate_tpch(0.01, seed=5)
    plain = Context(device=CPU)
    ck = Context(device=CPU)
    jck = JaxContext()
    for name, frame in data.items():
        plain.create_table(name, frame)
        if name == "lineitem":
            ck.create_table(name, frame, chunked=True, batch_rows=BATCH)
            jck.create_table(name, frame, chunked=True, batch_rows=BATCH)
        else:
            ck.create_table(name, frame)
            jck.create_table(name, frame)
    return plain, ck, jck, data


def _norm(df: pd.DataFrame) -> pd.DataFrame:
    df = df.reset_index(drop=True)
    for col in df.columns:
        if pd.api.types.is_float_dtype(df[col]):
            df[col] = df[col].astype(np.float64).round(6)
    return df.sort_values(list(df.columns), ignore_index=True)


def _assert_frames(a: pd.DataFrame, b: pd.DataFrame) -> None:
    pd.testing.assert_frame_equal(_norm(a), _norm(b), check_dtype=False,
                                  rtol=1e-5, atol=1e-6)


def _port_run(ctx, sql):
    c0 = tel.REGISTRY.counters()
    out = ctx.sql(sql, return_futures=False)
    c1 = tel.REGISTRY.counters()
    return out, {k: c1.get(k, 0) - c0.get(k, 0) for k in c1}


def _jax_run(ctx, sql):
    c0 = jax_tel.REGISTRY.counters()
    out = ctx.sql(sql, return_futures=False)
    c1 = jax_tel.REGISTRY.counters()
    return out, {k: c1.get(k, 0) - c0.get(k, 0) for k in c1}


@pytest.mark.parametrize("qid", sorted(QUERIES))
def test_tpch_chunked_equals_jax_and_resident(tpch, qid):
    plain, ck, jck, _ = tpch
    got, counts = _port_run(ck, QUERIES[qid])
    jax_got, jax_counts = _jax_run(jck, QUERIES[qid])
    _assert_frames(got, jax_got)
    _assert_frames(got, plain.sql(QUERIES[qid], return_futures=False))
    assert counts.get("stream_batches", 0) == \
        jax_counts.get("stream_batches", 0)
    # queries that never scan lineitem stream nothing
    if "lineitem" not in QUERIES[qid]:
        assert counts.get("stream_batches", 0) == 0


def test_batches_share_programs(tpch):
    """Q6: the batches run one program for the full batches and one for the
    padded last batch; a repeated query builds nothing."""
    _, ck, _, data = tpch
    n_batches = (len(data["lineitem"]) + BATCH - 1) // BATCH
    assert n_batches >= 3
    ck.sql(QUERIES[6])
    before = dict(compiled.stats)
    ck.sql(QUERIES[6], return_futures=False)
    d = {k: compiled.stats[k] - before[k] for k in before}
    assert d["compiles"] <= 2, d
    assert d["hits"] >= n_batches - 1, d
    # the merge plan over the partials is keyed by its per-query temp name
    assert d["compiles"] == 0 and d["hits"] == n_batches + 1, d


def test_eager_per_batch_path_compacts_row_valid(tpch, monkeypatch):
    """With the compiled tier off, every batch runs on the eager executor,
    whose scan drops the padded last batch's invalid rows."""
    plain, ck, _, _ = tpch
    monkeypatch.setenv("DSQL_COMPILE", "0")
    for qid in (1, 6):
        _assert_frames(ck.sql(QUERIES[qid], return_futures=False),
                       plain.sql(QUERIES[qid], return_futures=False))


def test_streaming_distinct_aggregate(tpch):
    plain, ck, jck, _ = tpch
    for q in ("SELECT l_returnflag, COUNT(DISTINCT l_suppkey) AS n "
              "FROM lineitem GROUP BY l_returnflag",
              "SELECT COUNT(DISTINCT l_suppkey) AS n FROM lineitem"):
        got = ck.sql(q, return_futures=False)
        _assert_frames(got, jck.sql(q, return_futures=False))
        _assert_frames(got, plain.sql(q, return_futures=False))


@pytest.mark.parametrize("q", [
    "SELECT COUNT(DISTINCT l_suppkey) AS n, SUM(l_quantity) AS s "
    "FROM lineitem",
    "SELECT l_orderkey FROM lineitem WHERE l_quantity > 1",
    "SELECT l_orderkey, SUM(l_quantity) OVER (ORDER BY l_orderkey) AS c "
    "FROM lineitem",
])
def test_unsupported_shapes_raise_the_jax_message(tpch, q):
    _, ck, jck, _ = tpch
    with pytest.raises(jax_stream.StreamingUnsupported) as want:
        jck.sql(q)
    with pytest.raises(StreamingUnsupported) as got:
        ck.sql(q)
    assert str(got.value) == str(want.value)


def test_streaming_null_group_keys():
    df = pd.DataFrame({"g": ["a", None, "a", None, "b"] * 200,
                       "v": np.arange(1000, dtype=np.float64)})
    plain = Context(device=CPU)
    plain.create_table("t", df)
    ck = Context(device=CPU)
    ck.create_table("t", df, chunked=True, batch_rows=128)
    jck = JaxContext()
    jck.create_table("t", df, chunked=True, batch_rows=128)
    q = "SELECT g, SUM(v) AS s, COUNT(*) AS n FROM t GROUP BY g"
    got = ck.sql(q, return_futures=False)
    _assert_frames(got, plain.sql(q, return_futures=False))
    _assert_frames(got, jck.sql(q, return_futures=False))


def test_host_merge_equals_jax_pandas_merge(tpch, monkeypatch):
    """A GROUP BY whose partials pass the budget merges on the host: the
    port's numpy merge against the JAX package's pandas merge."""
    plain, ck, jck, _ = tpch
    monkeypatch.setattr(sm, "PARTIAL_BYTES_BUDGET", 1024)
    monkeypatch.setattr(jax_stream, "PARTIAL_BYTES_BUDGET", 1024)
    q = ("SELECT l_orderkey, SUM(l_quantity) AS s, COUNT(*) AS n, "
         "MIN(l_discount) AS mi, MAX(l_shipmode) AS mx, "
         "AVG(l_tax) AS a FROM lineitem GROUP BY l_orderkey")
    got = ck.sql(q, return_futures=False)
    _assert_frames(got, jck.sql(q, return_futures=False))
    _assert_frames(got, plain.sql(q, return_futures=False))


def _merge_cols():
    """Host partials with NULL keys (int and string), an all-NULL SUM group
    and int64 sums past 2**53."""
    from dask_sql_tpu_torch.types import BIGINT, DOUBLE, VARCHAR

    big = (1 << 53) + 1
    k = np.array([1, 2, 1, 0, 2, 0, 3], dtype=np.int64)
    km = np.array([1, 1, 1, 0, 1, 0, 1], dtype=bool)
    s = np.array([0, 1, 0, 2, 1, 2, 0], dtype=np.int32)
    d = np.array(["x", "y", "z"], dtype=object)
    isum = np.array([big, 7, big, 5, -3, 1, 0], dtype=np.int64)
    fsum = np.array([1.5, 0.0, 2.5, 0.0, 0.0, 4.0, 3.0])
    fmask = np.array([1, 0, 1, 1, 0, 1, 1], dtype=bool)
    mx = np.array([0, 2, 1, 0, 1, 2, 0], dtype=np.int32)
    cols = [(k, km, BIGINT, None), (s, None, VARCHAR, d),
            (isum, None, BIGINT, None), (fsum, fmask, DOUBLE, None),
            (isum.copy(), None, BIGINT, None), (fsum, fmask, DOUBLE, None),
            (mx, None, VARCHAR, d), (isum.copy(), None, BIGINT, None)]
    ops = ["SUM", "SUM", "$SUM0", "$SUM0", "MAX", "MIN"]
    return cols, ops


def _rows(table):
    out = []
    for row in table.to_pylist() if hasattr(table, "to_pylist") else table:
        out.append(tuple(None if (isinstance(v, float) and np.isnan(v))
                         else v for v in row))
    return sorted(out, key=repr)


def test_merge_aggregate_on_host_unit():
    from dask_sql_tpu.plan.nodes import AggCall as JaxAggCall, Field as JF
    from dask_sql_tpu.types import BIGINT as JB, DOUBLE as JD, VARCHAR as JV
    from dask_sql_tpu_torch.plan.nodes import AggCall, Field
    from dask_sql_tpu_torch.types import BIGINT, VARCHAR

    cols, ops = _merge_cols()
    types = [c[2] for c in cols[2:]]
    merge = [AggCall(op, [2 + j], False, t, f"a{j}")
             for j, (op, t) in enumerate(zip(ops, types))]
    ctx = Context(device=CPU)
    scan = sm._merge_aggregate_on_host(
        ["c"] * len(cols), cols, 2, merge,
        [Field("k", BIGINT), Field("s", VARCHAR)], ctx)
    got = ctx.schema[sm.STREAM_SCHEMA].tables[scan.table_name].table
    rows = {tuple(r[:2]): r[2:] for r in got.to_pylist()}
    big = (1 << 53) + 1
    assert rows[(1, "x")] == [2 * big, 4.0, 2 * big, 4.0, "y", big]
    assert rows[(None, "z")][0] == 6 and rows[(None, "z")][1] == 4.0
    assert rows[(2, "y")][1] is None          # SUM over only NULLs
    assert rows[(2, "y")][3] == 0.0           # $SUM0 over only NULLs
    assert [c.stype.name for c in got.columns] == \
        ["BIGINT", "VARCHAR", "BIGINT", "DOUBLE", "BIGINT", "DOUBLE",
         "VARCHAR", "BIGINT"]

    # the JAX package's pandas merge on the same partials
    jtypes = {"BIGINT": JB, "DOUBLE": JD, "VARCHAR": JV}
    jcols = [(d, m, jtypes[t.name], di) for d, m, t, di in cols]
    jmerge = [JaxAggCall(op, [2 + j], False, jtypes[t.name], f"a{j}")
              for j, (op, t) in enumerate(zip(ops, types))]
    jctx = JaxContext()
    jscan = jax_stream._merge_aggregate_on_host(
        ["c"] * len(cols), jcols, 2, jmerge,
        [JF("k", JB), JF("s", JV)], jctx)
    jgot = jctx.schema[jax_stream.STREAM_SCHEMA].tables[
        jscan.table_name].table
    jrows = [tuple(v for v in r) for r in zip(
        *[c.to_numpy().tolist() for c in jgot.columns])]
    assert _rows(got) == _rows(jrows)


WINDOW_QUERIES = {
    "row_number": (
        "SELECT k, v, ROW_NUMBER() OVER (PARTITION BY k ORDER BY v, w) AS rn "
        "FROM t ORDER BY k, rn LIMIT 200"),
    "sum_over": (
        "SELECT k, SUM(v) OVER (PARTITION BY k ORDER BY v, w) AS c "
        "FROM t ORDER BY k, c LIMIT 200"),
    "rows_frame": (
        "SELECT k, SUM(w) OVER (PARTITION BY k ORDER BY v, w "
        "ROWS BETWEEN 2 PRECEDING AND CURRENT ROW) AS f "
        "FROM t ORDER BY k, f LIMIT 200"),
    "null_partition_keys": (
        "SELECT s, COUNT(*) OVER (PARTITION BY s) AS n, "
        "ROW_NUMBER() OVER (PARTITION BY s ORDER BY v, w) AS rn "
        "FROM t ORDER BY s, rn LIMIT 200"),
    "agg_above_window": (
        "SELECT k, MAX(rn) AS m, SUM(rs) AS t FROM (SELECT k, "
        "ROW_NUMBER() OVER (PARTITION BY k ORDER BY v, w) AS rn, "
        "SUM(v) OVER (PARTITION BY k) AS rs FROM t) x GROUP BY k "
        "ORDER BY k"),
}


@pytest.fixture(scope="module")
def window_trio():
    rng = np.random.RandomState(7)
    n = 3000
    df = pd.DataFrame({
        "k": rng.randint(0, 11, n),
        "s": rng.choice(["a", "b", "c", None], n),
        "v": np.round(rng.randn(n), 4),
        "w": rng.randint(-50, 50, n).astype(np.float64),
    })
    plain = Context(device=CPU)
    plain.create_table("t", df)
    ck = Context(device=CPU)
    ck.create_table("t", df, chunked=True, batch_rows=256)
    jck = JaxContext()
    jck.create_table("t", df, chunked=True, batch_rows=256)
    return plain, ck, jck


@pytest.mark.parametrize("name", sorted(WINDOW_QUERIES))
def test_window_chunked_equals_jax_and_resident(window_trio, name):
    plain, ck, jck = window_trio
    q = WINDOW_QUERIES[name]
    got = ck.sql(q, return_futures=False)
    _assert_frames(got, plain.sql(q, return_futures=False))
    _assert_frames(got, jck.sql(q, return_futures=False))


def test_window_output_reregisters_as_chunked(window_trio, monkeypatch):
    plain, ck, _ = window_trio
    monkeypatch.setattr(sm, "PARTIAL_BYTES_BUDGET", 1024)
    q = WINDOW_QUERIES["agg_above_window"]
    got, counts = _port_run(ck, q)
    _assert_frames(got, plain.sql(q, return_futures=False))
    # the input's 12 batches, the buckets, then the re-registered output
    assert counts["stream_batches"] > 2 * 12


def test_window_partition_skew_warns(caplog):
    n = 600
    df = pd.DataFrame({"k": np.zeros(n, dtype=np.int64),
                       "v": np.arange(n, dtype=np.float64)})
    plain = Context(device=CPU)
    plain.create_table("t", df)
    ck = Context(device=CPU)
    ck.create_table("t", df, chunked=True, batch_rows=100)
    q = ("SELECT k, SUM(v) OVER (PARTITION BY k ORDER BY v) AS c "
         "FROM t ORDER BY c LIMIT 50")
    with caplog.at_level(logging.WARNING,
                         logger="dask_sql_tpu_torch.physical.streaming"):
        got = ck.sql(q, return_futures=False)
    _assert_frames(got, plain.sql(q, return_futures=False))
    assert any("partition skew" in r.message for r in caplog.records)


def test_chunked_inside_scalar_subquery(tpch):
    plain, ck, jck, _ = tpch
    q = ("SELECT s_suppkey FROM supplier WHERE s_suppkey > "
         "(SELECT AVG(l_suppkey) FROM lineitem)")
    got = ck.sql(q, return_futures=False)
    _assert_frames(got, plain.sql(q, return_futures=False))
    _assert_frames(got, jck.sql(q, return_futures=False))


def test_explain_analyze_streams_and_cache_refuses(tpch, monkeypatch):
    """EXPLAIN ANALYZE runs a chunked plan through the streaming executor;
    the result cache neither keys nor stores a chunked plan."""
    _, ck, _, _ = tpch
    monkeypatch.setenv("DSQL_RESULT_CACHE_MB", "64")
    q = ("SELECT l_returnflag, SUM(l_quantity) AS s FROM lineitem "
         "GROUP BY l_returnflag")
    text = "\n".join(r[0] for r in
                     ck.sql("EXPLAIN ANALYZE " + q).to_pylist())
    assert "-- cache: uncacheable (volatile or chunked plan)" in text
    assert "stream_batches" in text
    want = ck.sql(q)
    c0 = tel.REGISTRY.counters()
    again = ck.sql(q)
    c1 = tel.REGISTRY.counters()
    for k in ("result_cache_stores", "result_cache_hits"):
        assert c1.get(k, 0) == c0.get(k, 0)
    assert c1["stream_batches"] - c0["stream_batches"] == 4
    assert sorted(again.to_pylist()) == sorted(want.to_pylist())


def test_scheduler_and_statistics_see_the_source(tpch):
    """The scheduler's ``chunked`` rung and the row estimate of a chunked
    scan, against the JAX package's."""
    from dask_sql_tpu.runtime import scheduler as jax_sched
    from dask_sql_tpu.runtime import statistics as jax_stats
    from dask_sql_tpu_torch.runtime import scheduler as sched
    from dask_sql_tpu_torch.runtime import statistics as stats

    _, ck, jck, data = tpch
    q = "SELECT SUM(l_quantity) AS s FROM lineitem WHERE l_tax > 0.02"
    plan = ck._get_plan(ck_query(q), q)
    jplan = jck._get_plan(ck_query(q, jax=True), q)
    got = sched.estimate_working_set(plan, ck)
    want = jax_sched.estimate_working_set(jplan, jck)
    assert got[1] == want[1] == "chunked"
    assert got[0] == want[0]
    scan = plan
    while scan.inputs:
        scan = scan.inputs[0]
    jscan = jplan
    while jscan.inputs:
        jscan = jscan.inputs[0]
    assert stats.estimate_rows(scan, ck) == len(data["lineitem"]) == \
        jax_stats.estimate_rows(jscan, jck)


def ck_query(q, jax=False):
    if jax:
        from dask_sql_tpu.sql.parser import parse_sql as jparse
        return jparse(q)[0].query
    from dask_sql_tpu_torch.sql.parser import parse_sql
    return parse_sql(q)[0].query


def test_chunked_read_fault_is_retried(tpch):
    from dask_sql_tpu_torch.runtime import faults

    plain, ck, _, _ = tpch
    with faults.inject("chunked_read:2"):
        got, counts = _port_run(ck, QUERIES[6])
    assert counts.get("fault_chunked_read", 0) == 1
    _assert_frames(got, plain.sql(QUERIES[6], return_futures=False))


def test_threads_share_one_context(tpch):
    """Server threads run streamed queries on one context: the process
    lock serializes them, every answer is right and no temp is left."""
    plain, ck, _, _ = tpch
    qids = (1, 6, 12, 14) * 2
    want = {q: plain.sql(QUERIES[q], return_futures=False) for q in qids}
    got, errors = {}, []

    def run(i, q):
        try:
            got[i] = ck.sql(QUERIES[q], return_futures=False)
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i, q))
               for i, q in enumerate(qids)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    for i, q in enumerate(qids):
        _assert_frames(got[i], want[q])
    assert sm.STREAM_SCHEMA not in ck.schema and not sm._exec_depth


def test_dictionary_fingerprints_are_not_recomputed_per_batch(tpch,
                                                              monkeypatch):
    """Every batch carries the source's own dictionary arrays, so the
    program key's content fingerprint of a dictionary is computed once
    (memoized by the array), not once per batch."""
    _, ck, _, _ = tpch

    class Counting(dict):
        inserted = 0

        def __setitem__(self, key, value):
            Counting.inserted += 1
            super().__setitem__(key, value)

    monkeypatch.setattr(compiled, "_dict_fp_memo",
                        Counting(compiled._dict_fp_memo))
    c0 = tel.REGISTRY.counters()
    ck.sql(QUERIES[1])
    first = Counting.inserted
    ck.sql(QUERIES[1])
    c1 = tel.REGISTRY.counters()
    assert c1["stream_batches"] - c0["stream_batches"] == 8
    # l_returnflag and l_linestatus, and the merged partials' copies
    assert first <= 4
    assert Counting.inserted == first
