"""Custom aggregations and row UDFs of the port against the JAX package's.

Both are host work in pandas in both packages: a UDAF is a groupby-apply
over the device's group codes (brought to the host first), a row UDF a
function called per pandas row with fields ``a0 .. an``.  The same
functions are registered in both packages over one seeded table and the
answers compared: group keys (strings, integers, NULL keys), FILTER (a
group that keeps no row is NULL), whole-table UDAFs, a string-valued
UDAF, a UDAF beside built-in aggregates, and row UDFs over columns and
literals.  Neither tier that compiles takes a UDAF: the compiled tier and
the streaming executor decline it as the JAX package's do.
"""
import numpy as np
import pandas as pd
import pytest
import torch

from dask_sql_tpu import Context as JaxContext
from dask_sql_tpu_torch import Context

CPU = torch.device("cpu")


def _span(s):
    return s.max() - s.min()


def _first_word(s):
    return " / ".join(sorted(set(str(v) for v in s)))


def _mean_or_none(s):
    return None if len(s) < 3 else float(s.mean())


@pytest.fixture(scope="module")
def frame():
    rng = np.random.RandomState(21)
    n = 60
    k = rng.choice(["a", "b", "c"], n).astype(object)
    k[rng.rand(n) < 0.15] = None
    return pd.DataFrame({
        "k": k,
        "g": rng.randint(0, 4, n),
        "x": rng.randint(-100, 100, n),
        "f": rng.randn(n) * 10,
        "w": rng.choice(["red", "green", "blue"], n).astype(object),
    })


@pytest.fixture
def contexts(frame):
    jc, pc = JaxContext(), Context(device=CPU)
    for ctx in (jc, pc):
        ctx.create_table("t", frame)
        ctx.register_aggregation(_span, "span", [("x", np.int64)], np.int64)
        ctx.register_aggregation(_span, "fspan", [("x", np.float64)],
                                 np.float64)
        ctx.register_aggregation(_first_word, "words", [("x", str)], str)
        ctx.register_aggregation(_mean_or_none, "mean3",
                                 [("x", np.float64)], np.float64)
        ctx.register_function(lambda row: row["a0"] * 2 + row["a1"], "rowf",
                              [("x", np.int64), ("y", np.float64)],
                              np.float64, row_udf=True)
        ctx.register_function(lambda row: f"{row['a0']}:{row['a1']}",
                              "rowtag", [("x", str), ("y", np.int64)], str,
                              row_udf=True)
    return jc, pc


def _sorted_rows(df):
    def key(row):
        return tuple((v is None or v != v, str(v)) for v in row)
    rows = [tuple(None if (v is None or (isinstance(v, float) and v != v))
                  else v for v in r) for r in df.itertuples(index=False)]
    return sorted(rows, key=key)


def _assert_same(contexts, sql):
    jc, pc = contexts
    got = pc.sql(sql, return_futures=False)
    want = jc.sql(sql, return_futures=False)
    assert list(got.columns) == list(want.columns), sql
    g, w = _sorted_rows(got), _sorted_rows(want)
    assert len(g) == len(w), sql
    for gr, wr in zip(g, w):
        for a, b in zip(gr, wr):
            if isinstance(b, float) and a is not None:
                assert a == pytest.approx(b, rel=1e-12), sql
            else:
                assert a == b, sql
    return got


@pytest.mark.parametrize("sql", [
    "SELECT k, span(x) AS s FROM t GROUP BY k",
    "SELECT g, k, span(x) AS s, fspan(f) AS fs FROM t GROUP BY g, k",
    "SELECT g, span(x) AS s, SUM(x) AS total, COUNT(*) AS n FROM t "
    "GROUP BY g",
    "SELECT k, span(x) FILTER (WHERE x > 50) AS s FROM t GROUP BY k",
    "SELECT g, mean3(f) AS m FROM t GROUP BY g",
    "SELECT k, mean3(f) FILTER (WHERE g = 1) AS m FROM t GROUP BY k",
    "SELECT g, words(w) AS ws FROM t GROUP BY g",
    "SELECT k, words(w) FILTER (WHERE x > 0) AS ws FROM t GROUP BY k",
    "SELECT span(x) AS s, fspan(f) AS fs, COUNT(*) AS n FROM t",
    "SELECT span(x) FILTER (WHERE x > 1000) AS s FROM t",
    "SELECT words(w) AS ws FROM t WHERE g = 2",
])
def test_udaf_matches_jax(contexts, sql):
    _assert_same(contexts, sql)


def test_udaf_group_with_no_row_is_null(contexts):
    got = _assert_same(contexts, "SELECT g, span(x) FILTER (WHERE x > 95) "
                                 "AS s FROM t GROUP BY g ORDER BY g")
    assert got["s"].isna().any()


@pytest.mark.parametrize("sql", [
    "SELECT g, rowf(x, f) AS r FROM t",
    "SELECT rowf(x, 0.5) AS r FROM t WHERE g > 1",
    "SELECT rowtag(w, g) AS r FROM t",
    "SELECT k, SUM(rowf(x, f)) AS r FROM t GROUP BY k",
])
def test_row_udf_matches_jax(contexts, sql):
    _assert_same(contexts, sql)


def test_udaf_is_declined_by_the_compiling_tiers(contexts, monkeypatch):
    """The compiled tier declines a UDAF (its verdict on the report) and
    the eager executor answers."""
    monkeypatch.setenv("DSQL_COMPILE", "1")
    _, pc = contexts
    _assert_same(contexts, "SELECT g, span(x) AS s FROM t GROUP BY g")
    verdicts = [s.attrs.get("compiled_unsupported")
                for s in pc.last_report.root.walk()]
    assert "udaf agg" in verdicts


def test_udaf_over_a_chunked_table_is_refused(frame):
    from dask_sql_tpu.physical.streaming import \
        StreamingUnsupported as JaxUnsupported
    from dask_sql_tpu_torch.physical.streaming import StreamingUnsupported

    for ctx, unsupported in ((JaxContext(), JaxUnsupported),
                             (Context(device=CPU), StreamingUnsupported)):
        ctx.create_table("c", frame, chunked=True, batch_rows=16)
        ctx.register_aggregation(_span, "span", [("x", np.int64)], np.int64)
        with pytest.raises(unsupported):
            ctx.sql("SELECT g, span(x) AS s FROM c GROUP BY g")


def test_register_aggregation_replace_rules(contexts):
    for ctx in contexts:
        with pytest.raises(ValueError, match="already registered"):
            ctx.register_aggregation(lambda s: 0, "span")
        ctx.register_aggregation(lambda s: s.sum(), "span", [("x", np.int64)],
                                 np.int64, replace=True)
    got = _assert_same(contexts, "SELECT span(x) AS s FROM t")
    assert int(got["s"][0]) == int(contexts[1].sql(
        "SELECT SUM(x) AS s FROM t", return_futures=False)["s"][0])
