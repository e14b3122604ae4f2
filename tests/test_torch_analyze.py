"""The port's ANALYZE TABLE against the JAX package's, cell for cell.

The JAX package's statement is pandas' ``describe(include="all")`` of the
table with a ``data_type`` and a ``col_name`` row, every cell a string;
the port computes the same table on the device without pandas.  Seeded
tables of integer, double, string, timestamp, date and boolean columns,
with and without NULLs, go to both packages; numeric cells compare as
floats at rtol 1e-12, every other cell exactly (NULL for NULL).
"""
import math

import numpy as np
import pandas as pd
import pytest
import torch

from dask_sql_tpu import Context as JaxContext
from dask_sql_tpu_torch import Context

CPU = torch.device("cpu")


def _table(n=3000, seed=0, nulls=True):
    rng = np.random.default_rng(seed)
    df = pd.DataFrame({
        "i": rng.integers(-1000, 1000, n),
        "d": np.round(rng.normal(50.0, 20.0, n), 4),
        "s": rng.choice(["alpha", "beta", "gamma", "delta"], n).astype(object),
        "t": pd.to_datetime(1_577_836_800_000_000
                            + rng.integers(0, 10**14, n), unit="us"),
        "day": pd.to_datetime(rng.integers(18000, 19000, n), unit="D"),
        "b": rng.random(n) < 0.3,
    })
    if nulls:
        holes = rng.random(n) < 0.1
        df["i"] = pd.array(np.where(holes, None, df["i"]), dtype="Int64")
        df.loc[rng.random(n) < 0.1, "d"] = np.nan
        df.loc[rng.random(n) < 0.1, "s"] = None
        df.loc[rng.random(n) < 0.1, "t"] = pd.NaT
    return df


def _is_number(v) -> bool:
    try:
        float(v)
    except (TypeError, ValueError):
        return False
    return True


def _cells(df):
    return [[None if v is None or (isinstance(v, float) and math.isnan(v))
             else v for v in row] for row in df.itertuples(index=False)]


def _same(jc, pc, sql):
    want = jc.sql(sql, return_futures=False)
    got = pc.sql(sql, return_futures=False)
    assert list(got.columns) == list(want.columns)
    g, w = _cells(got), _cells(want)
    assert [r[0] for r in g] == [r[0] for r in w]   # the statistic names
    for rg, rw in zip(g, w):
        for a, b in zip(rg, rw):
            if a is not None and b is not None and _is_number(a) \
                    and _is_number(b) and a != b:
                assert math.isclose(float(a), float(b), rel_tol=1e-12), \
                    (rg[0], a, b)
            else:
                assert a == b, (rg[0], a, b)
    return got


@pytest.fixture(scope="module")
def tables():
    jc, pc = JaxContext(), Context(device=CPU)
    frames = {"wide": _table(), "dense": _table(seed=1, nulls=False),
              "tiny": pd.DataFrame({"i": [1, 2, 3], "d": [1.0, 2.0, 4.0]}),
              "one": pd.DataFrame({"x": [2.5], "s": ["only"]}),
              "ties": pd.DataFrame({"s": ["b", "a", "a", "b", None, "c"],
                                    "i": pd.array([3, 1, 1, 3, None, 2],
                                                  dtype="Int64")}),
              "empty": pd.DataFrame({"a": pd.array([None, None],
                                                   dtype="Int64"),
                                     "s": [None, None]})}
    for name, df in frames.items():
        jc.create_table(name, df)
        pc.create_table(name, df)
    return jc, pc


@pytest.mark.parametrize("sql", [
    "ANALYZE TABLE wide COMPUTE STATISTICS FOR ALL COLUMNS",
    "ANALYZE TABLE wide COMPUTE STATISTICS FOR COLUMNS i, d",
    "ANALYZE TABLE wide COMPUTE STATISTICS FOR COLUMNS i, s",
    "ANALYZE TABLE wide COMPUTE STATISTICS FOR COLUMNS t",
    "ANALYZE TABLE wide COMPUTE STATISTICS FOR COLUMNS day, b",
    "ANALYZE TABLE dense COMPUTE STATISTICS FOR ALL COLUMNS",
    "ANALYZE TABLE dense COMPUTE STATISTICS FOR COLUMNS i, d",
    "ANALYZE TABLE tiny COMPUTE STATISTICS FOR ALL COLUMNS",
    "ANALYZE TABLE one COMPUTE STATISTICS FOR ALL COLUMNS",
    "ANALYZE TABLE ties COMPUTE STATISTICS FOR ALL COLUMNS",
    "ANALYZE TABLE ties COMPUTE STATISTICS FOR COLUMNS s",
    "ANALYZE TABLE empty COMPUTE STATISTICS FOR ALL COLUMNS",
])
def test_analyze_equals_jax(tables, sql):
    _same(*tables, sql)


def test_analyze_row_order_puts_std_last_beside_a_timestamp(tables):
    got = _same(*tables, "ANALYZE TABLE wide COMPUTE STATISTICS FOR "
                         "COLUMNS s, t, d")
    assert list(got["statistic"]) == [
        "count", "unique", "top", "freq", "mean", "min", "25%", "50%",
        "75%", "max", "std", "data_type", "col_name"]
    row = dict(zip(got["statistic"], got["t"]))
    assert pd.isna(row["std"]) and row["data_type"] == "timestamp"


def test_analyze_ties_go_to_the_value_seen_first(tables):
    got = _same(*tables, "ANALYZE TABLE ties COMPUTE STATISTICS FOR "
                         "COLUMNS s")
    assert dict(zip(got["statistic"], got["s"]))["top"] == "b"


def test_analyze_view(tables):
    jc, pc = tables
    for c in (jc, pc):
        c.sql("CREATE OR REPLACE VIEW fv AS SELECT i, d * 2 AS d2, s FROM "
              "wide WHERE s <> 'beta'")
    _same(jc, pc, "ANALYZE TABLE fv COMPUTE STATISTICS FOR ALL COLUMNS")


def test_analyze_after_appends(tables):
    jc, pc = tables
    for c in (jc, pc):
        c.create_table("grow", _table(200, seed=5))
        c.append_rows("grow", _table(50, seed=6))
        c.sql("INSERT INTO grow SELECT * FROM wide WHERE d > 90")
    _same(jc, pc, "ANALYZE TABLE grow COMPUTE STATISTICS FOR ALL COLUMNS")


def test_analyze_chunked_equals_resident():
    """A chunked table streams one column at a time (its catalog entry
    holds a one-row stub): ANALYZE equals ANALYZE of the same rows
    resident."""
    df = _table(3000, seed=2)
    pc = Context(device=CPU)
    pc.create_table("res", df)
    pc.create_table("tc", df, chunked=True, batch_rows=512)
    res = pc.sql("ANALYZE TABLE res COMPUTE STATISTICS FOR ALL COLUMNS",
                 return_futures=False)
    got = pc.sql("ANALYZE TABLE tc COMPUTE STATISTICS FOR ALL COLUMNS",
                 return_futures=False)
    assert _cells(got) == _cells(res)


def test_analyze_chunked_uploads_one_column_at_a_time():
    """Every upload of a chunked ANALYZE is one batch of one column, each
    batch of each named column once: the device never holds the table."""
    df = _table(3000, seed=3)
    pc = Context(device=CPU)
    pc.create_table("tc", df, chunked=True, batch_rows=512)
    source = pc.schema["root"].tables["tc"].chunked
    uploads = []
    real = source.batch_table

    def spy(i, device, columns=None):
        uploads.append((i, tuple(columns)))
        return real(i, device, columns)

    source.batch_table = spy
    pc.sql("ANALYZE TABLE tc COMPUTE STATISTICS FOR COLUMNS d, s, t")
    assert uploads == [(i, (c,)) for c in ("d", "s", "t")
                       for i in range(source.n_batches)]


def test_analyze_chunked_refuses_a_column_past_the_budget(monkeypatch):
    """A column whose rows and mask would pass DSQL_STREAM_PARTIAL_BYTES
    on the device raises StreamingUnsupported before any upload."""
    from dask_sql_tpu_torch.physical import streaming

    df = _table(3000, seed=4)
    pc = Context(device=CPU)
    pc.create_table("tc", df, chunked=True, batch_rows=512)
    source = pc.schema["root"].tables["tc"].chunked
    uploads = []
    real = source.batch_table
    source.batch_table = lambda *a, **k: uploads.append(a) or real(*a, **k)
    # "d" holds 3,000 doubles and a mask: 27,000 bytes; "b" 3,000 bytes
    monkeypatch.setattr(streaming, "PARTIAL_BYTES_BUDGET", 26_999)
    with pytest.raises(streaming.StreamingUnsupported, match="column d"):
        pc.sql("ANALYZE TABLE tc COMPUTE STATISTICS FOR COLUMNS b, d")
    assert uploads == []
    got = pc.sql("ANALYZE TABLE tc COMPUTE STATISTICS FOR COLUMNS b",
                 return_futures=False)
    assert dict(zip(got["statistic"], got["b"]))["count"] == "3000"
