"""The port's input plugins (``io/inputs.py``, ``io/hive.py``) against the
JAX package's.

The same inputs, made from a seed with numpy, go to both packages'
``create_table``: a ``Table``, a pandas frame and Series, a dict, a pyarrow
table, lists of them, every file format the location plugin reads (by
extension and by ``format=``), an intake catalog through the fake module
of ``tests/unit/test_integrations.py``, a Hive metastore through the fake
cursor of ``tests/integration/test_hive.py``, and ``CREATE TABLE ... WITH
(location=...)``.  Each registered table is equal in both: names, SQL
types and values (pandas' ``assert_frame_equal``), and the catalog entry's
``statistics``, ``filepath`` and ``gpu``.
"""
import sys
import types

import numpy as np
import pandas as pd
import pytest
import torch

from dask_sql_tpu import Context as JaxContext
from dask_sql_tpu.io import hive as jax_hive
from dask_sql_tpu.table import Table as JaxTable
from dask_sql_tpu_torch import Context, Table
from dask_sql_tpu_torch.io import hive as port_hive

from tests.integration.test_hive import (PARQUET_FMT, TEXT_FMT,
                                         FakeHiveCursor, _describe_rows)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def frame():
    rng = np.random.RandomState(11)
    n = 40
    return pd.DataFrame({
        "i": rng.randint(-50, 50, n).astype(np.int64),
        "f": np.where(rng.rand(n) < 0.1, np.nan, rng.randn(n) * 10),
        "s": rng.choice(["ab", "cd", "e f"], n).astype(object),
        "b": rng.rand(n) > 0.5,
        "d": pd.to_datetime("2001-02-03") + pd.to_timedelta(
            rng.randint(0, 500, n), unit="D"),
    })


@pytest.fixture(scope="module")
def files(frame, tmp_path_factory):
    """``frame`` written once in every format, keyed by extension."""
    d = tmp_path_factory.mktemp("inputs")
    out = {}
    for ext in ("csv", "txt"):
        out[ext] = d / f"t.{ext}"
        frame.to_csv(out[ext], index=False)
    out["tsv"] = d / "t.tsv"
    frame.to_csv(out["tsv"], index=False, sep="\t")
    for ext in ("parquet", "pq"):
        out[ext] = d / f"t.{ext}"
        frame.to_parquet(out[ext])
    out["json"] = d / "t.json"
    frame.to_json(out["json"])
    for ext in ("feather", "arrow"):
        out[ext] = d / f"t.{ext}"
        frame.to_feather(out[ext])
    out["orc"] = d / "t.orc"
    frame.to_orc(out["orc"])
    out["dat"] = d / "t.dat"          # a csv file under another extension
    frame.to_csv(out["dat"], index=False)
    out["bin"] = d / "t.bin"          # a parquet file under another one
    frame.to_parquet(out["bin"])
    return {k: str(v) for k, v in out.items()}


def _both(name, jax_input, port_input, **kw):
    jc, pc = JaxContext(), Context(device=CPU)
    jc.create_table(name, jax_input, **kw)
    pc.create_table(name, port_input, **kw)
    return jc, pc


def _assert_entries_equal(jc, pc, name="t"):
    je = jc.schema["root"].tables[name]
    pe = pc.schema["root"].tables[name]
    assert pe.table.names == je.table.names
    assert [str(c.stype) for c in pe.table.columns] == \
        [str(c.stype) for c in je.table.columns]
    assert all(c.data.device == CPU for c in pe.table.columns)
    pd.testing.assert_frame_equal(pe.table.to_pandas(), je.table.to_pandas())
    assert (pe.statistics, pe.filepath, pe.gpu) == \
        (je.statistics, je.filepath, je.gpu)
    got = pc.sql(f"SELECT COUNT(*) AS n FROM {name}", return_futures=False)
    assert int(got["n"][0]) == je.table.num_rows


def _jax_table(df):
    return JaxTable.from_pandas(df)


def _port_table(df):
    return Table.from_pandas(df, CPU)


_OBJECTS = {
    "table": (_jax_table, _port_table),
    "pandas": (lambda df: df, lambda df: df),
    "series": (lambda df: df["f"], lambda df: df["f"]),
    "dict": (lambda df: {"i": df["i"].to_numpy(), "f": df["f"].to_numpy(),
                         "s": df["s"].to_numpy()},) * 2,
    "arrow": (lambda df: __import__("pyarrow").Table.from_pandas(df),) * 2,
    "list_of_dicts": (lambda df: [{"i": df["i"].to_numpy()[:15]},
                                  {"i": df["i"].to_numpy()[15:]}],) * 2,
    "list_of_frames": (lambda df: [df.iloc[:10], df.iloc[10:]],) * 2,
    "list_of_tables": (lambda df: [_jax_table(df.iloc[:7]),
                                   _jax_table(df.iloc[7:])],
                       lambda df: [_port_table(df.iloc[:7]),
                                   _port_table(df.iloc[7:])]),
}


@pytest.mark.parametrize("kind", list(_OBJECTS))
def test_object_inputs_match_jax(frame, kind):
    make_jax, make_port = _OBJECTS[kind]
    jc, pc = _both("t", make_jax(frame), make_port(frame),
                   statistics={"row_count": len(frame)}, gpu=True)
    _assert_entries_equal(jc, pc)


@pytest.mark.parametrize("ext", ["csv", "tsv", "txt", "parquet", "pq",
                                 "json", "feather", "arrow", "orc"])
def test_every_reader_matches_jax(files, ext):
    kw = {"parse_dates": ["d"]} if ext in ("csv", "tsv", "txt") else {}
    jc, pc = _both("t", files[ext], files[ext], **kw)
    _assert_entries_equal(jc, pc)


@pytest.mark.parametrize("ext,fmt", [("dat", "csv"), ("bin", "parquet"),
                                     ("bin", "PQ")])
def test_format_overrides_the_extension(files, ext, fmt):
    jc, pc = _both("t", files[ext], files[ext], format=fmt)
    _assert_entries_equal(jc, pc)


def test_wrong_format_raises_in_both(files):
    for ctx in (JaxContext(), Context(device=CPU)):
        with pytest.raises(AttributeError,
                           match="Do not understand input format strange"):
            ctx.create_table("t", files["csv"], format="strange")
        with pytest.raises(AttributeError,
                           match="Do not understand input format dat2"):
            ctx.create_table("t", files["csv"].replace(".csv", ".dat2"))
        with pytest.raises(ValueError, match="Do not understand the input"):
            ctx.create_table("t", 3.5)


@pytest.mark.parametrize("clause", ["", "IF NOT EXISTS", "OR REPLACE"])
def test_create_table_with_location(files, frame, clause):
    """CREATE TABLE ... WITH (location=...) reads the file once; a second
    statement raises (plain), keeps the first table (IF NOT EXISTS) or
    replaces it (OR REPLACE), as in the JAX package."""
    jc, pc = _both("t", frame.iloc[:3], frame.iloc[:3])
    verb = "CREATE TABLE" if clause != "OR REPLACE" else "CREATE OR REPLACE TABLE"
    verb = verb if clause != "IF NOT EXISTS" else "CREATE TABLE IF NOT EXISTS"
    sql = (f"{verb} t WITH (location = '{files['csv']}', format = 'csv', "
           "parse_dates = ARRAY ['d'])")
    for ctx in (jc, pc):
        if not clause:
            with pytest.raises(RuntimeError, match="already present"):
                ctx.sql(sql)
            ctx.sql(sql.replace("CREATE TABLE t", "CREATE TABLE t2"))
        else:
            ctx.sql(sql)
    _assert_entries_equal(jc, pc, "t2" if not clause else "t")
    if clause == "IF NOT EXISTS":
        assert pc.schema["root"].tables["t"].table.num_rows == 3
    for ctx in (jc, pc):
        with pytest.raises(AttributeError, match="'location'"):
            ctx.sql("CREATE TABLE u WITH (format = 'csv')")


# ---------------------------------------------------------------------------
# intake, through the fake module of tests/unit/test_integrations.py
# ---------------------------------------------------------------------------

@pytest.fixture
def fake_intake(monkeypatch):
    intake = types.ModuleType("intake")
    catalog_mod = types.ModuleType("intake.catalog")

    class Source:
        def __init__(self, df, **kwargs):
            self.df = df
            self.kwargs = kwargs

        def __call__(self, **kwargs):
            return Source(self.df, **kwargs)

        def read(self):
            return self.df

    class Catalog:
        def __init__(self):
            self._entries = {}

        def __setitem__(self, k, v):
            self._entries[k] = v

        def __getitem__(self, k):
            return self._entries[k]

    catalog_mod.Catalog = Catalog
    intake.catalog = catalog_mod
    opened = []

    def open_catalog(path, **kwargs):
        opened.append((path, kwargs))
        cat = Catalog()
        cat["t"] = Source(pd.DataFrame({"a": [1, 2, 3],
                                        "b": ["x", "y", "x"]}))
        return cat

    intake.open_catalog = open_catalog
    monkeypatch.setitem(sys.modules, "intake", intake)
    monkeypatch.setitem(sys.modules, "intake.catalog", catalog_mod)
    return Catalog, Source, opened


def test_intake_catalog_object_and_path(fake_intake, frame):
    Catalog, Source, opened = fake_intake
    cat = Catalog()
    cat["sales"] = Source(frame)
    jc, pc = _both("t", cat, cat, intake_table_name="sales")
    _assert_entries_equal(jc, pc)
    jc, pc = _both("t", "/some/catalog.yaml", "/some/catalog.yaml",
                   format="intake", intake_table_name="t",
                   catalog_kwargs={"ttl": 60})
    _assert_entries_equal(jc, pc)
    assert opened[-2:] == [("/some/catalog.yaml", {"ttl": 60})] * 2


def test_intake_format_without_intake_names_it(monkeypatch):
    monkeypatch.setitem(sys.modules, "intake", None)
    for ctx in (JaxContext(), Context(device=CPU)):
        with pytest.raises(ImportError, match="requires intake"):
            ctx.create_table("t", "/x.yaml", format="intake")


# ---------------------------------------------------------------------------
# Hive, through the fake cursor of tests/integration/test_hive.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hive_parquet(tmp_path_factory):
    d = tmp_path_factory.mktemp("warehouse") / "tbl"
    d.mkdir()
    rng = np.random.RandomState(3)
    df = pd.DataFrame({"i": rng.randint(0, 100, 12).astype("int32"),
                       "s": rng.choice(["a", "b", "c"], 12)})
    df.to_parquet(d / "part-0000")
    pd.DataFrame({"i": [7], "s": ["junk"]}).to_parquet(d / "_SUCCESS")
    cursor = FakeHiveCursor({
        "USE default": [],
        "DESCRIBE FORMATTED tbl": _describe_rows(
            [("i", "int"), ("s", "string")], str(d), PARQUET_FMT),
    })
    return cursor, df


@pytest.fixture(scope="module")
def hive_partitioned(tmp_path_factory):
    base = tmp_path_factory.mktemp("wh") / "t2"
    rng = np.random.RandomState(4)
    for part in ("p=1", "p=2"):
        d = base / part
        d.mkdir(parents=True)
        pd.DataFrame({"x": rng.randint(0, 9, 5), "y": rng.rand(5)}).to_csv(
            d / "data-000", index=False, header=False, sep="|")
    common = dict(field_delim="|")
    cursor = FakeHiveCursor({
        "USE default": [],
        "DESCRIBE FORMATTED t2": _describe_rows(
            [("x", "bigint"), ("y", "double")], str(base), TEXT_FMT,
            partitions=[("p", "int")], **common),
        "SHOW PARTITIONS t2": [("p=1",), ("p=2",)],
        **{f"DESCRIBE FORMATTED t2 PARTITION (p={k})": _describe_rows(
            [("x", "bigint"), ("y", "double")], str(base / f"p={k}"),
            TEXT_FMT, detail_extra=[("Partition Value", f"[{k}]", "")],
            **common) for k in (1, 2)},
    })
    return cursor


def test_hive_parse_dicts_match_jax(hive_parquet, hive_partitioned):
    cursor, _ = hive_parquet
    for cur, name in ((cursor, "tbl"), (hive_partitioned, "t2")):
        assert port_hive.parse_hive_table_description(cur, "default", name) \
            == jax_hive.parse_hive_table_description(cur, "default", name)
    assert port_hive.parse_hive_partition_description(
        hive_partitioned, "default", "t2") == \
        jax_hive.parse_hive_partition_description(
            hive_partitioned, "default", "t2") == ["p=1", "p=2"]
    assert port_hive.parse_hive_table_description(
        hive_partitioned, "default", "t2", partition="p=2")[1][
            "Partition Value"] == "[2]"


def test_hive_unpartitioned_parquet(hive_parquet):
    cursor, df = hive_parquet
    got = port_hive.hive_table_to_pandas(cursor, "tbl")
    pd.testing.assert_frame_equal(got, jax_hive.hive_table_to_pandas(
        cursor, "tbl"))
    pd.testing.assert_frame_equal(got, df, check_dtype=False)


def test_hive_partitioned_csv(hive_partitioned):
    got = port_hive.hive_table_to_pandas(hive_partitioned, "t2")
    pd.testing.assert_frame_equal(got, jax_hive.hive_table_to_pandas(
        hive_partitioned, "t2"))
    assert got["p"].tolist() == [1] * 5 + [2] * 5
    assert got["p"].dtype == np.int32


def test_hive_through_context_sql(hive_parquet, hive_partitioned):
    cursor, _ = hive_parquet
    jc, pc = _both("hive_t", cursor, cursor, format="hive",
                   hive_table_name="tbl")
    _assert_entries_equal(jc, pc, "hive_t")
    sql = "SELECT s, SUM(i) AS n FROM hive_t GROUP BY s ORDER BY s"
    pd.testing.assert_frame_equal(pc.sql(sql, return_futures=False),
                                  jc.sql(sql, return_futures=False))
    for ctx in (jc, pc):
        ctx.create_table("t2", hive_partitioned, format="hive",
                         hive_table_name="t2")
    _assert_entries_equal(jc, pc, "t2")


def test_hive_like_detection():
    from dask_sql_tpu.io.hive import HiveInput as JaxHive
    from dask_sql_tpu_torch.io.hive import HiveInput

    class Connection:
        def execute(self, sql):
            return self

    Connection.__module__ = "sqlalchemy.engine.base"

    class Engine(Connection):
        pass

    Engine.__module__ = "sqlalchemy.engine.base"
    Cursor = type("Cursor", (), {"__module__": "pyhive.hive"})
    for item, kw in ((Connection(), {}), (Engine(), {}), (Cursor(), {}),
                     (object(), {}), (object(), {"format": "hive"}),
                     (object(), {"file_format": "hive"})):
        assert HiveInput.is_hive_like(item, **kw) == \
            JaxHive.is_hive_like(item, **kw)
