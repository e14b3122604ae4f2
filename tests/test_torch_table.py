"""The port's columnar tables against the JAX package's: the same frames
and dicts of numpy arrays round-trip to the same host values, and a JAX
table carried across by ``convert.py`` reads back identically."""
import numpy as np
import pandas as pd
import pytest
import torch

from dask_sql_tpu.table import Table as JaxTable
from dask_sql_tpu_torch import convert
from dask_sql_tpu_torch.table import Column, Table

CPU = torch.device("cpu")


def _frames():
    rng = np.random.RandomState(0)
    n = 12
    return {
        "nullable_ints": pd.DataFrame({
            "a": pd.array([1, None, 3, 4, None, 6, 7, 8, 9, 10, 11, 12],
                          dtype="Int64"),
            "b": np.arange(n, dtype=np.int32),
            "c": np.arange(n, dtype=np.int16) - 5,
        }),
        "floats": pd.DataFrame({
            "x": [1.5, np.nan, np.inf, -np.inf, 0.0, -0.0, 2.5, np.nan,
                  1e300, -1e-300, 3.0, 4.0],
            "y": rng.randn(n).astype(np.float32),
        }),
        "strings": pd.DataFrame({
            "s": ["b", None, "a", "c", "a", None, "zz", "b", "", "a", "c", "q"],
            "t": ["x", "y", "x", "y", "x", "y", "x", "y", "x", "y", "x", "y"],
            "u": pd.Series(["%", "_", "a.b", "*", None, "\\", "[", "]", "^",
                            "$", "(", ")"], dtype="string"),
        }),
        "datetimes": pd.DataFrame({
            "d": pd.to_datetime(["2001-01-01", None, "1999-12-31 23:59:59",
                                 "1970-01-01", "2020-02-29", None,
                                 "1960-06-01", "2038-01-19", "2000-01-01",
                                 "2000-01-02", "2000-01-03", "2000-01-04"],
                                format="ISO8601"),
            "tz": pd.to_datetime(["2001-01-01 10:00"] * n).tz_localize(
                "Europe/Berlin"),
        }),
        "bools": pd.DataFrame({
            "f": [True, False] * 6,
            "g": pd.array([True, None, False] * 4, dtype="boolean"),
        }),
    }


_NAMES = ["nullable_ints", "floats", "strings", "datetimes", "bools"]


@pytest.mark.parametrize("name", _NAMES)
def test_from_pandas_roundtrip_matches_jax(name):
    df = _frames()[name]
    got = Table.from_pandas(df, CPU).to_pandas()
    want = JaxTable.from_pandas(df).to_pandas()
    pd.testing.assert_frame_equal(got, want)


@pytest.mark.parametrize("name", _NAMES)
def test_schema_matches_jax(name):
    df = _frames()[name]
    got = [(n, str(t)) for n, t in Table.from_pandas(df, CPU).schema()]
    want = [(n, str(t)) for n, t in JaxTable.from_pandas(df).schema()]
    assert got == want


def test_from_pydict_numpy_matches_jax():
    data = {
        "i": np.arange(5, dtype=np.int64),
        "f": np.array([0.5, np.nan, 2.0, np.inf, -1.0]),
        "s": np.array(["b", "a", "c", "a", "b"]),
        "o": [None, "x", "y", None, "x"],
        "n": [1, None, 3, None, 5],
        "ts": np.array(["2000-01-01", "NaT", "1999-01-01", "2000-01-01",
                        "2010-05-05"], dtype="datetime64[s]"),
    }
    got = Table.from_pydict(data, CPU)
    want = JaxTable.from_pydict(data)
    assert [str(c.stype) for c in got.columns] == [str(c.stype) for c in want.columns]
    for gc, wc in zip(got.columns, want.columns):
        g, w = gc.to_numpy(), wc.to_numpy()
        if g.dtype.kind == "f":
            np.testing.assert_array_equal(g, w)
        else:
            assert g.tolist() == w.tolist()
    pd.testing.assert_frame_equal(got.to_pandas(), want.to_pandas())


def test_string_dictionary_and_ranks_match_jax():
    df = pd.DataFrame({"s": ["pear", None, "apple", "fig", "apple", "Zed"]})
    got = Table.from_pandas(df, CPU).columns[0]
    want = JaxTable.from_pandas(df).columns[0]
    assert got.dictionary.tolist() == want.dictionary.tolist()
    assert got.data.tolist() == np.asarray(want.data).tolist()
    assert got.dict_ranks().data.tolist() == np.asarray(want.dict_ranks().data).tolist()


def test_take_slice_and_scalar_columns():
    t = Table.from_pydict({"a": np.arange(6), "s": np.array(list("abcabc"))}, CPU)
    taken = t.take(torch.tensor([5, 0, 2]))
    assert taken.to_numpy()["a"].tolist() == [5, 0, 2]
    assert taken.to_numpy()["s"].tolist() == ["c", "a", "c"]
    assert t.slice(1, 3).to_numpy()["a"].tolist() == [1, 2]
    from dask_sql_tpu_torch.table import Scalar
    from dask_sql_tpu_torch.types import VARCHAR
    col = Column.from_scalar(Scalar(None, VARCHAR), 3, CPU)
    assert col.to_numpy().tolist() == [None, None, None]


@pytest.mark.parametrize("name", _NAMES)
def test_convert_carries_jax_table_across(name):
    """convert.py builds the port's table from the JAX table's physical
    arrays (codes, dictionaries, masks), handed over as numpy."""
    df = _frames()[name]
    jt = JaxTable.from_pandas(df)
    specs = [(n, str(c.stype), np.asarray(c.data),
              None if c.mask is None else np.asarray(c.mask), c.dictionary)
             for n, c in zip(jt.names, jt.columns)]
    pt = convert.table_from_columns(specs, CPU)
    for pc, jc in zip(pt.columns, jt.columns):
        assert str(pc.stype) == str(jc.stype)
        assert pc.data.numpy().tobytes() == np.asarray(jc.data).tobytes()
    pd.testing.assert_frame_equal(pt.to_pandas(), jt.to_pandas())


def test_convert_parses_decimal_type_names():
    t = convert.sql_type_from_name("DECIMAL(15, 2)")
    assert (t.name, t.precision, t.scale) == ("DECIMAL", 15, 2)
    assert convert.sql_type_from_name("TIMESTAMP").name == "TIMESTAMP"
