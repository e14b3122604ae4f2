"""The port's chunked source (``dask_sql_tpu_torch/io/chunked.py``) against
the JAX package's (``dask_sql_tpu/io/chunked.py``): the same seeded frame
gives the same host batches, masks, types and global dictionaries through
``from_pandas``, ``from_parquet`` and the port's pandas-free
``from_columns``; a short last batch is padded with a ``row_valid`` mask,
as in the JAX package; and ``Context.create_table(..., chunked=True)``
takes every input kind."""
import numpy as np
import pandas as pd
import pytest
import torch

from dask_sql_tpu.io.chunked import ChunkedSource as JaxSource
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.io.chunked import ChunkedInputError, ChunkedSource

N = 2500
BATCH = 1000


def _columns(seed: int = 11) -> dict:
    rng = np.random.RandomState(seed)
    s = rng.choice(["pear", "fig", "kiwi", "apple"], N).astype(object)
    s[rng.rand(N) < 0.1] = None
    f = np.round(rng.randn(N), 3)
    f[rng.rand(N) < 0.05] = np.nan
    d = (np.datetime64("2020-01-01") + rng.randint(0, 900, N)
         .astype("timedelta64[D]")).astype("datetime64[ns]")
    d[rng.rand(N) < 0.05] = np.datetime64("NaT")
    return {"i": rng.randint(-50, 50, N).astype(np.int64),
            "i32": rng.randint(0, 9, N).astype(np.int32),
            "f": f, "s": s, "b": rng.rand(N) < 0.5, "d": d,
            "u": rng.choice(["x", "yy", "zzz"], N)}


def _frame() -> pd.DataFrame:
    return pd.DataFrame(_columns())


def _assert_same_source(port: ChunkedSource, jax_src: JaxSource) -> None:
    assert port.names == jax_src.names
    assert port.n_rows == jax_src.n_rows
    assert port.batch_rows == jax_src.batch_rows
    assert port.n_batches == jax_src.n_batches
    assert [t.name for t in port.stypes] == [t.name for t in jax_src.stypes]
    for a, b in zip(port.dictionaries, jax_src.dictionaries):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.tolist() == b.tolist()
    for pb, jb in zip(port.batches, jax_src.batches):
        for (pd_, pm), (jd, jm) in zip(pb, jb):
            assert pd_.dtype == jd.dtype
            np.testing.assert_array_equal(pd_, jd)
            assert (pm is None) == (jm is None)
            if pm is not None:
                np.testing.assert_array_equal(pm, jm)


def test_from_pandas_equals_jax():
    df = _frame()
    _assert_same_source(ChunkedSource.from_pandas(df, batch_rows=BATCH),
                        JaxSource.from_pandas(df, batch_rows=BATCH))


def test_from_columns_equals_jax_from_pandas():
    """The pandas-free constructor encodes through ``host_encode_numpy`` with
    the same global dictionaries, NULLs and NaN as the JAX package's
    pandas path."""
    _assert_same_source(
        ChunkedSource.from_columns(_columns(), batch_rows=BATCH),
        JaxSource.from_pandas(_frame(), batch_rows=BATCH))


def test_from_columns_lists_with_none():
    src = ChunkedSource.from_columns(
        {"k": ["a", None, "b", "a"], "v": [1, None, 3, 4]}, batch_rows=3)
    assert src.n_batches == 2
    (k0, km0), (v0, vm0) = src.batches[0]
    assert src.dictionaries[0].tolist() == ["", "a", "b"]
    assert km0.tolist() == [True, False, True]
    assert vm0.tolist() == [True, False, True]
    assert v0.tolist()[0] == 1 and v0.tolist()[2] == 3
    with pytest.raises(ChunkedInputError):
        ChunkedSource.from_columns({"a": [1, 2], "b": [1]})


def test_parquet_equals_jax(tmp_path):
    df = _frame().drop(columns=["d"])
    path = str(tmp_path / "t.parquet")
    df.to_parquet(path, index=False, row_group_size=700)
    port = ChunkedSource.from_parquet(path, batch_rows=BATCH)
    _assert_same_source(port, JaxSource.from_parquet(path, batch_rows=BATCH))
    assert port.n_batches == 3
    assert [len(b[0][0]) for b in port.batches] == [1000, 1000, 500]


def _two_group_parquet(tmp_path, name, g1, g2):
    import pyarrow as pa
    import pyarrow.parquet as pq

    t1 = pa.table({"g": g1, "v": pa.array(np.arange(300, dtype=np.float64))})
    t2 = pa.table({"g": g2,
                   "v": pa.array(np.arange(300, 600, dtype=np.float64))})
    path = str(tmp_path / name)
    with pq.ParquetWriter(path, t1.schema) as w:
        w.write_table(t1)
        w.write_table(t2)
    return path


def test_parquet_categorical_dictionaries_equal_jax(tmp_path):
    """Row groups whose dictionary orders differ re-encode against ONE
    global dictionary, in both packages."""
    import pyarrow as pa

    path = _two_group_parquet(
        tmp_path, "cat.parquet",
        pa.array(["b", "a", "b"] * 100).dictionary_encode(),
        pa.array(["c", "b"] * 150).dictionary_encode())
    port = ChunkedSource.from_parquet(path, batch_rows=150)
    _assert_same_source(port, JaxSource.from_parquet(path, batch_rows=150))
    c = Context(device="cpu")
    c.create_table("t", path, chunked=True, batch_rows=150)
    got = c.sql("SELECT g, COUNT(*) AS n, SUM(v) AS s FROM t GROUP BY g "
                "ORDER BY g").to_numpy()
    assert got["g"].tolist() == ["a", "b", "c"]
    assert got["n"].tolist() == [100, 350, 150]
    want = (pd.DataFrame({"g": ["b", "a", "b"] * 100 + ["c", "b"] * 150,
                          "v": np.arange(600, dtype=np.float64)})
            .groupby("g")["v"].sum())
    np.testing.assert_allclose(got["s"], want.to_numpy())


def test_parquet_binary_column_equals_jax(tmp_path):
    """Binary columns share one dictionary of decoded strings."""
    import pyarrow as pa

    path = _two_group_parquet(
        tmp_path, "bin.parquet",
        pa.array([b"aa"] * 100 + [b"bb"] * 200, type=pa.binary()),
        pa.array([b"bb"] * 150 + [b"cc"] * 150, type=pa.binary()))
    port = ChunkedSource.from_parquet(path, batch_rows=150)
    _assert_same_source(port, JaxSource.from_parquet(path, batch_rows=150))
    c = Context(device="cpu")
    c.create_table("t", path, chunked=True, batch_rows=150)
    got = c.sql("SELECT g, COUNT(*) AS n FROM t GROUP BY g ORDER BY g")
    assert got.to_pylist() == [["aa", 100], ["bb", 350], ["cc", 150]]
    one = c.sql("SELECT COUNT(*) AS n FROM t WHERE g = 'aa'")
    assert one.to_pylist() == [[100]]


def test_short_last_batch_padding_and_row_valid():
    port = ChunkedSource.from_columns(_columns(), batch_rows=BATCH)
    jax_src = JaxSource.from_pandas(_frame(), batch_rows=BATCH)
    dev = torch.device("cpu")
    full, rv = port.batch_table(0, dev)
    assert rv is None and full.num_rows == BATCH
    last, rv = port.batch_table(2, dev)
    jlast, jrv = jax_src.batch_table(2)
    assert last.num_rows == BATCH
    assert rv.dtype == torch.bool
    np.testing.assert_array_equal(rv.numpy(), np.asarray(jrv))
    assert int(rv.sum()) == N - 2 * BATCH
    for c, jc in zip(last.columns, jlast.columns):
        np.testing.assert_array_equal(c.data.numpy(), np.asarray(jc.data))
        assert (c.mask is None) == (jc.mask is None)
        if c.mask is not None:
            np.testing.assert_array_equal(c.mask.numpy(),
                                          np.asarray(jc.mask))
        assert c.dictionary is port.dictionaries[last.columns.index(c)]
    # a scan's columns only, in the source's order
    some, _ = port.batch_table(2, dev, ["s", "i"])
    assert some.names == ["i", "s"]
    np.testing.assert_array_equal(some.columns[1].data.numpy(),
                                  last.columns[3].data.numpy())


def test_create_table_takes_every_input_kind(tmp_path):
    cols = _columns()
    df = _frame()
    path = str(tmp_path / "t.parquet")
    df.drop(columns=["d"]).to_parquet(path, index=False)
    inputs = {"from_dict": cols, "from_frame": df, "from_path": path,
              "from_source": ChunkedSource.from_columns(cols,
                                                        batch_rows=BATCH)}
    c = Context(device="cpu")
    for name, value in inputs.items():
        c.create_table(name, value, chunked=True, batch_rows=BATCH)
        entry = c.schema["root"].tables[name]
        assert entry.chunked is not None and entry.table.num_rows == 1
        assert entry.statistics == {"row_count": N}
        got = c.sql(f"SELECT COUNT(*) AS n, SUM(i) AS s FROM {name}")
        assert got.to_pylist() == [[N, int(cols["i"].sum())]]
    with pytest.raises(TypeError, match="chunked=True"):
        c.create_table("bad", 42, chunked=True)


@pytest.mark.parametrize("threads", [False, True])
def test_staging_copy_pads_with_zeros(monkeypatch, threads):
    """The pinned staging copy of an upload (``table._stage``): every array
    at its aligned offset followed by its zero padding, in slices copied
    by threads for a large batch."""
    from dask_sql_tpu_torch import table as T

    monkeypatch.setattr(T, "_STAGE_SLICE", 1000)
    monkeypatch.setattr(T, "_STAGE_PARALLEL_BYTES", 0 if threads else 1 << 40)
    rng = np.random.RandomState(3)
    arrays = [rng.rand(777), rng.randint(0, 9, 777).astype(np.int32),
              rng.rand(777) > 0.5]
    offsets, total, pads = [], 0, []
    for a in arrays:
        total = -(-total // 16) * 16
        offsets.append(total)
        pads.append(23 * a.itemsize)
        total += (777 + 23) * a.itemsize
    buf = np.full(total, 0xFF, dtype=np.uint8)
    T._stage(buf, arrays, offsets, pads)
    for a, off in zip(arrays, offsets):
        got = buf[off:off + 800 * a.itemsize].view(a.dtype)
        np.testing.assert_array_equal(got[:777], a)
        assert not got[777:].any()
    padded = T.arrays_to_device(arrays, torch.device("cpu"), pad_to=800)
    for a, t in zip(arrays, padded):
        assert t.shape == (800,) and not t[777:].any()
        np.testing.assert_array_equal(t[:777].numpy(), a)
