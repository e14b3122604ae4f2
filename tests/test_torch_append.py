"""The port's append seam (``Context.append_rows``, ``_coerce_delta``,
INSERT INTO) against the JAX package's.

The same batches go to both packages' contexts over the same seeded
tables: the tables after the appends are equal, the column types are the
target's, and every refusal raises the same typed error with the same
message (``SchemaMismatch`` for a batch that does not fit).  Mirrors the
append half of the JAX package's ``tests/unit/test_matview_unit.py``; the
port's own inputs (dicts of numpy arrays, tensors on the device) and the
pandas-free process are checked beside it.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from dask_sql_tpu import Context as JaxContext
from dask_sql_tpu.runtime.resilience import SchemaMismatch as JaxSchemaMismatch
from dask_sql_tpu.runtime.resilience import UserError as JaxUserError
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.runtime.resilience import SchemaMismatch, UserError
from dask_sql_tpu_torch.table import Table

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]
COUNTERS = ("mv_refresh_incremental", "mv_refresh_full",
            "mv_deltas_recorded", "mv_serves")


def _cell(v):
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return None
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (pd.Timestamp, np.datetime64)):
        return str(pd.Timestamp(v))
    return v


def _rows(df) -> list:
    rows = [tuple(_cell(v) for v in r) for r in df.itertuples(index=False)]
    return sorted(rows, key=lambda r: tuple(
        (v is None, f"{v:.6g}" if isinstance(v, float) else str(v))
        for v in r))


def assert_same(got, want):
    assert list(got.columns) == list(want.columns)
    g, w = _rows(got), _rows(want)
    assert len(g) == len(w), (g, w)
    for rg, rw in zip(g, w):
        for a, b in zip(rg, rw):
            if isinstance(a, float) or isinstance(b, float):
                assert a is not None and b is not None, (rg, rw)
                assert math.isclose(a, b, rel_tol=1e-9, abs_tol=1e-12), \
                    (rg, rw)
            else:
                assert a == b, (rg, rw)


class Pair:
    """The same statements on both packages' contexts."""

    def __init__(self, **tables):
        self.j, self.p = JaxContext(), Context(device=CPU)
        for name, df in tables.items():
            self.create(name, df)

    def create(self, name, df, **kw):
        self.j.create_table(name, df, **kw)
        self.p.create_table(name, df, **kw)

    def run(self, sql):
        self.j.sql(sql)
        self.p.sql(sql)

    def same(self, sql):
        got = self.p.sql(sql, return_futures=False)
        assert_same(got, self.j.sql(sql, return_futures=False))
        return got

    def append(self, name, rows, **kw):
        nj = self.j.append_rows(name, rows, **kw)
        assert self.p.append_rows(name, rows, **kw) == nj
        return nj

    def raises(self, sql, jax_exc, port_exc):
        with pytest.raises(jax_exc) as ej:
            self.j.sql(sql)
        with pytest.raises(port_exc) as ep:
            self.p.sql(sql)
        assert str(ep.value) == str(ej.value)


class Counters:
    """Both packages' counter movements since it was made."""

    def __init__(self):
        self.j0, self.p0 = self._snap()

    @staticmethod
    def _snap():
        j, p = jax_tel.REGISTRY.counters(), port_tel.REGISTRY.counters()
        return ({n: j.get(n, 0) for n in COUNTERS},
                {n: p.get(n, 0) for n in COUNTERS})

    def moved(self) -> dict:
        j1, p1 = self._snap()
        dj = {n: j1[n] - self.j0[n] for n in COUNTERS}
        dp = {n: p1[n] - self.p0[n] for n in COUNTERS}
        assert dp == dj
        return dp


def _seeded(n=50, seed=3):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "k": rng.choice(["a", "b", "c"], n).astype(object),
        "x": np.round(rng.random(n) * 100, 2),
        "y": rng.integers(-50, 50, n),
        "ts": pd.to_datetime(1_577_836_800 + rng.integers(0, 10**7, n),
                             unit="s"),
    })


def _tiny():
    return pd.DataFrame({"k": ["a", "b", "a"], "x": [1.0, 2.0, 3.0],
                         "y": [1, 2, 3]})


def _types(c, name="t"):
    return [col.stype.name
            for col in c.schema["root"].tables[name].table.columns]


def _both_raise(pair, fn, jax_exc, port_exc):
    with pytest.raises(jax_exc) as ej:
        fn(pair.j)
    with pytest.raises(port_exc) as ep:
        fn(pair.p)
    assert str(ep.value) == str(ej.value)
    return str(ep.value)


def test_append_rows_coercion_paths():
    pair = Pair(t=_tiny())
    # a dict of columns, names in any case and order
    pair.append("t", {"Y": [7], "K": ["d"], "X": [4.0]})
    pair.append("t", pd.DataFrame({"k": ["e"], "x": [5.0], "y": [8]}))
    assert pair.append("t", [("f", 6.0, 9), ("g", 7.0, 10)]) == 2
    # an int where the table has DOUBLE casts
    pair.append("t", [("h", 8, 11)])
    pair.same("SELECT * FROM t")
    assert _types(pair.p) == _types(pair.j) == ["VARCHAR", "DOUBLE",
                                                "BIGINT"]


def test_append_rows_positional_and_subset():
    pair = Pair(t=_tiny())
    # names that do not match: positional
    pair.append("t", {"a": ["p"], "b": [1.5], "c": [4]})
    # a named strict subset NULL-fills the rest
    pair.append("t", {"k": ["sub"]})
    pair.append("t", {"x": [2.5], "K": ["sub2"]})
    pair.same("SELECT * FROM t")
    got = pair.same("SELECT x, y FROM t WHERE k = 'sub'")
    assert got["x"].isna().all() and got["y"].isna().all()


def test_append_rows_seeded_batches_with_timestamps():
    pair = Pair(t=_seeded())
    for i in range(3):
        pair.append("t", _seeded(7, seed=100 + i))
    pair.append("t", [("z", None, 5, "2021-03-04 05:06:07")])
    pair.same("SELECT * FROM t")
    pair.same("SELECT k, SUM(x) AS s, MAX(ts) AS m, COUNT(y) AS n FROM t "
              "GROUP BY k")
    assert _types(pair.p) == _types(pair.j)


@pytest.mark.parametrize("case", [
    "unknown", "arity", "missing", "extra_and_missing"])
def test_schema_mismatch_messages_equal(case):
    pair = Pair(t=_tiny())
    rows = {
        "unknown": {"k": ["a"], "nope": [1]},
        "arity": [("a", 1.0)],
        "missing": {"k": ["a"], "x": [1.0], "zz": [2], "ww": [3]},
        "extra_and_missing": {"q": ["a"], "x": [1.0], "r": [1], "s": [2]},
    }[case]
    _both_raise(pair, lambda c: c.append_rows("t", rows),
                JaxSchemaMismatch, SchemaMismatch)


@pytest.mark.parametrize("rows", [
    {"k": ["a"], "x": ["not a number"], "y": [1]},
    {"k": ["a"], "x": [1.0], "y": ["2020-01-01"]},
    {"k": [1.5], "x": [1.0], "y": [True]},
    {"k": ["a"], "x": ["2.5"], "y": ["zz"]},
])
def test_values_cast_as_the_reference_casts(rows):
    """A value of another type casts to the column's type as in the JAX
    package (a string that does not parse becomes NULL)."""
    pair = Pair(t=_tiny())
    pair.append("t", rows)
    pair.same("SELECT * FROM t")


def test_append_rows_refusals_are_typed():
    pair = Pair(t=_tiny())
    _both_raise(pair, lambda c: c.append_rows("missing", [(1,)]),
                JaxUserError, UserError)
    _both_raise(pair, lambda c: c.append_rows("t", 42),
                JaxUserError, UserError)
    pair.run("CREATE VIEW lazyv AS SELECT k FROM t")
    _both_raise(pair, lambda c: c.append_rows("lazyv", [("a",)]),
                JaxUserError, UserError)
    pair.run("CREATE MATERIALIZED VIEW matv AS SELECT k FROM t")
    msg = _both_raise(pair, lambda c: c.append_rows("matv", [("a",)]),
                      JaxUserError, UserError)
    assert "materialized view" in msg
    pair.create("big", pd.DataFrame({"a": np.arange(100)}), chunked=True,
                batch_rows=32)
    _both_raise(pair, lambda c: c.append_rows("big", [(1,)]),
                JaxUserError, UserError)
    # an empty batch appends nothing (the JAX package's pandas path
    # fails on an empty list of tuples)
    assert pair.p.append_rows("t", []) == 0


def test_insert_into_forms():
    pair = Pair(t=_tiny(), src=pd.DataFrame({"k": ["s1", "s2"],
                                             "x": [0.5, 0.25],
                                             "y": [7, 8]}))
    pair.run("INSERT INTO t VALUES ('d', 4.0, 4), ('e', NULL, 5)")
    pair.run("INSERT INTO t SELECT * FROM src WHERE y > 7")
    pair.run("INSERT INTO t (SELECT k, x, y FROM src)")
    pair.run("INSERT INTO t (x, k) VALUES (9.5, 'q')")
    pair.run("INSERT INTO t (y) SELECT y FROM src")
    pair.same("SELECT * FROM t")
    got = pair.same("SELECT y FROM t WHERE k = 'q'")
    assert got["y"].isna().all()


def test_insert_into_refusals():
    pair = Pair(t=_tiny())
    _both_raise(pair, lambda c: c.sql("INSERT INTO t (nope) VALUES (1)"),
                JaxUserError, UserError)
    _both_raise(pair, lambda c: c.sql("INSERT INTO t (k, x) VALUES (1)"),
                JaxUserError, UserError)
    _both_raise(pair, lambda c: c.sql("INSERT INTO nope VALUES (1)"),
                JaxUserError, UserError)


def test_append_bumps_epoch_and_refreshes_statistics():
    c = Context(device=CPU)
    c.create_table("t", _tiny())
    e0 = c.table_epoch("root", "t")
    c.append_rows("t", {"k": np.array(["z"], dtype=object),
                        "x": np.array([100.0]), "y": np.array([9])})
    assert c.table_epoch("root", "t") > e0
    entry = c.schema["root"].tables["t"]
    assert entry.stats.rows == 4
    assert entry.stats.col("x").max == 100.0
    assert c.sql("SELECT MAX(x) AS m FROM t").to_pylist() == [[100.0]]


def test_append_rows_takes_a_table_on_another_device_layout():
    """A ``Table`` batch (a query's result) appends column for column;
    its names decide the alignment as a dict's would."""
    c = Context(device=CPU)
    c.create_table("t", _tiny())
    batch = c.sql("SELECT y, k, x FROM t WHERE y > 1")
    assert isinstance(batch, Table)
    assert c.append_rows("t", batch) == 2
    got = c.sql("SELECT k, x, y FROM t ORDER BY y, k").to_pylist()
    assert got == [["a", 1.0, 1], ["b", 2.0, 2], ["b", 2.0, 2],
                   ["a", 3.0, 3], ["a", 3.0, 3]]


def test_concurrent_appends_lose_no_rows():
    """More writer threads than cores, switching often: the per-table
    append lock keeps every batch (a lost read-concat-swap drops one)."""
    import threading

    c = Context(device=CPU)
    c.create_table("t", _tiny())
    errors = []
    n_threads = (os.cpu_count() or 1) + 4

    def writer(tid):
        try:
            for i in range(4):
                c.append_rows("t", [(f"w{tid}b{i}", float(i), i)])
        except Exception as e:   # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=writer, args=(t,))
               for t in range(n_threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert not errors
    assert c.sql("SELECT COUNT(*) AS n FROM t").to_pylist() == [
        [3 + 4 * n_threads]]


_NO_PANDAS = """
import sys
sys.modules["pandas"] = None          # the card's machine has no pandas
import json
import numpy as np
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.runtime import ingest

c = Context(device="cpu")
c.create_table("t", {"k": np.array(["a", "b"], dtype=object),
                     "x": np.array([1.5, 2.0]),
                     "d": np.array(["2020-01-01", "NaT"],
                                   dtype="datetime64[us]")})
c.append_rows("t", {"k": np.array(["c"], dtype=object),
                    "x": np.array([3.0]),
                    "d": np.array(["2021-01-01"], dtype="datetime64[us]")})
c.append_rows("t", [("e", None, None)])
c.sql("INSERT INTO t VALUES ('f', 4.5, TIMESTAMP '2022-02-02 00:00:00')")
c.sql("INSERT INTO t (k) VALUES ('g')")
c.sql("CREATE MATERIALIZED VIEW v AS SELECT k, SUM(x) AS s FROM t GROUP BY k")
c.append_rows("t", [("a", 10.0, None)])
view = sorted(c.sql("SELECT * FROM v").to_pylist(), key=str)
stats = c.sql("ANALYZE TABLE t COMPUTE STATISTICS FOR ALL COLUMNS").to_pylist()
t = c.schema["root"].tables["t"].table
wire = ingest._decode_table(json.loads(json.dumps(ingest._encode_table(t))))
c.create_table("u", t.slice(0, 0))
c.append_rows("u", wire)
print(json.dumps({"rows": c.sql("SELECT COUNT(*) FROM t").to_pylist(),
                  "view": view, "stats": stats[0],
                  "replay": c.sql("SELECT COUNT(*) FROM u").to_pylist(),
                  "pandas": sys.modules.get("pandas") is None}, default=str))
"""


def test_write_path_runs_without_pandas():
    """append_rows (numpy dicts and tuples), INSERT INTO, a maintained
    view, ANALYZE TABLE and the WAL's encoder and decoder in a process
    where ``import pandas`` fails, as on the card's machine."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DSQL_INGEST")}
    env.update(DSQL_TIERED="0", CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", _NO_PANDAS], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["rows"] == [[7]] and got["replay"] == [[7]]
    assert got["view"] == [["a", 11.5], ["b", 2.0], ["c", 3.0], ["e", None],
                           ["f", 4.5], ["g", None]]
    assert got["stats"] == ["count", "7", "5.0", "3"]
    assert got["pandas"]
