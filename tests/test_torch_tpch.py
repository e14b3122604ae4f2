"""TPC-H Q1-Q22 through the port's ``Context(device="cpu")``.

Every query is held to the sqlite oracle, as ``tests/integration/test_tpch.py``
holds the JAX package (same data, same dialect rewrites, same rules: row
count exact, doubles rtol 1e-6, everything else as strings, unordered
results sorted).  Q4, Q13 and Q16 (semi join, left join with a residual,
anti join with COUNT(DISTINCT)) are also held to the JAX package's
``Context`` on the same carried-across tables: ints and strings exact,
doubles rtol 1e-12.  Only those three, because the JAX package's eager CPU
run takes seconds per query.
"""
import re
import sqlite3

import numpy as np
import pandas as pd
import pytest
import torch

from benchmarks.tpch import QUERIES, generate_tpch
from dask_sql_tpu import Context as JaxContext
from dask_sql_tpu_torch import Context, convert
from dask_sql_tpu_torch.ops import gpu_kernels as gk

SF = 0.003
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def tpch_data():
    return generate_tpch(SF)


@pytest.fixture(scope="module")
def port_ctx(tpch_data):
    ctx = Context(device=CPU)
    for name, df in tpch_data.items():
        ctx.create_table(name, df)
    return ctx


@pytest.fixture(scope="module")
def sqlite_conn(tpch_data):
    conn = sqlite3.connect(":memory:")
    for name, df in tpch_data.items():
        sdf = df.copy()
        for col in sdf.columns:
            if sdf[col].dtype.kind == "M":
                sdf[col] = sdf[col].dt.strftime("%Y-%m-%d")
        sdf.to_sql(name, conn, index=False)
        for col in sdf.columns:
            if col.endswith("key"):   # changes no answer; Q21 needs it to be quick
                conn.execute(f"CREATE INDEX {col}_idx ON {name} ({col})")
    yield conn
    conn.close()


def _to_sqlite(q: str) -> str:
    q = q.replace("DATE '", "'")
    q = re.sub(r"SUBSTRING\(\s*(\w+)\s+FROM\s+(\d+)\s+FOR\s+(\d+)\s*\)",
               r"substr(\1, \2, \3)", q)
    q = re.sub(r"EXTRACT\(\s*YEAR\s+FROM\s+(\w+)\s*\)",
               r"CAST(strftime('%Y', \1) AS INTEGER)", q)
    return q


@pytest.mark.parametrize("qid", sorted(QUERIES))
def test_tpch_port_matches_sqlite(port_ctx, sqlite_conn, qid):
    q = QUERIES[qid]
    got = port_ctx.sql(q, return_futures=False).reset_index(drop=True)
    want = pd.read_sql(_to_sqlite(q), sqlite_conn).reset_index(drop=True)
    got.columns = [c.lower() for c in got.columns]
    want.columns = [c.lower() for c in want.columns]
    assert len(got) == len(want), f"Q{qid}: {len(got)} vs {len(want)} rows"
    if "ORDER BY" not in q:
        key = list(got.columns)
        got = got.sort_values(key, ignore_index=True)
        want = want.sort_values(key, ignore_index=True)
    for col in want.columns:
        gv, wv = got[col], want[col]
        if gv.dtype.kind == "M":
            gv = gv.dt.strftime("%Y-%m-%d")
        if gv.dtype.kind in "fc" or wv.dtype.kind in "fc":
            np.testing.assert_allclose(
                pd.to_numeric(gv, errors="coerce").to_numpy(dtype=float),
                pd.to_numeric(wv, errors="coerce").to_numpy(dtype=float),
                rtol=1e-6, err_msg=f"Q{qid} col {col}")
        else:
            assert (gv.astype(str).to_numpy()
                    == wv.astype(str).to_numpy()).all(), f"Q{qid} col {col}"


@pytest.fixture(scope="module")
def both_contexts(tpch_data):
    jc, pc = JaxContext(), Context(device=CPU)
    for name, df in tpch_data.items():
        jc.create_table(name, df)
        jt = jc.schema["root"].tables[name].table
        specs = [(n, str(c.stype), np.asarray(c.data),
                  None if c.mask is None else np.asarray(c.mask), c.dictionary)
                 for n, c in zip(jt.names, jt.columns)]
        pc.create_table(name, convert.table_from_columns(specs, CPU))
    return jc, pc


@pytest.mark.parametrize("qid", [4, 13, 16])
def test_tpch_port_matches_jax(both_contexts, qid):
    jc, pc = both_contexts
    got = pc.sql(QUERIES[qid], return_futures=False)
    want = jc.sql(QUERIES[qid], return_futures=False)
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want) > 0
    for col in want.columns:
        g, w = got[col].to_numpy(), want[col].to_numpy()
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g.astype(np.float64), w, rtol=1e-12,
                                       err_msg=col)
        else:
            assert g.tolist() == w.tolist(), col


@pytest.mark.parametrize("qid,static", [(4, True), (5, True), (12, True),
                                        (3, False)])
def test_joined_dictionary_keys_take_static_route(port_ctx, monkeypatch, qid,
                                                  static):
    """Joined results keep dictionary-encoded keys, so Q4, Q5 and Q12 group
    through the static-domain reduction (kernel 1 on the card), in the
    compiled tier (through ``gpu_kernels``) as in the eager executor; Q3
    groups by integer keys and takes the hash path."""
    from dask_sql_tpu_torch.physical.rel import executor as ex

    calls = []
    real = ex.segmented_sums_dispatch

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(ex, "segmented_sums_dispatch", spy)
    monkeypatch.setattr(gk, "segmented_sums_dispatch", spy)
    port_ctx.sql(QUERIES[qid])
    assert bool(calls) == static
    assert gk.LAUNCHES["segsum_fixedpoint"] == 0   # no launch on the CPU
