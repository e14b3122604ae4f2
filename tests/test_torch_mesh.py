"""``Context(mesh=...)`` on the single-device tiers, on the CPU (a mesh of 8
CPU shards), with the SPMD executor off: ``tests/conftest.py`` pins
``DSQL_MESH=0`` for this module, as for the JAX package's
``tests/integration/test_tpch_mesh.py``.

- TPC-H Q1-Q22 at SF 0.01: the compiled tier serves every query over the
  padded mesh tables with no fallback, each answer equal to the
  single-device context's (the port's ``test_tpch_on_mesh_matches_
  single_device``), and a mesh program is never served to a context
  without the mesh;
- COUNT(*) ignores the padding rows, and the statistics count the valid
  rows only (``collect_table_stats(table, row_valid)``), as the JAX
  package's do;
- streaming x mesh (each batch row-sharded), append x mesh (the valid
  prefix concatenated and sharded again) and the delta-join refusal under
  a mesh, against the JAX package's answers and reasons (its
  ``Context(mesh=)`` on the 8-device CPU mesh).
"""
import numpy as np
import pandas as pd
import pytest
import torch

from benchmarks.tpch import QUERIES, generate_tpch
from dask_sql_tpu import Context as JaxContext
from dask_sql_tpu.parallel.mesh import default_mesh
from dask_sql_tpu.runtime import matview as jax_mv
from dask_sql_tpu.runtime import statistics as jax_stats
from dask_sql_tpu.sql.parser import parse_sql as jax_parse
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.parallel.mesh import Mesh
from dask_sql_tpu_torch.physical import compiled
from dask_sql_tpu_torch.runtime import matview as port_mv
from dask_sql_tpu_torch.runtime import statistics as port_stats
from dask_sql_tpu_torch.sql.parser import parse_sql

N_DEV = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several workers on one machine: torch's intra-op
    # threads on every core in each would oversubscribe it
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def pmesh():
    return Mesh(["cpu"] * N_DEV)


@pytest.fixture(scope="module")
def jmesh():
    m = default_mesh()
    if m.devices.size != N_DEV:
        pytest.skip("needs the 8-device virtual CPU mesh")
    return m


@pytest.fixture(scope="module")
def contexts(pmesh):
    data = generate_tpch(0.01, seed=11)
    plain, dist = Context(device="cpu"), Context(mesh=pmesh)
    for name, frame in data.items():
        plain.create_table(name, frame)
        dist.create_table(name, frame)
    return plain, dist


def _assert_same(got: pd.DataFrame, want: pd.DataFrame, ordered: bool,
                 rtol: float = 1e-9):
    got, want = got.reset_index(drop=True), want.reset_index(drop=True)
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    if not ordered:
        cols = list(want.columns)
        got = got.sort_values(cols, ignore_index=True)
        want = want.sort_values(cols, ignore_index=True)
    for col in want.columns:
        g, w = got[col], want[col]
        assert (g.isna().to_numpy() == w.isna().to_numpy()).all(), col
        live = ~w.isna().to_numpy()
        if pd.api.types.is_float_dtype(w):
            np.testing.assert_allclose(g.to_numpy(dtype=float)[live],
                                       w.to_numpy(dtype=float)[live],
                                       rtol=rtol, err_msg=col)
        else:
            assert [str(x) for x in g[live]] == [str(x) for x in w[live]], col


@pytest.mark.parametrize("qid", sorted(QUERIES))
def test_tpch_on_mesh_matches_single_device(contexts, qid):
    plain, dist = contexts
    q = QUERIES[qid]
    want = plain.sql(q, return_futures=False)
    before = compiled.stats["compiles"] + compiled.stats["hits"]
    before_fb = compiled.stats["fallbacks"]
    got = dist.sql(q, return_futures=False)
    # the compiled program is the vehicle: a fallback here would mean the
    # mesh path ran eager on the padded tables
    assert compiled.stats["compiles"] + compiled.stats["hits"] > before
    assert compiled.stats["fallbacks"] == before_fb
    _assert_same(got, want, "ORDER BY" in q)


def test_mesh_signature_keys_programs(contexts, pmesh):
    plain, dist = contexts
    assert compiled._mesh_signature(plain) == "cpu"
    assert compiled._mesh_signature(dist) == "cpu|" + pmesh.signature()
    other = Context(mesh=Mesh(["cpu"] * 4))
    assert compiled._mesh_signature(other) != compiled._mesh_signature(dist)


def _padded_frame(n: int) -> pd.DataFrame:
    rng = np.random.RandomState(n)
    v = np.round(rng.rand(n), 6)
    v[::5] = np.nan
    k = pd.array(rng.randint(0, 6, n), dtype="Int64")
    k[::4] = pd.NA
    return pd.DataFrame({"k": k, "v": v,
                         "g": rng.choice(["p", "q", "r"], n),
                         "i": rng.randint(-1000, 1000, n).astype(np.int64)})


@pytest.fixture(scope="module")
def small_pair(jmesh, pmesh):
    df = _padded_frame(8 * N_DEV + 3)
    j, p = JaxContext(mesh=jmesh), Context(mesh=pmesh)
    j.create_table("t", df)
    p.create_table("t", df)
    return j, p, df


def test_count_ignores_padding(small_pair):
    j, p, df = small_pair
    sql = ("SELECT COUNT(*) AS n, COUNT(k) AS nk, SUM(v) AS s, MIN(i) AS lo "
           "FROM t")
    got = p.sql(sql, return_futures=False)
    assert int(got["n"][0]) == len(df)
    assert int(got["nk"][0]) == int(df["k"].notna().sum())
    _assert_same(got, j.sql(sql, return_futures=False), True)
    sql = "SELECT g, COUNT(*) AS n, AVG(v) AS a FROM t GROUP BY g"
    _assert_same(p.sql(sql, return_futures=False),
                 j.sql(sql, return_futures=False), False)


def test_statistics_count_valid_rows_only(small_pair):
    j, p, df = small_pair
    pe = p.schema["root"].tables["t"]
    je = j.schema["root"].tables["t"]
    assert pe.row_valid is not None and je.row_valid is not None
    ps, js = pe.stats, je.stats
    assert ps.rows == js.rows == len(df)
    assert set(ps.cols) == set(js.cols)
    for name, jc in js.cols.items():
        pc = ps.cols[name]
        assert (pc.ndv, pc.min, pc.max, pc.is_int, pc.dense, pc.domain) == \
            (jc.ndv, jc.min, jc.max, jc.is_int, jc.dense, jc.domain), name
        assert pc.null_frac == pytest.approx(jc.null_frac, rel=1e-12)
    # the function itself, on the padded table with and without row_valid
    full = port_stats.collect_table_stats(pe.table)
    assert full.rows == pe.table.num_rows > ps.rows
    again = jax_stats.collect_table_stats(je.table, row_valid=je.row_valid)
    assert again.rows == port_stats.collect_table_stats(
        pe.table, row_valid=pe.row_valid).rows


def test_streaming_on_mesh_matches_jax(jmesh, pmesh):
    df = _padded_frame(301)
    j, p = JaxContext(mesh=jmesh), Context(mesh=pmesh)
    for c in (j, p):
        c.create_table("t", df, chunked=True, batch_rows=100)
    resident = Context(device="cpu")
    resident.create_table("t", df)
    for sql in ("SELECT g, COUNT(*) AS n, SUM(v) AS s, MAX(i) AS hi "
                "FROM t GROUP BY g",
                "SELECT SUM(i * v) AS r, COUNT(k) AS n FROM t "
                "WHERE v > 0.2 AND i < 500"):
        got = p.sql(sql, return_futures=False)
        _assert_same(got, j.sql(sql, return_futures=False), False)
        _assert_same(got, resident.sql(sql, return_futures=False), False)
    # the batch table of a mesh context is sharded: 100 rows pad to 104
    from dask_sql_tpu_torch.physical import streaming as S
    from dask_sql_tpu_torch.table import Table

    batch = Table.from_pandas(df.head(100), torch.device("cpu"))
    rv = torch.arange(100) < 97
    S._set_batch_entry(p, batch, rv)
    entry = p.schema[S.STREAM_SCHEMA].tables[S.BATCH_TABLE]
    assert entry.table.num_rows == 104
    assert entry.row_valid.tolist() == [True] * 97 + [False] * 7
    S._cleanup(p)


def test_append_on_mesh_matches_jax(jmesh, pmesh):
    df = _padded_frame(8 * N_DEV + 1)
    j, p = JaxContext(mesh=jmesh), Context(mesh=pmesh)
    for c in (j, p):
        c.create_table("t", df)
    rng = np.random.RandomState(3)
    for n in (5, 7):   # 65 -> 70 -> 77 rows: padding changes each time
        rows = {"k": rng.randint(0, 6, n), "v": np.round(rng.rand(n), 6),
                "g": rng.choice(["p", "s"], n),
                "i": rng.randint(-10, 10, n)}
        assert p.append_rows("t", rows) == j.append_rows(
            "t", pd.DataFrame(rows)) == n
    pe = p.schema["root"].tables["t"]
    je = j.schema["root"].tables["t"]
    assert pe.table.num_rows == je.table.num_rows == 80
    assert pe.stats.rows == je.stats.rows == 77
    assert pe.row_valid.tolist() == np.asarray(je.row_valid).tolist()
    for sql in ("SELECT COUNT(*) AS n, SUM(i) AS si, SUM(v) AS sv FROM t",
                "SELECT g, COUNT(*) AS n, MIN(v) AS lo FROM t GROUP BY g",
                "SELECT k, SUM(i) AS s FROM t GROUP BY k"):
        _assert_same(p.sql(sql, return_futures=False),
                     j.sql(sql, return_futures=False), False)


@pytest.mark.parametrize("n,needle", [
    (8 * N_DEV + 2, "validity-masked (mesh-padded) base"),
    (8 * N_DEV, "mesh-sharded bases reshard on append"),
])
def test_delta_join_refused_under_mesh(jmesh, pmesh, n, needle):
    rng = np.random.RandomState(n)
    t1 = pd.DataFrame({"k": rng.randint(0, 9, n).astype(np.int64),
                       "x": rng.rand(n)})
    t2 = pd.DataFrame({"k": np.arange(N_DEV, dtype=np.int64),
                       "y": np.arange(N_DEV) * 1.5})
    j, p = JaxContext(mesh=jmesh), Context(mesh=pmesh)
    for c in (j, p):
        c.create_table("t1", t1)
        c.create_table("t2", t2)
    sql = "SELECT a.k, a.x, b.y FROM t1 a JOIN t2 b ON a.k = b.k"
    js, jr = jax_mv._analyze(j._get_plan(jax_parse(sql)[0].query, sql), j)
    ps, pr = port_mv._analyze(p._get_plan(parse_sql(sql)[0].query, sql), p)
    assert js is None and ps is None
    assert pr == jr
    assert needle in pr
