"""The first slice end to end: SELECT ... GROUP BY through the port's
``Context`` against the JAX package's ``Context`` on the same data.

The port's tables are carried across from the JAX catalog by ``convert.py``
(same dictionaries, same codes).  Tolerances: strings, ints and counts
exact; doubles rtol 1e-12, since the JAX package on the CPU sums by scatter
in another order (and the port's static route sums on the exact limb grid).
"""
import numpy as np
import pandas as pd
import pytest
import torch

from benchmarks.tpch import QUERIES, generate_tpch
from dask_sql_tpu import Context as JaxContext
from dask_sql_tpu_torch import Context, convert
from dask_sql_tpu_torch.physical.rel import executor as port_executor

CPU = torch.device("cpu")


def _carry(jc: JaxContext, pc: Context, name: str) -> None:
    jt = jc.schema["root"].tables[name].table
    specs = [(n, str(c.stype), np.asarray(c.data),
              None if c.mask is None else np.asarray(c.mask), c.dictionary)
             for n, c in zip(jt.names, jt.columns)]
    pc.create_table(name, convert.table_from_columns(specs, CPU))


def _contexts(tables: dict):
    jc, pc = JaxContext(), Context(device=CPU)
    for name, df in tables.items():
        jc.create_table(name, df)
        _carry(jc, pc, name)
    return jc, pc


def _assert_same(got: pd.DataFrame, want: pd.DataFrame):
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for col in want.columns:
        g, w = got[col].to_numpy(), want[col].to_numpy()
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g.astype(np.float64), w, rtol=1e-12,
                                       err_msg=col)
        else:
            assert g.tolist() == w.tolist(), col


@pytest.fixture
def static_calls(monkeypatch):
    """Counts calls of the static-domain reduction from either executor:
    the compiled tier (through ``gpu_kernels``) or the eager one."""
    from dask_sql_tpu_torch.ops import gpu_kernels

    calls = []
    real = port_executor.segmented_sums_dispatch

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(port_executor, "segmented_sums_dispatch", spy)
    monkeypatch.setattr(gpu_kernels, "segmented_sums_dispatch", spy)
    return calls


@pytest.fixture(scope="module")
def tpch_li():
    return {"lineitem": generate_tpch(0.002, seed=1)["lineitem"]}


@pytest.mark.parametrize("q", [1, 6])
def test_tpch_matches_jax(tpch_li, q, static_calls):
    jc, pc = _contexts(tpch_li)
    got = pc.sql(QUERIES[q], return_futures=False)
    want = jc.sql(QUERIES[q], return_futures=False)
    _assert_same(got, want)
    # Q1 takes the static-domain route (17 value rows), Q6 has no GROUP BY
    assert [shape[0] for shape in static_calls] == ([17] if q == 1 else [])
    assert len(got) == (4 if q == 1 else 1)


def test_q1_matches_jax_fixedpoint_kernel(tpch_li, monkeypatch):
    """With DSQL_PALLAS=force the JAX package runs its limb kernel too: the
    unit/int aggregates (COUNT) are bit-identical, the doubles 1e-12."""
    monkeypatch.setenv("DSQL_PALLAS", "force")
    jc, pc = _contexts(tpch_li)
    got = pc.sql(QUERIES[1], return_futures=False)
    want = jc.sql(QUERIES[1], return_futures=False)
    _assert_same(got, want)
    assert got["count_order"].tolist() == want["count_order"].tolist()


@pytest.fixture(scope="module")
def small_tables():
    rng = np.random.RandomState(0)
    n = 3000
    li = pd.DataFrame({
        "rf": rng.choice(["A", "N", "R"], n),
        "ls": rng.choice(["O", "F"], n),
        "qty": rng.rand(n) * 50,
        "price": rng.rand(n) * 1000,
        "disc": rng.rand(n) * 0.1,
        "iq": rng.randint(-1000, 1000, n),
        "flag": rng.rand(n) > 0.5,
    })
    t = pd.DataFrame({"k": ["a", None, "b", "a", None, "b", "a"],
                      "ik": [3, 1, 2, 3, 1, 2, 5],
                      "v": [1.0, 2.0, None, 4.0, 5.0, 6.0, 7.0],
                      "big": [2**53, 2**53 + 2, 5, -7, 1, 2, 3]})
    return {"li": li, "t": t}


_STATIC = {
    "where": "SELECT rf, ls, SUM(qty) AS sq, SUM(price) AS sp, AVG(disc) AS ad, "
             "COUNT(*) AS n FROM li WHERE qty < 40 GROUP BY rf, ls "
             "ORDER BY rf, ls",
    "nullable_key": "SELECT k, SUM(v) AS s, COUNT(v) AS n, AVG(v) AS a "
                    "FROM t GROUP BY k",
    "int_values": "SELECT ls, SUM(iq) AS s, AVG(iq) AS a, COUNT(iq) AS c "
                  "FROM li GROUP BY ls ORDER BY ls",
    "bool_key": "SELECT flag, rf, SUM(price) AS s FROM li WHERE disc > 0.05 "
                "GROUP BY flag, rf ORDER BY flag, rf",
}


@pytest.mark.parametrize("name", list(_STATIC))
def test_static_domain_queries_match_jax(small_tables, name, static_calls):
    jc, pc = _contexts(small_tables)
    _assert_same(pc.sql(_STATIC[name], return_futures=False),
                 jc.sql(_STATIC[name], return_futures=False))
    assert len(static_calls) == 1


_GENERIC = {
    # an integer key has no static domain: hash group codes
    "int_key": "SELECT ik, SUM(v) AS s, COUNT(*) AS n, AVG(v) AS a, "
               "MIN(v) AS lo, MAX(k) AS hk FROM t GROUP BY ik ORDER BY ik",
    # an int row reaching 2**53: the static route's exactness bound fails
    "int_2_53": "SELECT k, SUM(big) AS s, COUNT(*) AS n FROM t GROUP BY k "
                "ORDER BY k NULLS FIRST",
    # MIN is not a static-route aggregate
    "min_agg": "SELECT rf, MIN(qty) AS m, SUM(price) AS s FROM li GROUP BY rf "
               "ORDER BY rf DESC",
}


@pytest.mark.parametrize("name", list(_GENERIC))
def test_generic_group_by_matches_jax(small_tables, name, static_calls,
                                      monkeypatch):
    jc, pc = _contexts(small_tables)
    want = jc.sql(_GENERIC[name], return_futures=False)
    # the compiled tier (int_2_53: the program's 2**53 flag sends the query
    # to the eager executor after the static reduction ran in it)
    _assert_same(pc.sql(_GENERIC[name], return_futures=False), want)
    static_calls.clear()
    # the eager executor decides before it reduces: no static route
    monkeypatch.setenv("DSQL_COMPILE", "0")
    _assert_same(pc.sql(_GENERIC[name], return_futures=False), want)
    assert static_calls == []


_SCALAR = {
    "case_cast": "SELECT CASE WHEN v > 2 THEN 'big' WHEN v IS NULL THEN 'none' "
                 "ELSE 'small' END AS c, CAST(v AS INTEGER) AS i, v / 2 AS h, "
                 "ik * 2 - 1 AS j FROM t WHERE k IS NOT NULL OR NOT (v <> 5)",
    "three_valued": "SELECT k, v, (v > 3) AND (k = 'a') AS a, "
                    "(v > 3) OR (k = 'b') AS o FROM t ORDER BY ik, v",
    "whole_table": "SELECT SUM(v) AS s, COUNT(v) AS c, COUNT(*) AS n, "
                   "AVG(v) AS a, MIN(k) AS mk, MAX(ik) AS mx FROM t",
    "limit": "SELECT ik, v FROM t ORDER BY v DESC NULLS LAST LIMIT 3 OFFSET 1",
    "dates": "SELECT COUNT(*) AS n FROM lineitem WHERE l_shipdate "
             "BETWEEN DATE '1994-01-01' AND DATE '1994-01-01' + INTERVAL '1' YEAR",
}


@pytest.mark.parametrize("name", list(_SCALAR))
def test_scalar_operators_match_jax(small_tables, tpch_li, name):
    jc, pc = _contexts({**small_tables, **tpch_li})
    _assert_same(pc.sql(_SCALAR[name], return_futures=False),
                 jc.sql(_SCALAR[name], return_futures=False))


def test_unported_operator_names_itself(small_tables):
    """A row UDF (fed pandas rows in the JAX package) is not ported: the
    query raises and names it."""
    _, pc = _contexts(small_tables)
    pc.register_function(lambda row: row["a0"], "row_identity",
                         [("x", np.float64)], np.float64, row_udf=True)
    with pytest.raises(NotImplementedError, match="row_identity"):
        pc.sql("SELECT row_identity(v) FROM t")
