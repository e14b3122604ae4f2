"""The port's equi-join primitives against the JAX package's.

``join_key_codes`` and ``join_tables`` of both packages run on the same
seeded tables (the port's carried across by ``convert.py``: same codes,
same dictionaries).  Key codes must be equal, and joined rows must be
equal value for value and in the same order (the pair order of the sort
probe: left rows in order, each left row's matches in right-row order).
Set operations run through both ``Context``s.
"""
import numpy as np
import pandas as pd
import pytest
import torch

from dask_sql_tpu import Context as JaxContext
from dask_sql_tpu.ops import join as jax_join
from dask_sql_tpu.ops import kernels as jax_kernels
from dask_sql_tpu.table import Table as JaxTable
from dask_sql_tpu_torch import Context, convert
from dask_sql_tpu_torch.ops import join as port_join
from dask_sql_tpu_torch.ops import kernels as port_kernels

CPU = torch.device("cpu")


def _pair(df: pd.DataFrame):
    jt = JaxTable.from_pandas(df)
    specs = [(n, str(c.stype), np.asarray(c.data),
              None if c.mask is None else np.asarray(c.mask), c.dictionary)
             for n, c in zip(jt.names, jt.columns)]
    return jt, convert.table_from_columns(specs, CPU)


def _values(table):
    return {n: [None if (isinstance(v, float) and np.isnan(v)) else v
                for v in np.asarray(c.to_numpy()).tolist()]
            for n, c in zip(table.names, table.columns)}


@pytest.fixture(scope="module")
def sides():
    rng = np.random.RandomState(5)
    nl, nr = 300, 200
    left = pd.DataFrame({
        "a": rng.randint(0, 40, nl),
        "b": pd.array(np.where(rng.rand(nl) < 0.1, None,
                               rng.choice(["p", "q", "r", "s"], nl)), dtype=object),
        "x": rng.randn(nl),
        "k": pd.array(np.where(rng.rand(nl) < 0.1, None, rng.randint(0, 30, nl)),
                      dtype="Int64"),
    })
    right = pd.DataFrame({
        "a2": rng.randint(0, 50, nr),
        "b2": rng.choice(["q", "s", "t", "u", "v"], nr),   # another dictionary
        "y": rng.randint(-100, 100, nr),
        "k2": pd.array(np.where(rng.rand(nr) < 0.05, None,
                                rng.randint(0, 30, nr)), dtype="Int64"),
    })
    return _pair(left), _pair(right)


KEYS = {"int": ([0], [0]), "string": ([1], [1]), "multi": ([0, 1], [0, 1]),
        "nullable_int": ([3], [3])}


@pytest.mark.parametrize("keys", sorted(KEYS))
@pytest.mark.parametrize("null_equal", [False, True])
def test_join_key_codes_match_jax(sides, keys, null_equal):
    (jl, pl), (jr, pr) = sides
    lk, rk = KEYS[keys]
    want = jax_kernels.join_key_codes([jl.columns[i] for i in lk],
                                      [jr.columns[i] for i in rk],
                                      null_equal=null_equal)
    got = port_kernels.join_key_codes([pl.columns[i] for i in lk],
                                      [pr.columns[i] for i in rk],
                                      null_equal=null_equal)
    for g, w in zip(got, want):
        assert g.tolist() == np.asarray(w).tolist()


@pytest.mark.parametrize("join_type", ["INNER", "LEFT", "RIGHT", "FULL",
                                       "SEMI", "ANTI"])
@pytest.mark.parametrize("keys", sorted(KEYS))
def test_join_tables_match_jax(sides, join_type, keys):
    (jl, pl), (jr, pr) = sides
    lk, rk = KEYS[keys]
    want, _ = jax_join.join_tables(jl, jr, lk, rk, join_type)
    got, _ = port_join.join_tables(pl, pr, lk, rk, join_type)
    assert got.names == want.names
    assert got.num_rows == want.num_rows > 0
    assert _values(got) == _values(want)


@pytest.mark.parametrize("keys", ["nullable_int", "int"])
def test_null_aware_anti_matches_jax(sides, keys):
    (jl, pl), (jr, pr) = sides
    lk, rk = KEYS[keys]
    # the whole build side, an empty one, and a prefix without NULL keys
    for stop in (jr.num_rows, 0, 5):
        want, _ = jax_join.join_tables(jl, jr.slice(0, stop), lk, rk, "ANTI",
                                       null_aware_anti=True)
        got, _ = port_join.join_tables(pl, pr.slice(0, stop), lk, rk, "ANTI",
                                       null_aware_anti=True)
        assert _values(got) == _values(want)


@pytest.mark.parametrize("join_type", ["INNER", "LEFT", "RIGHT", "FULL",
                                       "SEMI", "ANTI"])
def test_empty_side_matches_jax(sides, join_type):
    (jl, pl), (jr, pr) = sides
    for empty_left in (True, False):
        j_left = jl.slice(0, 0) if empty_left else jl
        p_left = pl.slice(0, 0) if empty_left else pl
        j_right = jr if empty_left else jr.slice(0, 0)
        p_right = pr if empty_left else pr.slice(0, 0)
        want, _ = jax_join.join_tables(j_left, j_right, [0], [0], join_type)
        got, _ = port_join.join_tables(p_left, p_right, [0], [0], join_type)
        assert got.names == want.names
        assert _values(got) == _values(want)


def test_expand_matches_pair_order_matches_jax():
    rng = np.random.RandomState(9)
    lc = rng.randint(-1, 6, 500)
    rc = rng.randint(-1, 6, 300)
    want = jax_join._expand_matches(lc, rc)
    got = port_join._expand_matches(torch.from_numpy(lc), torch.from_numpy(rc))
    for g, w in zip(got, want):
        assert g.tolist() == np.asarray(w).tolist()


def test_concat_merges_dictionaries(sides):
    (_, pl), (_, pr) = sides
    col = port_join.concat_columns([pl.columns[1], pr.columns[1]])
    assert list(col.dictionary) == sorted(set(pl.columns[1].dictionary)
                                          | set(pr.columns[1].dictionary))
    assert col.decode().tolist() == (pl.columns[1].decode().tolist()
                                     + pr.columns[1].decode().tolist())


@pytest.fixture(scope="module")
def set_contexts():
    a = pd.DataFrame({"u": pd.array([1, 2, 2, None, 3, 4, None], dtype="Int64"),
                      "v": ["x", "y", "y", "z", None, "x", "z"]})
    b = pd.DataFrame({"u": pd.array([2, None, 5, 4, 4], dtype="Int64"),
                      "v": ["y", "z", "w", "q", "x"]})
    jc, pc = JaxContext(), Context(device=CPU)
    for name, df in (("a", a), ("b", b)):
        jc.create_table(name, df)
        jt = jc.schema["root"].tables[name].table
        specs = [(n, str(c.stype), np.asarray(c.data),
                  None if c.mask is None else np.asarray(c.mask), c.dictionary)
                 for n, c in zip(jt.names, jt.columns)]
        pc.create_table(name, convert.table_from_columns(specs, CPU))
    return jc, pc


@pytest.mark.parametrize("op", ["UNION", "UNION ALL", "INTERSECT", "EXCEPT"])
def test_set_operations_match_jax(set_contexts, op):
    jc, pc = set_contexts
    sql = f"SELECT u, v FROM a {op} SELECT u, v FROM b"
    got = pc.sql(sql, return_futures=False)
    want = jc.sql(sql, return_futures=False)
    key = lambda df: sorted(map(str, df.itertuples(index=False)))  # noqa: E731
    assert len(got) == len(want) > 0
    assert key(got) == key(want)
