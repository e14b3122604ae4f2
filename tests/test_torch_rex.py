"""The port's rex operators against the JAX package, query by query.

Each query runs through the JAX package's ``Context`` and through the
port's ``Context(device="cpu")`` on the same table, carried across by
``convert.py`` (same codes, same dictionaries); the answers must be equal:
ints, strings and NULLs exact, doubles rtol 1e-12.

Two faults of the port are pinned here: integer ``%`` / ``MOD`` with a
scalar operand raised (``torch.abs`` of a Python int), and an integer
divided by zero raised on the CPU; the JAX package answers both, with 0
for a zero divisor.
"""
import numpy as np
import pandas as pd
import pytest
import torch

from dask_sql_tpu import Context as JaxContext
from dask_sql_tpu_torch import Context, convert

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def contexts():
    rng = np.random.RandomState(3)
    n = 40
    t = pd.DataFrame({
        "i": pd.array([5, -7, 0, None, 13, -1, 7, -14] * 5, dtype="Int64"),
        "k": pd.array([2, 0, 3, 0, None, -4, 7, 1] * 5, dtype="Int64"),
        "f": rng.randn(n) * 10,
        "s": rng.choice(["apple pie", "banana_split", "cherry%tart", "date",
                         "Apple", "green apple", "elder"], n),
        "ns": pd.array(rng.choice(["x", "y", None], n), dtype=object),
        "d": pd.to_datetime("1995-01-01") + pd.to_timedelta(
            rng.randint(0, 1500, n), unit="D"),
        "ts": pd.to_datetime("1999-12-31 23:00") + pd.to_timedelta(
            rng.randint(0, 10**6, n), unit="s"),
        "p": rng.choice(["13-555", "31-777", "29-111", "17-000"], n),
        "g": rng.randint(0, 4, n),
    })
    jc, pc = JaxContext(), Context(device=CPU)
    jc.create_table("t", t)
    jt = jc.schema["root"].tables["t"].table
    specs = [(name, str(c.stype), np.asarray(c.data),
              None if c.mask is None else np.asarray(c.mask), c.dictionary)
             for name, c in zip(jt.names, jt.columns)]
    pc.create_table("t", convert.table_from_columns(specs, CPU))
    return jc, pc


def _same(contexts, sql):
    jc, pc = contexts
    got = pc.sql(sql, return_futures=False)
    want = jc.sql(sql, return_futures=False)
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for col in want.columns:
        g, w = got[col].to_numpy(), want[col].to_numpy()
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g.astype(np.float64), w, rtol=1e-12,
                                       equal_nan=True, err_msg=col)
        else:
            assert [str(x) for x in g] == [str(x) for x in w], col
    return got


# F1: % and MOD with a scalar on either side, and modulo zero
@pytest.mark.parametrize("expr", ["i % 7", "MOD(i, 7)", "7 % i", "k % 0",
                                  "i % k", "-7 % 3", "f % 3"])
def test_modulo_matches_jax(contexts, expr):
    _same(contexts, f"SELECT {expr} AS r FROM t")


# F2: integer division by zero gives 0; float division stays IEEE
@pytest.mark.parametrize("expr", ["i / 0", "i / k", "k / 2", "-7 / 2",
                                  "f / 0", "f / k"])
def test_division_matches_jax(contexts, expr):
    _same(contexts, f"SELECT {expr} AS r FROM t")


def test_integer_division_by_zero_is_zero(contexts):
    got = _same(contexts, "SELECT i / k AS q, k % 0 AS m FROM t")
    assert got["q"].tolist()[:4] == [2, 0, 0, None]
    assert got["m"].dropna().eq(0).all()


@pytest.mark.parametrize("pred", [
    "s LIKE '%apple%'", "s NOT LIKE '%apple%'", "s LIKE '_pple%'",
    "s LIKE 'banana\\_%' ESCAPE '\\'", "s LIKE '%!%%' ESCAPE '!'",
    "s LIKE 'date'", "s ILIKE 'APPLE%'", "ns LIKE 'x%'",
])
def test_like_matches_jax(contexts, pred):
    _same(contexts, f"SELECT s, ns FROM t WHERE {pred}")


@pytest.mark.parametrize("expr", [
    "g IN (1, 3)", "g NOT IN (0, 2)", "s IN ('date', 'elder')",
    "ns IN ('x', NULL)", "ns NOT IN ('x')", "i IN (5, NULL, -1)",
])
def test_in_list_matches_jax(contexts, expr):
    _same(contexts, f"SELECT {expr} AS r FROM t")


@pytest.mark.parametrize("expr", [
    "EXTRACT(YEAR FROM d)", "EXTRACT(MONTH FROM d)", "EXTRACT(DAY FROM d)",
    "EXTRACT(YEAR FROM ts)", "EXTRACT(HOUR FROM ts)", "EXTRACT(DOW FROM d)",
    "EXTRACT(QUARTER FROM d)",
])
def test_extract_matches_jax(contexts, expr):
    _same(contexts, f"SELECT {expr} AS r FROM t")


@pytest.mark.parametrize("expr", [
    "SUBSTRING(p FROM 1 FOR 2)", "SUBSTRING(s FROM 3 FOR 4)",
    "SUBSTRING(s FROM 0 FOR 3)", "SUBSTRING(s FROM 2)",
])
def test_substring_matches_jax(contexts, expr):
    _same(contexts, f"SELECT {expr} AS r FROM t")


def test_substring_in_list_groups(contexts):
    """The Q22 shape: a SUBSTRING key filtered by an IN list, grouped."""
    _same(contexts, "SELECT SUBSTRING(p FROM 1 FOR 2) AS cc, COUNT(*) AS n "
                    "FROM t WHERE SUBSTRING(p FROM 1 FOR 2) IN ('13', '31') "
                    "GROUP BY SUBSTRING(p FROM 1 FOR 2) ORDER BY cc")


@pytest.mark.parametrize("expr", ["COALESCE(i, k, 0)", "COALESCE(ns, s)",
                                  "COALESCE(k, 99)", "COALESCE(NULL, f)"])
def test_coalesce_matches_jax(contexts, expr):
    _same(contexts, f"SELECT {expr} AS r FROM t")


@pytest.mark.parametrize("sql", [
    "SELECT g, COUNT(DISTINCT s) AS c, SUM(DISTINCT k) AS sk FROM t "
    "GROUP BY g ORDER BY g",
    "SELECT COUNT(DISTINCT ns) AS c, COUNT(DISTINCT i) AS ci FROM t",
    "SELECT g, COUNT(DISTINCT i) FILTER (WHERE f > 0) AS c FROM t "
    "GROUP BY g ORDER BY g",
])
def test_count_distinct_matches_jax(contexts, sql):
    _same(contexts, sql)


def test_dictionary_substring_matches_per_entry():
    """The vectorized dictionary slice gives what ``_substring`` gives
    entry by entry, for any characters (UCS-4) and every start/length."""
    from dask_sql_tpu_torch.physical.rex.ops import _substring, substring_dict

    rng = np.random.RandomState(8)
    alphabet = list("ab-7 Zé漢😀")
    d = np.array(["".join(rng.choice(alphabet, rng.randint(0, 9)))
                  for _ in range(300)] + [""], dtype=str)
    for start in (1, 2, 5, 9, 12):
        for length in (None, 0, 1, 3, 20):
            got = substring_dict(d, start, length)
            want = [_substring(x, start, length) for x in d.tolist()]
            assert got.tolist() == want, (start, length)
    assert substring_dict(d, 0, 3) is None and substring_dict(d, 2, -1) is None
