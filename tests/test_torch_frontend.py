"""The port's front end and planner against the JAX package's: for the
slice's queries, ``explain()`` text is identical.  The port plans natively;
the JAX package runs its Python parser and optimizer here: its native
library is switched off for the test by patching the loader's cache, since
``DSQL_NATIVE=0`` is read only on the first load of a process
(``tests/test_torch_native.py`` holds the two native paths together)."""
import numpy as np
import pandas as pd
import pytest
import torch

import dask_sql_tpu.native as jax_native
from dask_sql_tpu import Context as JaxContext
from benchmarks.tpch import QUERIES, generate_tpch
from dask_sql_tpu_torch import Context

_QUERIES = {
    "q1": QUERIES[1],
    "q6": QUERIES[6],
    "static_where": "SELECT rf, ls, SUM(qty) AS sq, SUM(price) AS sp, "
                    "AVG(disc) AS ad, COUNT(*) AS n FROM li WHERE qty < 40 "
                    "GROUP BY rf, ls ORDER BY rf, ls",
    "static_nulls": "SELECT k, SUM(v) AS s, COUNT(v) AS n FROM t GROUP BY k",
    "int_key": "SELECT ik, SUM(v) AS s, MIN(v) AS lo FROM t GROUP BY ik "
               "ORDER BY ik DESC LIMIT 2",
    "case_cast": "SELECT CASE WHEN v > 2 THEN 'big' ELSE 'small' END AS c, "
                 "CAST(v AS INTEGER) AS i FROM t WHERE k IS NOT NULL "
                 "AND NOT (v = 3) OR v IS NULL",
}


@pytest.fixture(scope="module")
def frames():
    rng = np.random.RandomState(0)
    n = 200
    li = pd.DataFrame({"rf": rng.choice(["A", "N", "R"], n),
                       "ls": rng.choice(["O", "F"], n),
                       "qty": rng.rand(n) * 50, "price": rng.rand(n) * 1000,
                       "disc": rng.rand(n) * 0.1})
    t = pd.DataFrame({"k": ["a", None, "b", "a", None, "b", "a"],
                      "ik": [3, 1, 2, 3, 1, 2, 5],
                      "v": [1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0]})
    return {"lineitem": generate_tpch(0.001)["lineitem"], "li": li, "t": t}


@pytest.fixture
def contexts(frames, monkeypatch):
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_load_attempted", True)
    jc, pc = JaxContext(), Context(device=torch.device("cpu"))
    for name, df in frames.items():
        jc.create_table(name, df)
        pc.create_table(name, df)
    return jc, pc


@pytest.mark.parametrize("name", list(_QUERIES))
def test_explain_matches_jax_python_planner(contexts, name):
    jc, pc = contexts
    assert jax_native.load() is None
    assert pc.explain(_QUERIES[name]) == jc.explain(_QUERIES[name])


def test_parse_errors_match(contexts):
    jc, pc = contexts
    from dask_sql_tpu.utils import ParsingException as JaxErr
    from dask_sql_tpu_torch.utils import ParsingException as PortErr
    with pytest.raises(JaxErr) as je:
        jc.explain("SELECT FROM WHERE")
    with pytest.raises(PortErr) as pe:
        pc.explain("SELECT FROM WHERE")
    assert str(pe.value) == str(je.value)
