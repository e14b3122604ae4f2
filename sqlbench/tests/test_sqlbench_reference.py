"""The plain reference against two independent oracles: the frozen pandas
queries at the repository's fixed literals, and sqlite on drawn literals."""
import pytest
import torch

import sqlbench_pandas_tpch as pandas_tpch
from sqlbench_helpers import (ROOT, VALIDATION, frame_columns, pandas_tables,
                              sqlite_answer, sqlite_db, tpch_data)
from sqlbench.core import manifest, params
from sqlbench.core.compare import compare
from sqlbench.reference import tpch as ref_tpch

# every template there is, also those no cell's traffic sends yet
TPCH = manifest.templates("tpch", sorted(
    p.stem for p in (ROOT / "sqlbench" / "templates" / "tpch").glob("*.toml")))
DRAWS = 3


def _clean(r):
    return r["exact_mismatches"] == 0 and r["order_violations"] == 0 \
        and r["max_rel_gap"] < 1e-9


@pytest.fixture(scope="module")
def tpch_frames():
    return pandas_tables(tpch_data())


@pytest.fixture(scope="module")
def tpch_sqlite():
    return sqlite_db(tpch_data())


@pytest.mark.parametrize("tid", sorted(TPCH))
def test_tpch_reference_matches_pandas(tid, tpch_frames):
    want = frame_columns(getattr(pandas_tpch, f"q{int(tid[1:])}")(
        tpch_frames))
    got, _ = ref_tpch.QUERIES[tid](tpch_data(), VALIDATION[tid],
                                   torch.float64)
    t = TPCH[tid]
    r = compare(got, want, t["key"], t["order"])
    assert _clean(r), (tid, r)


@pytest.mark.parametrize("tid", sorted(TPCH))
def test_tpch_reference_matches_sqlite(tid, tpch_sqlite):
    t = TPCH[tid]
    for d in params.draws(t, 99, 1, DRAWS, 0.01):
        got, _ = ref_tpch.QUERIES[tid](tpch_data(), d["values"],
                                       torch.float64)
        want = sqlite_answer(tpch_sqlite, d["sql"], got)
        r = compare(got, want, t["key"], t["order"])
        assert _clean(r), (tid, d["sql"], r)


def test_validation_literals_render_the_fixed_texts():
    """The validation sets fill every placeholder of every template."""
    for tid, t in TPCH.items():
        values = dict(VALIDATION[tid])
        for name, rule in t["params"].items():
            if name not in values and rule["kind"] in ("join",):
                values[name] = ", ".join(str(v) for v in values[rule["of"]])
            values.setdefault(name, 0)
        assert "{" not in params.render(t, values)
