"""The port's window functions against the JAX package's.

The queries of ``tests/integration/test_over.py`` run through both
packages' ``Context`` on the same frames; every window function, frame
form and edge (RANGE offset frames, string MIN/MAX, NULL order keys, an
empty table, ``row_valid``) runs through both packages' ``compute_window``
directly on the same seeded table; bounded MIN/MAX is also held against a
brute force.  Ints, strings and NULLs exact; float sums and averages
within 1e-12 of the column's absolute total (they are differences of one
prefix sum, whose rounding follows its order); everything else exact.
TABLESAMPLE is checked by its properties (the two generators' streams
differ).
"""
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from dask_sql_tpu import Context as JaxContext
from dask_sql_tpu import table as JT
from dask_sql_tpu.ops import window as JW
from dask_sql_tpu.plan import functions as JF
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch import table as PT
from dask_sql_tpu_torch.ops import window as PW
from dask_sql_tpu_torch.plan import functions as PF

CPU = torch.device("cpu")


def _frame():
    rng = np.random.RandomState(42)
    n = 200
    t = rng.randint(0, 15, n)
    return pd.DataFrame({
        "p": rng.randint(0, 5, n),
        "o": rng.permutation(n),
        "t": t,
        "v": rng.randn(n).round(3) * 100,
        "i": rng.randint(-50, 50, n),
        "s": rng.choice(["kiwi", "apple", "fig", "banana", "cherry"], n),
        "ns": pd.array(rng.choice(["x", "yy", "a", None], n), dtype=object),
        "nk": pd.array(np.where(rng.rand(n) < 0.2, None, rng.randint(0, 9, n)),
                       dtype="Int64"),
        "nv": np.where(rng.rand(n) < 0.15, np.nan, rng.randn(n)),
        "one": np.full(n, 1),
        "three": np.full(n, 3),
    })


DF = _frame()
COLS = list(DF.columns)
ABS_TOTAL = {c: float(np.nansum(np.abs(DF[c].astype(float)))) for c in ("v", "i", "nv")}


@pytest.fixture(scope="module")
def tables():
    return JT.Table.from_pandas(DF), PT.Table.from_pandas(DF, CPU)


def _idx(name):
    return COLS.index(name)


def _order(*keys):
    """(name, asc, nulls_first) -> (index, asc, nulls_first)."""
    return [(_idx(k), asc, nf) for k, asc, nf in keys]


def _run(tables, op, args, part, order, frame, row_valid=None):
    jt, pt = tables
    arg_idx = [_idx(a) for a in args]
    jtype = JF.infer_agg_type(op, [jt.columns[i].stype for i in arg_idx])
    ptype = PF.infer_agg_type(op, [pt.columns[i].stype for i in arg_idx])
    part_idx = [_idx(p) for p in part]
    want = JW.compute_window(jt, op, arg_idx, part_idx, order, frame, jtype,
                             None if row_valid is None else jnp.asarray(row_valid))
    got = PW.compute_window(pt, op, arg_idx, part_idx, order, frame, ptype,
                            None if row_valid is None else torch.from_numpy(row_valid))
    return got, want


def _assert_same(got, want, args, keep=None):
    assert got.stype.name == want.stype.name
    g, w = got.to_numpy(), want.to_numpy()
    if keep is not None:
        g, w = g[keep], w[keep]
    if w.dtype.kind == "f":
        scale = max([ABS_TOTAL.get(a, 0.0) for a in args] + [1.0])
        np.testing.assert_allclose(g.astype(np.float64), w, rtol=0,
                                   atol=1e-12 * scale, equal_nan=True)
    else:
        assert [str(x) for x in g] == [str(x) for x in w]


ORDER_PO = _order(("o", True, False))
ORDER_T = _order(("t", True, False), ("o", False, True))
ROWS = lambda lo, hi: ("ROWS", lo, hi)  # noqa: E731
RANGE = lambda lo, hi: ("RANGE", lo, hi)  # noqa: E731
UP, UF, CUR = ("UNBOUNDED_PRECEDING", None), ("UNBOUNDED_FOLLOWING", None), \
    ("CURRENT", None)
P = lambda k: ("PRECEDING", k)  # noqa: E731
F = lambda k: ("FOLLOWING", k)  # noqa: E731

CALLS = {
    "row_number": ("ROW_NUMBER", [], ["p"], ORDER_T, None),
    "row_number_whole": ("ROW_NUMBER", [], [], [], None),
    "rank": ("RANK", [], ["p"], ORDER_T[:1], None),
    "dense_rank": ("DENSE_RANK", [], ["p"], ORDER_T[:1], None),
    "percent_rank": ("PERCENT_RANK", [], ["p"], ORDER_T[:1], None),
    "cume_dist": ("CUME_DIST", [], ["s"], _order(("t", False, False)), None),
    "lag": ("LAG", ["v"], ["p"], ORDER_PO, None),
    "lead_offset": ("LEAD", ["s", "three"], ["p"], ORDER_PO, None),
    "lag_nullable_string": ("LAG", ["ns", "one"], [], ORDER_PO, None),
    "first_value": ("FIRST_VALUE", ["s"], ["p"], ORDER_T[:1], None),
    "last_value": ("LAST_VALUE", ["i"], ["p"], ORDER_T[:1], None),
    "nth_value": ("NTH_VALUE", ["v", "three"], ["p"], ORDER_PO, ROWS(P(2), F(2))),
    "count_star": ("COUNT", [], ["p"], ORDER_T[:1], None),
    "count_nullable": ("COUNT", ["nv"], [], ORDER_PO, ROWS(P(5), F(1))),
    "sum_default": ("SUM", ["v"], ["p"], ORDER_T[:1], None),
    "sum_rows": ("SUM", ["i"], ["p"], ORDER_PO, ROWS(P(6), CUR)),
    "sum0_empty_frames": ("$SUM0", ["nv"], ["p"], ORDER_PO, ROWS(F(3), F(5))),
    "sum_whole": ("SUM", ["nv"], ["s"], [], None),
    "avg": ("AVG", ["v"], ["p"], ORDER_PO, ROWS(P(3), F(3))),
    "avg_int": ("AVG", ["i"], [], ORDER_T, None),
    "min_default": ("MIN", ["v"], ["p"], ORDER_T[:1], None),
    "max_unbounded_following": ("MAX", ["nv"], ["p"], ORDER_PO, ROWS(P(1), UF)),
    "min_whole": ("MIN", ["i"], ["p"], [], None),
    "single_value": ("SINGLE_VALUE", ["s"], ["p"], ORDER_PO, None),
    # RANGE offset frames (one numeric ORDER BY key, ascending and descending)
    "range_sum": ("SUM", ["v"], ["p"], _order(("t", True, False)), RANGE(P(3), CUR)),
    "range_sum_desc": ("SUM", ["i"], ["p"], _order(("t", False, False)),
                       RANGE(P(2), F(2))),
    "range_count": ("COUNT", [], [], _order(("o", True, False)), RANGE(P(10), F(5))),
    "range_min_unbounded": ("MIN", ["v"], ["p"], _order(("t", True, False)),
                            RANGE(UP, F(1))),
    "range_current": ("AVG", ["v"], ["p"], _order(("t", True, False)),
                      RANGE(CUR, UF)),
    # string MIN/MAX
    "string_min_bounded": ("MIN", ["s"], ["p"], ORDER_PO, ROWS(P(2), F(2))),
    "string_max_default": ("MAX", ["ns"], ["p"], ORDER_PO, None),
    "string_max_whole": ("MAX", ["s"], ["t"], [], None),
    # NULL order keys, both placements
    "null_keys_rank": ("RANK", [], [], _order(("nk", True, True)), None),
    "null_keys_last": ("ROW_NUMBER", [], ["p"], _order(("nk", False, False), ("o", True, False)),
                       None),
    "null_keys_sum": ("SUM", ["i"], ["p"], _order(("nk", True, False)), None),
    "null_partition": ("DENSE_RANK", [], ["nk"], _order(("t", True, False)), None),
    "float_partition": ("COUNT", [], ["nv"], [], None),
}


# string-valued results: the JAX package raises on each (its scatter_back
# builds a VARCHAR column without a dictionary); the port's answers are
# held against a brute force instead
STRING_VALUED = ["lead_offset", "lag_nullable_string", "first_value",
                 "single_value", "string_min_bounded", "string_max_default",
                 "string_max_whole"]


@pytest.mark.parametrize("name", [n for n in CALLS if n not in STRING_VALUED])
def test_window_matches_jax(tables, name):
    op, args, part, order, frame = CALLS[name]
    got, want = _run(tables, op, args, part, order, frame)
    _assert_same(got, want, args)


def _brute_force(op, args, part, order, frame) -> list:
    """Row by row: sort stably by partition and order keys, then read each
    row's frame (no NULL order keys here)."""
    names = [COLS[i] for i, _, _ in order]
    asc = [a for _, a, _ in order]
    srt = DF.sort_values(part + names, ascending=[True] * len(part) + asc,
                         kind="stable")
    vals = DF[args[0]].astype(object).where(DF[args[0]].notna(), None).to_numpy()
    out = [None] * len(DF)
    for _, grp in (srt.groupby(part, sort=False) if part else [(0, srt)]):
        rows = list(grp.index)
        keys = [tuple(DF.loc[r, names]) for r in rows]
        for i, r in enumerate(rows):
            if frame is not None:
                lo, hi = (-frame[1][1] if frame[1][0] == "PRECEDING" else frame[1][1],
                          -frame[2][1] if frame[2][0] == "PRECEDING" else frame[2][1])
                span = rows[max(i + lo, 0): max(i + hi + 1, 0)]
            elif names:
                last = max(j for j in range(len(rows)) if keys[j] == keys[i])
                span = rows[:last + 1]
            else:
                span = rows
            if op in ("LAG", "LEAD"):
                k = int(DF[args[1]].iloc[0]) if len(args) > 1 else 1
                j = i - k if op == "LAG" else i + k
                out[r] = vals[rows[j]] if 0 <= j < len(rows) else None
            elif op in ("FIRST_VALUE", "SINGLE_VALUE"):
                out[r] = vals[span[0]] if span else None
            else:
                present = [vals[x] for x in span if vals[x] is not None]
                out[r] = (min if op == "MIN" else max)(present) if present else None
    return out


@pytest.mark.parametrize("name", STRING_VALUED)
def test_string_valued_windows(tables, name):
    op, args, part, order, frame = CALLS[name]
    jt, pt = tables
    arg_idx = [_idx(a) for a in args]
    st = PF.infer_agg_type(op, [pt.columns[i].stype for i in arg_idx])
    got = PW.compute_window(pt, op, arg_idx, [_idx(p) for p in part], order,
                            frame, st)
    assert got.stype.is_string
    assert got.to_numpy().tolist() == _brute_force(op, args, part, order, frame)
    with pytest.raises(ValueError, match="dictionary"):  # the reference
        JW.compute_window(jt, op, arg_idx, [_idx(p) for p in part], order,
                          frame, JF.infer_agg_type(op, [jt.columns[i].stype
                                                        for i in arg_idx]))


@pytest.mark.parametrize("k", [1, 3, 4, 7, 64])
def test_ntile_gives_sql_buckets(tables, k):
    """NTILE(k): the first (n mod k) buckets of a partition hold one row
    more (SQL, sqlite).  The JAX package's floor(row * k / n) + 1 sizes
    them otherwise (six rows in four buckets: 2, 1, 2, 1); where n mod k
    is 0 or 1 the two agree."""
    _, pt = tables
    kcol = PT.Column.from_numpy(np.full(len(DF), k), CPU)
    table = PT.Table(pt.names + ["k"], pt.columns + [kcol])
    got = PW.compute_window(table, "NTILE", [len(COLS)], [_idx("p")], ORDER_PO,
                            None, PF.infer_agg_type("NTILE", [kcol.stype]))
    p, o = DF["p"].to_numpy(), DF["o"].to_numpy()
    want = np.empty(len(DF), np.int64)
    for part in np.unique(p):
        rows = np.where(p == part)[0]
        rows = rows[np.argsort(o[rows])]
        q, r = divmod(len(rows), k)
        sizes = [q + 1] * r + [q] * (k - r)
        want[rows] = np.repeat(np.arange(1, k + 1), sizes)
    assert got.to_numpy().tolist() == want.tolist()
    six = PT.Table(["o", "k"], [PT.Column.from_numpy(np.arange(6), CPU),
                               PT.Column.from_numpy(np.full(6, 4), CPU)])
    out = PW.compute_window(six, "NTILE", [1], [], [(0, True, False)], None,
                            PF.infer_agg_type("NTILE", []))
    assert out.to_numpy().tolist() == [1, 1, 2, 2, 3, 4]
    jsix = JT.Table(["o", "k"], [JT.Column.from_numpy(np.arange(6)),
                                JT.Column.from_numpy(np.full(6, 4))])
    ref = JW.compute_window(jsix, "NTILE", [1], [], [(0, True, False)], None,
                            JF.infer_agg_type("NTILE", []))
    assert ref.to_numpy().tolist() == [1, 1, 2, 3, 3, 4]  # the reference


@pytest.mark.parametrize("lo,hi", [(-2, 1), (-7, -3), (2, 9), (-4, 0), (0, 4)])
def test_bounded_min_max_against_brute_force(tables, lo, hi):
    """van Herk's bounded MIN/MAX over five frame shapes, frames clipped at
    partition edges included, against a brute force and the JAX package."""
    bound = lambda k: P(-k) if k < 0 else CUR if k == 0 else F(k)  # noqa: E731
    frame = ROWS(bound(lo), bound(hi))
    p, o, v = DF["p"].to_numpy(), DF["o"].to_numpy(), DF["v"].to_numpy()
    for op, pick in (("MIN", np.min), ("MAX", np.max)):
        got, want = _run(tables, op, ["v"], ["p"], ORDER_PO, frame)
        _assert_same(got, want, ["v"])
        g = got.to_numpy()
        for part in range(5):
            rows = np.where(p == part)[0]
            rows = rows[np.argsort(o[rows])]
            for i, r in enumerate(rows):
                win = v[rows[max(i + lo, 0): max(i + hi + 1, 0)]]
                if len(win):
                    assert g[r] == pick(win), (op, lo, hi, part, i)
                else:
                    assert np.isnan(g[r]), (op, lo, hi, part, i)


def test_empty_table(tables):
    jt, pt = tables[0].slice(0, 0), tables[1].slice(0, 0)
    for op, args in (("ROW_NUMBER", []), ("SUM", ["v"]), ("MIN", ["i"])):
        arg_idx = [_idx(a) for a in args]
        st = PF.infer_agg_type(op, [pt.columns[i].stype for i in arg_idx])
        out = PW.compute_window(pt, op, arg_idx, [_idx("p")], ORDER_PO, None, st)
        want = JW.compute_window(jt, op, arg_idx, [_idx("p")], ORDER_PO, None,
                                 JF.infer_agg_type(op, [jt.columns[i].stype
                                                        for i in arg_idx]))
        assert len(out) == len(want) == 0 and out.stype.name == want.stype.name


@pytest.mark.parametrize("name", ["sum_rows", "range_sum", "count_nullable",
                                  "cume_dist", "min_default"])
def test_row_valid(tables, name):
    """Invalid rows sort into their own trailing segment: the valid rows'
    answers equal the answers over the valid rows alone, and the JAX
    package's under the same mask."""
    op, args, part, order, frame = CALLS[name]
    valid = np.random.RandomState(1).rand(len(DF)) < 0.7
    got, want = _run(tables, op, args, part, order, frame, row_valid=valid)
    _assert_same(got, want, args, keep=valid)
    sub = PT.Table.from_pandas(DF[valid].reset_index(drop=True), CPU)
    arg_idx = [_idx(a) for a in args]
    alone = PW.compute_window(sub, op, arg_idx, [_idx(x) for x in part], order,
                              frame, got.stype)
    g, a = got.to_numpy()[valid], alone.to_numpy()
    if a.dtype.kind == "f":
        np.testing.assert_allclose(g.astype(float), a, rtol=1e-12, atol=1e-9,
                                   equal_nan=True)
    else:
        assert [str(x) for x in g] == [str(x) for x in a]


@pytest.mark.parametrize("order,frame,op,match", [
    (_order(("t", True, False), ("o", True, False)), RANGE(P(1), CUR), "SUM",
     "exactly one ORDER BY key"),
    (_order(("nk", True, False)), RANGE(P(1), CUR), "SUM", "nullable ORDER BY key"),
    (_order(("t", True, False)), RANGE(P(1), F(1)), "MIN", "bounded on both sides"),
])
def test_unsupported_frames_raise_as_in_jax(tables, order, frame, op, match):
    _, pt = tables
    st = PF.infer_agg_type(op, [pt.columns[_idx("v")].stype])
    with pytest.raises(NotImplementedError, match=match):
        PW.compute_window(pt, op, [_idx("v")], [], order, frame, st)


def test_segmented_scan_matches_a_loop():
    """The doubling loop equals a sequential segmented scan, with and
    without a span bound."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(1000))
    starts = torch.from_numpy(rng.rand(1000) < 0.05)
    starts[0] = True
    want = np.empty(1000)
    for i in range(1000):
        want[i] = x[i] if starts[i] else max(want[i - 1], float(x[i]))
    got = PW.segmented_scan(x, starts, torch.maximum)
    np.testing.assert_array_equal(got.numpy(), want)
    block = starts | (torch.arange(1000) % 7 == 0)
    want_b = np.empty(1000)
    for i in range(1000):
        want_b[i] = x[i] if block[i] else max(want_b[i - 1], float(x[i]))
    np.testing.assert_array_equal(
        PW.segmented_scan(x, block, torch.maximum, span=7).numpy(), want_b)


# ---------------------------------------------------------------------------
# the queries of tests/integration/test_over.py, through both Contexts
# ---------------------------------------------------------------------------

def _fractional_frame():
    """A non-null DOUBLE key with ties and gaps of every size around the
    fractional offsets below, an integer and a string column."""
    rng = np.random.RandomState(5)
    n = 60
    return pd.DataFrame({"g": np.round(rng.randint(0, 40, n) * 0.25, 2),
                         "p": rng.randint(0, 3, n),
                         "k": rng.permutation(n).astype(np.int64),
                         "s": rng.choice(["kiwi", "fig", "apple"], n)})


@pytest.fixture(scope="module")
def contexts():
    jc, pc = JaxContext(), Context(device=CPU)
    frames = {
        "user_table_1": pd.DataFrame({"user_id": [2, 1, 2, 3], "b": [3, 3, 1, 3]}),
        "user_table_2": pd.DataFrame({"user_id": [1, 1, 2, 4], "c": [1, 2, 3, 4]}),
        "tmp": pd.DataFrame({"a": range(5)}),
        "ll": pd.DataFrame({"g": [1, 1, 1, 2, 2], "v": [10, 20, 30, 40, 50]}),
        "wf_t": pd.DataFrame({"o": [1, 2, 3, 4], "v": [5.0, 1.0, 7.0, 3.0]}),
        "df": pd.DataFrame({"a": [1.0] * 100 + [2.0] * 200 + [3.0] * 400,
                            "b": 10 * np.random.RandomState(42).rand(700)}),
        "fr": _fractional_frame(),
    }
    for name, frame in frames.items():
        jc.create_table(name, frame)
        pc.create_table(name, frame)
    return jc, pc


OVER_QUERIES = {
    "sorting": 'SELECT user_id, b, ROW_NUMBER() OVER (ORDER BY user_id, b) AS "R" '
               'FROM user_table_1',
    "partitioning": 'SELECT user_id, c, ROW_NUMBER() OVER (PARTITION BY c ORDER BY '
                    'user_id) AS "R" FROM user_table_2',
    "different": 'SELECT user_id, b, ROW_NUMBER() OVER (PARTITION BY user_id ORDER BY '
                 'b) AS "R1", ROW_NUMBER() OVER (ORDER BY user_id, b) AS "R2" '
                 'FROM user_table_1',
    "calls": 'SELECT user_id, b, FIRST_VALUE(user_id*10 - b) OVER (PARTITION BY '
             'user_id ORDER BY b) AS "F", SUM(b) OVER (PARTITION BY user_id ORDER '
             'BY b) AS "S", AVG(b) OVER (PARTITION BY user_id ORDER BY b) AS "A", '
             'COUNT(*) OVER (PARTITION BY user_id ORDER BY b) AS "C", MAX(b) OVER '
             '(PARTITION BY user_id ORDER BY b) AS "M" FROM user_table_1',
    "windows": 'SELECT a, SUM(a) OVER (ORDER BY a ROWS BETWEEN 2 PRECEDING AND '
               'CURRENT ROW) AS "S1", SUM(a) OVER (ORDER BY a ROWS BETWEEN 2 '
               'PRECEDING AND 1 FOLLOWING) AS "S2", SUM(a) OVER (ORDER BY a ROWS '
               'BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW) AS "S3", SUM(a) OVER '
               '(ORDER BY a ROWS BETWEEN UNBOUNDED PRECEDING AND UNBOUNDED '
               'FOLLOWING) AS "S4" FROM tmp',
    "ranks": 'SELECT user_id, b, RANK() OVER (PARTITION BY user_id ORDER BY b) AS "r", '
             'DENSE_RANK() OVER (PARTITION BY user_id ORDER BY b) AS "dr" '
             'FROM user_table_1',
    "lag_lead": 'SELECT g, v, LAG(v) OVER (PARTITION BY g ORDER BY v) AS "lag1", '
                'LEAD(v) OVER (PARTITION BY g ORDER BY v) AS "lead1" FROM ll',
    "one_side_unbounded": 'SELECT o, MIN(v) OVER (ORDER BY o ROWS BETWEEN UNBOUNDED '
                          'PRECEDING AND 1 FOLLOWING) AS m1, MAX(v) OVER (ORDER BY o '
                          'ROWS BETWEEN 1 PRECEDING AND UNBOUNDED FOLLOWING) AS m2, '
                          'MIN(v) OVER (ORDER BY o ROWS BETWEEN UNBOUNDED PRECEDING '
                          'AND 1 PRECEDING) AS m3 FROM wf_t ORDER BY o',
}


@pytest.mark.parametrize("name", list(OVER_QUERIES))
def test_over_queries_match_jax(contexts, name):
    jc, pc = contexts
    got = pc.sql(OVER_QUERIES[name], return_futures=False)
    want = jc.sql(OVER_QUERIES[name], return_futures=False)
    assert list(got.columns) == list(want.columns)
    for col in want.columns:
        g, w = got[col].to_numpy(), want[col].to_numpy()
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g.astype(float), w, rtol=1e-12,
                                       equal_nan=True, err_msg=col)
        else:
            assert [str(x) for x in g] == [str(x) for x in w], col


def test_tablesample_properties(contexts):
    """BERNOULLI keeps each row with the given probability: the count is
    within 5 binomial standard deviations; REPEATABLE gives the same rows
    on one device, another seed other rows; 100 keeps all, 0 none."""
    _, pc = contexts
    n, p = 700, 0.3

    def rows(sql):
        return pc.sql(sql).columns[1].to_numpy()

    a = rows("SELECT * FROM df TABLESAMPLE BERNOULLI (30) REPEATABLE (42)")
    b = rows("SELECT * FROM df TABLESAMPLE BERNOULLI (30) REPEATABLE (42)")
    other = rows("SELECT * FROM df TABLESAMPLE BERNOULLI (30) REPEATABLE (43)")
    assert abs(len(a) - n * p) <= 5 * np.sqrt(n * p * (1 - p))
    assert np.array_equal(a, b) and not np.array_equal(a, other)
    assert len(rows("SELECT * FROM df TABLESAMPLE SYSTEM (100) REPEATABLE (1)")) == n
    assert len(rows("SELECT * FROM df TABLESAMPLE BERNOULLI (0)")) == 0
    s = rows("SELECT * FROM df TABLESAMPLE SYSTEM (50) REPEATABLE (7)")
    assert abs(len(s) - n * 0.5) <= 5 * np.sqrt(n * 0.25)


# ---------------------------------------------------------------------------
# F5: fractional RANGE offsets, through the native and the Python parser
# ---------------------------------------------------------------------------

FRACTIONAL = {
    "count_half": "SELECT k, COUNT(*) OVER (ORDER BY g RANGE BETWEEN 0.5 "
                  "PRECEDING AND CURRENT ROW) AS c FROM fr",
    "sum_mixed": "SELECT k, SUM(g) OVER (ORDER BY g RANGE BETWEEN 1.5 "
                 "PRECEDING AND 0.25 FOLLOWING) AS c FROM fr",
    "sum_partitioned": "SELECT k, SUM(g) OVER (PARTITION BY p ORDER BY g "
                       "RANGE BETWEEN 1.5 PRECEDING AND 0.25 FOLLOWING) AS c "
                       "FROM fr",
}


@pytest.mark.parametrize("parser", ["native", "python"])
@pytest.mark.parametrize("name", list(FRACTIONAL))
def test_fractional_range_offsets(contexts, monkeypatch, name, parser):
    """The JAX package answers these through its native parser (its Python
    parser refuses the offset); the port gives the same answer through
    either of its parsers, and the two parse to the same AST."""
    from dask_sql_tpu_torch.sql import native_bridge
    from dask_sql_tpu_torch import native as port_native
    from dask_sql_tpu_torch.sql.parser import Parser

    jc, pc = contexts
    sql = FRACTIONAL[name] + " ORDER BY k"
    want = jc.sql(sql, return_futures=False)
    assert Parser(sql).parse_statements() == native_bridge.json_to_statements(
        port_native.parse_to_json(sql), sql)
    if parser == "python":
        monkeypatch.setenv("DSQL_NATIVE", "0")
    got = pc.sql(sql, return_futures=False)
    assert got["k"].tolist() == want["k"].tolist()
    np.testing.assert_allclose(got["c"].to_numpy(float),
                               want["c"].to_numpy(float), rtol=1e-12)


# ---------------------------------------------------------------------------
# F6: LAG / LEAD with a default, against sqlite
# ---------------------------------------------------------------------------

DEFAULTS = {  # name: (query, its default)
    "lag_int": ("SELECT k, LAG(k, 1, -1) OVER (ORDER BY k) AS d FROM fr", -1),
    "lead_string": ("SELECT k, LEAD(s, 2, 'dflt') OVER (ORDER BY k) AS d "
                    "FROM fr", "dflt"),
    "lag_partitioned": ("SELECT k, LAG(k, 2, -7) OVER (PARTITION BY p ORDER "
                        "BY k) AS d FROM fr", -7),
}


@pytest.mark.parametrize("name", list(DEFAULTS))
def test_lag_lead_defaults_are_sql(contexts, name):
    """The port gives the third argument outside the partition, as sqlite
    does; the JAX package ignores it (NULL for an integer, and its string
    windows raise)."""
    import sqlite3

    jc, pc = contexts
    sql, default = DEFAULTS[name]
    sql += " ORDER BY k"
    con = sqlite3.connect(":memory:")
    _fractional_frame().to_sql("fr", con, index=False)
    want = [list(r) for r in con.execute(sql).fetchall()]
    got = pc.sql(sql, return_futures=False)
    assert [[int(k), d if isinstance(d, str) else int(d)]
            for k, d in zip(got["k"], got["d"])] == want
    assert any(d == default for _, d in want)
    if name == "lead_string":
        with pytest.raises(ValueError, match="require a dictionary"):
            jc.sql(sql)
        return
    jax_d = jc.sql(sql, return_futures=False)["d"].tolist()
    assert [None if d == default else d for _, d in want] == [
        None if pd.isna(d) else int(d) for d in jax_d]
