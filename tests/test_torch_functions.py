"""Every scalar function of the port against the JAX package.

One case per key of the JAX package's ``OPERATION_MAPPING``: the same
seeded numpy inputs (columns with NULLs, literals, NULL literals) go
through both packages' operator functions directly, and the results must
be equal.  Ints, strings, booleans, dates and NULLs exact; rounding,
FLOOR / CEIL, SIGN and TRUNCATE exact; transcendental functions rtol
1e-13 (XLA's and torch's CPU libraries differ by an ulp or two); CBRT
rtol 1e-14.

Where the JAX package's answer is not SQL's, the port's is pinned to SQL's
instead: POWER of integers with a negative exponent, CBRT of a negative
literal, GREATEST / LEAST over strings.  RAND streams cannot match across
the two generators, so the RAND keys check properties.
"""
import math

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from dask_sql_tpu import Context as JaxContext
from dask_sql_tpu import table as JT
from dask_sql_tpu import types as JTy
from dask_sql_tpu.physical.rex import ops as JO
from dask_sql_tpu.plan import functions as JF
from dask_sql_tpu_torch import Context, table as PT, types as PTy
from dask_sql_tpu_torch.physical.rex import ops as PO
from dask_sql_tpu_torch.plan import functions as PF

CPU = torch.device("cpu")
N = 8
_rng = np.random.RandomState(11)

# column specs: (values, valid mask or None, SQL type name)
COLS = {
    "I": (np.array([5, -7, 0, 3, 13, -1, 2, 9]),
          np.array([1, 1, 1, 0, 1, 1, 1, 1], bool), "BIGINT"),
    "K": (np.array([2, 0, 3, -2, 1, -4, 7, 1]),
          np.array([1, 1, 1, 1, 0, 1, 1, 1], bool), "BIGINT"),
    "PI": (np.array([65, 97, 49, 90, 122, 48, 33, 126]),
           np.array([1, 1, 1, 1, 1, 1, 1, 0], bool), "BIGINT"),
    "F": (np.round(_rng.randn(N) * 10, 3), np.array([1, 1, 0, 1, 1, 1, 1, 1], bool),
          "DOUBLE"),
    "FN": (np.array([1.5, -2.5, np.nan, 0.5, -0.0, 2.675, -8.0, 27.0]),
           np.array([1, 1, 1, 1, 1, 1, 0, 1], bool), "DOUBLE"),
    "P": (np.abs(_rng.randn(N)) * 5 + 0.1, np.array([1, 0, 1, 1, 1, 1, 1, 1], bool),
          "DOUBLE"),
    "U": (_rng.uniform(-0.99, 0.99, N), np.array([1, 1, 1, 1, 0, 1, 1, 1], bool),
          "DOUBLE"),
    "B": (np.array([1, 0, 1, 0, 1, 1, 0, 0], bool),
          np.array([1, 1, 0, 1, 1, 1, 1, 0], bool), "BOOLEAN"),
    "B2": (np.array([0, 0, 1, 1, 1, 0, 1, 0], bool),
           np.array([1, 0, 1, 1, 1, 1, 1, 1], bool), "BOOLEAN"),
    "S": (np.array(["apple pie", "Banana", "  cherry  ", "date", "", "a%b c",
                    "x_y z", "Éclair"], dtype=object),
          np.array([1, 1, 1, 1, 1, 1, 0, 1], bool), "VARCHAR"),
    "S2": (np.array(["pie", "an", "rr", "date", "z", "%", "y", "É"], dtype=object),
           np.array([1, 1, 1, 0, 1, 1, 1, 1], bool), "VARCHAR"),
    "D": (np.array([9131, 9500, 10957, 10988, 11000, 0, -1, 12345], np.int32),
          np.array([1, 1, 1, 1, 0, 1, 1, 1], bool), "DATE"),
    "TS": (np.array([9131, 9500, 10957, 10988, 11000, 0, -1, 12345], np.int64)
           * 86_400_000_000 + _rng.randint(0, 86_400_000_000, N),
           np.array([1, 1, 0, 1, 1, 1, 1, 1], bool), "TIMESTAMP"),
}

SYM = "SYMBOL"
DAY_MS = 86_400_000


def c(name):
    return ("c", name)


def s(value, tname):
    return ("s", value, tname)


_RANGES = [(0, False, 5, True), (10, True, None, False)]

# key -> argument lists; each list is one call
CASES = {
    "AND": [[c("B"), c("B2")], [c("B"), s(None, "BOOLEAN")],
            [s(True, "BOOLEAN"), s(None, "BOOLEAN")]],
    "OR": [[c("B"), c("B2")], [c("B"), s(False, "BOOLEAN")],
           [s(False, "BOOLEAN"), s(None, "BOOLEAN")]],
    "NOT": [[c("B")], [s(False, "BOOLEAN")]],
    "+": [[c("I"), c("K")], [c("F"), s(1.5, "DOUBLE")],
          [c("D"), s(3 * DAY_MS, "INTERVAL_DAY_TIME")],
          [c("D"), s(14, "INTERVAL_YEAR_MONTH")], [s(2, "INTEGER"), s(3, "INTEGER")]],
    "-": [[c("I"), c("K")], [c("TS"), s(DAY_MS, "INTERVAL_DAY_TIME")],
          [c("TS"), c("D")], [s(2, "INTEGER"), s(None, "INTEGER")]],
    "*": [[c("I"), c("K")], [c("F"), s(2.5, "DOUBLE")], [s(2, "INTEGER"), s(3, "INTEGER")]],
    "/": [[c("I"), c("K")], [c("F"), c("K")], [s(7, "INTEGER"), s(2, "INTEGER")]],
    "%": [[c("I"), c("K")], [s(-7, "INTEGER"), s(3, "INTEGER")]],
    "MOD": [[c("I"), s(3, "INTEGER")], [s(7, "INTEGER"), s(-3, "INTEGER")]],
    "NEGATE": [[c("I")], [c("F")], [s(4, "INTEGER")]],
    "IS_NULL": [[c("I")], [s(None, "INTEGER")]],
    "IS_NOT_NULL": [[c("S")], [s(3, "INTEGER")]],
    "IS_TRUE": [[c("B")], [s(None, "BOOLEAN")]],
    "IS_NOT_TRUE": [[c("B")], [s(True, "BOOLEAN")]],
    "IS_FALSE": [[c("B")], [s(False, "BOOLEAN")]],
    "IS_NOT_FALSE": [[c("B")], [s(None, "BOOLEAN")]],
    "IS_DISTINCT_FROM": [[c("I"), c("K")], [c("S"), s("date", "VARCHAR")],
                         [c("I"), s(None, "BIGINT")], [s(None, "INTEGER"), s(1, "INTEGER")]],
    "IS_NOT_DISTINCT_FROM": [[c("I"), c("K")], [c("S"), c("S2")],
                             [s(None, "INTEGER"), s(None, "INTEGER")]],
    "CASE": [[c("B"), c("I"), c("K")], [c("B"), c("S"), s("z", "VARCHAR")],
             [c("B"), c("F"), c("B2"), c("P"), s(None, "DOUBLE")],
             [s(True, "BOOLEAN"), s(1, "INTEGER"), s(2, "INTEGER")]],
    "COALESCE": [[c("I"), c("K"), s(0, "BIGINT")], [c("S"), s("none", "VARCHAR")],
                 [s(None, "INTEGER"), s(3, "INTEGER")]],
    "IFNULL": [[c("F"), c("P")], [s(None, "INTEGER"), s(4, "INTEGER")]],
    "NVL": [[c("S"), c("S2")], [s(1, "INTEGER"), s(4, "INTEGER")]],
    "NULLIF": [[c("I"), c("K")], [c("S"), s("date", "VARCHAR")],
               [c("I"), s(None, "BIGINT")], [s(1, "INTEGER"), s(1, "INTEGER")]],
    "GREATEST": [[c("I"), c("K")], [c("F"), s(0.0, "DOUBLE"), c("P")],
                 [c("I"), s(None, "BIGINT")], [s(1, "INTEGER"), s(5, "INTEGER")]],
    "LEAST": [[c("I"), c("K"), s(1, "BIGINT")], [c("F"), c("P")],
              [s(1.5, "DOUBLE"), s(-5.0, "DOUBLE")]],
    "IN_LIST": [[c("I"), s(5, "BIGINT"), s(0, "BIGINT")],
                [c("S"), s("date", "VARCHAR"), s(None, "VARCHAR")],
                [s(3, "INTEGER"), s(3, "INTEGER")]],
    "SEARCH": [[c("I"), s(_RANGES, "ANY")], [c("F"), s([(None, False, 0.0, True)], "ANY")],
               [s(3, "INTEGER"), s(_RANGES, "ANY")]],
    "LIKE": [[c("S"), s("%a%", "VARCHAR")], [c("S"), s("_a%", "VARCHAR")],
             [c("S"), s("a!%b%", "VARCHAR"), s("!", "VARCHAR")],
             [c("S"), s(None, "VARCHAR")], [s("abc", "VARCHAR"), s("a_c", "VARCHAR")]],
    "ILIKE": [[c("S"), s("%A%", "VARCHAR")], [c("S"), s("éCLAIR", "VARCHAR")],
              [s("ABC", "VARCHAR"), s("a%", "VARCHAR")]],
    "SIMILAR": [[c("S"), s("(a|d)%", "VARCHAR")], [c("S"), s("%[ae]", "VARCHAR")],
                [s("abc", "VARCHAR"), s("a(b|x)c", "VARCHAR")]],
    "ABS": [[c("I")], [c("F")], [s(-3, "INTEGER")]],
    "SQRT": [[c("P")], [c("I")], [s(4.0, "DOUBLE")]],
    "EXP": [[c("F")], [c("I")], [s(1.0, "DOUBLE")]],
    "LN": [[c("P")], [s(2.0, "DOUBLE")]],
    "LOG10": [[c("P")], [c("PI")], [s(100.0, "DOUBLE")]],
    "LOG": [[c("P")], [s(2.0, "DOUBLE"), c("P")], [s(2.0, "DOUBLE"), s(8.0, "DOUBLE")]],
    "POWER": [[c("F"), s(2, "INTEGER")], [c("P"), c("F")], [c("I"), s(3, "INTEGER")],
              [s(2.0, "DOUBLE"), s(-1, "INTEGER")]],
    "POW": [[c("P"), s(0.5, "DOUBLE")], [c("K"), s(2, "INTEGER")],
            [s(3, "INTEGER"), s(2, "INTEGER")]],
    "SIN": [[c("F")], [c("I")], [s(1.0, "DOUBLE")]],
    "COS": [[c("F")], [s(1.0, "DOUBLE")]],
    "TAN": [[c("F")], [s(1.0, "DOUBLE")]],
    "ASIN": [[c("U")], [s(0.5, "DOUBLE")]],
    "ACOS": [[c("U")], [s(0.5, "DOUBLE")]],
    "ATAN": [[c("F")], [s(0.5, "DOUBLE")]],
    "ATAN2": [[c("F"), c("P")], [c("I"), s(2.0, "DOUBLE")], [s(1.0, "DOUBLE"), s(2.0, "DOUBLE")]],
    "SINH": [[c("U")], [s(0.5, "DOUBLE")]],
    "COSH": [[c("U")], [s(0.5, "DOUBLE")]],
    "TANH": [[c("F")], [s(0.5, "DOUBLE")]],
    "COT": [[c("P")], [s(0.5, "DOUBLE")]],
    "DEGREES": [[c("F")], [c("I")], [s(1.0, "DOUBLE")]],
    "RADIANS": [[c("F")], [s(90.0, "DOUBLE")]],
    "SIGN": [[c("I")], [c("FN")], [s(-2, "INTEGER")]],
    "CBRT": [[c("FN")], [c("F")], [c("I")], [s(27.0, "DOUBLE")]],
    "ROUND": [[c("FN")], [c("F"), s(2, "INTEGER")], [c("I"), s(-1, "INTEGER")],
              [c("I")], [s(2.5, "DOUBLE")], [s(2.567, "DOUBLE"), s(2, "INTEGER")]],
    "TRUNCATE": [[c("FN")], [c("F"), s(1, "INTEGER")], [s(-2.5, "DOUBLE")],
                 [s(2.567, "DOUBLE"), s(2, "INTEGER")]],
    "PI": [[]],
    "FLOOR": [[c("FN")], [c("I")], [c("D"), s("MONTH", SYM)], [c("D"), s("WEEK", SYM)],
              [c("TS"), s("HOUR", SYM)], [c("TS"), s("YEAR", SYM)],
              [s(9500, "DATE"), s("QUARTER", SYM)], [s(2.5, "DOUBLE")]],
    "CEIL": [[c("FN")], [c("D"), s("MONTH", SYM)], [c("D"), s("YEAR", SYM)],
             [c("TS"), s("DAY", SYM)], [c("TS"), s("MONTH", SYM)], [s(-2.5, "DOUBLE")]],
    "CEILING": [[c("F")], [c("TS"), s("MINUTE", SYM)], [s(None, "DOUBLE")]],
    "||": [[c("S"), s("!", "VARCHAR")], [c("S"), c("S2")],
           [s("a", "VARCHAR"), s("b", "VARCHAR")], [c("S"), s(None, "VARCHAR")]],
    "CONCAT": [[s("<", "VARCHAR"), c("S"), s(">", "VARCHAR")], [c("S"), c("I")],
               [s("a", "VARCHAR"), s("b", "VARCHAR"), s("c", "VARCHAR")]],
    "UPPER": [[c("S")], [s("abc", "VARCHAR")], [s(None, "VARCHAR")]],
    "LOWER": [[c("S")], [s("ABC", "VARCHAR")]],
    "INITCAP": [[c("S")], [s("hello wORLD", "VARCHAR")]],
    "REVERSE": [[c("S")], [s("abc", "VARCHAR")]],
    "CHAR_LENGTH": [[c("S")], [s("abc", "VARCHAR")]],
    "CHARACTER_LENGTH": [[c("S")], [s("", "VARCHAR")]],
    "LENGTH": [[c("S")], [s("hello", "VARCHAR")]],
    "OCTET_LENGTH": [[c("S")], [s("é", "VARCHAR")]],
    "ASCII": [[c("S")], [s("A", "VARCHAR")]],
    "CHR": [[c("PI")], [s(65, "INTEGER")]],
    "SUBSTRING": [[c("S"), s(2, "INTEGER"), s(3, "INTEGER")], [c("S"), s(0, "INTEGER")],
                  [s("hello", "VARCHAR"), s(2, "INTEGER"), s(2, "INTEGER")]],
    "SUBSTR": [[c("S"), s(3, "INTEGER")], [c("S"), s(-1, "INTEGER"), s(3, "INTEGER")],
               [s("hello", "VARCHAR"), s(3, "INTEGER")]],
    "TRIM": [[s("BOTH", SYM), s(" ", "VARCHAR"), c("S")],
             [s("LEADING", SYM), s("a", "VARCHAR"), c("S")],
             [s("TRAILING", SYM), s("e", "VARCHAR"), s("apple", "VARCHAR")]],
    "LTRIM": [[c("S")], [c("S"), s("a", "VARCHAR")], [s("  x", "VARCHAR")]],
    "RTRIM": [[c("S")], [s("xaa", "VARCHAR"), s("a", "VARCHAR")]],
    "BTRIM": [[c("S")], [c("S"), s(" ac", "VARCHAR")], [s(" x ", "VARCHAR")]],
    "POSITION": [[s("a", "VARCHAR"), c("S")], [c("S2"), c("S")],
                 [s("l", "VARCHAR"), s("hello", "VARCHAR")]],
    "STRPOS": [[c("S"), s("e", "VARCHAR")], [s("hello", "VARCHAR"), s("lo", "VARCHAR")]],
    "OVERLAY": [[c("S"), s("XY", "VARCHAR"), s(2, "INTEGER")],
                [c("S"), s("XY", "VARCHAR"), s(2, "INTEGER"), s(0, "INTEGER")],
                [s("hello", "VARCHAR"), s("XY", "VARCHAR"), s(2, "INTEGER"), s(3, "INTEGER")]],
    "REPLACE": [[c("S"), s("a", "VARCHAR"), s("o", "VARCHAR")],
                [s("aaa", "VARCHAR"), s("a", "VARCHAR"), s("", "VARCHAR")]],
    "REPEAT": [[c("S"), s(2, "INTEGER")], [s("ab", "VARCHAR"), s(3, "INTEGER")]],
    "LEFT": [[c("S"), s(3, "INTEGER")], [c("S"), s(-2, "INTEGER")],
             [s("hello", "VARCHAR"), s(2, "INTEGER")]],
    "RIGHT": [[c("S"), s(3, "INTEGER")], [c("S"), s(-2, "INTEGER")],
              [s("hello", "VARCHAR"), s(0, "INTEGER")]],
    "LPAD": [[c("S"), s(7, "INTEGER"), s("*-", "VARCHAR")], [c("S"), s(3, "INTEGER")],
             [s("ab", "VARCHAR"), s(5, "INTEGER"), s("0", "VARCHAR")]],
    "RPAD": [[c("S"), s(7, "INTEGER"), s("*", "VARCHAR")], [s("ab", "VARCHAR"), s(4, "INTEGER")]],
    "SPLIT_PART": [[c("S"), s(" ", "VARCHAR"), s(1, "INTEGER")],
                   [c("S"), s(" ", "VARCHAR"), s(2, "INTEGER")],
                   [s("a,b,c", "VARCHAR"), s(",", "VARCHAR"), s(3, "INTEGER")]],
    "TRANSLATE": [[c("S"), s("ae", "VARCHAR"), s("AE", "VARCHAR")],
                  [c("S"), s("abc", "VARCHAR"), s("x", "VARCHAR")],
                  [s("abc", "VARCHAR"), s("b", "VARCHAR"), s("B", "VARCHAR")]],
    "REGEXP_REPLACE": [[c("S"), s("a+", "VARCHAR"), s("_", "VARCHAR")],
                       [s("aab", "VARCHAR"), s("a", "VARCHAR"), s("", "VARCHAR")]],
    "EXTRACT": [[s("YEAR", SYM), c("D")], [s("HOUR", SYM), c("TS")],
                [s("DOY", SYM), c("TS")], [s("MONTH", SYM), s(9500, "DATE")]],
}
for _key in ("=", "<>", "<", "<=", ">", ">="):
    CASES[_key] = [[c("I"), c("K")], [c("S"), s("date", "VARCHAR")],
                   [s(3, "INTEGER"), c("F")], [c("S"), c("S2")],
                   [c("D"), c("TS")], [s(1, "INTEGER"), s(2, "INTEGER")],
                   [c("I"), s(None, "BIGINT")]]
for _key in ("YEAR", "MONTH", "DAY", "HOUR", "MINUTE", "SECOND", "QUARTER",
             "DAYOFWEEK", "DAYOFMONTH", "DAYOFYEAR", "WEEK"):
    CASES[_key] = [[c("D")], [c("TS")], [s(10988, "DATE")]]

_RANDOM = {"RAND", "RANDOM", "RAND_INTEGER"}
_TRANSCENDENTAL = {"SQRT", "EXP", "LN", "LOG10", "LOG", "POWER", "POW", "SIN",
                   "COS", "TAN", "ASIN", "ACOS", "ATAN", "ATAN2", "SINH",
                   "COSH", "TANH", "COT"}


def _jax_value(spec):
    if spec[0] == "s":
        return JT.Scalar(spec[1], JTy.SqlType(spec[2]))
    values, mask, tname = COLS[spec[1]]
    st = JTy.SqlType(tname)
    if st.is_string:
        return JT.Column._encode_strings(np.where(mask if mask is not None else True,
                                                  values, ""), mask)
    return JT.Column(jnp.asarray(values.astype(JTy.physical_dtype(st))), st,
                     None if mask is None else jnp.asarray(mask))


def _port_value(spec):
    if spec[0] == "s":
        return PT.Scalar(spec[1], PTy.SqlType(spec[2]))
    values, mask, tname = COLS[spec[1]]
    st = PTy.SqlType(tname)
    if st.is_string:
        return PT.Column._encode_strings(np.where(mask if mask is not None else True,
                                                  values, ""), mask, CPU)
    return PT.Column.from_encoded(values, st, mask, None, CPU)


def _host(v):
    """(kind, stype name, values) of either package's Column or Scalar."""
    if hasattr(v, "data"):
        return "column", v.stype.name, list(v.to_numpy())
    val = v.value
    if isinstance(val, (np.generic,)):
        val = val.item()
    return "scalar", v.stype.name, [val]


def _assert_equal(got, want, rtol, what):
    assert got[:2] == want[:2], what
    g, w = got[2], want[2]
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        if isinstance(b, (float, np.floating)) and not isinstance(b, bool):
            if a is None or b is None:
                assert a is None and b is None, (what, i, a, b)
            elif math.isnan(float(b)):
                assert a is not None and math.isnan(float(a)), (what, i, a, b)
            elif rtol:
                assert float(a) == pytest.approx(float(b), rel=rtol, abs=0), (what, i)
            else:
                assert float(a) == float(b), (what, i, a, b)
        else:
            assert str(a) == str(b), (what, i, a, b)


def _call(key, args):
    jargs = [_jax_value(a) for a in args]
    pargs = [_port_value(a) for a in args]
    # CASE is typed by its values (every other argument, and ELSE)
    typed = (lambda xs: xs[1::2] + xs[-1:]) if key == "CASE" else (lambda xs: xs)
    jt = JF.infer_call_type(key, [a.stype for a in typed(jargs)])
    pt = PF.infer_call_type(key, [a.stype for a in typed(pargs)])
    jctx = JT.Table(["x"], [_jax_value(c("I"))])
    pctx = PT.Table(["x"], [_port_value(c("I"))])
    return (JO.OPERATION_MAPPING[key](jargs, jt, jctx),
            PO.OPERATION_MAPPING[key](pargs, pt, pctx))


@pytest.mark.parametrize("key", sorted(k for k in JO.OPERATION_MAPPING
                                       if k not in _RANDOM))
def test_operator_matches_jax(key):
    rtol = 1e-13 if key in _TRANSCENDENTAL else 1e-14 if key == "CBRT" else 0
    cases = CASES[key]
    for spec in cases:
        want, got = _call(key, spec)
        _assert_equal(_host(got), _host(want), rtol, (key, spec))
    # every key is run on a column with NULLs and on literals alone
    assert any(a[0] == "c" and COLS[a[1]][1] is not None
               for spec in cases for a in spec) or key == "PI"
    assert any(all(a[0] == "s" for a in spec) for spec in cases)


def test_mapping_keys_equal_jax():
    assert set(PO.OPERATION_MAPPING) == set(JO.OPERATION_MAPPING)
    assert set(CASES) | _RANDOM == set(JO.OPERATION_MAPPING)


def test_power_of_integers_is_double():
    """POWER is DOUBLE-valued: POWER(2, -1) = 0.5 and POWER(-2, -1) = -0.5.
    The JAX package gives INT64_MIN there (jnp.power on int64), cast to
    DOUBLE; the port computes in float64."""
    i = PT.Column.from_encoded(np.array([2, -2, 3]), PTy.SqlType("BIGINT"),
                               None, None, CPU)
    k = PT.Column.from_encoded(np.array([-1, -1, 2]), PTy.SqlType("BIGINT"),
                               None, None, CPU)
    out = PO.OPERATION_MAPPING["POWER"]([i, k], PTy.SqlType("DOUBLE"), None)
    assert out.to_numpy().tolist() == [0.5, -0.5, 9.0]
    lit = PO.OPERATION_MAPPING["POWER"](
        [PT.Scalar(2, PTy.SqlType("INTEGER")), PT.Scalar(-1, PTy.SqlType("INTEGER"))],
        PTy.SqlType("DOUBLE"), None)
    assert lit.value == 0.5
    ji = JT.Column(jnp.asarray([2, -2]), JTy.SqlType("BIGINT"))
    jk = JT.Column(jnp.asarray([-1, -1]), JTy.SqlType("BIGINT"))
    jout = JO.OPERATION_MAPPING["POWER"]([ji, jk], JTy.SqlType("DOUBLE"), None)
    assert np.asarray(jout.data).tolist() == [float(-2**63)] * 2  # the reference


def test_cube_root_of_a_negative_literal():
    """CBRT(-8.0) = -2.0 on columns and literals alike (the JAX package's
    literal path takes the real part of a complex root, 1.0)."""
    out = PO.OPERATION_MAPPING["CBRT"]([PT.Scalar(-8.0, PTy.SqlType("DOUBLE"))],
                                       PTy.SqlType("DOUBLE"), None)
    assert out.value == pytest.approx(-2.0, rel=1e-15)


def test_greatest_least_over_strings():
    """Strings compare through their dictionaries (the JAX package raises
    here: it takes the maximum of codes of different dictionaries)."""
    col = _port_value(c("S"))
    other = _port_value(c("S2"))
    vals, mask = COLS["S"][0], COLS["S"][1]
    vals2, mask2 = COLS["S2"][0], COLS["S2"][1]
    for key, pick in (("GREATEST", max), ("LEAST", min)):
        out = PO.OPERATION_MAPPING[key]([col, PT.Scalar("c", PTy.SqlType("VARCHAR")),
                                         other], PTy.SqlType("VARCHAR"), None)
        want = [pick(a, "c", b) if m and m2 else None
                for a, b, m, m2 in zip(vals, vals2, mask, mask2)]
        assert out.to_numpy().tolist() == want


@pytest.mark.parametrize("key", sorted(_RANDOM))
def test_random_properties(key):
    """In [0, 1) (or [0, bound)); the same seed gives the same values on one
    device, another seed others; no seed draws fresh values."""
    table = PT.Table(["x"], [_port_value(c("I"))] * 1)
    big = PT.Table(["x"], [PT.Column.from_encoded(np.arange(1000), PTy.SqlType("BIGINT"),
                                                  None, None, CPU)])
    st = PF.infer_call_type(key, [])
    fn = PO.OPERATION_MAPPING[key]
    if key == "RAND_INTEGER":
        args = lambda seed: [PT.Scalar(seed, PTy.SqlType("INTEGER")),  # noqa: E731
                             PT.Scalar(10, PTy.SqlType("INTEGER"))]
        lo, hi = 0, 10
    else:
        args = lambda seed: [PT.Scalar(seed, PTy.SqlType("INTEGER"))]  # noqa: E731
        lo, hi = 0.0, 1.0
    a, b, other = (fn(args(sd), st, big).data for sd in (42, 42, 43))
    assert len(a) == 1000 and fn(args(1), st, table).data.shape == (N,)
    assert bool((a >= lo).all()) and bool((a < hi).all())
    assert torch.equal(a, b) and not torch.equal(a, other)
    unseeded = args(None)[1:] if key == "RAND_INTEGER" else []
    assert not torch.equal(fn(unseeded, st, big).data, fn(unseeded, st, big).data)
    if key != "RAND_INTEGER":
        assert a.dtype == torch.float64 and 0.4 < float(a.mean()) < 0.6
    else:
        assert a.dtype == torch.int32 and set(a.tolist()) == set(range(10))


@pytest.fixture(scope="module")
def contexts():
    rng = np.random.RandomState(5)
    n = 30
    t = pd.DataFrame({
        "i": rng.randint(-20, 20, n),
        "f": rng.randn(n) * 100,
        "s": rng.choice(["alpha beta", " Gamma ", "delta-epsilon", "zeta"], n),
        "d": pd.to_datetime("1995-03-01") + pd.to_timedelta(
            rng.randint(0, 900, n), unit="D"),
    })
    jc, pc = JaxContext(), Context(device=CPU)
    jc.create_table("t", t)
    pc.create_table("t", t)
    return jc, pc


def _same_sql(contexts, sql):
    jc, pc = contexts
    got = pc.sql(sql, return_futures=False)
    want = jc.sql(sql, return_futures=False)
    assert list(got.columns) == list(want.columns)
    for col in want.columns:
        g, w = got[col].to_numpy(), want[col].to_numpy()
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g.astype(np.float64), w, rtol=1e-13,
                                       equal_nan=True, err_msg=col)
        else:
            assert [str(x) for x in g] == [str(x) for x in w], col


@pytest.mark.parametrize("sql", [
    "SELECT ROUND(f * (1 - i / 100.0), 2) AS r, SQRT(ABS(f)) AS q, "
    "LN(ABS(f) + 1) AS l, POWER(i, 2) AS p, SIGN(f) AS sg, FLOOR(f) AS fl, "
    "CEIL(f) AS ce FROM t",
    "SELECT FLOOR(d TO MONTH) AS m, CEIL(d TO YEAR) AS y, YEAR(d) AS yy, "
    "DAYOFWEEK(d) AS dw, GREATEST(i, 0) AS g, LEAST(i, 5) AS l, "
    "NULLIF(i, 0) AS n, i IS DISTINCT FROM 3 AS dist FROM t",
    "SELECT UPPER(s) || '!' AS u, LOWER(s) AS lo, TRIM(s) AS tr, "
    "POSITION('a' IN s) AS po, REPLACE(s, 'a', 'A') AS re, LPAD(s, 12, '.') AS lp, "
    "SPLIT_PART(s, ' ', 1) AS sp, CHAR_LENGTH(s) AS cl FROM t",
    "SELECT s, COUNT(*) AS n FROM t WHERE s SIMILAR TO '%(a|e)' GROUP BY s ORDER BY s",
])
def test_sql_functions_match_jax(contexts, sql):
    _same_sql(contexts, sql)


def test_register_function_column_udf(contexts):
    """A column UDF gets numpy arrays and its result becomes a column of the
    declared type; the same function registered in both packages answers
    the same.  A row UDF (pandas rows) raises in the port."""
    jc, pc = contexts

    def f(x, y):
        return np.where(np.asarray(y) > 0, x * 2.0, x - 1.0)

    for ctx in (jc, pc):
        ctx.register_function(f, "twice_or_less", [("x", np.float64), ("y", np.int64)],
                              np.float64, replace=True)
        ctx.register_function(lambda row: row["a0"], "row_fn", [("x", np.int64)],
                              np.int64, replace=True, row_udf=True)
    _same_sql(contexts, "SELECT twice_or_less(f, i) AS u, i FROM t")
    with pytest.raises(NotImplementedError, match="row_fn"):
        pc.sql("SELECT row_fn(i) FROM t")
    with pytest.raises(ValueError, match="already registered"):
        pc.register_function(lambda x: x, "twice_or_less")


def test_smoke_script_drives_every_key(monkeypatch):
    """chip_smoke.py's phase 10 runs every key through ``Context.sql`` on
    the card (SEARCH from its RexCall); here its SQL runs on the CPU."""
    import chip_smoke as cs

    assert set(cs.FUNCTION_SQL) | {"SEARCH"} == set(JO.OPERATION_MAPPING)
    monkeypatch.setattr(cs, "FX_ROWS", 2000)
    monkeypatch.setattr(cs, "wall_ms", lambda fn: (fn(), 0.0)[1])
    walls = cs.phase_functions(CPU, 0)
    assert set(walls) == set(cs.FUNCTION_SQL)
