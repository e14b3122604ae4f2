"""The port's string fast paths against the JAX package's and the regex
bitmap: the vectorized host bitmap and the device bytes-matrix bitmap
(here on the CPU) must give the regex transpiler's bitmap on every pattern
they accept, and refuse the same patterns (``_`` wildcards, SIMILAR TO,
entries over 128 bytes, non-ASCII ILIKE on the device).  The inputs are
the JAX package's own differential set (``tests/unit/test_strings_fast.py``)."""
import re

import numpy as np
import pytest
import torch

from dask_sql_tpu.ops import strings_fast as JS
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.ops import strings_fast as PS
from dask_sql_tpu_torch.physical.rex.ops import like_bitmap, sql_like_to_regex

CPU = torch.device("cpu")

STRINGS = np.array([
    "", "a", "ab", "abc", "abcabc", "xabcy", "aabbcc", "abab",
    "hello world", "worldly", "special requests", "specialrequests",
    "xx special yy requests zz", "requests special", "%", "a%b", "a_b",
    "ABC", "AbC", "ivory blue", "blue ivory", "MEDIUM POLISHED TIN",
    "PROMO BRUSHED STEEL", "Customer on Complaints", "CustomerComplaints",
], dtype=object)

PATTERNS = [
    "%", "%%", "abc", "%abc", "abc%", "%abc%", "a%c", "%a%c%", "a%b%c",
    "%special%requests%", "ivory%", "%BRASS", "MEDIUM POLISHED%",
    "%Customer%Complaints%", "", "%a", "b%", "%ab%ab%", "abcabc",
    "x\\%y", "a\\%b",
]


def _regex_bitmap(d, pattern, escape, flags=0):
    rx = re.compile(sql_like_to_regex(pattern, escape), flags)
    return np.array([rx.match(s) is not None for s in d])


@pytest.mark.parametrize("pattern", PATTERNS)
def test_bitmaps_match_regex_and_jax(pattern):
    escape = "\\" if "\\" in pattern else None
    d = STRINGS.astype(str)
    want = _regex_bitmap(d, pattern, escape)
    vec = PS.like_bitmap_vectorized(d, pattern, escape, "LIKE")
    dev = PS.device_like_bitmap(STRINGS, pattern, escape, "LIKE", CPU)
    np.testing.assert_array_equal(vec, want, err_msg=pattern)
    np.testing.assert_array_equal(dev.numpy(), want, err_msg=pattern)
    np.testing.assert_array_equal(
        np.asarray(JS.device_like_bitmap(STRINGS, pattern, escape, "LIKE")),
        dev.numpy(), err_msg=pattern)
    assert PS.parse_like_chunks(pattern, escape) == \
        JS.parse_like_chunks(pattern, escape)


@pytest.mark.parametrize("pattern", ["%abc%", "ABC", "%promo%", "a%C"])
def test_ilike_paths(pattern):
    d = STRINGS.astype(str)
    want = _regex_bitmap(d, pattern, None, re.IGNORECASE)
    np.testing.assert_array_equal(
        PS.like_bitmap_vectorized(d, pattern, None, "ILIKE"), want)
    np.testing.assert_array_equal(
        PS.device_like_bitmap(STRINGS, pattern, None, "ILIKE", CPU).numpy(), want)


def test_outside_the_grammar_is_refused():
    d = STRINGS.astype(str)
    assert PS.parse_like_chunks("a_c", None) is None
    assert PS.like_bitmap_vectorized(d, "a_c", None, "LIKE") is None
    assert PS.like_bitmap_vectorized(d, "a%c", None, "SIMILAR") is None
    assert PS.device_like_bitmap(STRINGS, "a_c", None, "LIKE", CPU) is None
    assert PS.device_like_bitmap(STRINGS, "a%c", None, "SIMILAR", CPU) is None


def test_non_ascii_ilike_leaves_the_device():
    """Case folding beyond ASCII is the host's: the device refuses a
    non-ASCII dictionary or pattern, and the vectorized bitmap answers as
    the JAX package's does."""
    d = np.array(["Éclair", "éclair", "ÉCLAIR", "eclair", "straße"], dtype=object)
    assert PS.device_like_bitmap(d, "%clair", None, "ILIKE", CPU) is None
    ascii_d = STRINGS
    assert PS.device_like_bitmap(ascii_d, "é%", None, "ILIKE", CPU) is None
    for pattern in ("éclair", "%CLAIR", "STRASSE"):
        got = PS.like_bitmap_vectorized(d.astype(str), pattern, None, "ILIKE")
        np.testing.assert_array_equal(
            got, JS.like_bitmap_vectorized(d.astype(str), pattern, None, "ILIKE"))


def test_the_128_byte_cap():
    d = np.array(["x" * 200, "abc"], dtype=object)
    assert PS.device_like_bitmap(d, "%abc%", None, "LIKE", CPU) is None
    np.testing.assert_array_equal(
        PS.like_bitmap_vectorized(d.astype(str), "%abc%", None, "LIKE"),
        [False, True])
    # 128 bytes exactly is in; multi-byte characters count in bytes
    d = np.array(["y" * 128, "é" * 64, "é" * 65], dtype=object)
    assert PS.device_like_bitmap(d[:2], "%y", None, "LIKE", CPU) is not None
    assert PS.device_like_bitmap(d, "%y", None, "LIKE", CPU) is None


def test_random_differential():
    rng = np.random.RandomState(0)
    alphabet = list("abcx%")
    d = np.array(["".join(rng.choice(list("abcxy"), rng.randint(0, 12)))
                  for _ in range(300)], dtype=object)
    for _ in range(40):
        pattern = "".join(rng.choice(alphabet, rng.randint(0, 8)))
        want = _regex_bitmap(d.astype(str), pattern, None)
        np.testing.assert_array_equal(
            PS.like_bitmap_vectorized(d.astype(str), pattern, None, "LIKE"),
            want, err_msg=repr(pattern))
        np.testing.assert_array_equal(
            PS.device_like_bitmap(d, pattern, None, "LIKE", CPU).numpy(),
            want, err_msg=repr(pattern))


def test_chunk_longer_than_every_entry():
    d = np.array(["abcd", "efgh"], dtype=object)
    for pattern in ("%this-is-way-longer-than-any-entry%", "longer-than-entries"):
        got = PS.device_like_bitmap(d, pattern, None, "LIKE", CPU)
        np.testing.assert_array_equal(got.numpy(), [False, False])


def test_bytes_matrix_is_memoized_per_device():
    """One matrix per (dictionary, device); NUL characters survive the
    vectorized encode's fallback."""
    d = np.array(["ab", "a\x00", "b\x00\x00"], dtype=object)
    m1, lens, ascii_ = PS._bytes_matrix(d, CPU)
    assert lens.tolist() == [2, 2, 3] and ascii_
    assert PS._bytes_matrix(d, CPU)[0] is m1
    assert (id(d), "cpu") in PS._matrix_memo
    np.testing.assert_array_equal(
        PS.device_like_bitmap(d, "a%", None, "LIKE", CPU).numpy(), [True, True, False])


def test_like_routes_by_dictionary_size(monkeypatch):
    """At or past the threshold the device bitmap answers and is counted;
    below it the vectorized bitmap; ``_`` patterns take the regex path."""
    monkeypatch.setattr(PS, "DEVICE_STRING_THRESHOLD", 10)
    monkeypatch.setattr(PS, "stats", {k: 0 for k in PS.stats})
    d = STRINGS
    want = _regex_bitmap(d.astype(str), "%abc%", None)
    np.testing.assert_array_equal(like_bitmap("LIKE", "%abc%", None, d, CPU).numpy(), want)
    np.testing.assert_array_equal(like_bitmap("LIKE", "a_c", None, d, CPU).numpy(),
                                  _regex_bitmap(d.astype(str), "a_c", None))
    np.testing.assert_array_equal(like_bitmap("LIKE", "%abc%", None, d[:5], CPU).numpy(),
                                  want[:5])
    assert PS.stats == {"device_bitmaps": 1, "vectorized_bitmaps": 1,
                        "regex_bitmaps": 1}
    c = Context(device=CPU)
    c.create_table("t", {"c": np.tile(d, 3)})
    n = c.sql("SELECT COUNT(*) AS n FROM t WHERE c NOT LIKE '%special%requests%'")
    assert n.columns[0].to_numpy().tolist() == [3 * (len(d) - 3)]
    assert PS.stats["device_bitmaps"] == 2
