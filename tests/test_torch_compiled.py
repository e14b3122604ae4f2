"""The port's compiled tier (``dask_sql_tpu_torch/physical/compiled.py``) on
the CPU, against its eager executor, the JAX package's compiled tier, and
sqlite.

- The cases of ``tests/integration/test_compiled.py`` that do not depend on
  stage graphs, on ``Context(device="cpu")``: compiled answers equal the
  eager executor's (``DSQL_COMPILE=0``), with the same cache, escalation,
  fallback and persistence behaviour.
- The hashes, hash-table slots and group codes equal the JAX package's
  bit for bit (its uint64 values viewed as int64).
- TPC-H Q1-Q22 at SF 0.003: each query's tier verdict (compiled, runtime
  fallback or unsupported) equals the JAX tier's
  (``dask_sql_tpu.physical.compiled.try_execute_compiled``), each answer
  the port's eager answer (ints and strings exact, doubles rtol 1e-12) and
  sqlite's (the rules of ``test_torch_tpch.py``); Q1 bit for bit.  The
  stage counters (``stage_graphs``, ``stage_compiles``, ``stage_hits``)
  equal the JAX tier's too: Q2, Q8 and Q21 run as stage graphs at the
  default budget in both packages.
"""
import os
import sqlite3

import numpy as np
import pandas as pd
import pytest
import torch

from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.physical import compiled, graphs

CPU = torch.device("cpu")


@pytest.fixture()
def pc(df_simple, df, user_table_1, user_table_2, user_table_lk,
       string_table, user_table_nan):
    ctx = Context(device=CPU)
    for name, frame in {"df_simple": df_simple, "df": df,
                        "user_table_1": user_table_1,
                        "user_table_2": user_table_2,
                        "user_table_lk": user_table_lk,
                        "string_table": string_table,
                        "user_table_nan": user_table_nan}.items():
        ctx.create_table(name, frame)
    return ctx


def _eager(ctx, query):
    prev = os.environ.get("DSQL_COMPILE")
    os.environ["DSQL_COMPILE"] = "0"
    try:
        return ctx.sql(query, return_futures=False)
    finally:
        if prev is None:
            del os.environ["DSQL_COMPILE"]
        else:
            os.environ["DSQL_COMPILE"] = prev


def _both_paths(ctx, query):
    return ctx.sql(query, return_futures=False), _eager(ctx, query)


def _assert_same(comp: pd.DataFrame, eager: pd.DataFrame, ordered: bool):
    if not ordered:
        cols = list(comp.columns)
        comp = comp.sort_values(cols, ignore_index=True)
        eager = eager.sort_values(cols, ignore_index=True)
    pd.testing.assert_frame_equal(comp.reset_index(drop=True),
                                  eager.reset_index(drop=True),
                                  check_dtype=False)


def _tier(ctx) -> str:
    tier = None
    for s in ctx.last_report.root.walk():
        tier = s.attrs.get("tier", tier)
    return tier


def _served() -> int:
    return compiled.stats.get("compiles", 0) + compiled.stats.get("hits", 0)


QUERIES = [
    ("SELECT * FROM df_simple", False),
    ("SELECT a + b AS s, a * b AS p FROM df_simple WHERE a > 1", False),
    ("SELECT a, SUM(b) AS sb, COUNT(*) AS n, AVG(b) AS ab FROM df GROUP BY a", False),
    ("SELECT a, SUM(b) FILTER (WHERE b > 5) AS sb FROM df GROUP BY a", False),
    ("SELECT SUM(b) AS sb, MIN(a) AS ma, MAX(b) AS mb FROM df", False),
    ("SELECT user_id, SUM(b) AS x FROM user_table_1 GROUP BY user_id "
     "HAVING SUM(b) > 2", False),
    ("SELECT * FROM df WHERE b BETWEEN 2 AND 6 ORDER BY b DESC LIMIT 7", True),
    ("SELECT * FROM df ORDER BY a ASC, b DESC LIMIT 5 OFFSET 3", True),
    ("SELECT u1.user_id, u2.c FROM user_table_1 u1 "
     "JOIN user_table_2 u2 ON u1.user_id = u2.user_id", False),
    ("SELECT u1.user_id, u2.c FROM user_table_1 u1 "
     "LEFT JOIN user_table_2 u2 ON u1.user_id = u2.user_id", False),
    ("SELECT user_id FROM user_table_1 WHERE user_id IN "
     "(SELECT user_id FROM user_table_2)", False),
    ("SELECT lk_nullint FROM user_table_lk WHERE lk_nullint IS NOT NULL", False),
    ("SELECT a FROM string_table WHERE a LIKE '%normal%'", False),
    ("SELECT user_id FROM user_table_1 UNION SELECT user_id FROM user_table_2",
     False),
    ("SELECT user_id FROM user_table_1 UNION ALL "
     "SELECT user_id FROM user_table_2", False),
    ("SELECT CASE WHEN a > 1 THEN b ELSE -b END AS x FROM df_simple", False),
    ("SELECT lk_nullint, COUNT(*) AS n FROM user_table_lk GROUP BY lk_nullint",
     False),
    ("SELECT c FROM user_table_nan WHERE c IS NOT NULL ORDER BY c", True),
]


@pytest.mark.parametrize("query,ordered", QUERIES)
def test_compiled_matches_eager(pc, query, ordered):
    comp, eager = _both_paths(pc, query)
    _assert_same(comp, eager, ordered)


def test_compiled_path_used(pc):
    before = _served()
    pc.sql("SELECT a, SUM(b) AS s FROM df GROUP BY a")
    assert _served() == before + 1
    assert _tier(pc) == "compiled"


def test_left_join_actually_compiles(pc):
    pc.create_table("lj_build", pd.DataFrame({"user_id": [1, 2, 4],
                                              "c": [10, 20, 40]}))
    before_uns = compiled.stats.get("unsupported", 0)
    before = _served()
    fb = compiled.stats.get("fallbacks", 0)
    comp, eager = _both_paths(
        pc, "SELECT u1.user_id, u2.c FROM user_table_1 u1 "
            "LEFT JOIN lj_build u2 ON u1.user_id = u2.user_id")
    _assert_same(comp, eager, ordered=False)
    assert _served() == before + 1
    assert compiled.stats.get("unsupported", 0) == before_uns
    assert compiled.stats.get("fallbacks", 0) == fb


def test_cache_hit_on_repeat(pc):
    q = "SELECT a, COUNT(*) AS n FROM df WHERE b < 9 GROUP BY a"
    first = pc.sql(q, return_futures=False)
    hits = compiled.stats.get("hits", 0)
    second = pc.sql(q, return_futures=False)
    assert compiled.stats["hits"] == hits + 1
    _assert_same(first, second, ordered=True)


def test_group_capacity_escalation(pc, monkeypatch):
    # a tiny starting capacity: the first run overflows, the program is
    # rebuilt with a larger one, and the answer is exact
    monkeypatch.setattr(compiled, "DEFAULT_GROUP_CAP", 2)
    rec = compiled.stats.get("recompiles", 0)
    comp, eager = _both_paths(pc, "SELECT b, COUNT(*) AS n FROM df GROUP BY b")
    _assert_same(comp, eager, ordered=False)
    assert compiled.stats["recompiles"] > rec


def test_hash_rounds_escalation(pc, monkeypatch):
    # one probing round cannot resolve 700 distinct float keys: the flags
    # report the site unresolved and the program is rebuilt with twice the
    # rounds until it resolves, with the JAX package's exact answer
    monkeypatch.setattr(compiled, "DEFAULT_HASH_ROUNDS", 1)
    rec = compiled.stats.get("recompiles", 0)
    fb = compiled.stats.get("fallbacks", 0)
    comp, eager = _both_paths(
        pc, "SELECT b, COUNT(*) AS n, SUM(a) AS s FROM df GROUP BY b")
    _assert_same(comp, eager, ordered=False)
    assert compiled.stats["recompiles"] > rec
    assert compiled.stats.get("fallbacks", 0) == fb
    learned = [c for c in compiled._learned_caps.values() if "rnd0" in c]
    assert learned and all(1 < c["rnd0"] <= 64 for c in learned)


def test_group_caps_persist_to_file(pc, monkeypatch, tmp_path):
    caps_file = tmp_path / "caps.json"
    monkeypatch.setenv("DSQL_CAPS_FILE", str(caps_file))
    monkeypatch.setattr(compiled, "DEFAULT_GROUP_CAP", 2)
    monkeypatch.setattr(compiled, "_caps_disk", None)
    q = "SELECT b, SUM(a) AS s FROM df GROUP BY b"
    rec = compiled.stats.get("recompiles", 0)
    pc.sql(q)
    assert compiled.stats["recompiles"] > rec
    assert caps_file.exists()
    # a cold process: no programs, no caps in memory, only the file
    monkeypatch.setattr(compiled, "_cache", type(compiled._cache)())
    monkeypatch.setattr(compiled, "_learned_caps",
                        type(compiled._learned_caps)())
    monkeypatch.setattr(compiled, "_caps_disk", None)
    rec = compiled.stats["recompiles"]
    comp, eager = _both_paths(pc, q)
    _assert_same(comp, eager, ordered=False)
    assert compiled.stats["recompiles"] == rec


def test_runtime_fallback_nonunique_build(pc):
    fb = compiled.stats.get("fallbacks", 0)
    comp, eager = _both_paths(
        pc, "SELECT u1.b, u2.b AS b2 FROM user_table_1 u1 "
            "JOIN user_table_1 u2 ON u1.user_id = u2.user_id")
    _assert_same(comp, eager, ordered=False)
    assert compiled.stats["fallbacks"] > fb
    assert _tier(pc) == "eager"


@pytest.mark.parametrize("strategy", ["host", "tpu"])
def test_semi_join_heavy_duplicate_build(pc, strategy, monkeypatch):
    # a SEMI build side with one key 200 times: duplicates are legal for
    # SEMI/ANTI, and both strategies (hash table; sorted probe) answer
    # in-program with no fallback
    monkeypatch.setenv("DSQL_STRATEGY", strategy)
    big = pd.DataFrame({"k": np.r_[np.full(200, 7),
                                   np.arange(50)].astype(np.int64)})
    probe = pd.DataFrame({"k": np.arange(20).astype(np.int64)})
    pc.create_table(f"bucket_build_{strategy}", big)
    pc.create_table(f"bucket_probe_{strategy}", probe)
    q = (f"SELECT k FROM bucket_probe_{strategy} WHERE k IN "
         f"(SELECT k FROM bucket_build_{strategy})")
    fb = compiled.stats.get("fallbacks", 0)
    comp, eager = _both_paths(pc, q)
    _assert_same(comp, eager, ordered=False)
    assert compiled.stats.get("fallbacks", 0) == fb


def test_unsupported_plan_falls_back(pc):
    # LAG is outside the traceable window functions
    uns = compiled.stats.get("unsupported", 0)
    r = pc.sql("SELECT b, LAG(b, 1) OVER (ORDER BY b) AS lb FROM df_simple",
               return_futures=False)
    assert r["lb"].tolist()[1:] == [1.1, 2.2]
    assert compiled.stats["unsupported"] > uns
    assert _tier(pc) == "eager"


def test_host_read_in_trace_falls_back(pc):
    # a cast of numbers to strings builds its dictionary from the values on
    # the host: the trace sees the read and declines, counted, annotated
    # and cached like any unsupported plan
    q = "SELECT CAST(user_id AS VARCHAR) AS s FROM user_table_1"
    uns = compiled.stats.get("unsupported", 0)
    comp = pc.sql(q, return_futures=False)
    reasons = [s.attrs.get("compiled_unsupported")
               for s in pc.last_report.root.walk()]
    assert any(r and "host read" in r for r in reasons), reasons
    assert compiled.stats["unsupported"] == uns + 1
    assert _tier(pc) == "eager"
    _assert_same(comp, _eager(pc, q), ordered=False)
    pc.sql(q)
    assert compiled.stats["unsupported"] == uns + 2


def test_window_compiles(pc):
    before = _served()
    r = pc.sql("SELECT b, ROW_NUMBER() OVER (ORDER BY b DESC) AS rn, "
               "SUM(b) OVER (PARTITION BY a) AS sb FROM df_simple",
               return_futures=False)
    assert _served() == before + 1
    assert sorted(r["rn"].tolist()) == [1, 2, 3]


def test_compiled_disabled_by_env(pc, monkeypatch):
    monkeypatch.setenv("DSQL_COMPILE", "0")
    n = _served()
    r = pc.sql("SELECT SUM(a) AS s FROM df_simple", return_futures=False)
    assert r["s"][0] == 6
    assert _served() == n
    assert _tier(pc) == "eager"


def test_nan_join_key_matches_nothing(pc):
    pc.create_table("nan_l", pd.DataFrame({"x": [0.0, 1.0], "y": [0.0, 1.0]}))
    pc.create_table("nan_r", pd.DataFrame({"f": [0.0, 1.0], "tag": [10, 20]}))
    comp, eager = _both_paths(
        pc, "SELECT t.f2, r.tag FROM (SELECT x / y AS f2 FROM nan_l) t "
            "JOIN nan_r r ON t.f2 = r.f")
    _assert_same(comp, eager, ordered=False)
    assert len(comp) == 1


def test_desc_sort_nan_last_both_paths(pc):
    pc.create_table("nan_s", pd.DataFrame({"x": [0.0, 2.0, 1.0],
                                           "y": [0.0, 1.0, 1.0]}))
    comp, eager = _both_paths(
        pc, "SELECT x / y AS r FROM nan_s ORDER BY r DESC")
    assert np.isnan(comp["r"].iloc[-1]) and np.isnan(eager["r"].iloc[-1])
    _assert_same(comp, eager, ordered=True)


def test_distinct_aggregate_compiles(pc):
    before = _served()
    comp, eager = _both_paths(
        pc, "SELECT user_id, COUNT(DISTINCT b) AS n, SUM(DISTINCT b) AS s "
            "FROM user_table_1 GROUP BY user_id")
    _assert_same(comp, eager, ordered=False)
    assert _served() == before + 1
    comp, eager = _both_paths(
        pc, "SELECT COUNT(DISTINCT b) AS n FROM user_table_1")
    _assert_same(comp, eager, ordered=True)


def test_scalar_subquery_compiles(pc):
    before = _served()
    comp, eager = _both_paths(
        pc, "SELECT user_id, b FROM user_table_1 "
            "WHERE b > (SELECT AVG(b) FROM user_table_1)")
    _assert_same(comp, eager, ordered=False)
    assert _served() == before + 1


def test_left_join_residual_compiles(pc):
    before = _served()
    comp, eager = _both_paths(
        pc, "SELECT u2.user_id, u2.c, u1.b FROM user_table_2 u2 "
            "LEFT JOIN user_table_1 u1 "
            "ON u2.user_id = u1.user_id AND u1.b > u2.user_id")
    _assert_same(comp, eager, ordered=False)
    # the build side has a duplicate key: a runtime fallback, as in the
    # JAX package; either way one attempt is counted
    assert _served() == before + 1


@pytest.mark.parametrize("strategy", ["host", "tpu"])
def test_anti_join_comparison_residual_compiles(pc, strategy, monkeypatch):
    # NOT EXISTS with a build-vs-probe comparison residual (TPC-H Q21's
    # shape): per-key build count/min/max decide existence in-program (the
    # hash table's groups; the merged stream's hash runs)
    monkeypatch.setenv("DSQL_STRATEGY", strategy)
    pc.create_table("resid_li", pd.DataFrame({"ok": [1, 1, 1, 2, 2, 3],
                                              "sk": [10, 11, 10, 20, 20, 30]}))
    before = _served()
    fb = compiled.stats.get("fallbacks", 0)
    comp, eager = _both_paths(
        pc, "SELECT l1.ok, l1.sk FROM resid_li l1 WHERE NOT EXISTS ("
            "SELECT * FROM resid_li l2 WHERE l2.ok = l1.ok AND l2.sk <> l1.sk)")
    _assert_same(comp, eager, ordered=False)
    assert sorted(comp.ok.unique().tolist()) == [2, 3]
    assert _served() == before + 1
    assert compiled.stats.get("fallbacks", 0) == fb


def test_wide_build_side_merge_join(pc, monkeypatch):
    """The tpu strategy's sorted probe gathers build columns by row id:
    width changes neither the answer nor the single program."""
    monkeypatch.setenv("DSQL_STRATEGY", "tpu")
    wide = pd.DataFrame({"user_id": [1, 2, 3],
                         **{f"w{i}": [i, i + 1, i + 2] for i in range(6)}})
    pc.create_table("wide_build", wide)
    before = _served()
    comp, eager = _both_paths(
        pc, "SELECT u1.user_id, w.w0, w.w5 FROM user_table_1 u1 "
            "JOIN wide_build w ON u1.user_id = w.user_id")
    _assert_same(comp, eager, ordered=False)
    assert _served() == before + 1


@pytest.mark.parametrize("query,ordered", QUERIES)
def test_tpu_strategy_matches_eager(pc, query, ordered, monkeypatch):
    """``DSQL_STRATEGY=tpu``: sorted group-by, merge joins and the
    in-program sort give the eager answers too."""
    monkeypatch.setenv("DSQL_STRATEGY", "tpu")
    comp, eager = _both_paths(pc, query)
    _assert_same(comp, eager, ordered)


def test_cache_hit_on_reloaded_identical_data():
    """Reloaded equal data (new tables) hits the same program and answers
    from the new data; a changed dictionary is another program."""
    def make_df():
        return pd.DataFrame({"k": ["x", "y", "x", "z"] * 5,
                             "v": list(range(20))})

    q = "SELECT k, SUM(v) AS s FROM reload_t GROUP BY k"
    c1 = Context(device=CPU)
    c1.create_table("reload_t", make_df())
    r1 = c1.sql(q, return_futures=False)
    compiles = compiled.stats["compiles"]
    hits = compiled.stats.get("hits", 0)

    c2 = Context(device=CPU)
    df2 = make_df()
    df2["v"] = df2["v"] * 10   # same layout, new values
    c2.create_table("reload_t", df2)
    r2 = c2.sql(q, return_futures=False)
    assert compiled.stats["compiles"] == compiles, "recompiled on reload"
    assert compiled.stats["hits"] == hits + 1
    pd.testing.assert_series_equal(
        r2.sort_values("k", ignore_index=True)["s"],
        r1.sort_values("k", ignore_index=True)["s"] * 10, check_dtype=False)

    c3 = Context(device=CPU)
    df3 = make_df()
    df3.loc[3, "k"] = "w"
    c3.create_table("reload_t", df3)
    r3 = c3.sql(q, return_futures=False)
    assert compiled.stats["compiles"] == compiles + 1
    assert set(r3["k"]) == {"w", "x", "y", "z"}
    assert int(r3.set_index("k").loc["w", "s"]) == 3


def test_runtime_verdict_not_inherited_by_reloaded_data():
    q = "SELECT p.k, b.v FROM rv_probe p JOIN rv_build b ON p.k = b.k"
    c1 = Context(device=CPU)
    c1.create_table("rv_probe", pd.DataFrame({"k": [1, 2, 3, 4]}))
    c1.create_table("rv_build", pd.DataFrame({"k": [1, 1, 2, 4],
                                              "v": [9, 8, 7, 6]}))
    fb = compiled.stats.get("fallbacks", 0)
    c1.sql(q, return_futures=False)
    assert compiled.stats["fallbacks"] > fb

    c2 = Context(device=CPU)
    c2.create_table("rv_probe", pd.DataFrame({"k": [1, 2, 3, 4]}))
    c2.create_table("rv_build", pd.DataFrame({"k": [1, 3, 2, 4],
                                              "v": [9, 8, 7, 6]}))
    fb2 = compiled.stats["fallbacks"]
    r = c2.sql(q, return_futures=False)
    assert compiled.stats["fallbacks"] == fb2, "inherited stale exile"
    assert sorted(r["k"].tolist()) == [1, 2, 3, 4]


def test_compiled_path_uses_device_string_bitmap(monkeypatch):
    from dask_sql_tpu_torch.ops import strings_fast

    monkeypatch.setattr(strings_fast, "DEVICE_STRING_THRESHOLD", 1)
    c = Context(device=CPU)
    c.create_table("t", pd.DataFrame(
        {"s": ["special requests", "plain", "very special requests here",
               "nothing"] * 50}))
    before_dev = strings_fast.stats["device_bitmaps"]
    before = compiled.stats["compiles"]
    out = c.sql("SELECT COUNT(*) AS n FROM t WHERE s LIKE "
                "'%special%requests%'", return_futures=False)
    assert out["n"].tolist() == [100]
    assert compiled.stats["compiles"] > before
    assert strings_fast.stats["device_bitmaps"] > before_dev


def test_small_result_keeps_host_copies(pc):
    r = pc.sql("SELECT a, SUM(b) AS s FROM df GROUP BY a ORDER BY a")
    assert _tier(pc) == "compiled"
    assert all(c.host is not None for c in r.columns)
    np.testing.assert_array_equal(r.columns[0].host[0],
                                  r.columns[0].data.numpy())


@pytest.mark.parametrize("query", [
    "SELECT * FROM df ORDER BY a ASC, b DESC LIMIT 5 OFFSET 3",
    "SELECT s.k, d.b FROM sorted_s s JOIN df_simple d "
    "ON s.v = d.a ORDER BY s.k DESC, d.b LIMIT 2",
    "SELECT lk_nullint, id FROM user_table_lk ORDER BY lk_nullint NULLS FIRST",
])
def test_large_result_sorts_on_device(pc, query, monkeypatch):
    # past SMALL_FETCH_BYTES only the flags come to the host: the peeled
    # ORDER BY then sorts on the device, with the same answer
    monkeypatch.setattr(compiled, "SMALL_FETCH_BYTES", 0)
    pc.create_table("sorted_s", pd.DataFrame(
        {"k": ["pear", "fig", "apple", "kiwi"], "v": [1, 2, 4, 3]}))
    comp = pc.sql(query)
    assert _tier(pc) == "compiled"
    assert all(c.host is None for c in comp.columns)
    _assert_same(comp.to_pandas(), _eager(pc, query), ordered=True)


# ---------------------------------------------------------------------------
# the trace checks of physical/graphs.py
# ---------------------------------------------------------------------------

def test_host_read_of_traced_data_raises():
    x = torch.arange(6)

    def reads(t):
        return torch.full((3,), t.sum().item())

    def reads_constant(t):
        k = torch.tensor([1, 2, 3]).sum().item()   # host-side value
        return (t + k,)

    with pytest.raises(graphs.HostRead, match="item"):
        graphs.GraphProgram(reads, CPU)(x)
    out = graphs.GraphProgram(reads_constant, CPU)(x)
    assert out[0].tolist() == [6, 7, 8, 9, 10, 11]
    for bad in (lambda t: (t[t > 2],), lambda t: (torch.nonzero(t),),
                lambda t: (torch.unique(t),), lambda t: (int(t[0]),)):
        with pytest.raises(graphs.HostRead):
            graphs.GraphProgram(bad, CPU)(x)


def test_trace_mode_is_per_thread():
    """A warm-up's ``_TraceMode`` (a ``TorchFunctionMode``) lives on its
    thread's mode stack: while one thread traces, another thread's host
    read of the same tensor neither raises nor is seen by the trace."""
    import threading

    x = torch.arange(6)
    inside, done = threading.Event(), threading.Event()
    seen = {}

    def traced(t):
        inside.set()
        done.wait(30)
        return (t * 2,)

    def other():
        inside.wait(30)
        seen["modes"] = torch._C._len_torch_function_stack()
        seen["value"] = x.sum().item()   # a host read of the traced input
        done.set()

    thread = threading.Thread(target=other)
    thread.start()
    out = graphs.GraphProgram(traced, CPU)(x)
    thread.join()
    assert seen == {"modes": 0, "value": 15}
    assert out[0].tolist() == [0, 2, 4, 6, 8, 10]


# ---------------------------------------------------------------------------
# bit equality with the JAX package
# ---------------------------------------------------------------------------

def _u64_as_i64(a) -> np.ndarray:
    return np.asarray(a).view(np.int64)


def test_mix64_and_f64_hash_part_equal_jax():
    import jax.numpy as jnp
    from dask_sql_tpu.physical import compiled as jc

    rng = np.random.default_rng(0)
    z = rng.integers(-2**63, 2**63 - 1, 4096, dtype=np.int64)
    got = compiled._mix64(torch.from_numpy(z)).numpy()
    want = _u64_as_i64(jc._mix64(jnp.asarray(z.view(np.uint64))))
    np.testing.assert_array_equal(got, want)

    x = np.concatenate([rng.normal(0, 1e6, 2000), [0.0, -0.0, np.nan, np.inf,
                                                   -np.inf, 1e-310, 3.5e38]])
    got = compiled._f64_hash_part(torch.from_numpy(x)).numpy()
    want = _u64_as_i64(jc._f64_hash_part(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)


def _both_tables(frame: pd.DataFrame):
    """The same frame as a JAX and a port table (same encodings)."""
    from dask_sql_tpu import Context as JaxContext

    jc_ctx, pc_ctx = JaxContext(), Context(device=CPU)
    jc_ctx.create_table("t", frame)
    pc_ctx.create_table("t", frame)
    return (jc_ctx.schema["root"].tables["t"].table,
            pc_ctx.schema["root"].tables["t"].table)


@pytest.fixture(scope="module")
def key_frame():
    rng = np.random.default_rng(1)
    n = 3000
    f = rng.integers(0, 40, n).astype(np.float64)
    f[rng.random(n) < 0.05] = np.nan
    s = rng.choice(["ant", "bee", "cat", "dog", "eel"], n).astype(object)
    s[rng.random(n) < 0.05] = None
    b = pd.array(rng.random(n) < 0.5, dtype="boolean")
    b[rng.random(n) < 0.05] = pd.NA
    return pd.DataFrame({"i": rng.integers(-5, 300, n), "f": f, "s": s,
                         "b": b, "big": rng.integers(0, 2**40, n)})


def test_hash_group_parts_equal_jax(key_frame):
    from dask_sql_tpu.ops.kernels import key_parts as jkp
    from dask_sql_tpu.physical import compiled as jc
    from dask_sql_tpu_torch.ops.kernels import key_parts as tkp

    jt, tt = _both_tables(key_frame)
    for cols in (["i"], ["f"], ["s", "i"], ["i", "f", "s", "b"]):
        jcols = [jt.column(n) for n in cols]
        tcols = [tt.column(n) for n in cols]
        want = _u64_as_i64(jc._hash_group_parts(jkp(jcols)))
        got = compiled._hash_group_parts(tkp(tcols)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(cols))


@pytest.mark.parametrize("direct", [False, True])
def test_hash_table_insert_equal_jax(key_frame, direct):
    import jax.numpy as jnp
    from dask_sql_tpu.ops.kernels import key_parts as jkp
    from dask_sql_tpu.physical import compiled as jc
    from dask_sql_tpu_torch.ops.kernels import key_parts as tkp

    jt, tt = _both_tables(key_frame)
    n = tt.num_rows
    valid = np.random.default_rng(2).random(n) < 0.9
    cols = ["big"] if direct else ["f", "s"]
    jparts = jkp([jt.column(c) for c in cols])
    tparts = tkp([tt.column(c) for c in cols])
    jh = jc._hash_group_parts(jparts)
    th = compiled._hash_group_parts(tparts)
    size = jc._hash_table_size(n)
    jd = td = None
    if direct:
        raw = jparts[0][0].astype(jnp.int64)
        jd = jc._direct_info(raw, jnp.asarray(valid), size)
        td = compiled._direct_info(tparts[0][0], torch.from_numpy(valid), size)
    js, jr, jok, jtab, _ = jc._hash_table_insert(jh, jnp.asarray(valid), size,
                                                 jd)
    ts, tr, tok, ttab, unres = compiled._hash_table_insert(
        th, torch.from_numpy(valid), size, td)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(ttab.numpy(), np.asarray(jtab))
    assert not bool(unres)


def test_group_hashed_codes_equal_jax(key_frame):
    import jax.numpy as jnp
    from dask_sql_tpu.physical import compiled as jc

    jt, tt = _both_tables(key_frame)
    valid = np.random.default_rng(3).random(tt.num_rows) < 0.8
    for cols, cap in ((["i"], 512), (["s", "b"], 64), (["f", "s"], 512),
                      (["i", "f"], 64)):
        want = jc._group_hashed_codes([jt.column(c) for c in cols],
                                      jnp.asarray(valid), cap)
        got = compiled._group_hashed_codes([tt.column(c) for c in cols],
                                           torch.from_numpy(valid), cap)
        for g, w, name in zip(got, want, ("codes", "first_rows",
                                          "num_groups", "collision")):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"{cols} {name}")


def test_try_static_codes_equal_jax(key_frame):
    from dask_sql_tpu.physical import compiled as jc

    jt, tt = _both_tables(key_frame)
    for cols in (["s"], ["s", "b"], ["b"]):
        jcodes, jdom, jmeta = jc._try_static_codes([jt.column(c) for c in cols])
        tcodes, tdom, tmeta = compiled._try_static_codes(
            [tt.column(c) for c in cols])
        assert (tdom, tmeta) == (jdom, jmeta)
        np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
        jkeys = jc._decode_static_keys([jt.column(c) for c in cols], jmeta,
                                       jdom)
        tkeys = compiled._decode_static_keys([tt.column(c) for c in cols],
                                             tmeta, tdom, CPU)
        for j, t in zip(jkeys, tkeys):
            np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
    assert compiled._try_static_codes([tt.column("i")]) is None


@pytest.mark.parametrize("strategy", ["host", "tpu"])
def test_group_sorted_codes_equal_jax(key_frame, strategy, monkeypatch):
    import jax.numpy as jnp
    from dask_sql_tpu.physical import compiled as jc

    monkeypatch.setenv("DSQL_STRATEGY", strategy)
    jt, tt = _both_tables(key_frame)
    valid = np.random.default_rng(4).random(tt.num_rows) < 0.85
    for cols in (["i"], ["s", "b"], ["f", "s", "i"]):
        want = jc._group_sorted_codes([jt.column(c) for c in cols],
                                      jnp.asarray(valid), 1024)
        got = compiled._group_sorted_codes([tt.column(c) for c in cols],
                                           torch.from_numpy(valid), 1024,
                                           tpu=strategy == "tpu")
        for name in ("perm", "codes_sorted", "num_groups", "starts", "ends",
                     "first_rows", "collision", "valid_sorted"):
            np.testing.assert_array_equal(
                getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                err_msg=f"{cols} {name}")


@pytest.mark.parametrize("op", ["COUNT", "SUM", "$SUM0", "AVG", "MIN", "MAX",
                                "STDDEV_SAMP", "BOOL_OR", "FIRST_VALUE",
                                "LAST_VALUE"])
def test_sorted_segment_aggregate_matches_jax(key_frame, op):
    import jax.numpy as jnp
    from dask_sql_tpu.ops import groupby as JG
    from dask_sql_tpu.physical import compiled as jc
    from dask_sql_tpu_torch.ops import groupby as TG

    jt, tt = _both_tables(key_frame)
    valid = np.random.default_rng(5).random(tt.num_rows) < 0.9
    jgs = jc._group_sorted_codes([jt.column("s")], jnp.asarray(valid), 16)
    tgs = compiled._group_sorted_codes([tt.column("s")],
                                       torch.from_numpy(valid), 16)
    arg = "b" if op == "BOOL_OR" else "f"
    jcol, tcol = jt.column(arg), tt.column(arg)
    jcs = jcol.take(jgs.perm)
    tcs = tcol.take(tgs.perm)
    jv = jgs.valid_sorted & jcs.valid_mask()
    tv = tgs.valid_sorted & tcs.valid_mask()
    from dask_sql_tpu.types import SqlType as JS
    from dask_sql_tpu_torch.types import SqlType as TS
    rtype = {"COUNT": "BIGINT", "BOOL_OR": "BOOLEAN"}.get(op, "DOUBLE")
    want = JG.sorted_segment_aggregate(op, jcs, jv, jgs.codes_sorted,
                                       jgs.starts, jgs.ends, JS(rtype))
    got = TG.sorted_segment_aggregate(op, tcs, tv, tgs.codes_sorted,
                                      tgs.starts, tgs.ends, TS(rtype))
    w, g = np.asarray(want.data), got.data.numpy()
    wm = np.ones(len(w), bool) if want.mask is None else np.asarray(want.mask)
    gm = np.ones(len(g), bool) if got.mask is None else got.mask.numpy()
    np.testing.assert_array_equal(gm, wm)
    if w.dtype.kind == "f":
        np.testing.assert_allclose(g[wm], w[wm], rtol=1e-12)
    else:
        np.testing.assert_array_equal(g[wm], w[wm])


# ---------------------------------------------------------------------------
# TPC-H Q1-Q22: verdicts against the JAX tier, answers against eager and sqlite
# ---------------------------------------------------------------------------

SF = 0.003


@pytest.fixture(scope="module")
def tpch_data():
    from benchmarks.tpch import generate_tpch
    return generate_tpch(SF)


def _verdict(before: dict, after: dict, result) -> str:
    def d(k):
        return after.get(k, 0) - before.get(k, 0)
    if d("unsupported"):
        return "unsupported"
    if d("fallbacks"):
        return "fallback"
    return "compiled" if result is not None else "eager"


STAGE_COUNTERS = ("stage_graphs", "stage_compiles", "stage_hits")


def _stage_counters(before: dict, after: dict) -> dict:
    return {k: after.get(k, 0) - before.get(k, 0) for k in STAGE_COUNTERS}


@pytest.fixture(scope="module")
def jax_verdicts(tpch_data):
    """The JAX tier's verdict and stage counters on each query (its
    try_execute_compiled on the plan its Context builds), under the pins
    of conftest."""
    from benchmarks.tpch import QUERIES
    from dask_sql_tpu import Context as JaxContext
    from dask_sql_tpu.physical import compiled as jc
    from dask_sql_tpu.sql.parser import parse_sql

    with pytest.MonkeyPatch.context() as mp:
        for k, v in (("DSQL_ADAPTIVE", "0"), ("DSQL_TIERED", "0"),
                     ("DSQL_RESULT_CACHE_MB", "0"),
                     ("DSQL_MAX_CONCURRENT_QUERIES", "0")):
            mp.setenv(k, v)
        for k in ("DSQL_COMPILE", "DSQL_STRATEGY", "DSQL_PROGRAM_STORE",
                  "DSQL_CAPS_FILE"):
            mp.delenv(k, raising=False)
        ctx = JaxContext()
        for name, frame in tpch_data.items():
            ctx.create_table(name, frame)
        out = {}
        for qid in sorted(QUERIES):
            plan = ctx._get_plan(parse_sql(QUERIES[qid])[0].query)
            before = dict(jc.stats)
            result = jc.try_execute_compiled(plan, ctx)
            after = dict(jc.stats)
            out[qid] = (_verdict(before, after, result),
                        _stage_counters(before, after))
    return out


@pytest.fixture(scope="module")
def tpch_port(tpch_data):
    ctx = Context(device=CPU)
    for name, frame in tpch_data.items():
        ctx.create_table(name, frame)
    return ctx


@pytest.fixture(scope="module")
def tpch_sqlite(tpch_data):
    conn = sqlite3.connect(":memory:")
    for name, frame in tpch_data.items():
        sdf = frame.copy()
        for col in sdf.columns:
            if sdf[col].dtype.kind == "M":
                sdf[col] = sdf[col].dt.strftime("%Y-%m-%d")
        sdf.to_sql(name, conn, index=False)
        for col in sdf.columns:
            if col.endswith("key"):
                conn.execute(f"CREATE INDEX {col}_idx ON {name} ({col})")
    yield conn
    conn.close()


def _tpch_qids():
    from benchmarks.tpch import QUERIES
    return sorted(QUERIES)


@pytest.mark.parametrize("qid", _tpch_qids())
def test_tpch_compiled(qid, tpch_port, tpch_sqlite, jax_verdicts):
    from benchmarks.tpch import QUERIES
    from test_torch_tpch import _to_sqlite

    q = QUERIES[qid]
    before = dict(compiled.stats)
    got = tpch_port.sql(q)
    after = dict(compiled.stats)
    verdict = (_verdict(before, after,
                        got if _tier(tpch_port) == "compiled" else None),
               _stage_counters(before, after))
    assert verdict == jax_verdicts[qid], f"Q{qid}: {verdict}"
    assert bool(verdict[1]["stage_graphs"]) == (qid in (2, 8, 21))
    eager = _eager(tpch_port, q)
    comp = got.to_pandas()
    assert list(comp.columns) == list(eager.columns)
    assert len(comp) == len(eager)
    ordered = "ORDER BY" in q
    if not ordered:
        comp = comp.sort_values(list(comp.columns), ignore_index=True)
        eager = eager.sort_values(list(eager.columns), ignore_index=True)
    for col in eager.columns:
        g, w = comp[col].to_numpy(), eager[col].to_numpy()
        if qid == 1 and w.dtype.kind == "f":
            assert np.array_equal(g.view(np.int64), w.view(np.int64)), col
        elif w.dtype.kind == "f":
            np.testing.assert_allclose(g.astype(np.float64), w, rtol=1e-12,
                                       err_msg=f"Q{qid} {col}")
        else:
            assert g.tolist() == w.tolist(), f"Q{qid} {col}"
    want = pd.read_sql(_to_sqlite(q), tpch_sqlite)
    assert len(comp) == len(want)
    want.columns = list(comp.columns)
    if not ordered:
        want = want.sort_values(list(want.columns), ignore_index=True)
    for col in want.columns:
        gv, wv = comp[col], want[col]
        if gv.dtype.kind == "M":
            gv = gv.dt.strftime("%Y-%m-%d")
        if gv.dtype.kind in "fc" or wv.dtype.kind in "fc":
            np.testing.assert_allclose(
                pd.to_numeric(gv, errors="coerce").to_numpy(dtype=float),
                pd.to_numeric(wv, errors="coerce").to_numpy(dtype=float),
                rtol=1e-6, err_msg=f"Q{qid} {col}")
        else:
            assert (gv.astype(str).to_numpy()
                    == wv.astype(str).to_numpy()).all(), f"Q{qid} {col}"


@pytest.mark.parametrize("qid", _tpch_qids())
def test_tpch_tpu_strategy(qid, tpch_port, monkeypatch):
    """Q1-Q22 under ``DSQL_STRATEGY=tpu`` equal the eager answers (doubles
    rtol 1e-12: sorted sums add in another order)."""
    from benchmarks.tpch import QUERIES

    monkeypatch.setenv("DSQL_STRATEGY", "tpu")
    q = QUERIES[qid]
    comp = tpch_port.sql(q, return_futures=False)
    eager = _eager(tpch_port, q)
    assert len(comp) == len(eager)
    if "ORDER BY" not in q:
        comp = comp.sort_values(list(comp.columns), ignore_index=True)
        eager = eager.sort_values(list(eager.columns), ignore_index=True)
    for col in eager.columns:
        g, w = comp[col].to_numpy(), eager[col].to_numpy()
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g.astype(np.float64), w, rtol=1e-12,
                                       err_msg=f"Q{qid} {col}")
        else:
            assert g.tolist() == w.tolist(), f"Q{qid} {col}"


def test_selective_filter_compacts_under_tpu_strategy(monkeypatch):
    """A filter keeping 1% of 2**17 rows under a GROUP BY is compacted to a
    learned capacity (the tpu strategy): the first run's cap shrinks once,
    and the answers equal eager."""
    monkeypatch.setenv("DSQL_STRATEGY", "tpu")
    rng = np.random.default_rng(6)
    n = 1 << 17
    c = Context(device=CPU)
    c.create_table("big", pd.DataFrame({"k": rng.integers(0, 50, n),
                                        "x": rng.random(n)}))
    q = "SELECT k, COUNT(*) AS n, SUM(x) AS s FROM big WHERE x < 0.01 GROUP BY k"
    rec = compiled.stats.get("recompiles", 0)
    comp, eager = _both_paths(c, q)
    assert compiled.stats["recompiles"] > rec
    cmp_caps = [v for caps in compiled._learned_caps.values()
                for t, v in caps.items() if t.startswith("cmp")]
    assert cmp_caps and min(cmp_caps) < n // 8
    comp = comp.sort_values("k", ignore_index=True)
    eager = eager.sort_values("k", ignore_index=True)
    assert comp["n"].tolist() == eager["n"].tolist()
    np.testing.assert_allclose(comp["s"], eager["s"], rtol=1e-12)


def test_escalation_bound_falls_back_counted(pc, monkeypatch):
    """A program whose flags keep asking for a larger capacity past the
    escalation bound goes to eager, counted as a runtime fallback."""
    monkeypatch.setattr(compiled, "DEFAULT_GROUP_CAP", 1)
    real = compiled._check_flags

    def always_grow(entry, flags):
        real(entry, flags)
        raise compiled._NeedsRecompile(
            {**entry.caps, "agg0": entry.caps.get("agg0", 1) + 1})

    monkeypatch.setattr(compiled, "_check_flags", always_grow)
    fb = compiled.stats.get("fallbacks", 0)
    q = "SELECT b, COUNT(*) AS n FROM user_table_1 GROUP BY b"
    comp = pc.sql(q, return_futures=False)
    assert compiled.stats["fallbacks"] == fb + 1
    assert _tier(pc) == "eager"
    _assert_same(comp, _eager(pc, q), ordered=False)
