"""The port's program store in the compiled tier, on the CPU, against the
JAX package's answers.

The store cases of ``tests/integration/test_tiered_program_store.py``:

- a fresh process (simulated by dropping every in-process program, learned
  cap and hint; proven for real with two interpreters) answers a stored
  program with zero builds and zero recompiles, and the caps it learned
  survive;
- a corrupt entry, a fingerprint mismatch, constants that do not match
  their digests and an arity that does not fit each fall back to a build,
  counted, with the answer equal;
- DDL with the same layout serves the fresh data; a changed layout misses;
- stage graph programs persist, one record per stage;
- tiering serves a stored program compiled at its first arrival;
- a new literal is served from the store (``tests/integration/
  test_param_plans.py``);
- TPC-H queries (stage graphs included) from the store in process and in a
  second interpreter that shares only ``DSQL_PROGRAM_STORE``, and Q1 and
  Q12 on an 8-shard CPU mesh from stored stage records (``tests/
  integration/test_spmd_executor.py``).

Every answer is held to the JAX package's on the same seeded numpy
inputs: integers and strings exact, doubles within rtol 1e-12.  One torch
thread, SF 0.003.
"""
import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pandas as pd
import pytest
import torch

from benchmarks.tpch import QUERIES, generate_tpch
from dask_sql_tpu import Context as JaxContext
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.parallel import spmd
from dask_sql_tpu_torch.physical import compiled
from dask_sql_tpu_torch.runtime import program_store as ps
from dask_sql_tpu_torch.runtime import telemetry as tel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SF = 0.003
#: single programs, the kernel-1 static GROUP BYs among them, and the
#: stage graphs of the default budget (Q8, Q21)
TPCH = (1, 3, 6, 8, 12, 21)
QUERY = "SELECT k, SUM(v) AS s, COUNT(*) AS n FROM t GROUP BY k ORDER BY k"


def _frame(seed: int = 5, n: int = 3000) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    return pd.DataFrame({"k": rng.integers(0, 40, n).astype(np.int32),
                         "v": rng.random(n)})


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("DSQL_TIERED", "0")
    monkeypatch.delenv("DSQL_PROGRAM_STORE", raising=False)
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    _forget_programs()
    yield
    _forget_programs()
    torch.set_num_threads(prev)


def _forget_programs():
    """What a fresh process starts from: no program, learned cap, hint or
    runtime verdict in memory."""
    for entry in list(compiled._cache.values()):
        if isinstance(entry, compiled._Compiled):
            entry.fn.release()
    compiled._cache.clear()
    compiled._learned_caps.clear()
    compiled._runtime_eager.clear()
    compiled._hints_memo.clear()
    with compiled._tier_lock:
        compiled._tier_done.clear()
        compiled._tier_inflight.clear()
    spmd.clear_programs()


@pytest.fixture()
def pstore(tmp_path, monkeypatch):
    monkeypatch.setenv("DSQL_PROGRAM_STORE", str(tmp_path / "programs"))
    return ps.get_store()


def _deltas(c0):
    now = tel.REGISTRY.counters()
    return {k: v - c0.get(k, 0) for k, v in now.items() if v != c0.get(k, 0)}


def _jax_answer(frames: dict, query: str) -> pd.DataFrame:
    """The JAX package's answer (its compiled tier, no store)."""
    prev = {k: os.environ.pop(k, None)
            for k in ("DSQL_PROGRAM_STORE", "DSQL_MESH")}
    os.environ["DSQL_TIERED"] = "0"
    try:
        jc = JaxContext()
        for name, df in frames.items():
            jc.create_table(name, df)
        return jc.sql(query, return_futures=False)
    finally:
        for k, v in prev.items():
            if v is not None:
                os.environ[k] = v


def _assert_equal(got: pd.DataFrame, want: pd.DataFrame) -> None:
    got = got.reset_index(drop=True)
    want = want.reset_index(drop=True)
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for col in want.columns:
        g, w = got[col].to_numpy(), want[col].to_numpy()
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g.astype(np.float64), w, rtol=1e-12,
                                       err_msg=col)
        else:
            assert g.tolist() == w.tolist(), col


@pytest.fixture(scope="module")
def simple_want():
    return _jax_answer({"t": _frame()}, QUERY)


@pytest.fixture()
def c():
    ctx = Context(device="cpu")
    ctx.create_table("t", _frame())
    return ctx


# ---------------------------------------------------------------------------
# a fresh process in this one
# ---------------------------------------------------------------------------

def test_fresh_load_executes_with_zero_compiles(c, pstore, simple_want):
    c0 = tel.REGISTRY.counters()
    cold = c.sql(QUERY, return_futures=False)
    d1 = _deltas(c0)
    assert d1.get("compiles", 0) >= 1
    assert d1.get("program_store_stores", 0) >= 1
    _forget_programs()
    c1 = tel.REGISTRY.counters()
    warm = c.sql(QUERY, return_futures=False)
    d2 = _deltas(c1)
    assert d2.get("compiles", 0) == 0 and d2.get("recompiles", 0) == 0, d2
    assert d2.get("program_store_hits", 0) >= 1, d2
    pd.testing.assert_frame_equal(cold, warm)
    _assert_equal(warm, simple_want)
    # the hit is in memory now: the next call replays it
    c2 = tel.REGISTRY.counters()
    c.sql(QUERY, return_futures=False)
    assert _deltas(c2).get("hits", 0) == 1


def test_store_caps_survive_fresh_process(c, pstore, simple_want,
                                          monkeypatch):
    """An escalated program's record is rewritten with its final caps: a
    fresh process loads those, with no recompile."""
    monkeypatch.setattr(compiled, "DEFAULT_GROUP_CAP", 2)
    from dask_sql_tpu_torch.runtime import statistics
    monkeypatch.setattr(statistics, "compiled_cap_hints", lambda *a: {})
    c0 = tel.REGISTRY.counters()
    cold = c.sql(QUERY, return_futures=False)
    d1 = _deltas(c0)
    assert d1.get("recompiles", 0) >= 1, d1
    assert d1["program_store_stores"] == d1["compiles"]
    _forget_programs()
    c1 = tel.REGISTRY.counters()
    warm = c.sql(QUERY, return_futures=False)
    d2 = _deltas(c1)
    assert d2.get("recompiles", 0) == 0 and d2.get("compiles", 0) == 0, d2
    assert d2.get("program_store_hits", 0) == 1
    pd.testing.assert_frame_equal(cold, warm)
    _assert_equal(warm, simple_want)


def _rewrite_entries(store, change) -> int:
    n = 0
    for name in os.listdir(store.path()):
        if name.endswith(".prog"):
            path = os.path.join(store.path(), name)
            with open(path, "rb") as f:
                raw = pickle.load(f)
            change(raw)
            with open(path, "wb") as f:
                pickle.dump(raw, f)
            n += 1
    return n


def _altered_consts(raw):
    key = ("torch.int64", (3,), "0" * 32)
    raw["consts"] = {key: (np.arange(3, dtype=np.int64), 1)}


def _other_arity(raw):
    raw["n_args"] = int(raw["n_args"]) + 1


@pytest.mark.parametrize("damage,counter", [
    ("corrupt", "program_store_errors"),
    ("fingerprint", "program_store_rejects"),
    ("consts", "program_store_errors"),
    ("arity", "program_store_errors"),
])
def test_damaged_entry_falls_back_to_a_build(c, pstore, simple_want, damage,
                                             counter):
    c.sql(QUERY, return_futures=False)
    if damage == "corrupt":
        progs = [f for f in os.listdir(pstore.path()) if f.endswith(".prog")]
        assert progs
        for f in progs:
            with open(os.path.join(pstore.path(), f), "wb") as fh:
                fh.write(b"\x80corrupt")
    else:
        change = {"fingerprint": lambda raw: raw["fingerprint"].update(
                      torch="0.0.0"),
                  "consts": _altered_consts, "arity": _other_arity}[damage]
        assert _rewrite_entries(pstore, change) >= 1
    _forget_programs()
    c1 = tel.REGISTRY.counters()
    out = c.sql(QUERY, return_futures=False)
    d = _deltas(c1)
    assert d.get(counter, 0) >= 1, d
    assert d.get("program_store_hits", 0) == 0, d
    assert d.get("compiles", 0) >= 1, d
    _assert_equal(out, simple_want)
    if damage != "fingerprint":
        # the bad entry was dropped, and the build stored a good one
        _forget_programs()
        c2 = tel.REGISTRY.counters()
        c.sql(QUERY, return_futures=False)
        assert _deltas(c2).get("program_store_hits", 0) == 1


def test_ddl_same_layout_serves_fresh_data(c, pstore):
    old = c.sql(QUERY, return_futures=False)
    df2 = _frame()
    df2["v"] = df2["v"] * 3.0
    c.drop_table("t")
    c.create_table("t", df2)
    _forget_programs()
    c1 = tel.REGISTRY.counters()
    new = c.sql(QUERY, return_futures=False)
    d = _deltas(c1)
    assert d.get("compiles", 0) == 0, d
    assert d.get("program_store_hits", 0) >= 1
    assert not new["s"].equals(old["s"])
    _assert_equal(new, _jax_answer({"t": df2}, QUERY))


def test_ddl_layout_change_misses_cleanly(c, pstore):
    c.sql(QUERY, return_futures=False)
    df3 = _frame()
    df3["k"] = df3["k"].astype("int64")
    c.drop_table("t")
    c.create_table("t", df3)
    _forget_programs()
    c1 = tel.REGISTRY.counters()
    out = c.sql(QUERY, return_futures=False)
    d = _deltas(c1)
    assert d.get("program_store_hits", 0) == 0, d
    assert d.get("compiles", 0) >= 1
    _assert_equal(out, _jax_answer({"t": df3}, QUERY))


def _join_frames() -> dict:
    rng = np.random.default_rng(9)
    return {"u1": pd.DataFrame({"user_id": np.arange(200),
                                "b": rng.integers(0, 5, 200)}),
            "u2": pd.DataFrame({"user_id": rng.integers(0, 200, 900),
                                "c": rng.integers(0, 100, 900)})}


JOIN = ("SELECT u1.user_id, SUM(u2.c) AS s FROM u1 "
        "JOIN u2 ON u1.user_id = u2.user_id "
        "GROUP BY u1.user_id ORDER BY u1.user_id")


def test_stage_graph_programs_persist(pstore, monkeypatch):
    monkeypatch.setenv("DSQL_STAGE_HEAVY", "1")
    frames = _join_frames()
    ctx = Context(device="cpu")
    for name, df in frames.items():
        ctx.create_table(name, df)
    c0 = tel.REGISTRY.counters()
    cold = ctx.sql(JOIN, return_futures=False)
    d1 = _deltas(c0)
    assert d1.get("stage_graphs", 0) >= 1
    assert d1.get("program_store_stores", 0) >= 2
    _forget_programs()
    c1 = tel.REGISTRY.counters()
    warm = ctx.sql(JOIN, return_futures=False)
    d2 = _deltas(c1)
    assert d2.get("compiles", 0) == 0 and d2.get("stage_compiles", 0) == 0
    assert d2.get("program_store_hits", 0) >= 2, d2
    pd.testing.assert_frame_equal(cold, warm)
    _assert_equal(warm, _jax_answer(frames, JOIN))


def test_tiered_with_store_serves_warm_without_eager_tier(c, pstore,
                                                          monkeypatch,
                                                          simple_want):
    """The tier decision reads the store: a fresh process with the program
    stored runs it compiled at its first arrival, with no eager answer and
    no background build."""
    monkeypatch.setenv("DSQL_TIERED", "1")
    monkeypatch.delenv("DSQL_EAGER_FALLBACK", raising=False)
    c0 = tel.REGISTRY.counters()
    c.sql(QUERY, return_futures=False)     # eager, building behind it
    deadline = time.monotonic() + 60
    while compiled.inflight_background_compiles():
        assert time.monotonic() < deadline
        time.sleep(0.01)
    d0 = _deltas(c0)
    assert d0.get("served_eager_while_compiling", 0) == 1, d0
    assert d0.get("program_store_stores", 0) >= 1, d0
    _forget_programs()
    plan = c._get_plan(__import__(
        "dask_sql_tpu_torch.sql.parser", fromlist=["x"]).parse_sql(
            QUERY)[0].query)
    assert compiled.tier_probe(plan, c) == "compiled"
    c1 = tel.REGISTRY.counters()
    out = c.sql(QUERY, return_futures=False)
    d = _deltas(c1)
    assert d.get("served_eager_while_compiling", 0) == 0, d
    assert d.get("compiles", 0) == 0, d
    assert d.get("program_store_hits", 0) >= 1, d
    tier = None
    for s in c.last_report.root.walk():
        tier = s.attrs.get("tier", tier)
    assert tier == "compiled"
    _assert_equal(out, simple_want)


def test_store_serves_fresh_process_with_new_literal(pstore):
    rng = np.random.default_rng(2)
    frame = pd.DataFrame({"a": rng.integers(0, 200, 500),
                          "b": rng.random(500)})
    ctx = Context(device="cpu")
    ctx.create_table("p", frame)
    c0 = tel.REGISTRY.counters()
    cold = ctx.sql("SELECT a, b FROM p WHERE a > 10", return_futures=False)
    d1 = _deltas(c0)
    assert d1.get("compiles", 0) == 1 and d1.get("program_store_stores")
    _forget_programs()
    c1 = tel.REGISTRY.counters()
    q = "SELECT a, b FROM p WHERE a > 120"
    warm = ctx.sql(q, return_futures=False)
    d2 = _deltas(c1)
    assert d2.get("compiles", 0) == 0, d2
    assert d2.get("program_store_hits", 0) >= 1, d2
    assert d2.get("param_plan_hits", 0) >= 1, d2
    assert len(cold) != len(warm)
    _assert_equal(warm, _jax_answer({"p": frame}, q))


# ---------------------------------------------------------------------------
# TPC-H
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tpch():
    return generate_tpch(SF)


@pytest.fixture(scope="module")
def tpch_want(tpch):
    prev = os.environ.get("DSQL_TIERED")
    os.environ["DSQL_TIERED"] = "0"
    try:
        jc = JaxContext()
        for name, df in tpch.items():
            jc.create_table(name, df)
        return {q: jc.sql(QUERIES[q], return_futures=False) for q in TPCH}
    finally:
        if prev is None:
            os.environ.pop("DSQL_TIERED", None)
        else:
            os.environ["DSQL_TIERED"] = prev


@pytest.fixture(scope="module")
def tpch_ctx(tpch):
    ctx = Context(device="cpu")
    for name, df in tpch.items():
        ctx.create_table(name, df)
    return ctx


@pytest.mark.parametrize("qid", TPCH)
def test_tpch_from_the_store(tpch_ctx, tpch_want, pstore, qid):
    c0 = tel.REGISTRY.counters()
    cold = tpch_ctx.sql(QUERIES[qid], return_futures=False)
    d1 = _deltas(c0)
    assert d1.get("program_store_stores", 0) == d1.get("compiles", 0) >= 1
    _forget_programs()
    c1 = tel.REGISTRY.counters()
    warm = tpch_ctx.sql(QUERIES[qid], return_futures=False)
    d2 = _deltas(c1)
    assert d2.get("compiles", 0) == 0 and d2.get("recompiles", 0) == 0, d2
    assert d2.get("program_store_hits", 0) >= 1 + (qid in (8, 21)), d2
    pd.testing.assert_frame_equal(cold, warm)
    _assert_equal(warm, tpch_want[qid])


_CHILD = r"""
import json, os, pickle, sys
os.environ.update(DSQL_TIERED="0", DSQL_RESULT_CACHE_MB="0",
                  DSQL_MAX_CONCURRENT_QUERIES="0", DSQL_ADAPTIVE="0",
                  DSQL_MESH="1")
import torch
torch.set_num_threads(1)
from benchmarks.tpch import QUERIES, generate_tpch
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.parallel.mesh import Mesh
from dask_sql_tpu_torch.runtime import telemetry as tel

queries, mesh_queries = json.loads(sys.argv[2]), json.loads(sys.argv[3])
data = generate_tpch(float(sys.argv[1]))
out = {"single": {}, "mesh": {}}
for label, qs, kw in (("single", queries, {}),
                      ("mesh", mesh_queries, {"mesh": Mesh(["cpu"] * 8)})):
    c = Context(device="cpu", **kw)
    for name, df in data.items():
        c.create_table(name, df)
    for q in qs:
        c0 = tel.REGISTRY.counters()
        df = c.sql(QUERIES[q], return_futures=False)
        c1 = tel.REGISTRY.counters()
        tier = None
        for s in c.last_report.root.walk():
            tier = s.attrs.get("tier", tier)
        out[label][q] = {"frame": df, "tier": tier, "counters": {
            k: c1.get(k, 0) - c0.get(k, 0) for k in (
                "compiles", "recompiles", "program_store_hits",
                "program_store_stores", "program_store_errors",
                "spmd_compiles", "spmd_store_hits")}}
with open(sys.argv[4], "wb") as f:
    pickle.dump(out, f)
"""

CHILD_SINGLE = (1, 2, 8, 12, 21)
CHILD_MESH = (1, 12)


@pytest.fixture(scope="module")
def two_interpreters(tmp_path_factory):
    """Two interpreters sharing only ``DSQL_PROGRAM_STORE``: TPC-H queries
    on one CPU device, then Q1 and Q12 on an 8-shard CPU mesh."""
    tmp = tmp_path_factory.mktemp("two")
    env = {k: v for k, v in os.environ.items() if not k.startswith("DSQL_")}
    env.update(DSQL_PROGRAM_STORE=str(tmp / "programs"),
               CUDA_VISIBLE_DEVICES="", PYTHONPATH=ROOT)
    runs = []
    for i in range(2):
        out = tmp / f"run{i}.pkl"
        proc = subprocess.run(
            [sys.executable, "-c", _CHILD, str(SF),
             json.dumps(CHILD_SINGLE), json.dumps(CHILD_MESH), str(out)],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        with open(out, "rb") as f:
            runs.append(pickle.load(f))
    return runs


@pytest.fixture(scope="module")
def child_want(tpch):
    prev = os.environ.get("DSQL_TIERED")
    os.environ["DSQL_TIERED"] = "0"
    try:
        jc = JaxContext()
        for name, df in tpch.items():
            jc.create_table(name, df)
        return {q: jc.sql(QUERIES[q], return_futures=False)
                for q in sorted(set(CHILD_SINGLE) | set(CHILD_MESH))}
    finally:
        if prev is None:
            os.environ.pop("DSQL_TIERED", None)
        else:
            os.environ["DSQL_TIERED"] = prev


@pytest.mark.parametrize("qid", CHILD_SINGLE)
def test_two_interpreters_sharing_only_the_store(two_interpreters,
                                                 child_want, qid):
    first, second = (r["single"][qid] for r in two_interpreters)
    assert first["counters"]["compiles"] >= 1
    assert first["counters"]["program_store_stores"] >= 1
    c = second["counters"]
    assert c["compiles"] == 0 and c["recompiles"] == 0, c
    assert c["program_store_hits"] >= 1 + (qid in (2, 8, 21)), c
    assert second["tier"] == first["tier"]
    _assert_equal(second["frame"], first["frame"])
    _assert_equal(second["frame"], child_want[qid])


@pytest.mark.parametrize("qid", CHILD_MESH)
def test_sharded_round_trip_on_an_8_shard_cpu_mesh(two_interpreters,
                                                  child_want, qid):
    first, second = (r["mesh"][qid] for r in two_interpreters)
    assert first["tier"] == second["tier"] == "spmd"
    assert first["counters"]["spmd_compiles"] >= 1
    assert first["counters"]["program_store_stores"] >= 1
    c = second["counters"]
    assert c["spmd_compiles"] == 0, c
    assert c["spmd_store_hits"] >= 1, c
    assert c["program_store_errors"] == 0, c
    _assert_equal(second["frame"], first["frame"])
    _assert_equal(second["frame"], child_want[qid])


def test_a_stage_record_that_fails_falls_back_to_a_build(tmp_path,
                                                        monkeypatch, tpch,
                                                        child_want):
    """A stored stage record whose first run fails is counted, dropped and
    the stage built anew, with the answer equal."""
    monkeypatch.setenv("DSQL_PROGRAM_STORE", str(tmp_path / "programs"))
    monkeypatch.setenv("DSQL_MESH", "1")
    from dask_sql_tpu_torch.parallel.mesh import Mesh

    ctx = Context(device="cpu", mesh=Mesh(["cpu"] * 8))
    for name, df in tpch.items():
        ctx.create_table(name, df)
    ctx.sql(QUERIES[1], return_futures=False)
    store = ps.get_store()

    def broken(raw):
        raw["meta"]["decisions"] = [("join", "nonsense", {})] * 3
        raw["n_outs"] = int(raw["n_outs"]) + 7

    assert _rewrite_entries(store, broken) >= 1
    spmd.clear_programs()
    c0 = tel.REGISTRY.counters()
    out = ctx.sql(QUERIES[1], return_futures=False)
    d = _deltas(c0)
    assert d.get("program_store_errors", 0) >= 1, d
    assert d.get("spmd_compiles", 0) >= 1, d
    assert d.get("spmd_store_hits", 0) == 0, d
    _assert_equal(out, child_want[1])


def test_two_callers_of_a_stored_program_load_it_once(c, pstore,
                                                     simple_want,
                                                     monkeypatch):
    """Concurrent first calls in a fresh process: one loads the record (a
    slowed load), the other waits for it (``_inflight``), takes the stored
    caps and runs the loaded program."""
    import threading

    c.sql(QUERY, return_futures=False)
    _forget_programs()
    load = compiled._pstore_attempt

    def slow_load(*a, **k):
        time.sleep(0.3)
        return load(*a, **k)

    monkeypatch.setattr(compiled, "_pstore_attempt", slow_load)
    c0 = tel.REGISTRY.counters()
    got, errors = [], []

    def run():
        try:
            got.append(c.sql(QUERY, return_futures=False))
        except Exception as e:   # reported below
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors, errors
    d = _deltas(c0)
    assert d.get("program_store_hits", 0) == 1, d
    assert d.get("compiles", 0) == 0 and d.get("hits", 0) == 1, d
    for out in got:
        _assert_equal(out, simple_want)
