"""The port's SPMD stage executor (``dask_sql_tpu_torch/parallel/spmd.py``)
and its per-shard primitives against the JAX package's, on the CPU.

The JAX side runs on the 8-device virtual CPU mesh of ``tests/conftest.py``
(its primitives inside ``shard_map``, where its executor uses them); the
port on a mesh of 8 CPU shards.  Inputs come from a numpy seed; floats
agree to rtol 1e-9, integers and strings exactly.

- ``exchange``, ``shard_replicated``, ``sorted_probe`` and the partial
  aggregates (``global_*``, ``local_slots``, ``slot_*``) against the JAX
  functions;
- the queries of ``tests/integration/test_spmd_executor.py``: pad rows,
  NULL keys, joins, a forced exchange join and the kill switch; for each
  the answers and every ``spmd_*`` counter (queries, stages, compiles,
  exchanges, joins, partial aggregates and the bytes of each collective
  kind) equal the JAX package's;
- a build side with duplicate keys flips and runs again, as in JAX;
- a stage whose body reads device values on the host (a CAST to VARCHAR,
  a string CASE or COALESCE: each shard would build its own dictionary)
  falls back as the JAX stage whose trace fails does, with its counters,
  and a dictionary map (``UPPER``) stays served.

The module name holds "spmd": the conftest's ``DSQL_MESH=0`` pin does not
apply.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from jax.sharding import PartitionSpec as P

from dask_sql_tpu import Context as JaxContext
from dask_sql_tpu.parallel import exchange as JX
from dask_sql_tpu.parallel import partial_agg as JPA
from dask_sql_tpu.parallel.mesh import ROW_AXIS, default_mesh, row_sharding
from dask_sql_tpu.runtime import telemetry as jtel
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.ops import groupby as GB
from dask_sql_tpu_torch.parallel import exchange as X
from dask_sql_tpu_torch.parallel import partial_agg as PA
from dask_sql_tpu_torch.parallel import spmd
from dask_sql_tpu_torch.parallel.mesh import Mesh
from dask_sql_tpu_torch.runtime import telemetry as tel

try:
    from jax import shard_map
except ImportError:
    from jax.experimental.shard_map import shard_map

N_DEV = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several workers on one machine: torch's intra-op
    # threads on every core in each would oversubscribe it
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jmesh():
    m = default_mesh()
    if m.devices.size != N_DEV:
        pytest.skip("needs the 8-device virtual CPU mesh")
    return m


@pytest.fixture(scope="module")
def pmesh():
    return Mesh(["cpu"] * N_DEV)


def _smap(mesh, body, *arrays):
    wrapped = shard_map(body, mesh=mesh, in_specs=P(ROW_AXIS),
                        out_specs=P(ROW_AXIS))
    out = wrapped(*[jax.device_put(jnp.asarray(a), row_sharding(mesh))
                    for a in arrays])
    return [np.asarray(o) for o in (out if isinstance(out, tuple)
                                    else (out,))]


def _shards(x, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return list(t.reshape(N_DEV, -1).unbind(0))


def _cat(parts):
    return torch.cat(list(parts)).numpy()


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def test_exchange_matches_jax_slot_for_slot(jmesh, pmesh):
    rng = np.random.RandomState(0)
    n = 16 * N_DEV
    codes = rng.randint(0, 37, n).astype(np.int64)
    codes[::5] = -1
    pay_f = np.arange(n, dtype=np.float64)
    pay_b = rng.rand(n) > 0.5

    def body(c, p, b):
        c2, (p2, b2) = JX.exchange(c, (p, b), N_DEV)
        return c2, p2, b2

    want = _smap(jmesh, body, codes, pay_f, pay_b)
    c2, pay2 = X.exchange(_shards(codes),
                          [list(z) for z in zip(_shards(pay_f),
                                                _shards(pay_b))],
                          pmesh.devices)
    np.testing.assert_array_equal(_cat(c2), want[0])
    np.testing.assert_array_equal(_cat(p[0] for p in pay2), want[1])
    np.testing.assert_array_equal(_cat(p[1] for p in pay2), want[2])
    # the byte counters from one shard's local shapes
    local_c = _shards(codes)[0]
    local_p = [_shards(pay_f)[0], _shards(pay_b)[0]]
    assert X.exchange_bytes(local_c, local_p, N_DEV) == JX.exchange_bytes(
        jnp.asarray(codes[:16]), (jnp.asarray(pay_f[:16]),
                                  jnp.asarray(pay_b[:16])), N_DEV)
    assert X.gather_bytes(local_p, N_DEV) == JX.gather_bytes(
        [jnp.asarray(pay_f[:16]), jnp.asarray(pay_b[:16])], N_DEV)
    assert X.psum_bytes(local_p, N_DEV) == JX.psum_bytes(
        [jnp.asarray(pay_f[:16]), jnp.asarray(pay_b[:16])], N_DEV)


@pytest.mark.parametrize("k", [3, N_DEV, N_DEV + 3])
def test_shard_replicated_matches_jax(jmesh, k):
    def body(_):
        v = jnp.arange(k, dtype=jnp.float64) * 2.0
        out, kp = JX.shard_replicated(v, N_DEV)
        return out

    want = _smap(jmesh, body, np.zeros(N_DEV))[0]
    parts, kp = X.shard_replicated(torch.arange(k, dtype=torch.float64) * 2.0,
                                   N_DEV)
    assert kp % N_DEV == 0 and kp >= k and len(parts) == N_DEV
    np.testing.assert_array_equal(_cat(parts), want)


def test_sorted_probe_matches_jax():
    rng = np.random.RandomState(3)
    s = JX.BROADCAST_SENTINEL
    build = rng.permutation(40).astype(np.int64)
    build[::7] = s
    probe = rng.randint(-3, 45, 100).astype(np.int64)
    probe[::11] = s
    for b in (build, np.concatenate([build, build[:3]])):   # + duplicates
        ji, jh, jd = JX.sorted_probe(jnp.asarray(b), jnp.asarray(probe), s)
        pi, ph, pd_ = X.sorted_probe(torch.from_numpy(b),
                                     torch.from_numpy(probe), s)
        np.testing.assert_array_equal(ph.numpy(), np.asarray(jh))
        hit = np.asarray(jh)
        np.testing.assert_array_equal(pi.numpy()[hit], np.asarray(ji)[hit])
        assert bool(pd_) == bool(jd)


def test_global_partials_match_jax(jmesh):
    rng = np.random.RandomState(1)
    n = 8 * N_DEV
    vals = rng.rand(n)
    ivals = rng.randint(-50, 50, n).astype(np.int64)
    ok = rng.rand(n) > 0.3

    def body(v, iv, m):
        s, c = JPA.global_sum(v, m, True)
        lo = JPA.global_minmax(iv, m, True, True)
        hi = JPA.global_minmax(v, m, False, True)
        c2 = JPA.global_count(m, True)
        return JX.shard_replicated(jnp.stack(
            [s, c.astype(jnp.float64), lo.astype(jnp.float64), hi,
             c2.astype(jnp.float64)]), N_DEV)[0]

    want = _smap(jmesh, body, vals, ivals, ok)[0][:5]
    oks = _shards(ok)
    s, c = PA.global_sum(_shards(vals), oks)
    lo = PA.global_minmax(_shards(ivals), oks, True)
    hi = PA.global_minmax(_shards(vals), oks, False)
    c2 = PA.global_count(oks)
    np.testing.assert_allclose(float(s), want[0], rtol=1e-9)
    assert int(c) == int(want[1]) == int(c2) == int(want[4])
    assert int(lo) == int(want[2])
    assert float(hi) == want[3]


def test_slot_partials_match_jax():
    rng = np.random.RandomState(2)
    n, cap = 200, 16
    codes = rng.randint(0, 20, n).astype(np.int64)   # 20 groups > cap
    codes[::6] = -1
    vals = rng.rand(n)
    ivals = rng.randint(-9, 9, n).astype(np.int32)
    ok = rng.rand(n) > 0.2
    js, jsc, jov = JPA.local_slots(jnp.asarray(codes), cap)
    ps, psc, pov = PA.local_slots(torch.from_numpy(codes), cap)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(psc.numpy(), np.asarray(jsc))
    assert bool(pov) == bool(jov) is True
    slot_ok = ok & (np.asarray(js) < cap)
    j_sum, j_cnt = JPA.slot_sum(jnp.asarray(vals), jnp.asarray(slot_ok), js,
                                cap)
    p_sum, p_cnt = PA.slot_sum(torch.from_numpy(vals),
                               torch.from_numpy(slot_ok), ps, cap)
    np.testing.assert_allclose(p_sum.numpy(), np.asarray(j_sum), rtol=1e-9)
    np.testing.assert_array_equal(p_cnt.numpy(), np.asarray(j_cnt))
    for is_min in (True, False):
        jm = JPA.slot_minmax(jnp.asarray(ivals), jnp.asarray(slot_ok), js,
                             cap, is_min)
        pm = PA.slot_minmax(torch.from_numpy(ivals),
                            torch.from_numpy(slot_ok), ps, cap, is_min)
        live = np.asarray(j_cnt) > 0
        np.testing.assert_array_equal(pm.numpy()[live], np.asarray(jm)[live])
    np.testing.assert_array_equal(
        PA.gather_groups([ps[:5], ps[5:9]]).numpy(), ps[:9].numpy())
    np.testing.assert_array_equal(
        PA.psum_table([p_cnt, p_cnt]).numpy(), 2 * np.asarray(j_cnt))


@pytest.mark.parametrize("groups", [3, 40, 5000])
def test_lane_segment_sum_matches_jax(groups):
    """Few groups over many rows spread over lanes (the card's route of
    ``ops.groupby._segment_sum``, run here on CPU tensors); the sums equal
    JAX's segment_sum and two runs give the same bits."""
    rng = np.random.RandomState(groups)
    n = 200_003
    vals = rng.randn(n) * 1e3
    codes = rng.randint(0, groups, n).astype(np.int64)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(vals),
                                          jnp.asarray(codes), groups))
    a = GB._lane_segment_sum(torch.from_numpy(vals),
                             torch.from_numpy(codes), groups)
    b = GB._lane_segment_sum(torch.from_numpy(vals),
                             torch.from_numpy(codes), groups)
    np.testing.assert_allclose(a.numpy(), want, rtol=1e-9)
    assert a.numpy().tobytes() == b.numpy().tobytes()
    ints = GB._lane_segment_sum(torch.from_numpy(codes),
                                torch.from_numpy(codes), groups)
    np.testing.assert_array_equal(ints.numpy(),
                                  np.bincount(codes, codes, groups))


# ---------------------------------------------------------------------------
# end-to-end sharded SQL: answers and counters against the JAX package
# ---------------------------------------------------------------------------

def _frames():
    rng = np.random.RandomState(7)
    n = 8 * N_DEV + 5   # not divisible: pad rows exist
    fact = pd.DataFrame({
        "k": rng.randint(0, 20, n).astype(np.int64),
        "grp": rng.randint(0, 4, n).astype(np.int64),
        "v": np.round(rng.rand(n), 6),
    })
    # NULLs in an aggregate input and in a group key
    fact.loc[fact.index[::7], "v"] = np.nan
    gk = fact["grp"].astype("float64")
    gk[fact.index[::11]] = np.nan
    fact["gk"] = gk.astype("Int64")
    fact["tag"] = np.array(["x", "y", "z"])[fact["grp"].to_numpy() % 3]
    # a string column with NULLs
    s = np.array(["ab", "cd", "ef", "gh", "ij"], dtype=object)[
        rng.randint(0, 5, n)]
    s[::6] = None
    fact["s"] = s
    dim = pd.DataFrame({"k": np.arange(20, dtype=np.int64),
                        "w": np.round(np.arange(20) * 0.25, 6)})
    return fact, dim


@pytest.fixture(scope="module")
def ctxs(jmesh, pmesh):
    fact, dim = _frames()
    jc, pc = JaxContext(mesh=jmesh), Context(mesh=pmesh)
    for c in (jc, pc):
        c.create_table("fact", fact)
        c.create_table("dim", dim)
    return jc, pc, fact


def _deltas(registry, c0):
    now = registry.counters()
    return {k: v - c0.get(k, 0) for k, v in now.items()
            if k.startswith("spmd_") and v != c0.get(k, 0)}


def _both(jc, pc, sql):
    """(JAX answer, port answer, JAX spmd_* deltas, port spmd_* deltas)."""
    c0 = jtel.REGISTRY.counters()
    want = jc.sql(sql, return_futures=False)
    dj = _deltas(jtel.REGISTRY, c0)
    c0 = tel.REGISTRY.counters()
    got = pc.sql(sql, return_futures=False)
    dp = _deltas(tel.REGISTRY, c0)
    return want, got, dj, dp


def _assert_frames(got: pd.DataFrame, want: pd.DataFrame):
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for col in want.columns:
        g, w = got[col], want[col]
        assert (g.isna().to_numpy() == w.isna().to_numpy()).all(), col
        live = ~w.isna().to_numpy()
        if pd.api.types.is_float_dtype(w):
            np.testing.assert_allclose(g.to_numpy(dtype=float)[live],
                                       w.to_numpy(dtype=float)[live],
                                       rtol=1e-9)
        else:
            assert [str(x) for x in g[live]] == [str(x) for x in w[live]], col


SPMD_QUERIES = {
    "pad_rows": "SELECT COUNT(*) AS n, SUM(v) AS s, AVG(v) AS a FROM fact",
    "null_keys": ("SELECT gk, COUNT(*) AS n, SUM(v) AS s FROM fact "
                  "GROUP BY gk ORDER BY gk"),
    "string_keys": ("SELECT tag, COUNT(v) AS n, MIN(v) AS lo, MAX(k) AS hi "
                    "FROM fact GROUP BY tag ORDER BY tag"),
    "join": ("SELECT grp, SUM(v * w) AS rev FROM fact "
             "JOIN dim ON fact.k = dim.k GROUP BY grp ORDER BY grp"),
    "join_rows": ("SELECT fact.k, v, w FROM fact JOIN dim ON fact.k = dim.k "
                  "WHERE v > 0.5 ORDER BY fact.k, v LIMIT 20"),
    # the filtered fact side is estimated smaller than dim and builds,
    # but its keys repeat: the join flips its build side and runs again
    "dup_build_flip": ("SELECT d.k, COUNT(*) AS n FROM dim d "
                       "JOIN fact f ON d.k = f.k WHERE f.v > 0.9 "
                       "GROUP BY d.k ORDER BY d.k"),
}


@pytest.mark.parametrize("name", sorted(SPMD_QUERIES))
def test_queries_match_jax_with_equal_counters(ctxs, name):
    jc, pc, _ = ctxs
    want, got, dj, dp = _both(jc, pc, SPMD_QUERIES[name])
    assert dp.get("spmd_queries", 0) == 1, dp
    assert dp == dj
    if name == "dup_build_flip":
        assert dp.get("spmd_join_flips") == 1, dp
    _assert_frames(got, want)


def test_pad_rows_invisible(ctxs):
    _, pc, fact = ctxs
    got = pc.sql(SPMD_QUERIES["pad_rows"], return_futures=False)
    assert int(got["n"][0]) == len(fact)
    np.testing.assert_allclose(float(got["s"][0]), fact["v"].sum(),
                               rtol=1e-9)
    nulls = pc.sql(SPMD_QUERIES["null_keys"], return_futures=False)
    assert int(nulls["gk"].isna().sum()) == 1


def test_forced_exchange_join(jmesh, pmesh, monkeypatch):
    # a zero broadcast cap forces the hash-partitioned all_to_all variant
    monkeypatch.setenv("DSQL_SPMD_BROADCAST_ROWS", "0")
    rng = np.random.RandomState(9)
    n = 16 * N_DEV
    a = pd.DataFrame({"k": rng.randint(0, 50, n).astype(np.int64),
                      "v": rng.rand(n)})
    b = pd.DataFrame({"k": np.arange(50, dtype=np.int64),
                      "w": np.arange(50) * 1.5})
    jc, pc = JaxContext(mesh=jmesh), Context(mesh=pmesh)
    for c in (jc, pc):
        c.create_table("a", a)
        c.create_table("b", b)
    want, got, dj, dp = _both(jc, pc, "SELECT SUM(v * w) AS s FROM a "
                                      "JOIN b ON a.k = b.k")
    assert dp.get("spmd_exchange_joins", 0) == 1, dp
    assert dp.get("spmd_exchange_bytes", 0) > 0, dp
    assert dp == dj
    np.testing.assert_allclose(float(got["s"][0]),
                               (a.merge(b, on="k").eval("v * w")).sum(),
                               rtol=1e-9)
    _assert_frames(got, want)


def test_mesh_kill_switch_restores_baseline(ctxs, monkeypatch):
    _, pc, fact = ctxs
    monkeypatch.setenv("DSQL_MESH", "0")
    assert not spmd.spmd_enabled(pc)
    c0 = tel.REGISTRY.counters()
    got = pc.sql("SELECT COUNT(*) AS n FROM fact", return_futures=False)
    assert _deltas(tel.REGISTRY, c0).get("spmd_queries", 0) == 0
    assert int(got["n"][0]) == len(fact)


def test_unsupported_shape_falls_through_to_the_tiers(ctxs):
    jc, pc, _ = ctxs
    sql = ("SELECT f.grp, COUNT(DISTINCT f.k) AS n FROM fact f "
           "GROUP BY f.grp ORDER BY f.grp")
    want, got, dj, dp = _both(jc, pc, sql)
    assert dp == dj == {"spmd_unsupported": 1}
    _assert_frames(got, want)


def test_second_run_replays_the_stage_program(ctxs):
    _, pc, _ = ctxs
    sql = SPMD_QUERIES["join"]
    first = pc.sql(sql, return_futures=False)
    c0 = tel.REGISTRY.counters()
    second = pc.sql(sql, return_futures=False)
    d = _deltas(tel.REGISTRY, c0)
    assert d.get("spmd_queries") == 1 and "spmd_compiles" not in d, d
    assert "spmd_eager_stages" not in d, d
    pd.testing.assert_frame_equal(first, second)
    tiers = [s.attrs.get("tier") for s in pc.last_report.root.walk()]
    assert "spmd" in tiers


def _span_attr(ctx, key):
    for s in ctx.last_report.root.walk():
        if key in s.attrs:
            return s.attrs[key]
    return None


def test_runtime_flag_fallback_names_its_flag(ctxs):
    # duplicate keys on both sides: the flip trips the flag again, and the
    # query falls back to the single-device tiers, as in JAX
    jc, pc, _ = ctxs
    sql = "SELECT COUNT(*) AS n FROM fact a JOIN fact b ON a.k = b.k"
    want, got, dj, dp = _both(jc, pc, sql)
    assert dp == dj
    assert dp.get("spmd_fallbacks") == 1 and "spmd_errors" not in dp, dp
    assert _span_attr(pc, "spmd_fallback").startswith("dup_build_keys@"), \
        _span_attr(pc, "spmd_fallback")
    assert _span_attr(pc, "spmd_error") is None
    _assert_frames(got, want)


def test_stage_error_counts_apart_from_flags(ctxs, monkeypatch):
    jc, pc, _ = ctxs

    def boom(*a, **k):
        raise RuntimeError("stage output unreadable")

    monkeypatch.setattr(spmd, "_parse_stage_outputs", boom)
    want, got, _, dp = _both(jc, pc, SPMD_QUERIES["join"])
    assert dp.get("spmd_errors") == 1 and dp.get("spmd_fallbacks") == 1, dp
    assert "spmd_queries" not in dp, dp
    assert "stage output unreadable" in _span_attr(pc, "spmd_error")
    _assert_frames(got, want)


def test_concurrent_first_eager_runs_record_once(ctxs, monkeypatch):
    # a mesh of distinct cards runs its stages eagerly (no graph); two
    # first runs of one program at once must not both record decisions
    # and counters (the byte counters of every later run would double)
    _, pc, _ = ctxs
    sql = SPMD_QUERIES["join"]
    monkeypatch.setattr(Mesh, "virtual", property(lambda self: False))
    spmd.clear_programs()
    try:
        c0 = tel.REGISTRY.counters()
        pc.sql(sql, return_futures=False)
        single = _deltas(tel.REGISTRY, c0)
        spmd.clear_programs()

        walk = spmd._Walker.walk
        import threading
        import time

        def slow_walk(self, node):
            if self.record:
                time.sleep(0.2)   # both threads inside a first run
            return walk(self, node)

        monkeypatch.setattr(spmd._Walker, "walk", slow_walk)
        out = []
        threads = [threading.Thread(
            target=lambda: out.append(pc.sql(sql, return_futures=False)))
            for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(out) == 2
        c0 = tel.REGISTRY.counters()
        again = pc.sql(sql, return_futures=False)
        later = _deltas(tel.REGISTRY, c0)
        single.pop("spmd_compiles", None)
        assert later == single, (later, single)
        for o in out:
            pd.testing.assert_frame_equal(o, again)
    finally:
        spmd.clear_programs()


# ---------------------------------------------------------------------------
# a stage that reads device values on the host falls back, as in JAX
# ---------------------------------------------------------------------------

HOST_READ_EXPRS = {
    "cast_int": "CAST(k AS VARCHAR)",
    "cast_double": "CAST(v AS VARCHAR)",
    "case_strings": "CASE WHEN grp > 1 THEN s ELSE 'zz' END",
    "case_literals": "CASE WHEN grp > 1 THEN 'hi' ELSE 'lo' END",
    "coalesce": "COALESCE(s, 'none')",
    "concat": "s || CAST(grp AS VARCHAR)",
    "upper": "UPPER(s)",
}
HOST_READ_SQL = {
    name: f"SELECT k, grp, v, {expr} AS c FROM fact"
    for name, expr in HOST_READ_EXPRS.items()}
HOST_READ_SQL["cast_group_by"] = (
    "SELECT CAST(k AS VARCHAR) AS c, COUNT(*) AS n, SUM(v) AS t FROM fact "
    "GROUP BY CAST(k AS VARCHAR) ORDER BY c")


@pytest.fixture(scope="module")
def plain():
    fact, _ = _frames()
    c = Context(device="cpu")
    c.create_table("fact", fact)
    return c


@pytest.mark.parametrize("name", sorted(HOST_READ_SQL))
def test_host_read_stage_falls_back_as_in_jax(ctxs, plain, name):
    jc, pc, _ = ctxs
    sql = HOST_READ_SQL[name]
    want, got, dj, dp = _both(jc, pc, sql)
    served = name == "upper"
    assert dp == dj, (dp, dj)
    if served:
        assert dp.get("spmd_queries") == 1 and "spmd_fallbacks" not in dp
    else:
        assert dp == {"spmd_fallbacks": 1}, dp
        assert _span_attr(pc, "spmd_fallback") == "host_read"
        assert _span_attr(pc, "spmd_error") is None
    assert "spmd_errors" not in dp and "spmd_eager_stages" not in dp, dp
    _assert_frames(got, want)
    _assert_frames(got, plain.sql(sql, return_futures=False))
    # a later run replays the served stage, and falls back again from one
    # that reads the host without running it
    c0 = tel.REGISTRY.counters()
    again = pc.sql(sql, return_futures=False)
    assert _deltas(tel.REGISTRY, c0) == {
        k: v for k, v in dp.items() if k != "spmd_compiles"}
    _assert_frames(again, want)


# ---------------------------------------------------------------------------
# a mesh of distinct cards builds one graph program over all of them
# ---------------------------------------------------------------------------

def test_a_mesh_of_distinct_cards_builds_one_graph_program_over_them(
        ctxs, monkeypatch):
    from dask_sql_tpu_torch.physical import graphs

    # an indexed card name touches no card: this builds without CUDA
    mesh = Mesh(["cuda:0", "cuda:1"])
    assert mesh.devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert mesh.graph_stages and not mesh.virtual
    assert not Mesh(["cpu", "cuda:0"]).graph_stages
    made = []

    class Recorder:
        def __init__(self, fn, device, **kw):
            made.append((torch.device(device), kw))
            self.cost = None

        def release(self):
            pass

    monkeypatch.setattr(graphs, "GraphProgram", Recorder)
    _, pc, _ = ctxs
    counts = {}
    key = ("distinct-cards-test",)
    try:
        prog = spmd._program(key, None, pc, [], [], mesh,
                             {"counts": {}, "decisions": []}, counts)
    finally:
        spmd._prog_cache.pop(key, None)
    assert isinstance(prog.graph, Recorder)
    assert counts == {"spmd_compiles": 1}
    (device, kw), = made
    assert device == torch.device("cuda", 0)
    assert list(kw["devices"]) == [torch.device("cuda", 0),
                                   torch.device("cuda", 1)]
    assert kw["group"] is None
    # a stage record carries no card: such a mesh keeps none in the store
    assert prog.digest is None


def test_stage_inputs_refilled_per_call_are_split_anew():
    # on a mesh of distinct devices a stage's boundary table is copied to
    # the shards' devices on every call (inside a graph), a catalog column
    # once ("meta" stands in for a second card)
    mesh = Mesh(["cpu", "meta"])
    t = torch.arange(8)
    first = mesh.split(t)
    assert mesh.split(t)[1] is first[1]
    fresh = mesh.split(t, cache=False)
    assert fresh[1] is not first[1] and fresh[1].device.type == "meta"
    assert mesh.split(t, cache=False)[1] is not fresh[1]


def test_graph_constants_go_to_the_card_a_copy_names():
    # a program over several cards makes a constant on the card of the
    # program that a copy names, else on its first; the capture hands the
    # warm-up's back in order ("meta" stands in for a second card)
    from dask_sql_tpu_torch.physical import graphs

    cpu, meta = torch.device("cpu"), torch.device("meta")
    host = torch.arange(5)
    consts = graphs._Consts(cpu, [meta])
    first = consts.record(host, meta)
    second = consts.record(host, None)
    assert (first.device, second.device) == (meta, cpu)
    consts.rewind()
    assert consts.replay(host, meta) is first
    assert consts.replay(host, torch.device("cuda")) is second
    consts.rewind()
    with pytest.raises(RuntimeError, match="did not make"):
        consts.replay(host, None)
    # one card: every copy goes to it, whatever card it names
    one = graphs._Consts(cpu)
    made = one.record(host, meta)
    assert made.device == cpu
    one.rewind()
    assert one.replay(host, torch.device("cuda")) is made
