"""The port's program store (``runtime/program_store.py``) against the JAX
package's, on the CPU.

- The cases of ``tests/unit/test_program_store_unit.py``: disabled without
  the variable, round trip, miss counts, a fingerprint mismatch rejected,
  the digest following the fingerprint, a corrupt entry dropped, the LRU
  eviction at the byte budget, a corrupt index tolerated.
- The canonical keys: ``__split__`` boundary names (``compiled.
  _canonical_program_key``, equal to the JAX package's rewrite) and
  ``__spmd__`` temp names (``spmd._stage_key``), and the ``DSQL_CAPS_FILE``
  key that follows them.
- The index file and ``system.programs`` have the JAX package's format
  and schema.
- Build records: ``graphs._Consts`` hands out its constants with their
  host copies, takes them back, and ``check_record`` refuses constants that
  do not match their digests; a cached upload read by a warm-up is noted.
- The store armed answers compiled queries, ``system.programs``,
  ``/v1/engine`` and the fleet heartbeat, and ``run_server`` starts;
  ``runtime/gates.py`` keeps no list of unported subsystems.

The card's side (a capture from a record without a warm-up, a record
without its constants) is in ``tests/test_torch_gpu.py``.
"""
import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from dask_sql_tpu.physical import compiled as jax_compiled
from dask_sql_tpu.runtime import program_store as jax_ps
from dask_sql_tpu.runtime import system_tables as jax_st
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.ops import gpu_kernels as gk
from dask_sql_tpu_torch.parallel import spmd
from dask_sql_tpu_torch.parallel.mesh import Mesh
from dask_sql_tpu_torch.physical import compiled, graphs
from dask_sql_tpu_torch.runtime import program_store as ps
from dask_sql_tpu_torch.runtime import telemetry as tel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    monkeypatch.setenv("DSQL_TIERED", "0")
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture()
def store(tmp_path, monkeypatch):
    monkeypatch.setenv("DSQL_PROGRAM_STORE", str(tmp_path / "programs"))
    monkeypatch.delenv("DSQL_PROGRAM_STORE_MB", raising=False)
    return ps.ProgramStore()


def _entry(payload: bytes = b"x" * 64) -> dict:
    return {"v": 1, "kind": "program", "caps": {"agg0": 4096},
            "meta": {"n_out": 1}, "consts": {}, "payload": payload,
            "n_args": 2, "n_outs": 3}


# ---------------------------------------------------------------------------
# the store on disk (tests/unit/test_program_store_unit.py)
# ---------------------------------------------------------------------------

def test_store_disabled_without_env(monkeypatch):
    monkeypatch.delenv("DSQL_PROGRAM_STORE", raising=False)
    s = ps.ProgramStore()
    assert not s.enabled()
    assert not s.store("d" * 32, _entry())
    assert s.load("d" * 32) is None
    assert not s.contains("d" * 32)


def test_store_round_trip(store):
    d = store.digest(("plan", "inputs", True))
    assert not store.contains(d)
    assert store.store(d, _entry())
    assert store.contains(d)
    got = store.load(d)
    assert got is not None
    assert got["payload"] == b"x" * 64
    assert got["caps"] == {"agg0": 4096}
    assert got["fingerprint"] == ps.runtime_fingerprint()


def test_store_miss_counts(store):
    before = tel.REGISTRY.get("program_store_misses")
    assert store.load(store.digest("never-stored")) is None
    assert tel.REGISTRY.get("program_store_misses") == before + 1


def test_fingerprint_mismatch_rejected(store):
    d = store.digest("some-program")
    store.store(d, _entry())
    path = store._entry_path(d)
    with open(path, "rb") as f:
        raw = pickle.load(f)
    raw["fingerprint"] = dict(raw["fingerprint"], device="cuda:another:sm90")
    with open(path, "wb") as f:
        pickle.dump(raw, f)
    before = tel.REGISTRY.get("program_store_rejects")
    assert store.load(d) is None
    assert tel.REGISTRY.get("program_store_rejects") == before + 1
    # a rejected entry stays: another runtime may still serve from it
    assert store.contains(d)


def test_digest_changes_with_runtime_fingerprint(store, monkeypatch):
    key = ("plan", "inputs", True)
    d1 = store.digest(key)
    assert store.digest(key) == d1
    monkeypatch.setattr(ps, "runtime_fingerprint",
                        lambda: {"device": "other", "torch": "0",
                                 "tracer": "0", "format": "1"})
    assert store.digest(key) != d1


def test_runtime_fingerprint_names_device_torch_tracer_and_format():
    fp = ps.runtime_fingerprint()
    assert set(fp) == {"device", "torch", "tracer", "format"}
    assert fp["device"] == "cpu" and fp["torch"] == torch.__version__
    assert len(fp["tracer"]) == 32 and fp["format"] == "1"
    assert ps.tracer_digest() == fp["tracer"]


def test_corrupt_entry_tolerated_and_dropped(store):
    d = store.digest("will-corrupt")
    store.store(d, _entry())
    with open(store._entry_path(d), "wb") as f:
        f.write(b"\x80truncated-garbage")
    before = tel.REGISTRY.get("program_store_errors")
    assert store.load(d) is None
    assert tel.REGISTRY.get("program_store_errors") == before + 1
    assert not os.path.exists(store._entry_path(d))
    assert not store.contains(d)


def test_lru_eviction_at_byte_budget(store, monkeypatch):
    # ~2 KB entries against a 10 KB budget: the fifth evicts the least
    # recently USED entry, not the oldest stored
    monkeypatch.setenv("DSQL_PROGRAM_STORE_MB", str(10 / 1024.0))
    digests = [store.digest(f"prog{i}") for i in range(5)]
    before = tel.REGISTRY.get("program_store_evictions")
    for d in digests[:4]:
        assert store.store(d, _entry(payload=b"p" * 2048))
        time.sleep(0.01)
    assert store.total_bytes() <= store.budget_bytes()
    assert store.load(digests[0]) is not None
    time.sleep(0.01)
    assert store.store(digests[4], _entry(payload=b"p" * 2048))
    assert tel.REGISTRY.get("program_store_evictions") > before
    assert store.contains(digests[0])
    assert not store.contains(digests[1])
    assert not os.path.exists(store._entry_path(digests[1]))
    assert store.contains(digests[4])
    assert store.total_bytes() <= store.budget_bytes()


def test_corrupt_index_tolerated(store):
    d = store.digest("indexed")
    store.store(d, _entry())
    with open(store._index_path(), "w") as f:
        f.write("not json at all")
    assert store.entries() == {}
    assert store.store(d, _entry())
    assert store.contains(d)


# ---------------------------------------------------------------------------
# canonical keys
# ---------------------------------------------------------------------------

_FP1 = ("Join(T|C=[@0])[s]<Scan(__split__.t0123456789abcdef)[x]<>,"
        "Scan(__split__.tfedcba9876543210)[y]<>>")
_FP2 = ("Join(T|C=[@0])[s]<Scan(__split__.taaaabbbbccccdddd)[x]<>,"
        "Scan(__split__.t1111222233334444)[y]<>>")
_FP3 = ("U<Scan(__split__.t0123456789abcdef)[x]<>,"
        "Scan(__split__.t0123456789abcdef)[x]<>>")


@pytest.mark.parametrize("fp", [_FP1, _FP2, _FP3, "Scan(root.t)[x]"])
def test_canonical_key_equals_the_jax_packages(fp):
    key = (fp, "inputs", True, "cpu")
    assert compiled._canonical_program_key(key) \
        == jax_compiled._canonical_program_key(key)


def test_canonical_key_rewrites_boundary_names():
    k1 = compiled._canonical_program_key((_FP1, "inputs", True))
    k2 = compiled._canonical_program_key((_FP2, "inputs", True))
    assert k1 == k2
    assert "__split__.#0" in k1[0] and "__split__.#1" in k1[0]
    k3 = compiled._canonical_program_key((_FP3, "i", True))
    assert k3[0].count("__split__.#0") == 2
    assert compiled._canonical_program_key(
        ("Scan(root.t)[x]", "i", True))[0] == "Scan(root.t)[x]"


def test_caps_file_key_is_canonical(tmp_path, monkeypatch):
    """A stage's learned caps survive a process whose boundary names
    differ (``DSQL_CAPS_FILE``)."""
    monkeypatch.setenv("DSQL_CAPS_FILE", str(tmp_path / "caps.json"))
    monkeypatch.setattr(compiled, "_caps_disk", None)
    monkeypatch.setattr(compiled, "_learned_caps",
                        type(compiled._learned_caps)())
    compiled._learned_caps_put((_FP1, "inputs", False, "cpu"),
                               {"agg0": 8192})
    compiled._learned_caps.clear()
    monkeypatch.setattr(compiled, "_caps_disk", None)
    assert compiled._learned_caps_get(
        (_FP2, "inputs", False, "cpu")) == {"agg0": 8192}
    assert compiled._caps_disk_key((_FP1, "i")) \
        == compiled._caps_disk_key((_FP2, "i"))


def test_spmd_stage_key_and_digest_are_canonical(store):
    mesh = Mesh(["cpu"] * 4)
    fps = ["Agg<Scan(__spmd__.t0123456789abcdef)[k]<>>",
           "Agg<Scan(__spmd__.tfedcba9876543210)[k]<>>"]
    keys = [spmd._stage_key(fp, "inputs", mesh, (), []) for fp in fps]
    assert keys[0] == keys[1]
    assert "__spmd__.#0" in keys[0][1]
    assert spmd._stage_digest(keys[0]) == spmd._stage_digest(keys[1])
    other = spmd._stage_key(fps[0], "inputs", Mesh(["cpu"] * 8), (), [])
    assert spmd._stage_digest(other) != spmd._stage_digest(keys[0])


# ---------------------------------------------------------------------------
# the JAX package's formats
# ---------------------------------------------------------------------------

def _cost_entry() -> dict:
    return dict(_entry(), cost={"flops": 12.0, "bytes": 34.0})


def test_index_and_files_have_the_jax_packages_format(tmp_path, monkeypatch):
    monkeypatch.delenv("DSQL_PROGRAM_STORE_MB", raising=False)
    mine = ps.ProgramStore(str(tmp_path / "port"))
    theirs = jax_ps.ProgramStore(str(tmp_path / "jax"))
    for s in (mine, theirs):
        assert s.store("a" * 32, _cost_entry())
        assert s.store("b" * 32, _entry())
    for name in ("port", "jax"):
        assert sorted(os.listdir(tmp_path / name)) == [
            "a" * 32 + ".prog", "b" * 32 + ".prog", "index.json"]
    got = json.load(open(tmp_path / "port" / "index.json"))
    want = json.load(open(tmp_path / "jax" / "index.json"))
    assert {d: sorted(e) for d, e in got.items()} \
        == {d: sorted(e) for d, e in want.items()}
    for d in got:
        for k in ("bytes", "cost_flops", "cost_bytes"):
            assert got[d].get(k) == want[d].get(k) or k == "bytes"
    assert mine.budget_bytes() == theirs.budget_bytes() == 512 << 20


def test_system_programs_schema_and_rows_equal_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("DSQL_PROGRAM_STORE", str(tmp_path / "port"))
    ps.get_store().store("a" * 32, _cost_entry())
    got = Context(device="cpu").sql("SELECT * FROM system.programs")
    monkeypatch.setenv("DSQL_PROGRAM_STORE", str(tmp_path / "jax"))
    jax_ps.get_store().store("a" * 32, _cost_entry())
    want = jax_st.build("programs")
    assert [(n, str(c.stype)) for n, c in zip(got.names, got.columns)] \
        == [(n, str(c.stype)) for n, c in zip(want.names, want.columns)]
    g, w = got.to_pylist(), want.to_pylist()
    assert len(g) == len(w) == 1
    assert g[0][0] == w[0][0] and g[0][4:] == w[0][4:] == [12.0, 34.0]


# ---------------------------------------------------------------------------
# build records
# ---------------------------------------------------------------------------

def test_consts_hand_out_and_take_back_their_record():
    consts = graphs._Consts(torch.device("cpu"))
    a = torch.arange(5, dtype=torch.int64)
    b = torch.tensor([True, False, True])
    consts.record(a)
    consts.record(a.clone())
    consts.record(b)
    cached = torch.full((3,), 7.5, dtype=torch.float64)
    consts.note(cached, cached.clone())
    consts.note(cached, cached.clone())      # one read per tensor
    rec = consts.to_record()
    assert sorted(n for _, n in rec.values()) == [1, 1, 2]
    graphs.check_record(rec)
    back = graphs._Consts.from_record(torch.device("cpu"), rec)
    assert torch.equal(back.replay(a), a) and torch.equal(back.replay(a), a)
    assert torch.equal(back.replay(b), b)
    assert torch.equal(back.replay(cached), cached)
    with pytest.raises(RuntimeError, match="did not make"):
        back.replay(a)
    back.rewind()
    assert torch.equal(back.replay(a), a)
    back.trim()
    assert back.nbytes() == a.numel() * 8


def test_check_record_refuses_altered_constants():
    consts = graphs._Consts(torch.device("cpu"))
    consts.record(torch.arange(4, dtype=torch.int32))
    rec = consts.to_record()
    key, (arr, n) = next(iter(rec.items()))
    arr = arr.copy()
    arr[0] += 1
    with pytest.raises(ValueError, match="does not match"):
        graphs.check_record({key: (arr, n)})
    with pytest.raises(ValueError):
        graphs.check_record({key: (rec[key][0], 0)})


def test_a_warm_up_notes_the_cached_uploads_it_reads(monkeypatch):
    """``note_cached`` reaches the warm-up's note hook for an upload that
    ``cached_upload`` remembered, and nothing outside a warm-up."""
    dev = torch.zeros(3)
    host = torch.ones(3)
    monkeypatch.setitem(gk._uploads, id(dev),
                        (__import__("weakref").ref(dev), host))
    seen = []
    gk.note_cached(dev)                     # no warm-up: nothing noted
    with gk.noting_cached(lambda d, h: seen.append((d, h))):
        gk.note_cached(dev, None, torch.zeros(1))
    assert seen == [(dev, host)]
    # on the CPU an upload is the tensor itself and is not remembered
    t = torch.arange(3)
    assert gk.cached_upload(t, torch.device("cpu")) is t
    assert id(t) not in gk._uploads


def test_graph_program_build_record_on_the_cpu_is_empty():
    prog = graphs.GraphProgram(lambda x: (x + 1,), torch.device("cpu"),
                               record={"consts": {"k": 1}})
    assert prog.record is None              # the CPU captures nothing
    prog(torch.arange(3))
    assert prog.build_record() == {"consts": {}, "pool_bytes": 0,
                                   "kernels": []}


# ---------------------------------------------------------------------------
# armed everywhere
# ---------------------------------------------------------------------------

def test_gates_keep_no_unported_list():
    from dask_sql_tpu_torch.runtime import gates

    assert not hasattr(gates, "UNPORTED")
    assert not hasattr(gates, "refuse")


def test_armed_store_answers_queries_tables_engine_and_server(store):
    from dask_sql_tpu_torch import run_server
    from dask_sql_tpu_torch.server import app

    c = Context(device="cpu")
    c.create_table("t", {"a": np.arange(30) % 4, "b": np.arange(30) * 1.5})
    out = c.sql("SELECT a, SUM(b) AS s FROM t GROUP BY a ORDER BY a")
    assert out.to_pylist()[0] == [0, sum(i * 1.5 for i in range(0, 30, 4))]
    assert c.sql("SELECT * FROM system.programs").num_rows >= 1
    assert app._program_store_section() == {
        "enabled": True, "entries": len(store.entries()),
        "bytes": store.total_bytes()}
    srv = run_server(context=c, host="127.0.0.1", port=0, blocking=False)
    try:
        assert srv.server_port > 0
    finally:
        srv.shutdown()
        srv.server_close()


def test_server_stats_count_program_store_hits(store):
    """A query the server answers from a stored record carries
    ``programStoreHits`` in its stats (absent when there was none), as the
    JAX package's server does."""
    import urllib.request

    from dask_sql_tpu_torch import run_server

    def post(base, sql):
        req = urllib.request.Request(f"{base}/v1/statement",
                                     data=sql.encode(), method="POST")
        with urllib.request.urlopen(req) as r:
            payload = json.loads(r.read())
        deadline = time.time() + 60
        while "/v1/status/" in payload.get("nextUri", "") \
                and time.time() < deadline:
            time.sleep(0.02)
            with urllib.request.urlopen(payload["nextUri"]) as r:
                payload = json.loads(r.read())
        return payload

    c = Context(device="cpu")
    c.create_table("t", {"a": np.arange(40) % 5, "b": np.arange(40) * 0.25})
    srv = run_server(context=c, host="127.0.0.1", port=0, blocking=False)
    base = f"http://127.0.0.1:{srv.server_port}"
    q = "SELECT a, SUM(b) AS s FROM t GROUP BY a ORDER BY a"
    try:
        cold = post(base, q)
        assert "programStoreHits" not in cold["stats"]
        compiled._cache.clear()
        compiled._learned_caps.clear()
        warm = post(base, q)
        assert warm["stats"]["programStoreHits"] == 1
        assert warm["data"] == cold["data"]
        with urllib.request.urlopen(f"{base}/v1/engine") as r:
            engine = json.loads(r.read())
        assert engine["programStore"]["enabled"] is True
        assert engine["programStore"]["entries"] >= 1
    finally:
        srv.shutdown()
        srv.server_close()
        srv.app_state.drained.set()


def test_armed_fleet_heartbeat_reports_the_store(store, tmp_path,
                                                 monkeypatch):
    from dask_sql_tpu_torch.runtime import events, fleet

    monkeypatch.setenv("DSQL_FLEET_DIR", str(tmp_path / "fleet"))
    try:
        c = Context(device="cpu")
        c.create_table("t", {"a": np.arange(20) % 3})
        c.sql("SELECT a, COUNT(*) AS n FROM t GROUP BY a")
        hb = fleet.collect_heartbeat()
        section = hb["programStore"]
        assert section["enabled"] is True
        assert section["entries"] == len(store.entries()) >= 1
        assert section["bytes"] == store.total_bytes() > 0
        assert set(section) == {"enabled", "entries", "bytes", "hits",
                                "misses", "hitRate"}
    finally:
        for k in ("DSQL_EVENTS", "DSQL_EVENTS_FILE", "DSQL_HISTORY_FILE",
                  "DSQL_REPLICA_ID"):
            os.environ.pop(k, None)
        fleet._reset_for_tests()
        events._reset_for_tests()


_UNARMED = """
import sys
import numpy as np
from dask_sql_tpu_torch import Context
c = Context(device="cpu")
c.create_table("t", {"a": np.arange(4)})
c.sql("SELECT SUM(a) AS s FROM t")
c.sql("SELECT * FROM system.programs")
print("dask_sql_tpu_torch.runtime.program_store" in sys.modules)
"""


def test_unarmed_the_store_is_never_imported():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DSQL_PROGRAM_STORE")}
    env.update(DSQL_TIERED="0", CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", _UNARMED], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=env, check=True)
    assert out.stdout.strip().splitlines()[-1] == "False"
