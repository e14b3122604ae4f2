"""The spill store (``runtime/spill.py``) in the port, against the JAX
package.

- The store cases of ``tests/unit/test_spill.py`` on both packages' stores
  (``P.spill``): host round trips, stats, the LRU flush to ``.npz`` files
  and the load back (bit for bit), a chunk larger than the host budget,
  a corrupt file raising ``SpillCorrupt``, and the device tier (torch
  tensors in the port) with its demotion and its cap.
- One script of puts, flushes, loads, demotions and frees gives equal
  ``stats()`` (the directory aside), ``runs_snapshot()`` and ``spill_*``
  counter deltas in both packages.
- The ``spill`` fault site: a fault on the first disk write is retried
  and the chunk lands; a fault on every write fails typed, counted as
  ``spill_errors``, in both packages alike.
"""
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dask_sql_tpu.runtime import faults as jax_faults
from dask_sql_tpu.runtime import resilience as jax_res
from dask_sql_tpu.runtime import spill as jax_spill
from dask_sql_tpu.runtime import telemetry as jax_tel
from dask_sql_tpu.table import Column as JaxColumn, Table as JaxTable
from dask_sql_tpu.types import BIGINT, DOUBLE
from dask_sql_tpu_torch.runtime import faults as port_faults
from dask_sql_tpu_torch.runtime import resilience as port_res
from dask_sql_tpu_torch.runtime import spill as port_spill
from dask_sql_tpu_torch.runtime import telemetry as port_tel
from dask_sql_tpu_torch.table import Column as PortColumn, Table as PortTable


def _jnp(host):
    import jax.numpy as jnp
    return jnp.asarray(host)


PKGS = {
    "jax": SimpleNamespace(spill=jax_spill, faults=jax_faults, R=jax_res,
                           tel=jax_tel, Table=JaxTable, Column=JaxColumn,
                           asarray=_jnp),
    "port": SimpleNamespace(spill=port_spill, faults=port_faults, R=port_res,
                            tel=port_tel, Table=PortTable, Column=PortColumn,
                            asarray=torch.from_numpy),
}


@pytest.fixture(params=sorted(PKGS))
def P(request):
    return PKGS[request.param]


@pytest.fixture
def store(P, monkeypatch, tmp_path):
    monkeypatch.setenv("DSQL_SPILL_MB", "64")
    monkeypatch.setenv("DSQL_SPILL_DIR", str(tmp_path))
    monkeypatch.setenv("DSQL_RETRY_BASE_MS", "1")
    return P.spill.SpillStore()


def _cols(n, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.random(n)
    mask = rng.random(n) > 0.1
    ints = rng.integers(0, 1000, n)
    return [(data, mask, DOUBLE, None), (ints, None, BIGINT, None)]


def _assert_cols_equal(got, want):
    assert len(got) == len(want)
    for (gd, gm, *_), (wd, wm, *_) in zip(got, want):
        np.testing.assert_array_equal(gd, wd)
        if wm is None:
            assert gm is None
        else:
            np.testing.assert_array_equal(gm, wm)


# ---------------------------------------------------------------------------
# host tier
# ---------------------------------------------------------------------------

def test_host_round_trip(P, store):
    a, b = _cols(100, seed=1), _cols(50, seed=2)
    assert store.put_host("r1", ["x", "y"], a) == 0
    assert store.put_host("r1", ["x", "y"], b) == 1
    assert store.n_chunks("r1") == 2
    assert store.run_rows("r1") == 150
    names, got = store.get_host_cols("r1", 0)
    assert names == ["x", "y"]
    _assert_cols_equal(got, a)
    _, got = store.get_host_cols("r1", 1)
    _assert_cols_equal(got, b)
    meta_names, stypes, dicts, rows = store.chunk_meta("r1", 1)
    assert meta_names == ["x", "y"]
    assert stypes == [DOUBLE, BIGINT]
    assert rows == 50
    assert store.host_bytes > 0
    store.free_run("r1")
    assert store.host_bytes == 0
    assert not store.has_run("r1")


def test_stats_and_snapshot(P, store):
    store.put_host("r1", ["x", "y"], _cols(10))
    s = store.stats()
    assert s["runs"] == 1 and s["chunks"] == 1 and s["host_bytes"] > 0
    snap = store.runs_snapshot()
    assert len(snap) == 1
    assert snap[0]["run"] == "r1"
    assert snap[0]["host_chunks"] == 1 and snap[0]["disk_chunks"] == 0


# ---------------------------------------------------------------------------
# disk tier
# ---------------------------------------------------------------------------

def test_disk_flush_lru_order_and_reload(P, store, monkeypatch, tmp_path):
    # ~0.9 MB per chunk against a 2 MB budget: chunk 0 (coldest) must
    # flush to disk when chunk 2 arrives, hotter chunks stay resident
    monkeypatch.setenv("DSQL_SPILL_MB", "2")
    chunks = [_cols(60_000, seed=i) for i in range(3)]
    for c in chunks:
        store.put_host("r", ["x", "y"], c)
    snap = store.runs_snapshot()[0]
    assert snap["disk_chunks"] >= 1
    assert store.disk_bytes > 0
    # the COLDEST chunk went first
    tier0 = store.get_chunk("r", 2)[0]
    assert tier0 == "host"
    assert any(f.endswith(".npz") for f in os.listdir(tmp_path))
    # reload round-trips bit-for-bit and consumes the file
    _, got = store.get_host_cols("r", 0)
    _assert_cols_equal(got, chunks[0])
    store.free_run("r")
    assert store.host_bytes == 0 and store.disk_bytes == 0
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".npz")]


def test_reload_never_self_evicts(P, store, monkeypatch):
    # regression: a chunk LARGER than the whole host budget must still be
    # readable after its disk round-trip — the budget sweep that runs
    # after a load pins the chunk being handed out (an unpinned sweep
    # flushed it straight back and the caller saw None payloads)
    monkeypatch.setenv("DSQL_SPILL_MB", "1")
    big = _cols(200_000, seed=7)  # ~2.4 MB > 1 MB budget
    store.put_host("r", ["x", "y"], big)
    assert store.runs_snapshot()[0]["disk_chunks"] == 1
    _, got = store.get_host_cols("r", 0)
    _assert_cols_equal(got, big)


def test_corrupt_disk_chunk_raises_typed(P, store, monkeypatch, tmp_path):
    monkeypatch.setenv("DSQL_SPILL_MB", "1")
    store.put_host("r", ["x", "y"], _cols(200_000, seed=3))
    files = [f for f in os.listdir(tmp_path) if f.endswith(".npz")]
    assert files
    with open(tmp_path / files[0], "wb") as f:
        f.write(b"not an npz payload")
    with pytest.raises(P.spill.SpillCorrupt):
        store.get_chunk("r", 0)


# ---------------------------------------------------------------------------
# device tier
# ---------------------------------------------------------------------------

def _device_table(P, n=64, seed=0):
    rng = np.random.default_rng(seed)
    host = rng.random(n)
    return host, P.Table(["v"], [P.Column(P.asarray(host), DOUBLE, None,
                                          None)])


def test_device_round_trip_and_shrink_demotion(P, store):
    host, table = _device_table(P, seed=11)
    store.put_table("d", table)
    tier, names, payload = store.get_chunk("d", 0)
    assert tier == "device" and names == ["v"]
    assert store.device_bytes > 0
    assert store.peak_device_bytes >= store.device_bytes
    # ledger-tenant hook: shrink demotes device chunks to host layout
    store.shrink_device_to(0)
    assert store.device_bytes == 0
    tier, _, _ = store.get_chunk("d", 0)
    assert tier == "host"
    _, got = store.get_host_cols("d", 0)
    np.testing.assert_allclose(got[0][0], host)


def test_device_cap_demotes_oversized_puts(P, store, monkeypatch):
    monkeypatch.setenv("DSQL_SPILL_DEVICE_MB", "0")
    _, table = _device_table(P, seed=12)
    store.put_table("d", table)
    tier, _, _ = store.get_chunk("d", 0)
    assert tier == "host"
    assert store.device_bytes == 0


# ---------------------------------------------------------------------------
# one script, both packages
# ---------------------------------------------------------------------------

def _script(P, tmp_path, monkeypatch):
    monkeypatch.setenv("DSQL_SPILL_MB", "2")
    monkeypatch.setenv("DSQL_SPILL_DIR", str(tmp_path))
    store = P.spill.SpillStore()
    before = P.tel.REGISTRY.counters()
    for i in range(3):
        store.put_host("r", ["x", "y"], _cols(60_000, seed=i))
    _, table = _device_table(P, n=5000, seed=4)
    store.put_table("d", table)
    states = [(store.stats(), store.runs_snapshot())]
    store.get_host_cols("r", 0)                 # load back from disk
    store.shrink_device_to(0)                   # demote the device chunk
    states.append((store.stats(), store.runs_snapshot()))
    store.free_run("r")
    states.append((store.stats(), store.runs_snapshot()))
    after = P.tel.REGISTRY.counters()
    deltas = {k: after[k] - before.get(k, 0) for k in after
              if k.startswith("spill_") and after[k] != before.get(k, 0)}
    for stats, _ in states:
        stats.pop("dir")
    return states, deltas


def test_one_script_equal_jax(tmp_path, monkeypatch):
    got = {name: _script(P, tmp_path / name, monkeypatch)
           for name, P in PKGS.items()}
    assert got["port"] == got["jax"]


def _fault_run(P, tmp_path, monkeypatch, spec):
    monkeypatch.setenv("DSQL_SPILL_MB", "1")
    monkeypatch.setenv("DSQL_SPILL_DIR", str(tmp_path))
    monkeypatch.setenv("DSQL_RETRY_BASE_MS", "1")
    store = P.spill.SpillStore()
    before = P.tel.REGISTRY.counters()
    outcome = "ok"
    with P.faults.inject(spec):
        try:
            store.put_host("r", ["x", "y"], _cols(200_000, seed=5))
        except P.R.TransientError as e:
            outcome = type(e).__name__
    after = P.tel.REGISTRY.counters()
    names = ("fault_spill", "retries", "spill_errors", "spill_flushes")
    return outcome, {k: after.get(k, 0) - before.get(k, 0) for k in names}


@pytest.mark.parametrize("spec,want", [
    ("spill:1", ("ok", {"fault_spill": 1, "retries": 1, "spill_errors": 0,
                        "spill_flushes": 1})),
    ("spill:1+", ("FaultInjected", {"fault_spill": 3, "retries": 2,
                                    "spill_errors": 1,
                                    "spill_flushes": 0})),
])
def test_spill_fault_site_equal_jax(tmp_path, monkeypatch, spec, want):
    got = {name: _fault_run(P, tmp_path / name, monkeypatch, spec)
           for name, P in PKGS.items()}
    assert got["port"] == got["jax"] == want
