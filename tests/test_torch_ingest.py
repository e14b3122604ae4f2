"""The port's ingest log (``runtime/ingest.py``) and ``POST /v1/ingest``.

The JAX package's own ingest tests fail under pandas 3 (its WAL encoder
reads a ``StringDtype`` column through ``np.issubdtype``), so the port is
held against the JAX package's plain ``append_rows`` (the same batches
without the log, which works there) and against replays of its own log:
a new Context recovers every committed batch, a torn tail is skipped,
micro-batches coalesce, backpressure refuses before the commit point, a
reader under a writer sees one committed prefix, and the server's wire
matrix equals the JAX server's on a numeric table (which its encoder
takes).  A numeric log the JAX package wrote replays equal in the port.
Mirrors the JAX package's ``tests/unit/test_ingest.py``.
"""
import contextlib
import glob
import json
import math
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pandas as pd
import pytest
import torch

from dask_sql_tpu import Context as JaxContext
from dask_sql_tpu.runtime import ingest as jax_ingest
from dask_sql_tpu.runtime import scheduler as jax_sched
from dask_sql_tpu.server import app as jax_app
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.physical import compiled
from dask_sql_tpu_torch.runtime import ingest
from dask_sql_tpu_torch.runtime import scheduler as port_sched
from dask_sql_tpu_torch.runtime import telemetry as tel
from dask_sql_tpu_torch.runtime.resilience import (AdmissionRejected,
                                                   IngestBackpressure)
from dask_sql_tpu_torch.server import app as port_app
from dask_sql_tpu_torch.sql.parser import parse_sql

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def ingest_root(tmp_path, monkeypatch):
    root = tmp_path / "ingest"
    monkeypatch.setenv("DSQL_INGEST_DIR", str(root))
    yield root
    ingest._reset_for_tests()
    jax_ingest._reset_for_tests()


@contextlib.contextmanager
def _unarmed():
    """The JAX package's plain append path (its log is the known red)."""
    saved = os.environ.pop("DSQL_INGEST_DIR", None)
    try:
        yield
    finally:
        if saved is not None:
            os.environ["DSQL_INGEST_DIR"] = saved


def _base():
    return pd.DataFrame({"k": ["a", "b"], "x": [1.0, 2.0],
                         "ts": pd.to_datetime(["2020-01-01 00:00:00",
                                               "2020-01-02 03:04:05"])})


BATCHES = [
    [("c", 3.0, "2021-01-01 00:00:00")],
    {"k": ["d", None], "x": [4.0, None],
     "ts": pd.to_datetime(["2021-02-03 04:05:06.789", None],
                          format="ISO8601")},
    [("e", 5.5, None), ("f", -1.25, "2019-12-31 23:59:59")],
]


def _wal_lines(root):
    out = []
    for seg in sorted(glob.glob(os.path.join(str(root), "wal", "*.log"))):
        with open(seg, "rb") as f:
            out.extend(ln for ln in f.read().split(b"\n") if ln.strip())
    return out


def _rows(c, sql="SELECT * FROM t"):
    df = c.sql(sql, return_futures=False)
    return sorted(
        (tuple(None if v is None or (isinstance(v, float) and math.isnan(v))
               or v is pd.NaT else str(v) for v in r)
         for r in df.itertuples(index=False)), key=str)


def _reference(batches):
    """The JAX package's table after the same appends, without a log."""
    with _unarmed():
        j = JaxContext()
        j.create_table("t", _base())
        for b in batches:
            j.append_rows("t", b)
        return _rows(j)


def _count(c):
    return int(c.sql("SELECT COUNT(*) AS n FROM t",
                     return_futures=False)["n"][0])


def test_append_writes_wal_and_applies(ingest_root):
    c = Context(device=CPU)
    c.create_table("t", _base())
    for b in BATCHES:
        assert c.append_rows("t", b) > 0
    assert _rows(c) == _reference(BATCHES)
    assert len(_wal_lines(ingest_root)) == len(BATCHES)
    sec = ingest.engine_section(c)
    assert sec["armed"] and sec["walBytes"] > 0
    assert sec["tables"]["root.t"]["batches"] == len(BATCHES)


def test_wal_replay_into_fresh_context(ingest_root):
    c1 = Context(device=CPU)
    c1.create_table("t", _base())
    for b in BATCHES:
        c1.append_rows("t", b)
    live = _rows(c1)
    ingest._reset_for_tests()        # a process death
    replayed0 = tel.REGISTRY.get("ingest_replayed_rows", 0)
    c2 = Context(device=CPU)
    c2.create_table("t", _base())    # the restart registers the base
    assert _rows(c2) == live == _reference(BATCHES)
    assert tel.REGISTRY.get("ingest_replayed_rows", 0) == replayed0 + 5
    types = [col.stype.name for col in
             c2.schema["root"].tables["t"].table.columns]
    assert types == ["VARCHAR", "DOUBLE", "TIMESTAMP"]


def test_replay_on_arming_for_registered_tables(ingest_root):
    """A Context armed after its tables were registered (the server's
    ``run_server`` path) replays them at arming."""
    c1 = Context(device=CPU)
    c1.create_table("t", _base())
    c1.append_rows("t", BATCHES[0])
    ingest._reset_for_tests()
    with _unarmed():
        c2 = Context(device=CPU)
        c2.create_table("t", _base())
    assert _count(c2) == 2
    assert ingest.ensure_armed(c2)
    assert _count(c2) == 3


def test_torn_wal_tail_is_skipped_not_fatal(ingest_root):
    c1 = Context(device=CPU)
    c1.create_table("t", _base())
    c1.append_rows("t", BATCHES[0])
    ingest._reset_for_tests()
    (seg,) = glob.glob(os.path.join(str(ingest_root), "wal", "*.log"))
    with open(seg, "ab") as f:       # a crash mid-write
        f.write(b'{"v":1,"crc":99,"p":"{\\"s\\":\\"root\\",\\"t')
    torn0 = tel.REGISTRY.get("ingest_wal_torn_lines", 0)
    c2 = Context(device=CPU)
    c2.create_table("t", _base())
    assert _count(c2) == 3
    assert tel.REGISTRY.get("ingest_wal_torn_lines", 0) == torn0 + 1


def test_corrupt_line_is_skipped_whole(ingest_root):
    """A line whose CRC does not match is never half-applied."""
    c1 = Context(device=CPU)
    c1.create_table("t", _base())
    c1.append_rows("t", BATCHES[0])
    c1.append_rows("t", BATCHES[2])
    ingest._reset_for_tests()
    (seg,) = glob.glob(os.path.join(str(ingest_root), "wal", "*.log"))
    lines = open(seg, "rb").read().split(b"\n")
    lines[0] = lines[0].replace(b'\\"c\\"', b'\\"X\\"')
    open(seg, "wb").write(b"\n".join(lines))
    c2 = Context(device=CPU)
    c2.create_table("t", _base())
    assert _count(c2) == 4
    assert ("X", ) not in {r[:1] for r in _rows(c2)}


def test_kill_switch_keeps_append_path_baseline(ingest_root, monkeypatch):
    monkeypatch.setenv("DSQL_INGEST", "0")
    c = Context(device=CPU)
    c.create_table("t", _base())
    assert c.append_rows("t", BATCHES[0]) == 1
    assert _count(c) == 3
    assert not os.path.exists(os.path.join(str(ingest_root), "wal"))
    assert c.__dict__.get("_ingest_log") is None


def test_micro_batch_coalesces_to_one_wal_line(ingest_root, monkeypatch):
    monkeypatch.setenv("DSQL_INGEST_BATCH_ROWS", "5")
    monkeypatch.setenv("DSQL_INGEST_BATCH_MS", "60000")
    c = Context(device=CPU)
    c.create_table("t", _base())
    assert c.append_rows("t", [("c", 3.0, None), ("d", 4.0, None)]) == 0
    assert _count(c) == 2            # nothing visible before the flush
    assert ingest.engine_section(c)["bufferedRows"] == 2
    assert c.append_rows("t", [("e", 5.0, None), ("f", 6.0, None),
                               ("g", 7.0, None)]) == 5
    assert _count(c) == 7
    assert len(_wal_lines(ingest_root)) == 1


def test_flusher_commits_aged_buffers(ingest_root, monkeypatch):
    monkeypatch.setenv("DSQL_INGEST_BATCH_ROWS", "1000")
    monkeypatch.setenv("DSQL_INGEST_BATCH_MS", "20")
    c = Context(device=CPU)
    c.create_table("t", _base())
    assert c.append_rows("t", BATCHES[0]) == 0
    deadline = time.monotonic() + 10.0
    table = c.schema["root"].tables
    while table["t"].table.num_rows < 3 and time.monotonic() < deadline:
        time.sleep(0.005)
    assert _count(c) == 3
    assert len(_wal_lines(ingest_root)) == 1


def test_backpressure_rejects_before_wal(ingest_root, monkeypatch):
    c = Context(device=CPU)
    c.create_table("t", _base())
    c.append_rows("t", BATCHES[0])
    lines0 = len(_wal_lines(ingest_root))
    rejects0 = tel.REGISTRY.get("ingest_backpressure_rejects", 0)
    monkeypatch.setattr(port_sched.get_manager().ledger, "reserve",
                        lambda nbytes: None)
    with pytest.raises(IngestBackpressure) as ei:
        c.append_rows("t", BATCHES[2])
    assert isinstance(ei.value, AdmissionRejected)
    assert ei.value.retry_after_s > 0
    assert len(_wal_lines(ingest_root)) == lines0
    assert _count(c) == 3
    assert tel.REGISTRY.get("ingest_backpressure_rejects", 0) == rejects0 + 1


def test_snapshot_pin_isolates_reads_from_writer(ingest_root):
    c = Context(device=CPU)
    c.create_table("t", _base())
    sql = "SELECT k FROM t"
    plan = c._get_plan(parse_sql(sql)[0].query, sql)
    with ingest.pin_scope(c, plan):
        epoch0 = c.table_epoch("root", "t")
        entry0 = c.catalog_entry("root", "t")
        c.append_rows("t", BATCHES[0])
        assert c.catalog_entry("root", "t") is entry0
        assert c.table_epoch("root", "t") == epoch0
        # the compiled tier's stage names read the pinned table too
        assert compiled._scan_uids(plan, c) == [str(entry0.table.uid)]
    assert c.catalog_entry("root", "t").table.num_rows == 3
    assert c.table_epoch("root", "t") > epoch0
    assert compiled._scan_uids(plan, c) == [
        str(c.catalog_entry("root", "t").table.uid)]


def test_pinned_query_reads_the_pinned_statistics(ingest_root):
    """The dispatch's statistics (a dense GROUP BY's value range) come
    from the pinned table, not one that replaced it since."""
    from dask_sql_tpu_torch.runtime import statistics

    c = Context(device=CPU)
    c.create_table("n", {"g": np.arange(10) % 3, "x": np.arange(10.0)})
    sql = "SELECT g, SUM(x) AS s FROM n GROUP BY g"
    plan = c._get_plan(parse_sql(sql)[0].query, sql)
    scan = plan
    while scan.inputs:
        scan = scan.inputs[0]
    with ingest.pin_scope(c, plan):
        pinned = statistics.table_stats_for_scan(scan, c)
        c.create_table("n", {"g": np.arange(5) + 100, "x": np.ones(5)})
        assert statistics.table_stats_for_scan(scan, c) is pinned
        assert pinned.col("g").max == 2
        got = c._run_query_plan(plan).to_pylist()   # inside the pin
    assert sorted(got) == [[0, 18.0], [1, 12.0], [2, 15.0]]
    assert statistics.table_stats_for_scan(scan, c).col("g").min == 100


def test_reader_under_writer_sees_one_committed_prefix(ingest_root):
    """A reader thread's every answer equals the query over some prefix of
    the committed batches, while a writer appends."""
    c = Context(device=CPU)
    c.create_table("t", pd.DataFrame({"k": ["base"], "x": [0.5],
                                      "ts": pd.to_datetime(["2020-01-01"])}))
    n_batches = 24
    prefixes = {(1, 0.5)}
    n, s = 1, 0.5
    for i in range(n_batches):
        n, s = n + 3, s + 3 * float(i + 1)
        prefixes.add((n, s))
    seen, errors = [], []
    done = threading.Event()

    def reader():
        try:
            while not done.is_set():
                got = c.sql("SELECT COUNT(*) AS n, SUM(x) AS s, "
                            "COUNT(DISTINCT k) AS d FROM t").to_pylist()[0]
                seen.append(got)
        except Exception as e:   # pragma: no cover
            errors.append(e)

    th = threading.Thread(target=reader)
    th.start()
    try:
        for i in range(n_batches):
            c.append_rows("t", [(f"b{i}", float(i + 1), None)] * 3)
            time.sleep(0.001)
    finally:
        done.set()
        th.join(timeout=60)
    assert not th.is_alive()
    assert not errors
    assert seen
    for n, s, d in seen:
        assert (n, s) in prefixes
        assert d == 1 + (n - 1) // 3
    assert c.sql("SELECT COUNT(*) AS n FROM t").to_pylist() == [[1 + 72]]


JOIN_SQL = ("SELECT d.g, SUM(f.x) AS s, COUNT(*) AS n FROM d "
            "JOIN f ON d.k = f.k GROUP BY d.g ORDER BY d.g")


def _join_batches(n_batches, rows=25, seed=7):
    """The fact table's base and its appended batches (keys 0..39)."""
    rng = np.random.default_rng(seed)
    return [{"k": rng.integers(0, 40, n), "x": rng.integers(1, 100, n)}
            for n in [300] + [rows] * n_batches]


def _join_ctx(base):
    """A dimension and a fact table whose join and aggregate run as a
    stage graph (``DSQL_STAGE_HEAVY=1``) on ``DSQL_COMPILE_WORKERS``
    threads."""
    c = Context(device=CPU)
    c.create_table("d", {"k": np.arange(40), "g": np.arange(40) % 4})
    c.create_table("f", base)
    return c


def _join_answer(batches):
    """``JOIN_SQL`` over the base and ``batches`` in numpy."""
    k = np.concatenate([b["k"] for b in batches])
    x = np.concatenate([b["x"] for b in batches])
    g = k % 4
    return [[i, int(x[g == i].sum()), int((g == i).sum())]
            for i in range(4) if (g == i).any()]


def _stage_counts(before):
    return {n: compiled.stats.get(n, 0) - before.get(n, 0)
            for n in ("stage_graphs", "stage_execs")}


@pytest.mark.parametrize("cache_mb", ["0", "64"])
def test_stage_workers_read_the_pinned_tables(ingest_root, monkeypatch,
                                              cache_mb):
    """A stage graph's worker threads carry the query's pins: a writer
    that commits after admission changes neither the answer nor what the
    subplan cache stores under the pinned tables' boundary names."""
    monkeypatch.setenv("DSQL_STAGE_HEAVY", "1")
    monkeypatch.setenv("DSQL_COMPILE_WORKERS", "4")
    monkeypatch.setenv("DSQL_RESULT_CACHE_MB", cache_mb)
    batches = _join_batches(1)
    c = _join_ctx(batches[0])
    plan = c._get_plan(parse_sql(JOIN_SQL)[0].query, JOIN_SQL)
    before = dict(compiled.stats)
    with ingest.pin_scope(c, plan):
        pins = ingest.current_pins()
        writer = threading.Thread(target=c.append_rows,
                                  args=("f", batches[1]))
        writer.start()
        writer.join(timeout=60)
        assert c.schema["root"].tables["f"].table.num_rows == 325
        got = c._run_query_plan(plan).to_pylist()
    d = _stage_counts(before)
    assert d["stage_graphs"] == 1 and d["stage_execs"] >= 2, d
    assert got == _join_answer(batches[:1])
    # a later reader of the same prefix (its own pins) gets it again, and
    # a reader of the live table sees the batch
    with ingest.carried_pins(pins):
        assert c._run_query_plan(plan).to_pylist() == got
    assert c.sql(JOIN_SQL).to_pylist() == _join_answer(batches)


def test_staged_reader_under_writer_sees_one_committed_prefix(ingest_root,
                                                              monkeypatch):
    """A reader thread's staged join, run on four worker threads, equals
    the join over some committed prefix every time, while a writer
    appends to the fact table."""
    monkeypatch.setenv("DSQL_STAGE_HEAVY", "1")
    monkeypatch.setenv("DSQL_COMPILE_WORKERS", "4")
    n_batches = 12
    batches = _join_batches(n_batches)
    c = _join_ctx(batches[0])
    prefixes = [_join_answer(batches[:i + 1]) for i in range(n_batches + 1)]
    seen, errors = [], []
    done = threading.Event()
    before = dict(compiled.stats)

    def reader():
        try:
            while not done.is_set():
                seen.append(c.sql(JOIN_SQL).to_pylist())
        except Exception as e:   # pragma: no cover
            errors.append(e)

    th = threading.Thread(target=reader)
    th.start()
    try:
        for b in batches[1:]:
            c.append_rows("f", b)
            time.sleep(0.002)
    finally:
        done.set()
        th.join(timeout=120)
    assert not th.is_alive()
    assert not errors
    assert seen
    d = _stage_counts(before)
    assert d["stage_graphs"] >= len(seen) and d["stage_execs"] >= 2 * len(
        seen), d
    for got in seen:
        assert got in prefixes
    assert c.sql(JOIN_SQL).to_pylist() == prefixes[-1]


def test_background_build_reads_the_arrivals_tables(ingest_root,
                                                    monkeypatch):
    """Tiering answers a cold arrival eager and builds its programs on a
    daemon thread: that thread reads the tables the arrival was pinned
    to, whose uids key what it builds."""
    monkeypatch.setenv("DSQL_TIERED", "1")
    monkeypatch.setenv("DSQL_STAGE_HEAVY", "1")
    # DOUBLE facts: no program of the other tests serves this plan
    batches = [{"k": b["k"], "x": b["x"].astype(np.float64)}
               for b in _join_batches(1, seed=8)]
    c = _join_ctx(batches[0])
    sql = JOIN_SQL.replace("SUM(f.x)", "MAX(f.x)")
    plan = c._get_plan(parse_sql(sql)[0].query, sql)
    seen = []
    real = compiled.try_execute_compiled

    def spy(plan, context, *args, **kwargs):
        if getattr(compiled._tier_local, "bg", False):
            seen.append(context.catalog_entry("root", "f").table.uid)
        return real(plan, context, *args, **kwargs)

    monkeypatch.setattr(compiled, "try_execute_compiled", spy)
    with ingest.pin_scope(c, plan):
        pinned = c.catalog_entry("root", "f").table.uid
        writer = threading.Thread(target=c.append_rows,
                                  args=("f", batches[1]))
        writer.start()
        writer.join(timeout=60)
        c._run_query_plan(plan)
    deadline = time.monotonic() + 60
    while compiled.inflight_background_compiles() \
            and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not compiled.inflight_background_compiles()
    assert seen == [pinned]
    assert c.catalog_entry("root", "f").table.uid != pinned


def test_matview_refreshes_over_ingested_appends(ingest_root, monkeypatch):
    monkeypatch.setenv("DSQL_RESULT_CACHE_MB", "64")
    c = Context(device=CPU)
    c.create_table("t", _base())
    c.sql("CREATE MATERIALIZED VIEW v AS SELECT SUM(x) AS s FROM t")
    inc0 = tel.REGISTRY.get("mv_refresh_incremental", 0)
    c.append_rows("t", BATCHES[0])
    assert c.sql("SELECT s FROM v").to_pylist() == [[6.0]]
    assert tel.REGISTRY.get("mv_refresh_incremental", 0) == inc0 + 1


def test_concurrent_appends_lose_no_rows(ingest_root):
    c = Context(device=CPU)
    c.create_table("t", _base())
    n_threads, n_batches = 4, 8
    errors = []

    def writer(tid):
        try:
            for i in range(n_batches):
                c.append_rows("t", [(f"w{tid}b{i}", float(i), None)])
        except Exception as e:   # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=writer, args=(t,))
               for t in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads)
    assert not errors
    total = 2 + n_threads * n_batches
    assert _count(c) == total
    assert len(_wal_lines(ingest_root)) == n_threads * n_batches
    live = _rows(c)
    ingest._reset_for_tests()
    c2 = Context(device=CPU)
    c2.create_table("t", _base())
    assert _rows(c2) == live


def test_wal_commit_point_fsyncs(ingest_root, monkeypatch):
    synced = []
    real_fsync = os.fsync
    monkeypatch.setattr(ingest.os, "fsync",
                        lambda fd: (synced.append(fd), real_fsync(fd)))
    c = Context(device=CPU)
    c.create_table("t", _base())
    c.append_rows("t", BATCHES[0])
    assert synced
    synced.clear()
    monkeypatch.setenv("DSQL_INGEST_FSYNC", "0")
    c.append_rows("t", BATCHES[2])
    assert not synced


def test_segments_rotate(ingest_root, monkeypatch):
    monkeypatch.setattr(ingest, "_segment_bytes", lambda: 1)
    c = Context(device=CPU)
    c.create_table("t", _base())
    for b in BATCHES:
        c.append_rows("t", b)
    segs = sorted(glob.glob(os.path.join(str(ingest_root), "wal", "*.log")))
    assert len(segs) == len(BATCHES)
    live = _rows(c)
    ingest._reset_for_tests()
    c2 = Context(device=CPU)
    c2.create_table("t", _base())
    assert _rows(c2) == live


def test_close_flushes_buffered_rows(ingest_root, monkeypatch):
    monkeypatch.setenv("DSQL_INGEST_BATCH_ROWS", "100")
    monkeypatch.setenv("DSQL_INGEST_BATCH_MS", "60000")
    c = Context(device=CPU)
    c.create_table("t", _base())
    assert c.append_rows("t", [("c", 3.0, None), ("d", 4.0, None)]) == 0
    assert len(_wal_lines(ingest_root)) == 0
    c._ingest_log.close()
    assert len(_wal_lines(ingest_root)) == 1
    assert _count(c) == 4


def test_buffered_rows_hold_ledger_reservation(ingest_root, monkeypatch):
    monkeypatch.setenv("DSQL_INGEST_BATCH_ROWS", "100")
    monkeypatch.setenv("DSQL_INGEST_BATCH_MS", "60000")
    ledger = port_sched.get_manager().ledger
    c = Context(device=CPU)
    c.create_table("t", _base())
    r0 = ledger.reserved_bytes()
    assert c.append_rows("t", BATCHES[0]) == 0
    assert ledger.reserved_bytes() > r0
    assert c._ingest_log.flush_all() == 1
    assert ledger.reserved_bytes() == r0


def test_drop_table_truncates_wal(ingest_root):
    c = Context(device=CPU)
    c.create_table("t", _base())
    c.append_rows("t", BATCHES[0])
    assert len(_wal_lines(ingest_root)) == 1
    c.drop_table("t")
    assert len(_wal_lines(ingest_root)) == 0
    ingest._reset_for_tests()
    c2 = Context(device=CPU)
    c2.create_table("t", _base())
    assert _count(c2) == 2


def test_reregister_truncates_wal_no_double_apply(ingest_root):
    c = Context(device=CPU)
    c.create_table("t", _base())
    c.append_rows("t", BATCHES[0])
    snapshot = c.sql("SELECT * FROM t").to_numpy()
    c.create_table("t", snapshot)    # the checkpoint
    assert len(_wal_lines(ingest_root)) == 0
    assert _count(c) == 3
    ingest._reset_for_tests()
    c2 = Context(device=CPU)
    c2.create_table("t", snapshot)
    assert _count(c2) == 3


def test_failed_replay_batch_raises_and_is_kept(ingest_root):
    """A logged batch that cannot be applied to the base registered at
    restart raises from ``create_table`` and is not lost: the log keeps
    every batch, and registering the right base replays them all."""
    from dask_sql_tpu_torch.runtime.resilience import SchemaMismatch

    c = Context(device=CPU)
    c.create_table("t", _base())
    for b in BATCHES[:2]:
        c.append_rows("t", b)
    ingest._reset_for_tests()
    replayed0 = tel.REGISTRY.get("ingest_replayed_batches", 0)
    c2 = Context(device=CPU)
    with pytest.raises(SchemaMismatch):
        c2.create_table("t", {"a": np.arange(2), "b": np.arange(2)})
    assert tel.REGISTRY.get("ingest_replayed_batches", 0) == replayed0
    assert len(_wal_lines(ingest_root)) == 2
    c2.create_table("t", _base())
    assert tel.REGISTRY.get("ingest_replayed_batches", 0) == replayed0 + 2
    assert _rows(c2) == _reference(BATCHES[:2])
    assert len(_wal_lines(ingest_root)) == 2


def test_numeric_log_written_by_jax_replays_in_port(ingest_root):
    """The envelope is shared: a log of numeric and timestamp columns
    that the JAX package wrote replays in the port to the JAX table."""
    base = pd.DataFrame({"i": [1, 2], "x": [0.5, 1.5],
                         "ts": pd.to_datetime(["2020-01-01", "2020-06-01"])})
    j = JaxContext()
    j.create_table("n", base)
    j.append_rows("n", pd.DataFrame({
        "i": [3, 4], "x": [2.5, np.nan],
        "ts": pd.to_datetime(["2021-01-01 01:02:03.456789", None],
                             format="ISO8601")}))
    j.append_rows("n", [(5, 3.25, pd.Timestamp("2022-02-02"))])
    want = sorted(map(tuple, j.sql("SELECT * FROM n", return_futures=False)
                      .astype(object).where(lambda d: d.notna(), None)
                      .astype(str).values.tolist()))
    jax_ingest._reset_for_tests()
    c = Context(device=CPU)
    c.create_table("n", base)
    got = sorted(map(tuple, c.sql("SELECT * FROM n", return_futures=False)
                     .astype(object).where(lambda d: d.notna(), None)
                     .astype(str).values.tolist()))
    assert got == want and len(got) == 5


# ---------------------------------------------------------------------------
# POST /v1/ingest
# ---------------------------------------------------------------------------

def _post(url, body, headers=None):
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _wire(app, ctx, sched, monkeypatch, tmp_path, name):
    """The wire matrix of one package's server on a numeric table."""
    monkeypatch.setenv("DSQL_INGEST_DIR", str(tmp_path / name))
    ctx.create_table("t", pd.DataFrame({"i": [1, 2], "x": [0.5, 1.5]}))
    srv = app.run_server(context=ctx, host="127.0.0.1", port=0,
                         blocking=False)
    url = f"http://127.0.0.1:{srv.server_port}/v1/ingest"
    out = []
    try:
        def post(body):
            code, payload, headers = _post(url, json.dumps(body).encode())
            err = payload.get("error") or {}
            out.append((code, payload.get("state"), payload.get("rows"),
                        err.get("errorName"),
                        "Retry-After" in headers))

        post({"table": "t", "rows": [[3, 2.5], [4, None]]})
        post({"table": "t", "rows": {"i": [5], "x": [3.5]}})
        post({"table": "t", "rows": {"nope": [1]}})
        post({"table": "t", "rows": [[1, 2, 3]]})
        post({"table": "missing", "rows": [[1, 2.0]]})
        code, payload, _ = _post(url, b"not json")
        out.append((code, payload["error"]["errorName"]))
        ledger = sched.get_manager().ledger
        monkeypatch.setattr(ledger, "reserve", lambda nbytes: None)
        post({"table": "t", "rows": [[6, 4.5]]})
        monkeypatch.undo()
        monkeypatch.setenv("DSQL_INGEST_DIR", str(tmp_path / name))
        mgr = sched.get_manager()
        mgr.begin_drain()
        try:
            post({"table": "t", "rows": [[7, 5.5]]})
        finally:
            mgr.end_drain()
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.server_port}/v1/engine") as r:
            engine = json.loads(r.read())
        out.append(sorted(engine["ingest"]))
        out.append(sorted(map(tuple, ctx.sql("SELECT * FROM t",
                                             return_futures=False)
                              .astype(object).where(lambda d: d.notna(),
                                                    None)
                              .values.tolist()), key=str))
    finally:
        srv.shutdown()
        srv.server_close()
    return out


def test_ingest_wire_matrix_equals_jax(monkeypatch, tmp_path):
    want = _wire(jax_app, JaxContext(), jax_sched, monkeypatch, tmp_path,
                 "jax")
    got = _wire(port_app, Context(device=CPU), port_sched, monkeypatch,
                tmp_path, "port")
    assert got == want
    assert got[0][:3] == (200, "COMMITTED", 2)
    assert got[2][0] == got[3][0] == 400
    assert got[6][0] == 429 and got[6][4]
    assert got[7][0] == 503


def test_ingest_route_404_when_unarmed(monkeypatch):
    monkeypatch.delenv("DSQL_INGEST_DIR", raising=False)
    c = Context(device=CPU)
    c.create_table("t", pd.DataFrame({"i": [1]}))
    srv = port_app.run_server(context=c, host="127.0.0.1", port=0,
                              blocking=False)
    try:
        code, _, _ = _post(f"http://127.0.0.1:{srv.server_port}/v1/ingest",
                           b'{"table": "t", "rows": [[2]]}')
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.server_port}/v1/engine") as r:
            engine = json.loads(r.read())
    finally:
        srv.shutdown()
        srv.server_close()
    assert code == 404 and "ingest" not in engine


def test_ingest_tenant_quota_answers_429(monkeypatch, tmp_path):
    from dask_sql_tpu_torch.runtime import tenancy
    from dask_sql_tpu_torch.runtime.resilience import TenantQuotaExceeded

    def refuse(tenant):
        raise TenantQuotaExceeded("tenant over quota", retry_after_s=2.0)

    c = Context(device=CPU)
    c.create_table("t", pd.DataFrame({"i": [1]}))
    srv = port_app.run_server(context=c, host="127.0.0.1", port=0,
                              blocking=False)
    monkeypatch.setattr(tenancy.get_registry(), "claim", refuse)
    try:
        code, payload, headers = _post(
            f"http://127.0.0.1:{srv.server_port}/v1/ingest",
            b'{"table": "t", "rows": [[2]]}')
    finally:
        srv.shutdown()
        srv.server_close()
    assert code == 429 and headers["Retry-After"] == "2"
    assert payload["error"]["errorName"] == "TENANT_QUOTA_EXCEEDED"
    assert c.schema["root"].tables["t"].table.num_rows == 1


def test_drain_flushes_buffered_rows(monkeypatch, ingest_root):
    monkeypatch.setenv("DSQL_INGEST_BATCH_ROWS", "100")
    monkeypatch.setenv("DSQL_INGEST_BATCH_MS", "60000")
    monkeypatch.setenv("DSQL_DRAIN_TIMEOUT_S", "5")
    c = Context(device=CPU)
    c.create_table("t", _base())
    srv = port_app.run_server(context=c, host="127.0.0.1", port=0,
                              blocking=False)
    code, payload, _ = _post(
        f"http://127.0.0.1:{srv.server_port}/v1/ingest",
        json.dumps({"table": "t", "rows": [["c", 3.0, None]]}).encode())
    assert (code, payload["state"]) == (200, "BUFFERED")
    srv.drain_async()
    assert srv.drained_event.wait(20)
    port_sched.get_manager().end_drain()
    assert len(_wal_lines(ingest_root)) == 1
    assert _count(c) == 3
