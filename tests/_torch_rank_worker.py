"""One rank of a mesh across processes, spawned by
``tests/test_torch_spmd_multiprocess.py`` and
``tests/test_torch_spmd_process_group.py`` (gloo on the CPU).

    python tests/_torch_rank_worker.py CONFIG.json

The config names the rank, the world size, the coordinator's port, the
local shard count, the group's timeout, the mode and the output prefix.
Modes:

- ``queries``: the tables of ``data`` (an ``.npz`` of ``table/column``
  arrays) on ``Context(mesh=init_multihost(...))`` and what each rank's
  entry holds (``placement``: its rows, ``rank_rows`` and statistics, and
  ``gather_rows`` of it as ``placed/<table>/...`` arrays), then each SQL
  of ``queries`` (those of ``again`` a second time, those of
  ``unmeshed`` with ``DSQL_MESH=0``), ``ANALYZED``, then
  ``WRITE_QUERIES`` after ``apply_writes`` and the placement of the
  appended table, then, with ``DSQL_PROGRAM_STORE`` at ``store``, two
  passes of the ``stored`` queries, each after ``spmd.clear_programs()``
  (``run_store_passes``), then lineitem registered chunked
  (``register_stream``) and each SQL of ``streamed`` over it (those of
  ``stream_again`` a second time, then ``stream_fault`` with a fault at
  its third upload: ``run_streams``); writes ``<out>.npz``
  (``name/column`` answers; a pass's as ``store1_<name>`` and
  ``store2_<name>``) and ``<out>.json`` (per query: the ``spmd_*``,
  ``mesh_process_*``, ``mesh_gather*`` and ``mv_refresh_*`` counter
  deltas, the tier, the wall seconds; per pass the same with
  ``program_store_*``; per streamed query what each batch entry held and
  what each batch plan did);
- ``collectives``: every collective of ``exchange.py``,
  ``partial_agg.py`` and ``distributed.py`` on seeded inputs
  (``collective_inputs``, shared with the test); writes ``<out>.npz``;
  then every rank but 0 leaves, and rank 0 runs a query the walker
  declines, whose gather must end in ``RankError`` (``run_gather_exit``;
  ``<out>.json``);
- ``errors``: a stage that raises on every rank; then a query whose first
  stage's capture step fails on ``bad_rank`` only, after its warm-up's
  collectives ran (``GraphProgram._capture``, which captures nothing on
  the CPU: where the card's capture would fail), run twice; then a stage
  that raises on ``bad_rank`` only; then, on the broken group, the
  queries after it (``run_errors``); writes ``<out>.json`` with what each
  query did (its answer, counters and collectives);
- ``profile``: ``DSQL_PROFILE`` armed on the ranks of ``profile_ranks``
  only, then each SQL of ``queries``; writes ``<out>.json`` with, per
  query, the tier and each ``spmd_stage`` span's skew probe
  (``shard_rows``, ``shard_first``, ``skew_ratio``), and ``<out>.npz``
  with the answers.
"""
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

#: what the tests' conftest pins in a module of this kind, for the ranks
#: (a spawned process reads no fixture)
RANK_ENV = {"DSQL_ADAPTIVE": "0", "DSQL_TIERED": "0",
            "DSQL_RESULT_CACHE_MB": "0", "DSQL_MAX_CONCURRENT_QUERIES": "0"}

N_GLOBAL = 8
ROWS_PER_SHARD = 24


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn(out_dir, mode: str, world: int, local: int, timeout_s: float,
          limit_s: float = 120.0, **cfg) -> list:
    """Run ``world`` ranks of ``mode`` on 127.0.0.1 (a free port, one
    torch thread each) and wait for them, at most ``limit_s`` seconds in
    all: past it every rank is killed and this raises ``TimeoutError``.
    Returns per rank (exit code, output tail, output prefix)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, **RANK_ENV)
    env.pop("DSQL_MESH", None)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    port = _free_port()
    procs, outs = [], []
    for rank in range(world):
        out = os.path.join(str(out_dir), f"{mode}{world}x{local}_{rank}")
        path = out + ".cfg.json"
        with open(path, "w") as f:
            json.dump(dict(cfg, rank=rank, world=world, port=port,
                           local=local, timeout=timeout_s, mode=mode,
                           out=out), f)
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), path], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + limit_s
    result = []
    try:
        for p, out in zip(procs, outs):
            log, _ = p.communicate(
                timeout=max(0.1, deadline - time.monotonic()))
            result.append((p.returncode, log[-3000:], out))
    except subprocess.TimeoutExpired:
        raise TimeoutError(f"{world} ranks of {mode} ran past {limit_s} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return result


def collective_inputs(seed: int = 5) -> dict:
    """Global arrays over ``N_GLOBAL`` shards of ``ROWS_PER_SHARD`` rows."""
    rng = np.random.RandomState(seed)
    n = N_GLOBAL * ROWS_PER_SHARD
    codes = rng.randint(-1, 40, n).astype(np.int64)
    return {
        "codes": codes,
        "vals": rng.standard_normal(n) * 1e3,
        "ivals": rng.randint(-50, 50, n).astype(np.int64),
        "oks": rng.rand(n) < 0.8,
        "groups": rng.randint(0, 7, n).astype(np.int64),
        "build": rng.permutation(n).astype(np.int64)[:n] - 3,
        "flags": rng.rand(N_GLOBAL) < 0.2,
        "table": rng.standard_normal((N_GLOBAL, 5)),
    }


def _shards(a, first: int, count: int):
    import torch

    t = torch.from_numpy(np.ascontiguousarray(a))
    per = t.shape[0] // N_GLOBAL
    return [t[(first + i) * per:(first + i + 1) * per]
            for i in range(count)]


#: the output families of ``run_collectives`` (a ``/<shard>`` suffix marks
#: one output per global shard, each rank writing its own shards')
COLLECTIVES = (
    "dist_groupby_sum_exchange", "dist_join_broadcast", "dist_prefix_sum",
    "dist_prefix_sum_int", "dist_segment_min", "dist_segment_sum",
    "exchange/codes", "exchange/oks", "exchange/vals", "gather_build",
    "gather_groups", "global_count", "global_max", "global_min",
    "global_sum", "global_sum_count", "hash_exchange", "pmax", "pmin",
    "psum", "psum_table", "replicated_flag", "ring_shift",
    "shard_replicated")


def run_collectives(mesh) -> dict:
    """Every collective over this process's shards of the same inputs; the
    test runs this on ``Mesh(["cpu"] * 8)`` and on each rank of a mesh
    across processes, and compares the bits."""
    import torch

    from dask_sql_tpu_torch.parallel import distributed as D
    from dask_sql_tpu_torch.parallel import exchange as X
    from dask_sql_tpu_torch.parallel import partial_agg as PA

    g = mesh.group
    first, loc = mesh.rank * mesh.local_size, mesh.local_size
    inp = collective_inputs()
    sh = {k: _shards(v, first, loc) for k, v in inp.items()
          if k not in ("flags", "table")}
    out = {}
    codes, pay = X.exchange(sh["codes"], [[v, o] for v, o in
                                          zip(sh["vals"], sh["oks"])],
                            mesh.devices, g)
    for i in range(loc):
        out[f"exchange/codes/{first + i}"] = codes[i]
        out[f"exchange/vals/{first + i}"] = pay[i][0]
        out[f"exchange/oks/{first + i}"] = pay[i][1]
    out["gather_build"] = X.gather_build(sh["vals"], g)
    flags = _shards(inp["flags"], first, loc)
    out["replicated_flag"] = X.replicated_flag(flags, g)
    parts, _ = X.shard_replicated(torch.arange(13.0), mesh.size, first, loc)
    for i in range(loc):
        out[f"shard_replicated/{first + i}"] = parts[i]
    tables = _shards(inp["table"], first, loc)
    out["psum"] = PA.psum([t[0] for t in tables], g)
    out["pmin"] = PA.pminmax([t[0] for t in tables], True, g)
    out["pmax"] = PA.pminmax([t[0] for t in tables], False, g)
    s, c = PA.global_sum(sh["vals"], sh["oks"], g)
    out["global_sum"], out["global_sum_count"] = s, c
    out["global_count"] = PA.global_count(sh["oks"], g)
    out["global_min"] = PA.global_minmax(sh["ivals"], sh["oks"], True, g)
    out["global_max"] = PA.global_minmax(sh["vals"], sh["oks"], False, g)
    out["gather_groups"] = PA.gather_groups(sh["ivals"], g)
    out["psum_table"] = PA.psum_table([t[0] for t in tables], g)

    glob = {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in inp.items()}
    out["dist_segment_sum"] = D.dist_segment_sum(mesh, glob["vals"],
                                                 glob["groups"], 7)
    out["dist_segment_min"] = D.dist_segment_minmax(
        mesh, glob["ivals"], glob["groups"], 7, True, -999)
    for j, t in enumerate(D.hash_exchange(mesh, glob["codes"], glob["vals"],
                                          glob["ivals"])):
        out[f"hash_exchange/{j}"] = t
    out["dist_groupby_sum_exchange"] = D.dist_groupby_sum_exchange(
        mesh, glob["codes"], glob["vals"], 40)
    out["dist_join_broadcast"] = D.dist_join_broadcast(
        mesh, glob["codes"], glob["build"], glob["vals"], -1.0)
    out["ring_shift"] = D.ring_shift(mesh, glob["vals"], 3)
    out["dist_prefix_sum"] = D.dist_prefix_sum(mesh, glob["vals"])
    out["dist_prefix_sum_int"] = D.dist_prefix_sum(mesh, glob["ivals"])
    return {k: v.numpy() for k, v in out.items()}


def multihost_frames() -> dict:
    """The JAX package's two-process test data
    (``tests/integration/test_multihost.py``): orders and cust."""
    import pandas as pd

    rng = np.random.RandomState(3)
    n = 1000
    orders = pd.DataFrame({"okey": np.arange(n),
                           "cust": rng.randint(0, 37, n),
                           "amount": np.round(rng.uniform(1, 100, n), 2)})
    cust = pd.DataFrame({"ckey": np.arange(37),
                         "seg": rng.choice(["A", "B", "C"], 37)})
    return {"orders": orders, "cust": cust}


def save_frames(path: str, frames: dict) -> None:
    arrays = {}
    for name, frame in frames.items():
        for col in frame.columns:
            a = frame[col].to_numpy()
            arrays[f"{name}/{col}"] = a.astype(str) if a.dtype == object else a
    np.savez(path, **arrays)


def frames_from_npz(path: str) -> dict:
    """``table/column`` arrays back into pandas frames (strings as ``str``
    arrays, as ``tests`` saved them)."""
    import pandas as pd

    data = np.load(path)
    cols: dict = {}
    for key in data.files:
        table, col = key.split("/", 1)
        cols.setdefault(table, {})[col] = data[key]
    return {t: pd.DataFrame(c) for t, c in cols.items()}


def answer_arrays(df) -> dict:
    out = {}
    for c in df.columns:
        a = df[c].to_numpy()
        out[c] = a.astype(str) if a.dtype == object else a
    return out


COUNTED = ("spmd_", "mesh_process_", "mesh_gather", "mv_refresh_",
           "stream_batches")


def _deltas(c0: dict, c1: dict, kinds: tuple = COUNTED) -> dict:
    return {k: v - c0.get(k, 0) for k, v in c1.items()
            if k.startswith(kinds) and v != c0.get(k, 0)}


def placement(ctx, tables) -> tuple:
    """What this rank's entry of each table holds: (arrays of
    ``gather_rows`` of it, as ``placed/<table>/<column>`` with ``.mask``
    and ``.dict`` and ``placed/<table>/.row_valid``; per table its local
    rows, ``rank_rows`` and statistics).  Every rank calls this alike."""
    from dask_sql_tpu_torch.parallel.mesh import gather_rows

    arrays, report = {}, {}
    for name in tables:
        entry = ctx.schema["root"].tables[name]
        whole, valid = gather_rows(entry.table, entry.row_valid, ctx.mesh)
        for col_name, col in zip(whole.names, whole.columns):
            arrays[f"placed/{name}/{col_name}"] = col.data.numpy()
            if col.mask is not None:
                arrays[f"placed/{name}/{col_name}.mask"] = col.mask.numpy()
            if col.dictionary is not None:
                arrays[f"placed/{name}/{col_name}.dict"] = np.asarray(
                    col.dictionary).astype(str)
        if valid is not None:
            arrays[f"placed/{name}/.row_valid"] = valid.numpy()
        rr = entry.rank_rows
        report[name] = {
            "rows": entry.table.num_rows,
            "rank_rows": None if rr is None else [rr.padded, rr.rows,
                                                  rr.first],
            "stats": stats_summary(entry.stats)}
    return arrays, report


def stats_summary(ts) -> list:
    """A ``TableStats`` as JSON: its rows and every column's fields (its
    collection time left out)."""
    return [ts.rows, sorted([name, cs.ndv, cs.min, cs.max, cs.null_frac,
                             cs.is_int, cs.dense, cs.domain]
                            for name, cs in ts.cols.items())]


def run_queries(ctx, queries: dict, prefix: str = "",
                kinds: tuple = COUNTED) -> tuple:
    from dask_sql_tpu_torch.runtime import telemetry as tel

    arrays, report = {}, {}
    for name, sql in queries.items():
        c0 = tel.REGISTRY.counters()
        t0 = time.perf_counter()
        df = ctx.sql(sql, return_futures=False)
        seconds = time.perf_counter() - t0
        tier = None
        for s in ctx.last_report.root.walk():
            tier = tier or s.attrs.get("tier")
        report[name] = {"counters": _deltas(c0, tel.REGISTRY.counters(),
                                            kinds),
                        "tier": tier, "seconds": seconds}
        for col, a in answer_arrays(df).items():
            arrays[f"{prefix}{name}/{col}"] = a
    return arrays, report


def run_store_passes(ctx, queries: dict, store: str) -> tuple:
    """Two passes of ``queries`` with the program store at ``store``, each
    after every stage program was dropped: the first builds and stores
    this rank's records, the second makes its programs from them."""
    from dask_sql_tpu_torch.parallel import spmd

    kinds = COUNTED + ("program_store_",)
    os.environ["DSQL_PROGRAM_STORE"] = store
    try:
        arrays, report = {}, {}
        for n in (1, 2):
            spmd.clear_programs()
            more, report[f"pass{n}"] = run_queries(ctx, queries,
                                                   f"store{n}_", kinds)
            arrays.update(more)
    finally:
        os.environ.pop("DSQL_PROGRAM_STORE", None)
    return arrays, report


#: ANALYZE TABLE of a padded table (37 rows on 8 shards), which reads its
#: columns whole: on a mesh across processes gathered one at a time
ANALYZED = {"analyzed": "ANALYZE TABLE mh_cust COMPUTE STATISTICS FOR ALL "
                          "COLUMNS"}

#: the write path and streaming on the mesh: a materialized view joining
#: mh_orders and mh_cust, rows appended to mh_orders (the view refreshes
#: in full on a mesh, over its bases read whole), and mh_orders
#: registered again as a chunked table of small batches
APPEND_ROWS = {"okey": np.arange(1000, 1013), "cust": np.arange(13) % 37,
               "amount": np.round(np.arange(13) * 1.25 + 0.5, 2)}
JOIN_VIEW = ("CREATE MATERIALIZED VIEW mh_order_segs AS SELECT okey, "
             "amount, seg FROM mh_orders JOIN mh_cust ON cust = ckey")
WRITE_QUERIES = {
    "appended": ("SELECT cust, COUNT(*) AS n, SUM(amount) AS s FROM "
                 "mh_orders GROUP BY cust ORDER BY cust"),
    "streamed": ("SELECT cust, COUNT(*) AS n, SUM(amount) AS s FROM "
                 "mh_orders_c WHERE amount > 20 GROUP BY cust ORDER BY cust"),
    "joined_view": ("SELECT seg, COUNT(*) AS n, SUM(amount) AS s FROM "
                    "mh_order_segs GROUP BY seg ORDER BY seg"),
}


def apply_writes(ctx, frames: dict) -> None:
    """The same appends, view and chunked registration on every rank (and
    on the tests' single-process mesh)."""
    from dask_sql_tpu_torch.io.chunked import ChunkedSource

    ctx.sql(JOIN_VIEW)
    ctx.append_rows("mh_orders", dict(APPEND_ROWS))
    cols = {c: frames["mh_orders"][c].to_numpy()
            for c in frames["mh_orders"].columns}
    ctx.create_table("mh_orders_c", ChunkedSource.from_columns(
        cols, batch_rows=256), chunked=True)


#: streaming on the mesh across processes: lineitem registered again as a
#: chunked table of small batches (8 at SF 0.01, the last short)
STREAM_TABLE = "lineitem_c"
STREAM_BATCH_ROWS = 8192


def register_stream(ctx, frames: dict) -> None:
    """lineitem as the chunked ``STREAM_TABLE`` (on every rank, and on the
    tests' single-process mesh)."""
    from dask_sql_tpu_torch.io.chunked import ChunkedSource

    li = frames["lineitem"]
    ctx.create_table(STREAM_TABLE, ChunkedSource.from_columns(
        {c: li[c].to_numpy() for c in li.columns},
        batch_rows=STREAM_BATCH_ROWS), chunked=True)


def run_streams(ctx, cfg: dict) -> tuple:
    """Each SQL of ``streamed`` over ``STREAM_TABLE`` (those of
    ``stream_again`` once more), recording per query what every batch
    entry held (its rows, ``rank_rows`` and row_valid length) and what
    every batch plan did (whether it scanned this rank's rows, whether
    the walker served it, its gathers and gather steps), and the
    ``__stream__`` keys left among the gathered columns after it; then
    ``stream_fault`` with a fatal fault at the third upload
    (``chunked_read``), which must leave no gathered batch either."""
    from dask_sql_tpu_torch.parallel import gather as G
    from dask_sql_tpu_torch.physical import streaming as S
    from dask_sql_tpu_torch.runtime import faults
    from dask_sql_tpu_torch.runtime import telemetry as tel

    log: dict = {}
    real_set, real_run, real_fill = (S._set_batch_entry, S._run_resident,
                                     G._fill)
    steps = [0]

    def set_entry(context, table, row_valid, name=S.BATCH_TABLE,
                  rank_rows=None):
        if name == S.BATCH_TABLE:
            log["entries"].append([
                table.num_rows,
                None if rank_rows is None else [rank_rows.padded,
                                                rank_rows.rows,
                                                rank_rows.first],
                None if row_valid is None else int(row_valid.shape[0])])
        return real_set(context, table, row_valid, name, rank_rows)

    def run(plan, context):
        local = S._scans_rank_local(plan, context)
        c0, s0 = tel.REGISTRY.counters(), steps[0]
        out = real_run(plan, context)
        c1 = tel.REGISTRY.counters()
        log["plans"].append({
            "local": local,
            "served": c1.get("spmd_queries", 0) - c0.get("spmd_queries", 0),
            "gathers": (c1.get("mesh_gathers", 0)
                        - c0.get("mesh_gathers", 0)),
            "steps": steps[0] - s0})
        return out

    def fill(context, wants):
        steps[0] += 1
        return real_fill(context, wants)

    def stale() -> list:
        return [list(k) for k in ctx.__dict__.get("_gathered", {})
                if k[0] == S.STREAM_SCHEMA]

    S._set_batch_entry, S._run_resident, G._fill = set_entry, run, fill
    arrays, report = {}, {}
    try:
        for label, names in (("", list(cfg["streamed"])),
                             ("again_", cfg["stream_again"])):
            for name in names:
                log.update(entries=[], plans=[])
                more, rep = run_queries(ctx, {name: cfg["streamed"][name]},
                                        label)
                arrays.update(more)
                report[label + name] = dict(
                    rep[name], entries=log["entries"], plans=log["plans"],
                    stale=stale())
        name = cfg["stream_fault"]
        log.update(entries=[], plans=[])
        with faults.inject("chunked_read:3:fatal"):
            try:
                ctx.sql(cfg["streamed"][name], return_futures=False)
                raised = None
            except Exception as e:
                raised = type(e).__name__
        report["fault"] = {"raised": raised, "plans": log["plans"],
                           "stale": stale()}
    finally:
        S._set_batch_entry, S._run_resident, G._fill = (real_set, real_run,
                                                         real_fill)
    return arrays, report


def run_profiled(ctx, cfg: dict) -> tuple:
    """The queries of ``cfg``, this rank armed with ``DSQL_PROFILE`` when it
    is one of ``profile_ranks``: (answers, per query its tier and stage
    probes)."""
    if cfg["rank"] in cfg["profile_ranks"]:
        os.environ["DSQL_PROFILE"] = "1"
    else:
        os.environ.pop("DSQL_PROFILE", None)
    arrays, report = {}, {}
    for name, sql in cfg["queries"].items():
        df = ctx.sql(sql, return_futures=False)
        stages, tier = [], None
        for s in ctx.last_report.root.walk():
            tier = tier or s.attrs.get("tier")
            if s.name == "spmd_stage":
                stages.append({k: s.attrs.get(k) for k in (
                    "index", "shard_rows", "shard_first", "skew_ratio")})
        report[name] = {"tier": tier, "stages": stages}
        for col, a in answer_arrays(df).items():
            arrays[f"{name}/{col}"] = a
    return arrays, report


def run_errors(ctx, cfg: dict) -> dict:
    """What each query does when the walker raises: on every rank (all fall
    back); then when the step that would capture fails on ``bad_rank``
    only, after the warm-up (every rank runs that stage eagerly), twice;
    then when the walker raises on ``bad_rank`` only (every rank raises
    ``RankError``), then a served query on the broken group, a declined
    one whose columns an earlier fallback gathered, and a declined one
    that needs a new gather."""
    from dask_sql_tpu_torch.parallel import spmd
    from dask_sql_tpu_torch.physical import graphs

    rank = cfg["rank"]
    sql = cfg["queries"]
    group = ctx.mesh.group
    out = {}
    real = spmd._Walker._aggregate
    real_capture = graphs.GraphProgram._capture

    def boom(self, rel):
        raise ValueError(f"stub raised on rank {rank}")

    armed = [rank == cfg["bad_rank"]]

    def capture_fails_once(self, inputs, consts):
        if armed[0]:
            armed[0] = False
            raise RuntimeError(f"capture stub failed on rank {rank}")
        return real_capture(self, inputs, consts)

    def run(name, text=None):
        from dask_sql_tpu_torch.runtime import telemetry as tel

        c0 = tel.REGISTRY.counters()
        n0 = group.collectives
        t0 = time.perf_counter()
        try:
            df = ctx.sql(text or sql[name], return_futures=False)
            out[name] = {"ok": True, "rows": len(df),
                         "answer": {c: a.tolist() for c, a in
                                    answer_arrays(df).items()}}
        except Exception as e:
            out[name] = {"ok": False, "type": type(e).__name__,
                         "error": str(e)}
        out[name]["seconds"] = time.perf_counter() - t0
        out[name]["counters"] = _deltas(c0, tel.REGISTRY.counters())
        out[name]["collectives"] = group.collectives - n0

    spmd._Walker._aggregate = boom
    run("every_rank")
    spmd._Walker._aggregate = real
    graphs.GraphProgram._capture = capture_fails_once
    run("capture_one_rank")
    run("capture_again", sql["capture_one_rank"])
    graphs.GraphProgram._capture = real_capture
    spmd._Walker._aggregate = boom
    if rank != cfg["bad_rank"]:
        spmd._Walker._aggregate = real
    run("one_rank")
    spmd._Walker._aggregate = real
    run("after")
    run("declined")
    run("declined_gather")
    return out


def run_gather_exit(mesh, cfg: dict) -> dict:
    """After the collectives: a table on every rank, then every rank but 0
    leaves the mesh, and rank 0 runs a query the walker declines, whose
    gather pairs with no one: it must end in ``RankError``."""
    from dask_sql_tpu_torch import Context
    from dask_sql_tpu_torch.parallel import group as G

    ctx = Context(mesh=mesh)
    ctx.create_table("t", {"k": np.arange(40) % 7, "v": np.arange(40.0)})
    G.rendezvous(mesh.group, {"step": "leave"})
    if mesh.rank:
        return {"left": True}
    t0 = time.perf_counter()
    try:
        ctx.sql("SELECT COUNT(DISTINCT k) AS n FROM t")
        raised, text = None, ""
    except Exception as e:
        raised, text = type(e).__name__, str(e)
    return {"left": False, "raised": raised, "error": text,
            "seconds": time.perf_counter() - t0}


def main(path: str) -> int:
    with open(path) as f:
        cfg = json.load(f)
    import torch

    torch.set_num_threads(1)
    from dask_sql_tpu_torch import Context
    from dask_sql_tpu_torch.parallel.mesh import init_multihost

    mesh = init_multihost(f"127.0.0.1:{cfg['port']}", cfg["world"],
                          cfg["rank"], device="cpu",
                          local_shards=cfg["local"],
                          timeout_s=cfg["timeout"])
    info = {"size": mesh.size, "local_size": mesh.local_size,
            "rank": mesh.rank, "world_size": mesh.world_size,
            "signature": mesh.signature()}
    # a second call reuses the group set up above
    again = init_multihost(f"127.0.0.1:{cfg['port']}", cfg["world"],
                           cfg["rank"], device="cpu",
                           local_shards=cfg["local"])
    info["reused_size"] = again.size
    out = cfg["out"]
    if cfg["mode"] == "collectives":
        np.savez(out + ".npz", **run_collectives(mesh))
        info["gather_exit"] = run_gather_exit(mesh, cfg)
    else:
        ctx = Context(mesh=mesh)
        frames = frames_from_npz(cfg["data"])
        for name, frame in frames.items():
            ctx.create_table(name, frame)
        if cfg["mode"] == "queries":
            placed, info["placement"] = placement(ctx, frames)
            arrays, info["queries"] = run_queries(ctx, cfg["queries"])
            _, info["again"] = run_queries(
                ctx, {k: cfg["queries"][k] for k in cfg["again"]})
            os.environ["DSQL_MESH"] = "0"
            unmeshed, info["unmeshed"] = run_queries(
                ctx, {k: cfg["queries"][k] for k in cfg["unmeshed"]},
                "unmeshed_")
            os.environ.pop("DSQL_MESH")
            analyzed, info["analyzed"] = run_queries(ctx, ANALYZED)
            apply_writes(ctx, frames)
            more, info["writes"] = run_queries(ctx, WRITE_QUERIES)
            appended, info["appended"] = placement(ctx, ["mh_orders"])
            stored, info["store"] = run_store_passes(
                ctx, {k: cfg["queries"][k] for k in cfg["stored"]},
                cfg["store"])
            register_stream(ctx, frames)
            streamed, info["streams"] = run_streams(ctx, cfg)
            np.savez(out + ".npz", **arrays, **more, **stored, **placed,
                     **unmeshed, **analyzed, **streamed,
                     **{"appended_" + k: v for k, v in appended.items()})
        elif cfg["mode"] == "profile":
            arrays, info["profile"] = run_profiled(ctx, cfg)
            np.savez(out + ".npz", **arrays)
        else:
            info["errors"] = run_errors(ctx, cfg)
    with open(out + ".json", "w") as f:
        json.dump(info, f)
    from dask_sql_tpu_torch.parallel.group import close

    close(mesh.group)
    # no interpreter teardown: a broken gloo group can block in it
    os._exit(0)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
