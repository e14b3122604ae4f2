"""One rank of a mesh across processes, spawned by
``tests/test_torch_spmd_multiprocess.py`` and
``tests/test_torch_spmd_process_group.py`` (gloo on the CPU).

    python tests/_torch_rank_worker.py CONFIG.json

The config names the rank, the world size, the coordinator's port, the
local shard count, the group's timeout, the mode and the output prefix.
Modes:

- ``queries``: the tables of ``data`` (an ``.npz`` of ``table/column``
  arrays) on ``Context(mesh=init_multihost(...))``, then each SQL of
  ``queries``, then ``WRITE_QUERIES`` after ``apply_writes``; writes
  ``<out>.npz`` (``name/column`` answers) and ``<out>.json`` (per query:
  the ``spmd_*`` and ``mesh_process_*`` counter deltas, the tier, the
  wall seconds);
- ``collectives``: every collective of ``exchange.py``,
  ``partial_agg.py`` and ``distributed.py`` on seeded inputs
  (``collective_inputs``, shared with the test); writes ``<out>.npz``;
- ``errors``: a stage that raises on every rank, then one that raises on
  ``bad_rank`` only; writes ``<out>.json`` with what each query did.
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


def _deltas(c0: dict, c1: dict) -> dict:
    return {k: v - c0.get(k, 0) for k, v in c1.items()
            if k.startswith(("spmd_", "mesh_process_", "stream_batches"))
            and v != c0.get(k, 0)}


def run_queries(ctx, queries: dict) -> tuple:
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
        report[name] = {"counters": _deltas(c0, tel.REGISTRY.counters()),
                        "tier": tier, "seconds": seconds}
        for col, a in answer_arrays(df).items():
            arrays[f"{name}/{col}"] = a
    return arrays, report


#: the write path and streaming on the mesh: rows appended to mh_orders,
#: and mh_orders registered again as a chunked table of small batches
APPEND_ROWS = {"okey": np.arange(1000, 1013), "cust": np.arange(13) % 37,
               "amount": np.round(np.arange(13) * 1.25 + 0.5, 2)}
WRITE_QUERIES = {
    "appended": ("SELECT cust, COUNT(*) AS n, SUM(amount) AS s FROM "
                 "mh_orders GROUP BY cust ORDER BY cust"),
    "streamed": ("SELECT cust, COUNT(*) AS n, SUM(amount) AS s FROM "
                 "mh_orders_c WHERE amount > 20 GROUP BY cust ORDER BY cust"),
}


def apply_writes(ctx, frames: dict) -> None:
    """The same appends and chunked registration on every rank (and on
    the tests' single-process mesh)."""
    from dask_sql_tpu_torch.io.chunked import ChunkedSource

    ctx.append_rows("mh_orders", dict(APPEND_ROWS))
    cols = {c: frames["mh_orders"][c].to_numpy()
            for c in frames["mh_orders"].columns}
    ctx.create_table("mh_orders_c", ChunkedSource.from_columns(
        cols, batch_rows=256), chunked=True)


def run_errors(ctx, cfg: dict) -> dict:
    """What each query does when the walker raises: on every rank (all fall
    back), then on ``bad_rank`` only (every rank raises ``RankError``),
    then a served query on the broken group and a declined one."""
    from dask_sql_tpu_torch.parallel import spmd

    rank = cfg["rank"]
    sql = cfg["queries"]
    out = {}
    real = spmd._Walker._aggregate

    def boom(self, rel):
        raise ValueError(f"stub raised on rank {rank}")

    def run(name):
        from dask_sql_tpu_torch.runtime import telemetry as tel

        c0 = tel.REGISTRY.counters()
        t0 = time.perf_counter()
        try:
            df = ctx.sql(sql[name], return_futures=False)
            out[name] = {"ok": True, "rows": len(df)}
        except Exception as e:
            out[name] = {"ok": False, "type": type(e).__name__,
                         "error": str(e)}
        out[name]["seconds"] = time.perf_counter() - t0
        out[name]["counters"] = _deltas(c0, tel.REGISTRY.counters())

    spmd._Walker._aggregate = boom
    run("every_rank")
    if rank != cfg["bad_rank"]:
        spmd._Walker._aggregate = real
    run("one_rank")
    spmd._Walker._aggregate = real
    run("after")
    run("declined")
    return out


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
    else:
        ctx = Context(mesh=mesh)
        frames = frames_from_npz(cfg["data"])
        for name, frame in frames.items():
            ctx.create_table(name, frame)
        if cfg["mode"] == "queries":
            arrays, info["queries"] = run_queries(ctx, cfg["queries"])
            apply_writes(ctx, frames)
            more, info["writes"] = run_queries(ctx, WRITE_QUERIES)
            np.savez(out + ".npz", **arrays, **more)
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
