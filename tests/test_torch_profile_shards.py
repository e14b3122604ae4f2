"""The profiling skew probe of the port's SPMD stage executor
(``parallel/spmd.py``) against the JAX package's.

With ``DSQL_PROFILE`` armed each SPMD stage's span carries the valid rows
of each shard of its output (``shard_rows``) and their max/mean ratio
(``skew_ratio``), from one host read of the stage's validity.  On the
port's mesh of 8 CPU shards they equal the JAX package's on its 8-device
virtual CPU mesh, stage by stage (integers exactly, ratios as the same
rounding of the same integers).  On a mesh across processes (world 2 x 4
over gloo, ``tests/_torch_rank_worker.py``) a rank reads only what it
holds: its own 4 shards of an inner stage (``shard_first``) and the whole
of the root stage's gathered output, so the probe adds no collective.
The ranks' shards put together equal the single-process mesh's, and two
ranks that disagree on ``DSQL_PROFILE`` still answer alike.

The module name holds "shard": the conftest's ``DSQL_MESH=0`` pin does not
apply.
"""
import json
import threading

import numpy as np
import pytest
import torch

import _torch_rank_worker as W
from dask_sql_tpu import Context as JaxContext
from dask_sql_tpu.parallel.mesh import default_mesh
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.parallel import spmd
from dask_sql_tpu_torch.parallel.mesh import Mesh

N_DEV = 8
#: a stage of at most one heavy node: the join and the GROUP BY are two
#: stages, the join's output an inner one (each rank holds its shards)
STAGE_HEAVY = "1"
QUERIES = {
    "mh": ("SELECT seg, COUNT(*) AS n, SUM(amount) AS s "
           "FROM mh_orders JOIN mh_cust ON cust = ckey WHERE okey < 300 "
           "GROUP BY seg ORDER BY seg"),
    "grp": ("SELECT cust, COUNT(*) AS n FROM mh_orders "
            "WHERE amount > 30 GROUP BY cust ORDER BY cust"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def frames():
    return {f"mh_{k}": v for k, v in W.multihost_frames().items()}


def _stages(report) -> list:
    return [s for s in report.root.walk() if s.name == "spmd_stage"]


def _probes(report) -> list:
    return [{k: s.attrs.get(k) for k in ("shard_rows", "skew_ratio")}
            for s in _stages(report)]


@pytest.fixture(scope="module")
def port_probes(frames):
    mp = pytest.MonkeyPatch()
    mp.setenv("DSQL_PROFILE", "1")
    mp.setenv("DSQL_STAGE_HEAVY", STAGE_HEAVY)
    try:
        # stage programs built unarmed elsewhere in this process would
        # carry no counted cost
        spmd.clear_programs()
        c = Context(mesh=Mesh(["cpu"] * N_DEV))
        for name, frame in frames.items():
            c.create_table(name, frame)
        out = {}
        for name, sql in QUERIES.items():
            df = c.sql(sql, return_futures=False)
            costs = [s.attrs.get("cost_bytes") for s in
                     _stages(c.last_report)]
            out[name] = (_probes(c.last_report), c.last_report.skew_ratio,
                         df, costs)
        return out
    finally:
        mp.undo()


def test_probe_at_8_shards_equals_the_jax_packages_8_device_mesh(
        monkeypatch, frames, port_probes):
    mesh = default_mesh()
    if mesh.devices.size != N_DEV:
        pytest.skip("needs the 8-device virtual CPU mesh")
    monkeypatch.setenv("DSQL_PROFILE", "1")
    monkeypatch.setenv("DSQL_STAGE_HEAVY", STAGE_HEAVY)
    jc = JaxContext(mesh=mesh)
    for name, frame in frames.items():
        jc.create_table(name, frame)
    for name, sql in QUERIES.items():
        jc.sql(sql, return_futures=False)
        want = _probes(jc.last_report)
        got, skew, _, costs = port_probes[name]
        assert got == want, name
        # each stage program's counted cost rides its span, as XLA's
        # cost analysis does the JAX package's (values differ: per op
        # against after fusion)
        assert costs and all(c and c > 0 for c in costs), costs
        assert all(s.attrs.get("cost_bytes")
                   for s in _stages(jc.last_report)), name
        assert skew == jc.last_report.skew_ratio
        assert all(p["shard_rows"] for p in got), name
        for p in got:
            if p["shard_rows"]:
                assert len(p["shard_rows"]) == N_DEV


def test_unarmed_stages_carry_no_probe(frames):
    c = Context(mesh=Mesh(["cpu"] * N_DEV))
    for name, frame in frames.items():
        c.create_table(name, frame)
    c.sql(QUERIES["grp"])
    assert c.last_report.tier == "spmd"
    assert all(p == {"shard_rows": None, "skew_ratio": None}
               for p in _probes(c.last_report))
    assert c.last_report.skew_ratio is None


def test_probe_across_processes_world_2x4(tmp_path, monkeypatch, frames,
                                          port_probes):
    """Two spawns of world 2 x 4 side by side: both ranks armed, and only
    rank 0 armed.  Every rank reads its own shards; put together they are
    the single-process mesh's; the answers of both spawns are equal."""
    data = str(tmp_path / "tables.npz")
    W.save_frames(data, frames)
    monkeypatch.setenv("DSQL_STAGE_HEAVY", STAGE_HEAVY)    # the ranks' too
    runs = {}

    def spawn(tag, armed):
        runs[tag] = W.spawn(tmp_path / tag, "profile", 2, 4, timeout_s=60.0,
                            limit_s=110.0, data=data, queries=QUERIES,
                            profile_ranks=armed)

    for tag in ("both", "rank0"):
        (tmp_path / tag).mkdir()
    threads = [threading.Thread(target=spawn, args=("both", [0, 1])),
               threading.Thread(target=spawn, args=("rank0", [0]))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=130)
        assert not t.is_alive()
    assert len(port_probes["mh"][0]) == 2     # an inner stage and the root
    inner = 0
    out = {}
    for tag, ranks in runs.items():
        out[tag] = []
        for rc, log, prefix in ranks:
            assert rc == 0, log
            with open(prefix + ".json") as f:
                info = json.load(f)
            out[tag].append((info["profile"], dict(np.load(prefix + ".npz"))))
    for name in QUERIES:
        want = port_probes[name][0]
        r0, r1 = (info[name] for info, _ in out["both"])
        assert r0["tier"] == r1["tier"] == "spmd", name
        for i, single in enumerate(want):
            a, b = r0["stages"][i], r1["stages"][i]
            if a["shard_first"] is None:     # the root: gathered whole
                assert a["shard_rows"] == b["shard_rows"] == \
                    single["shard_rows"]
            else:
                inner += 1
                assert (a["shard_first"], b["shard_first"]) == (0, 4)
                assert a["shard_rows"] + b["shard_rows"] == \
                    single["shard_rows"]
        m0, m1 = (info[name] for info, _ in out["rank0"])
        assert [s["shard_rows"] for s in m0["stages"]] == \
            [s["shard_rows"] for s in r0["stages"]]
        assert all(s["shard_rows"] is None for s in m1["stages"])
    assert inner >= 1
    for (_, ans), (_, other) in zip(out["both"], out["rank0"]):
        assert ans.keys() == other.keys()
        for k in ans:
            np.testing.assert_array_equal(ans[k], other[k])
