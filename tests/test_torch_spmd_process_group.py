"""The process group of a mesh across processes on the CPU (gloo): each
collective alone, and what a stage that raises does to every rank.

- Every function of ``parallel/exchange.py``, ``parallel/partial_agg.py``
  and ``parallel/distributed.py``, run by every rank of world 2 x 4 local
  shards and world 4 x 2 on its shards of seeded inputs
  (``tests/_torch_rank_worker.py:run_collectives``), equals the same
  function on the single-process 8-shard mesh bit for bit: every
  reduction adds in global shard order.
- A stage that raises on every rank at the same point falls back on
  every rank, as on one process.  A stage that raises on one rank (a
  stub in the walker) leaves the other waiting in a collective: with the
  group's timeout at 10 s, every rank's query ends with ``RankError``
  within it, naming the rank that raised; the broken group then refuses
  the next SPMD query at once, and a query the walker declines still
  answers on each rank's own tiers.

The module name holds "spmd": the conftest's ``DSQL_MESH=0`` pin does not
apply.
"""
import json

import numpy as np
import pytest
import torch

import _torch_rank_worker as W
from dask_sql_tpu_torch.parallel import group as G
from dask_sql_tpu_torch.parallel.mesh import Mesh

LAYOUTS = [(2, 4), (4, 2)]
GROUP_TIMEOUT_S = 10.0
ERROR_QUERIES = {
    "every_rank": "SELECT SUM(amount) AS s FROM mh_orders WHERE cust > 3",
    "one_rank": "SELECT SUM(amount) AS s FROM mh_orders WHERE cust > 4",
    "after": "SELECT SUM(amount) AS s FROM mh_orders WHERE cust > 5",
    "declined": "SELECT COUNT(DISTINCT cust) AS n FROM mh_orders",
}
BAD_RANK = 1


@pytest.fixture(scope="module")
def single_process():
    return W.run_collectives(Mesh(["cpu"] * W.N_GLOBAL))


@pytest.fixture(scope="module", params=LAYOUTS,
                ids=[f"world{w}x{loc}" for w, loc in LAYOUTS])
def rank_collectives(request, tmp_path_factory):
    world, local = request.param
    runs = W.spawn(tmp_path_factory.mktemp(f"c{world}"), "collectives",
                   world, local, timeout_s=60.0)
    for rc, log, _ in runs:
        assert rc == 0, log
    return [dict(np.load(prefix + ".npz")) for _, _, prefix in runs]


@pytest.mark.parametrize("name", W.COLLECTIVES)
def test_collective_equals_the_single_process_mesh(rank_collectives,
                                                   single_process, name):
    seen = set()
    for rank, got in enumerate(rank_collectives):
        keys = [k for k in got if k.rstrip("0123456789").rstrip("/") == name]
        assert keys, (rank, name)
        for k in keys:
            want = single_process[k]
            assert got[k].dtype == want.dtype and got[k].shape == want.shape
            assert got[k].tobytes() == want.tobytes(), (rank, k)
            seen.add(k)
    # the ranks' shards together cover every shard's output
    assert seen == {k for k in single_process
                    if k.rstrip("0123456789").rstrip("/") == name}


@pytest.fixture(scope="module")
def rank_errors(tmp_path_factory):
    out = tmp_path_factory.mktemp("errors")
    data = str(out / "tables.npz")
    W.save_frames(data, {f"mh_{k}": v
                         for k, v in W.multihost_frames().items()})
    runs = W.spawn(out, "errors", 2, 4, timeout_s=GROUP_TIMEOUT_S,
                   data=data, queries=ERROR_QUERIES, bad_rank=BAD_RANK)
    infos = []
    for rc, log, prefix in runs:
        assert rc == 0, log
        with open(prefix + ".json") as f:
            infos.append(json.load(f)["errors"])
    return infos


def test_an_error_on_every_rank_falls_back_on_every_rank(rank_errors):
    for rank, runs in enumerate(rank_errors):
        run = runs["every_rank"]
        assert run["ok"], (rank, run)
        assert run["counters"].get("spmd_errors") == 1, run
        assert run["counters"].get("spmd_fallbacks") == 1, run


def test_an_error_on_one_rank_ends_every_ranks_query(rank_errors):
    for rank, runs in enumerate(rank_errors):
        run = runs["one_rank"]
        assert not run["ok"] and run["type"] == "RankError", (rank, run)
        assert f"rank {BAD_RANK} raised ValueError: stub raised" \
            in run["error"], run
        # the other rank waits one group timeout in its collective, then
        # both read the outcome at the rendezvous
        assert run["seconds"] < 2 * GROUP_TIMEOUT_S, (rank, run)


def test_a_broken_group_refuses_at_once_and_declined_queries_answer(
        rank_errors):
    for rank, runs in enumerate(rank_errors):
        after = runs["after"]
        assert not after["ok"] and after["type"] == "RankError", after
        # refused before any collective: well inside one group timeout
        assert "broke earlier" in after["error"]
        assert after["seconds"] < GROUP_TIMEOUT_S / 2, after
        assert runs["declined"]["ok"] and runs["declined"]["rows"] == 1


def _rank_mesh(rank: int, world: int, local: int) -> Mesh:
    """A mesh of one rank of a world, without a process group behind it
    (nothing here runs a collective)."""
    group = G.ProcessGroup(rank, world, torch.device("cpu"), "gloo", 10.0,
                           store=None)
    return Mesh(["cpu"] * local, group=group)


def test_split_picks_this_ranks_shards():
    t = torch.arange(24)
    mesh = _rank_mesh(1, 3, 2)
    assert (mesh.size, mesh.local_size, mesh.spans_processes) == (6, 2, True)
    assert not mesh.virtual
    assert [p.tolist() for p in mesh.split(t)] == [[8, 9, 10, 11],
                                                   [12, 13, 14, 15]]
    assert [p.tolist() for p in mesh.split_local(t[:8])] == [[0, 1, 2, 3],
                                                             [4, 5, 6, 7]]
    assert mesh.signature() == "data:6@cpu,cpu/world3:rank1"
    with pytest.raises(ValueError, match="rank's shards"):
        Mesh(["meta"] * 2, group=mesh.group)


def test_a_broken_group_refuses_every_collective():
    mesh = _rank_mesh(0, 2, 2)
    mesh.group.broken = "a peer left"
    with pytest.raises(G.CollectiveError, match="a peer left"):
        G.all_gather(mesh.group, torch.zeros(3))
    assert mesh.group.collectives == 0


def test_server_and_ingest_log_refuse_a_mesh_across_processes(monkeypatch,
                                                              tmp_path):
    from dask_sql_tpu_torch import Context, run_server

    ctx = Context(mesh=_rank_mesh(0, 2, 2))
    with pytest.raises(NotImplementedError, match="across processes"):
        run_server(context=ctx, host="127.0.0.1", port=0, blocking=False)
    monkeypatch.setenv("DSQL_INGEST_DIR", str(tmp_path))
    with pytest.raises(NotImplementedError, match="ingest log"):
        Context(mesh=_rank_mesh(0, 2, 2))
