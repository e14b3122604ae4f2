"""The process group of a mesh across processes on the CPU (gloo): each
collective alone, and what a stage that raises does to every rank.

- Every function of ``parallel/exchange.py``, ``parallel/partial_agg.py``
  and ``parallel/distributed.py``, run by every rank of world 2 x 4 local
  shards and world 4 x 2 on its shards of seeded inputs
  (``tests/_torch_rank_worker.py:run_collectives``), equals the same
  function on the single-process 8-shard mesh bit for bit: every
  reduction adds in global shard order.
- A stage that raises on every rank at the same point falls back on
  every rank, as on one process.  Where the step that would capture a
  stage (on the card; on the CPU it captures nothing) fails on one rank
  only, after the warm-up's collectives ran, the ranks agree to drop the
  stage's graph: every rank answers from its warm-up and runs that
  stage eagerly after, with equal ``spmd_eager_stages`` and collective
  counts, answers bit for bit the single-process mesh's and no
  ``RankError``.  A stage that raises on one rank (a stub in the walker,
  inside the warm-up) leaves the other waiting in a collective: with the
  group's timeout at 10 s, every rank's query ends with ``RankError``
  within it, naming the rank that raised; the broken group then refuses
  the next SPMD query at once, and a query the walker declines still
  answers on each rank's own tiers from the columns an earlier fallback
  gathered, while one that needs a new gather refuses at once.  After the
  collectives every rank but 0 leaves, and rank 0's gather for a declined
  query ends in ``RankError`` within the group's timeout.
- A capture records the collectives it holds instead of counting them,
  and each replay counts them once.
- On rank 1 of a world 3 x 2 (no spawn: nothing gathers) a registered
  table holds that rank's rows of the global padded table, with the
  whole table's dictionaries and statistics; ``system.table_stats``
  reports the global row count.

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
#: the collectives' group timeout, which also bounds the gather after the
#: other ranks left
GATHER_TIMEOUT_S = 30.0
CAPTURE_QUERY = ("SELECT cust, COUNT(*) AS n, SUM(amount) AS s FROM "
                 "mh_orders WHERE cust > 2 GROUP BY cust ORDER BY cust")
ERROR_QUERIES = {
    "every_rank": "SELECT SUM(amount) AS s FROM mh_orders WHERE cust > 3",
    "capture_one_rank": CAPTURE_QUERY,
    "one_rank": "SELECT SUM(amount) AS s FROM mh_orders WHERE cust > 4",
    "after": "SELECT SUM(amount) AS s FROM mh_orders WHERE cust > 5",
    "declined": "SELECT COUNT(DISTINCT cust) AS n FROM mh_orders",
    "declined_gather": "SELECT COUNT(DISTINCT okey) AS n FROM mh_orders",
}
BAD_RANK = 1


@pytest.fixture(scope="module")
def single_process():
    return W.run_collectives(Mesh(["cpu"] * W.N_GLOBAL))


@pytest.fixture(scope="module", params=LAYOUTS,
                ids=[f"world{w}x{loc}" for w, loc in LAYOUTS])
def rank_collective_runs(request, tmp_path_factory):
    world, local = request.param
    runs = W.spawn(tmp_path_factory.mktemp(f"c{world}"), "collectives",
                   world, local, timeout_s=GATHER_TIMEOUT_S)
    for rc, log, _ in runs:
        assert rc == 0, log
    return runs


@pytest.fixture(scope="module")
def rank_collectives(rank_collective_runs):
    return [dict(np.load(prefix + ".npz"))
            for _, _, prefix in rank_collective_runs]


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


@pytest.mark.parametrize("name", ["capture_one_rank", "capture_again"])
def test_a_capture_failing_on_one_rank_runs_the_stage_eagerly_everywhere(
        rank_errors, name):
    from dask_sql_tpu_torch import Context

    ctx = Context(mesh=Mesh(["cpu"] * W.N_GLOBAL))
    for table, frame in W.multihost_frames().items():
        ctx.create_table(f"mh_{table}", frame)
    want = {c: a.tolist() for c, a in W.answer_arrays(
        ctx.sql(CAPTURE_QUERY, return_futures=False)).items()}
    first = rank_errors[0][name]
    for rank, runs in enumerate(rank_errors):
        run = runs[name]
        assert run["ok"], (rank, run)
        c = run["counters"]
        assert c.get("spmd_queries") == 1 and "spmd_rank_errors" not in c
        assert "spmd_fallbacks" not in c, (rank, run)
        # the stage whose capture failed on one rank, on every rank
        assert c.get("spmd_eager_stages") == 1, (rank, run)
        assert c == first["counters"], (rank, c, first["counters"])
        # its collectives ran once: as many as the first run's
        assert run["collectives"] == first["collectives"] \
            == runs["capture_one_rank"]["collectives"] > 0, (rank, run)
        assert run["answer"] == want, (rank, run)


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
        # the column it scans was gathered by every_rank's fallback: no
        # collective is needed
        declined = runs["declined"]
        assert declined["ok"] and declined["rows"] == 1, declined
        assert declined["collectives"] == 0, declined
        assert "mesh_gathers" not in declined["counters"], declined
        # a column never gathered: refused before any collective
        fresh = runs["declined_gather"]
        assert not fresh["ok"] and fresh["type"] == "RankError", fresh
        assert "broke earlier" in fresh["error"]
        assert fresh["seconds"] < GROUP_TIMEOUT_S / 2, fresh
        assert fresh["collectives"] == 0, fresh


def test_a_gather_whose_peers_left_raises_rank_error(rank_collective_runs):
    for rank, (_, _, prefix) in enumerate(rank_collective_runs):
        with open(prefix + ".json") as f:
            got = json.load(f)["gather_exit"]
        if rank:
            assert got == {"left": True}, got
            continue
        assert got["raised"] == "RankError", got
        assert "did not report" in got["error"] \
            or "collective failed" in got["error"], got
        assert got["seconds"] < GATHER_TIMEOUT_S + 10, got


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


def _padded_table(n: int = 22) -> dict:
    """``n`` rows, a string column among them: on a mesh of 6 shards
    they pad to 24, 8 per rank of a world of 3."""
    return {"k": np.arange(n) * 3, "s": np.array([f"v{i % 5}"
                                                 for i in range(n)]),
            "x": np.arange(n) * 0.5}


def test_a_rank_holds_its_rows_of_the_padded_table():
    from dask_sql_tpu_torch import Context

    ctx = Context(mesh=_rank_mesh(1, 3, 2))
    ctx.create_table("t", _padded_table())
    entry = ctx.schema["root"].tables["t"]
    rr = entry.rank_rows
    assert (rr.padded, rr.rows, rr.first) == (24, 22, 8)
    assert entry.table.num_rows == 8
    assert entry.table.column("k").data.tolist() == [3 * i for i in
                                                     range(8, 16)]
    assert entry.row_valid.tolist() == [True] * 8
    # a view of the whole column would keep its storage alive
    k = entry.table.column("k").data
    assert k.untyped_storage().nbytes() == k.numel() * k.element_size()
    # the statistics are the whole padded table's, as one process's mesh
    whole = Context(mesh=Mesh(["cpu"] * 6))
    whole.create_table("t", _padded_table())
    assert W.stats_summary(entry.stats) == W.stats_summary(
        whole.schema["root"].tables["t"].stats)
    last = Context(mesh=_rank_mesh(2, 3, 2))
    last.create_table("t", _padded_table())
    assert last.schema["root"].tables["t"].row_valid.tolist() == \
        [True] * 6 + [False] * 2


def test_a_ranks_columns_keep_the_whole_dictionary():
    from dask_sql_tpu_torch import Context

    ctx = Context(mesh=_rank_mesh(1, 3, 2))
    ctx.create_table("t", _padded_table())
    whole = Context(mesh=Mesh(["cpu"] * 6))
    whole.create_table("t", _padded_table())
    col = ctx.schema["root"].tables["t"].table.column("s")
    want = whole.schema["root"].tables["t"].table.column("s")
    # rank 1's rows hold four of the five strings; the codes stay global
    assert list(col.dictionary) == list(want.dictionary) == [
        f"v{i}" for i in range(5)]
    assert col.data.tolist() == want.data[8:16].tolist()


def test_system_table_stats_report_the_global_row_count(monkeypatch):
    from dask_sql_tpu_torch import Context

    # no group behind the mesh: the tiers answer (nothing to gather)
    monkeypatch.setenv("DSQL_MESH", "0")
    ctx = Context(mesh=_rank_mesh(1, 3, 2))
    ctx.create_table("t", _padded_table())
    got = ctx.sql("SELECT \"column\", \"rows\" FROM system.table_stats "
                  "WHERE \"table\" = 't'", return_futures=False)
    assert sorted(got["column"]) == ["k", "s", "x"]
    assert set(got["rows"]) == {22}


def test_stage_programs_are_graphs_on_one_device_or_across_processes():
    assert Mesh(["cpu"] * 4).graph_stages
    assert _rank_mesh(1, 2, 4).graph_stages
    # a single-process mesh of distinct devices runs its stages eagerly
    assert not Mesh(["cpu", "meta"]).graph_stages


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


def test_a_capture_records_its_collectives_and_a_replay_counts_them():
    from dask_sql_tpu_torch.runtime import telemetry as tel

    group = _rank_mesh(0, 2, 2).group
    c0 = tel.REGISTRY.counters()
    with G.recording_collectives() as tally:
        assert G._collective(group, 24, lambda: "sent") == "sent"
        assert G._collective(group, 8, lambda: "sent") == "sent"
        with pytest.raises(RuntimeError, match="not in a capture"):
            G._collective(group, 8, _fails)
    # a call that fails while recording fails the capture, not the group
    assert group.broken is None and group.collectives == 0
    assert [v[1:] for v in tally.values()] == [[3, 40]]
    for replay in (1, 2):
        G.count_replay(list(tally.values()))
        assert group.collectives == 3 * replay
    now = tel.REGISTRY.counters()
    assert now.get("mesh_process_collectives", 0) - c0.get(
        "mesh_process_collectives", 0) == 6
    assert now.get("mesh_process_bytes", 0) - c0.get(
        "mesh_process_bytes", 0) == 80
    group.broken = "a peer left"
    with pytest.raises(G.CollectiveError, match="a peer left"):
        G.count_replay(list(tally.values()))
    assert group.collectives == 6


def _fails():
    raise RuntimeError("the call is not in a capture")


def test_the_replay_wait_returns_at_once_on_the_cpu():
    group = _rank_mesh(0, 2, 2).group
    G.wait_device(group)
    assert group.broken is None
