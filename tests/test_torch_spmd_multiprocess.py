"""A mesh across processes on the CPU: ``init_multihost`` over gloo, one
rank per spawned process, the SPMD walker's collectives through the
process group.

Two layouts of the JAX package's 8-device mesh: world 2 x 4 local
shards and world 4 x 2.  The ranks (``tests/_torch_rank_worker.py``)
register the same tables, TPC-H at SF 0.01 (``generate_tpch(0.01,
seed=11)``) and the JAX two-process test's orders/cust
(``tests/integration/test_multihost.py``), and run the same queries.
Every rank's answer to the JAX test's join-and-group-by and to TPC-H
Q1, Q3, Q6, Q8, Q12 and Q14 equals:

- the JAX package's on its in-process 8-device CPU mesh (ints and
  strings exact, doubles rtol 1e-9);
- the port's single-process 8-shard mesh, bit for bit (every reduction
  adds in global shard order);
- every other rank's, bit for bit.

Every ``spmd_*`` counter of Q1, Q3 and Q8 equals the JAX package's on
every rank: each stage, collectives of the process group included, is a
built graph program (``spmd_compiles``), and none runs eagerly (no
``spmd_eager_stages``).  Q5 and Q18 decline the walker and answer through
each rank's single-device tiers.  Rows appended on every rank, and a
chunked table streamed on every rank, answer as on the single-process
mesh after the same steps.  With the program store armed, Q1, Q3, Q8 and
Q12 run again after every stage program was dropped, then once more
after that: the last pass makes every stage program from this rank's
record (``spmd_store_hits`` as many as the first pass's builds, no
``spmd_compiles``) and answers bit for bit as the first.

The module name holds "spmd": the conftest's ``DSQL_MESH=0`` pin does not
apply.
"""
import json

import numpy as np
import pandas as pd
import pytest
import torch

import _torch_rank_worker as W
from benchmarks.tpch import QUERIES, generate_tpch
from dask_sql_tpu import Context as JaxContext
from dask_sql_tpu.parallel.mesh import default_mesh
from dask_sql_tpu.runtime import telemetry as jtel
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.parallel.mesh import Mesh
from dask_sql_tpu_torch.runtime import telemetry as tel

LAYOUTS = [(2, 4), (4, 2)]
MULTIHOST = ("SELECT seg, COUNT(*) AS n, SUM(amount) AS s "
             "FROM mh_orders JOIN mh_cust ON cust = ckey "
             "GROUP BY seg ORDER BY seg")
SERVED = {"mh": MULTIHOST, **{f"q{q}": QUERIES[q]
                              for q in (1, 3, 6, 8, 12, 14)}}
DECLINED = {f"q{q}": QUERIES[q] for q in (5, 18)}
COUNTED = ("q1", "q3", "q8")
STORED = ("q1", "q3", "q8", "q12")
RUN_LIMIT_S = 120.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The tables, saved once for the ranks and read back here, so that
    every side registers the same frames."""
    frames = dict(generate_tpch(0.01, seed=11))
    frames.update({f"mh_{k}": v for k, v in W.multihost_frames().items()})
    path = str(tmp_path_factory.mktemp("mp") / "tables.npz")
    W.save_frames(path, frames)
    return path, W.frames_from_npz(path)


@pytest.fixture(scope="module", params=LAYOUTS,
                ids=[f"world{w}x{loc}" for w, loc in LAYOUTS])
def ranks(request, data, tmp_path_factory):
    """Every rank's answers and counters, one spawn per layout."""
    world, local = request.param
    out_dir = tmp_path_factory.mktemp(f"w{world}")
    runs = W.spawn(out_dir, "queries", world, local, timeout_s=60.0,
                   limit_s=RUN_LIMIT_S, data=data[0],
                   queries={**SERVED, **DECLINED}, stored=list(STORED),
                   store=str(out_dir / "store"))
    out = []
    for rc, log, prefix in runs:
        assert rc == 0, log
        answers = dict(np.load(prefix + ".npz"))
        with open(prefix + ".json") as f:
            out.append((json.load(f), answers))
    return world, local, out


@pytest.fixture(scope="module")
def port_contexts(data):
    """The port's single-device context and its single-process 8-shard
    mesh over the same frames."""
    plain = Context(device="cpu")
    mesh = Context(mesh=Mesh(["cpu"] * 8))
    for name, frame in data[1].items():
        plain.create_table(name, frame)
        mesh.create_table(name, frame)
    return plain, mesh


@pytest.fixture(scope="module")
def jax_mesh(data):
    mesh = default_mesh()
    if mesh.devices.size != 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    ctx = JaxContext(mesh=mesh)
    for name, frame in data[1].items():
        ctx.create_table(name, frame)
    return ctx, {}


def _jax(jax_mesh, name: str, sql: str):
    """The JAX package's answer and ``spmd_*`` counters, once per query."""
    ctx, memo = jax_mesh
    if name not in memo:
        c0 = jtel.REGISTRY.counters()
        df = ctx.sql(sql, return_futures=False)
        memo[name] = (df, _spmd(jtel.REGISTRY.counters(), c0))
    return memo[name]


def _spmd(now: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in now.items()
            if k.startswith("spmd_") and v != before.get(k, 0)}


def _rank_frame(answers: dict, name: str) -> pd.DataFrame:
    cols = {k.split("/", 1)[1]: v for k, v in answers.items()
            if k.split("/", 1)[0] == name}
    return pd.DataFrame(cols)


def _assert_same(got: pd.DataFrame, want: pd.DataFrame, ordered: bool):
    got = got.reset_index(drop=True)
    want = want.reset_index(drop=True)
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    if not ordered:
        cols = list(want.columns)
        got = got.sort_values(cols, ignore_index=True)
        want = want.sort_values(cols, ignore_index=True)
    for col in want.columns:
        g, w = got[col], want[col]
        if pd.api.types.is_float_dtype(w):
            np.testing.assert_allclose(g.to_numpy(dtype=float),
                                       w.to_numpy(dtype=float), rtol=1e-9,
                                       err_msg=col)
        else:
            assert [str(x) for x in g] == [str(x) for x in w], col


def _assert_bits(answers: dict, want: dict, name: str, who: str) -> None:
    keys = sorted(k for k in want if k.startswith(name + "/"))
    assert sorted(k for k in answers if k.startswith(name + "/")) == keys
    for k in keys:
        assert answers[k].dtype == want[k].dtype, (who, k)
        if answers[k].dtype.kind in "fiub":
            assert answers[k].tobytes() == want[k].tobytes(), (who, k)
        else:
            assert answers[k].tolist() == want[k].tolist(), (who, k)


def test_init_multihost_spans_the_processes(ranks):
    world, local, out = ranks
    for rank, (info, _) in enumerate(out):
        assert info["size"] == world * local == 8
        assert (info["local_size"], info["rank"], info["world_size"]) == (
            local, rank, world)
        assert info["signature"].endswith(f"/world{world}:rank{rank}")
        assert info["reused_size"] == 8


@pytest.mark.parametrize("name", sorted(SERVED))
def test_served_answers_equal_jax_and_the_single_process_mesh(
        ranks, port_contexts, jax_mesh, name):
    _, _, out = ranks
    sql = SERVED[name]
    want_jax, _ = _jax(jax_mesh, name, sql)
    single = W.answer_arrays(port_contexts[1].sql(sql, return_futures=False))
    single = {f"{name}/{k}": v for k, v in single.items()}
    first = out[0][1]
    for rank, (info, answers) in enumerate(out):
        run = info["queries"][name]
        assert run["tier"] == "spmd", (rank, run)
        assert run["counters"]["mesh_process_collectives"] > 0, run
        assert run["counters"]["mesh_process_bytes"] > 0, run
        _assert_bits(answers, single, name, f"rank {rank} vs one process")
        _assert_bits(answers, first, name, f"rank {rank} vs rank 0")
        _assert_same(_rank_frame(answers, name), want_jax,
                     "ORDER BY" in sql)


@pytest.mark.parametrize("name", COUNTED)
def test_spmd_counters_equal_jax(ranks, jax_mesh, name):
    _, _, out = ranks
    _, want = _jax(jax_mesh, name, SERVED[name])
    for rank, (info, _) in enumerate(out):
        got = {k: v for k, v in info["queries"][name]["counters"].items()
               if k.startswith("spmd_")}
        # every stage a built graph program, none eager
        assert got == want, (rank, got, want)


@pytest.mark.parametrize("name", sorted(DECLINED))
def test_declined_queries_answer_on_each_ranks_tiers(ranks, port_contexts,
                                                     name):
    _, _, out = ranks
    want = W.answer_arrays(port_contexts[0].sql(DECLINED[name],
                                                return_futures=False))
    want = {f"{name}/{k}": v for k, v in want.items()}
    for rank, (info, answers) in enumerate(out):
        run = info["queries"][name]
        assert run["counters"] == {"spmd_unsupported": 1}, (rank, run)
        assert run["tier"] != "spmd", run
        _assert_bits(answers, want, name, f"rank {rank} vs one device")


def test_single_process_mesh_counts_no_process_traffic(port_contexts):
    c0 = tel.REGISTRY.counters()
    port_contexts[1].sql(SERVED["q6"], return_futures=False)
    now = tel.REGISTRY.counters()
    assert now.get("spmd_queries", 0) - c0.get("spmd_queries", 0) == 1
    assert now.get("mesh_process_collectives", 0) == c0.get(
        "mesh_process_collectives", 0)


@pytest.mark.parametrize("name", sorted(W.WRITE_QUERIES))
def test_appends_and_streaming_equal_the_single_process_mesh(ranks, data,
                                                             name):
    _, _, out = ranks
    ctx = Context(mesh=Mesh(["cpu"] * 8))
    frames = {k: v for k, v in data[1].items() if k.startswith("mh_")}
    for table, frame in frames.items():
        ctx.create_table(table, frame)
    W.apply_writes(ctx, frames)
    want = W.answer_arrays(ctx.sql(W.WRITE_QUERIES[name],
                                   return_futures=False))
    want = {f"{name}/{k}": v for k, v in want.items()}
    for rank, (info, answers) in enumerate(out):
        run = info["writes"][name]
        if name == "streamed":
            assert run["counters"].get("stream_batches", 0) >= 4, run
        else:
            assert run["tier"] == "spmd", run
        _assert_bits(answers, want, name, f"rank {rank}")


@pytest.mark.parametrize("name", STORED)
def test_a_second_store_pass_makes_every_stage_from_its_record(
        ranks, jax_mesh, name):
    _, _, out = ranks
    want_jax, _ = _jax(jax_mesh, name, SERVED[name])
    first_rank = out[0][1]
    for rank, (info, answers) in enumerate(out):
        built = info["store"]["pass1"][name]
        hit = info["store"]["pass2"][name]
        assert built["tier"] == hit["tier"] == "spmd", (rank, built, hit)
        b, h = built["counters"], hit["counters"]
        # one stage program per stage, and one more per flipped variant:
        # as many as the first run of the query built
        programs = info["queries"][name]["counters"]["spmd_compiles"]
        assert programs >= b["spmd_stages"], b
        assert b["spmd_compiles"] == programs and "spmd_store_hits" not in b
        assert b.get("program_store_stores", 0) >= 1, b
        assert h.get("spmd_store_hits") == programs, (rank, h)
        assert "spmd_compiles" not in h and "spmd_eager_stages" not in h
        assert "program_store_errors" not in h, h
        assert h["mesh_process_collectives"] == \
            b["mesh_process_collectives"], (rank, b, h)
        stored = {k.split("_", 1)[1]: v for k, v in answers.items()
                  if k.startswith(f"store1_{name}/")}
        again = {k.split("_", 1)[1]: v for k, v in answers.items()
                 if k.startswith(f"store2_{name}/")}
        _assert_bits(again, stored, name, f"rank {rank} store passes")
        _assert_bits(stored, {k: v for k, v in first_rank.items()
                              if k.startswith(name + "/")}, name,
                     f"rank {rank} store pass vs rank 0's first run")
        _assert_same(_rank_frame(again, name), want_jax,
                     "ORDER BY" in SERVED[name])
