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
``spmd_eager_stages``).  A CAST to VARCHAR and a string CASE over
``supplier`` read device values on the host inside their stage: every
rank falls back (``spmd_fallbacks`` 1, as the JAX mesh counts) and
answers as the JAX mesh and every other rank.

Each rank's catalog entry holds only its ``padded / world`` rows of a
table, with the whole table's dictionaries and statistics (equal to the
single-process mesh's); ``gather_rows`` of every rank gives that mesh's
padded columns bit for bit.  Q5 and Q18 decline the walker and answer
through each rank's single-device tiers over the columns they scan,
gathered from every rank (``mesh_gathers``), bit for bit as one device;
a second run gathers nothing; with ``DSQL_MESH=0`` Q1 answers on the
tiers over gathers, bit for bit as one device; ANALYZE TABLE of a padded
table reads its columns gathered, as the single-process mesh's.  On world 2 x 4 every
TPC-H query, served or declined, equals the JAX package's 8-device
mesh.  Rows appended on every rank (the appended table's new padded rows
split by rank), a materialized view joining two tables kept fresh across
an append by the full recompute (a mesh refuses the delta join, as in
the JAX package; the refresh reads its bases gathered whole), and a
chunked table streamed on every rank answer as on the single-process
mesh after the same steps.  With the program store armed, Q1, Q3, Q8 and
Q12 run again after every stage program was dropped, then once more
after that: the last pass makes every stage program from this rank's
record (``spmd_store_hits`` as many as the first pass's builds, no
``spmd_compiles``) and answers bit for bit as the first.

Streaming: lineitem registered again as a chunked table of 8,192-row
batches (8, the last short) and TPC-H Q1, Q3, Q6 and Q14 streamed over
it, with a GROUP BY on a float key that the walker declines and one on
a CAST to VARCHAR, whose batch plans fall back on the host read.  Each
rank's batch entry holds only its ``padded / world`` rows
(``rank_rows``); a batch plan the walker serves gathers nothing, a
declined one gathers the batch in one step; no gathered ``__stream__``
column outlives its query, a failed one (a fault at an upload)
included; a repeated Q1 builds no stage program.  The answers equal the
single-process 8-shard mesh's streamed ones (ints and strings exact,
doubles rtol 1e-9: a served batch sums on the walker, in global shard
order, where that mesh sums a whole batch on the compiled tier), every
other rank's bit for bit and, on world 2 x 4, the JAX package's
8-device mesh over the same chunked table.

The module name holds "spmd": the conftest's ``DSQL_MESH=0`` pin does not
apply.
"""
import json
import re
import threading

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
#: stages that read device values on the host: the walker falls back on
#: every rank, as the JAX stage whose trace fails does
HOST_READ = {
    "hr_cast": ("SELECT s_suppkey, CAST(s_acctbal AS VARCHAR) AS a "
                "FROM supplier ORDER BY s_suppkey"),
    "hr_case": ("SELECT s_suppkey, CASE WHEN s_nationkey > 10 THEN s_name "
                "ELSE 'zz' END AS n FROM supplier ORDER BY s_suppkey"),
}
#: the rest of TPC-H, run on world 2 x 4 only
REST = {f"q{q}": QUERIES[q] for q in sorted(QUERIES)
        if f"q{q}" not in SERVED and f"q{q}" not in DECLINED}
ALL_LAYOUT = (2, 4)
#: run again with ``DSQL_MESH=0``: the walker off, the tiers over gathers
UNMESHED = ("q1",)
COUNTED = ("q1", "q3", "q8")
STORED = ("q1", "q3", "q8", "q12")
#: streamed over the chunked lineitem (``W.STREAM_TABLE``): TPC-H shapes the
#: walker serves per batch, and a float GROUP BY key, which it declines
STREAMED = {**{f"s_q{q}": re.sub(r"\blineitem\b", W.STREAM_TABLE,
                                 QUERIES[q]) for q in (1, 3, 6, 14)},
            "s_fkey": (f"SELECT l_discount, COUNT(*) AS n, SUM(l_quantity) "
                       f"AS q FROM {W.STREAM_TABLE} GROUP BY l_discount "
                       f"ORDER BY l_discount"),
            # a CAST to VARCHAR under the GROUP BY: a host read per batch
            "s_cast": (f"SELECT CAST(l_linenumber AS VARCHAR) AS ln, "
                       f"COUNT(*) AS n, SUM(l_quantity) AS q "
                       f"FROM {W.STREAM_TABLE} "
                       f"GROUP BY CAST(l_linenumber AS VARCHAR) ORDER BY ln")}
STREAM_SERVED = ("s_q1", "s_q6")
STREAM_DECLINED = ("s_fkey", "s_cast")
#: run twice: the second run builds no stage program (Q3's batch plan
#: joins a ``__stream__`` temp, named alike by every run of the query)
STREAM_AGAIN = ("s_q1", "s_q3")
RUN_LIMIT_S = 150.0
JAX_LIMIT_S = 600.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True, scope="module")
def _pins_held_for_the_module():
    """The conftest's per-test pins of this module, held across its tests:
    the JAX package's answers (``jax_mesh``) are computed on a thread that
    runs on while tests start and end."""
    mp = pytest.MonkeyPatch()
    for k, v in W.RANK_ENV.items():
        mp.setenv(k, v)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The tables, saved once for the ranks and read back here, so that
    every side registers the same frames."""
    frames = dict(generate_tpch(0.01, seed=11))
    frames.update({f"mh_{k}": v for k, v in W.multihost_frames().items()})
    path = str(tmp_path_factory.mktemp("mp") / "tables.npz")
    W.save_frames(path, frames)
    return path, W.frames_from_npz(path)


@pytest.fixture(scope="module")
def spawns():
    """The spawns made so far, by layout."""
    return {}


def _spawn(spawns: dict, layout, data, tmp_path_factory):
    """Every rank's answers and counters, one spawn per layout."""
    if layout not in spawns:
        world, local = layout
        out_dir = tmp_path_factory.mktemp(f"w{world}")
        queries = {**SERVED, **DECLINED, **HOST_READ,
                   **(REST if layout == ALL_LAYOUT else {})}
        runs = W.spawn(out_dir, "queries", world, local, timeout_s=60.0,
                       limit_s=RUN_LIMIT_S, data=data[0], queries=queries,
                       again=list(DECLINED), unmeshed=list(UNMESHED),
                       stored=list(STORED),
                       store=str(out_dir / "store"), streamed=STREAMED,
                       stream_again=list(STREAM_AGAIN),
                       stream_fault=STREAM_DECLINED[0])
        out = []
        for rc, log, prefix in runs:
            assert rc == 0, log
            answers = dict(np.load(prefix + ".npz"))
            with open(prefix + ".json") as f:
                out.append((json.load(f), answers))
        spawns[layout] = (world, local, out)
    return spawns[layout]


@pytest.fixture(scope="module", params=LAYOUTS,
                ids=[f"world{w}x{loc}" for w, loc in LAYOUTS])
def ranks(request, spawns, data, jax_mesh, tmp_path_factory):
    return _spawn(spawns, request.param, data, tmp_path_factory)


@pytest.fixture(scope="module")
def ranks_all(spawns, data, jax_mesh, tmp_path_factory):
    """World 2 x 4, which also ran the rest of TPC-H."""
    return _spawn(spawns, ALL_LAYOUT, data, tmp_path_factory)


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
    """The JAX package's 8-device mesh over the frames, and its answers
    and ``spmd_*`` counters to every query of the module, computed on a
    thread of their own while the ranks run (``_jax`` waits for it)."""
    mesh = default_mesh()
    if mesh.devices.size != 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    memo: dict = {}

    def answer_all():
        ctx = JaxContext(mesh=mesh)
        for name, frame in data[1].items():
            ctx.create_table(name, frame)
        ctx.create_table(W.STREAM_TABLE, data[1]["lineitem"], chunked=True,
                         batch_rows=W.STREAM_BATCH_ROWS)
        for name, sql in {**SERVED, **DECLINED, **HOST_READ, **REST,
                          **STREAMED}.items():
            c0 = jtel.REGISTRY.counters()
            try:
                df = ctx.sql(sql, return_futures=False)
            except Exception as e:  # read by the test that needs it
                memo[name] = (e, {})
                continue
            memo[name] = (df, _spmd(jtel.REGISTRY.counters(), c0))

    worker = threading.Thread(target=answer_all, name="jax-mesh",
                              daemon=True)
    worker.start()
    return worker, memo


def _jax(jax_mesh, name: str):
    """The JAX package's answer and ``spmd_*`` counters to one query."""
    worker, memo = jax_mesh
    worker.join(timeout=JAX_LIMIT_S)
    assert not worker.is_alive(), f"the JAX answers ran past {JAX_LIMIT_S} s"
    df, counters = memo[name]
    if isinstance(df, Exception):
        raise df
    return df, counters


def _spmd(now: dict, before: dict, kind: str = "spmd_") -> dict:
    return {k: v - before.get(k, 0) for k, v in now.items()
            if k.startswith(kind) and v != before.get(k, 0)}


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
    want_jax, _ = _jax(jax_mesh, name)
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
    _, want = _jax(jax_mesh, name)
    for rank, (info, _) in enumerate(out):
        got = {k: v for k, v in info["queries"][name]["counters"].items()
               if k.startswith("spmd_")}
        # every stage a built graph program, none eager
        assert got == want, (rank, got, want)


@pytest.mark.parametrize("name", sorted(HOST_READ))
def test_host_read_stages_fall_back_alike_on_every_rank(ranks, jax_mesh,
                                                        name):
    _, _, out = ranks
    want_jax, want = _jax(jax_mesh, name)
    assert want == {"spmd_fallbacks": 1}, want
    first = out[0][1]
    for rank, (info, answers) in enumerate(out):
        got = {k: v for k, v in info["queries"][name]["counters"].items()
               if k.startswith("spmd_")}
        assert got == want, (rank, got)
        _assert_bits(answers, first, name, f"rank {rank} vs rank 0")
        _assert_same(_rank_frame(answers, name), want_jax, True)


@pytest.mark.parametrize("name", sorted(DECLINED))
def test_declined_queries_answer_on_each_ranks_tiers(ranks, port_contexts,
                                                     name):
    _, _, out = ranks
    want = W.answer_arrays(port_contexts[0].sql(DECLINED[name],
                                                return_futures=False))
    want = {f"{name}/{k}": v for k, v in want.items()}
    for rank, (info, answers) in enumerate(out):
        run = info["queries"][name]
        c = run["counters"]
        # the columns it scans gathered from every rank: one all_gather
        # each through the process group, and nothing else
        assert c.pop("spmd_unsupported") == 1, (rank, run)
        assert c["mesh_gathers"] > 0 and c["mesh_gather_bytes"] > 0, run
        assert c.pop("mesh_gathers") == c.pop("mesh_process_collectives")
        assert set(c) == {"mesh_gather_bytes", "mesh_process_bytes"}, run
        assert run["tier"] != "spmd", run
        # the second run reads the cached columns
        again = info["again"][name]
        assert again["counters"] == {"spmd_unsupported": 1}, (rank, again)
        _assert_bits(answers, want, name, f"rank {rank} vs one device")


@pytest.mark.parametrize("name", UNMESHED)
def test_the_mesh_kill_switch_answers_over_gathers(ranks, port_contexts,
                                                   name):
    _, _, out = ranks
    want = W.answer_arrays(port_contexts[0].sql(SERVED[name],
                                                return_futures=False))
    want = {f"unmeshed_{name}/{k}": v for k, v in want.items()}
    for rank, (info, answers) in enumerate(out):
        run = info["unmeshed"][name]
        c = run["counters"]
        assert not any(k.startswith("spmd_") for k in c), (rank, run)
        assert c["mesh_gathers"] == c["mesh_process_collectives"] > 0, run
        _assert_bits(answers, want, f"unmeshed_{name}",
                     f"rank {rank} vs one device")


def test_analyze_reads_the_gathered_columns(ranks, port_contexts):
    _, _, out = ranks
    name, sql = next(iter(W.ANALYZED.items()))
    want = W.answer_arrays(port_contexts[1].sql(sql, return_futures=False))
    want = {f"{name}/{k}": v for k, v in want.items()}
    for rank, (info, answers) in enumerate(out):
        c = info["analyzed"][name]["counters"]
        # two columns, then the row_valid of the padded table
        assert c["mesh_gathers"] == c["mesh_process_collectives"] == 3, c
        _assert_bits(answers, want, name, f"rank {rank} vs one process")


def _entry_arrays(entry, prefix: str) -> dict:
    """A whole entry's arrays as ``placement`` names them."""
    out = {}
    for name, col in zip(entry.table.names, entry.table.columns):
        out[f"{prefix}/{name}"] = col.data.numpy()
        if col.mask is not None:
            out[f"{prefix}/{name}.mask"] = col.mask.numpy()
        if col.dictionary is not None:
            out[f"{prefix}/{name}.dict"] = np.asarray(
                col.dictionary).astype(str)
    if entry.row_valid is not None:
        out[f"{prefix}/.row_valid"] = entry.row_valid.numpy()
    return out


def _assert_placed(info: dict, answers: dict, ctx, tables, world: int,
                   rank: int, key: str) -> None:
    """Each of ``tables`` holds this rank's ``padded / world`` rows with
    the single-process mesh ``ctx``'s statistics, and its gather is that
    mesh's padded table bit for bit."""
    for table in tables:
        whole = ctx.schema["root"].tables[table]
        padded = whole.table.num_rows
        got = info[table]
        assert got["rows"] == padded // world, (rank, table, got)
        assert got["rank_rows"] == [padded, whole.stats.rows,
                                    rank * padded // world], (rank, got)
        assert got["stats"] == json.loads(json.dumps(
            W.stats_summary(whole.stats))), (rank, table)
        prefix = f"{key}placed/{table}"
        want = _entry_arrays(whole, prefix)
        assert sorted(k for k in answers if k.startswith(prefix + "/")) \
            == sorted(want), (rank, table)
        for k, w in want.items():
            assert answers[k].dtype == w.dtype, (rank, k)
            assert answers[k].tobytes() == w.tobytes(), (rank, k)


def test_each_rank_holds_its_rows_and_gathers_the_whole_table(
        ranks, port_contexts, data):
    world, _, out = ranks
    for rank, (info, answers) in enumerate(out):
        _assert_placed(info["placement"], answers, port_contexts[1],
                       data[1], world, rank, "")


@pytest.mark.parametrize("name", sorted(SERVED) + sorted(DECLINED)
                         + sorted(REST, key=lambda q: int(q[1:])))
def test_every_tpch_query_equals_jax_on_world_2x4(ranks_all, jax_mesh,
                                                  name):
    _, _, out = ranks_all
    sql = {**SERVED, **DECLINED, **REST}[name]
    want_jax, _ = _jax(jax_mesh, name)
    first = out[0][1]
    for rank, (info, answers) in enumerate(out):
        _assert_same(_rank_frame(answers, name), want_jax,
                     "ORDER BY" in sql)
        _assert_bits(answers, first, name, f"rank {rank} vs rank 0")


def test_single_process_mesh_counts_no_process_traffic(port_contexts):
    c0 = tel.REGISTRY.counters()
    port_contexts[1].sql(SERVED["q6"], return_futures=False)
    now = tel.REGISTRY.counters()
    assert now.get("spmd_queries", 0) - c0.get("spmd_queries", 0) == 1
    assert now.get("mesh_process_collectives", 0) == c0.get(
        "mesh_process_collectives", 0)


@pytest.fixture(scope="module")
def written(data):
    """The single-process mesh after ``apply_writes``, and its answer to
    each write query with the view refreshes that query made."""
    ctx = Context(mesh=Mesh(["cpu"] * 8))
    frames = {k: v for k, v in data[1].items() if k.startswith("mh_")}
    for table, frame in frames.items():
        ctx.create_table(table, frame)
    W.apply_writes(ctx, frames)
    answers = {}
    for name, sql in W.WRITE_QUERIES.items():
        c0 = tel.REGISTRY.counters()
        got = W.answer_arrays(ctx.sql(sql, return_futures=False))
        answers[name] = ({f"{name}/{k}": v for k, v in got.items()},
                         _spmd(tel.REGISTRY.counters(), c0, "mv_refresh_"))
    return ctx, answers


@pytest.mark.parametrize("name", sorted(W.WRITE_QUERIES))
def test_appends_and_streaming_equal_the_single_process_mesh(ranks, written,
                                                             name):
    _, _, out = ranks
    want, refreshed = written[1][name]
    for rank, (info, answers) in enumerate(out):
        run = info["writes"][name]
        if name == "streamed":
            assert run["counters"].get("stream_batches", 0) >= 4, run
        elif name == "joined_view":
            # recomputed after the append, its bases gathered whole
            assert refreshed == {"mv_refresh_full": 1}, refreshed
            c = run["counters"]
            assert c.get("mv_refresh_full") == 1, (rank, run)
            assert "mv_refresh_incremental" not in c, (rank, run)
            assert c.get("mesh_gathers", 0) > 0, (rank, run)
        else:
            assert run["tier"] == "spmd", run
        _assert_bits(answers, want, name, f"rank {rank}")


def test_appended_tables_hold_their_new_rows_by_rank(ranks, written):
    world, _, out = ranks
    for rank, (info, answers) in enumerate(out):
        _assert_placed(info["appended"], answers, written[0],
                       ["mh_orders"], world, rank, "appended_")


@pytest.mark.parametrize("name", STORED)
def test_a_second_store_pass_makes_every_stage_from_its_record(
        ranks, jax_mesh, name):
    _, _, out = ranks
    want_jax, _ = _jax(jax_mesh, name)
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


@pytest.fixture(scope="module")
def streamed_mesh(data):
    """The single-process 8-shard mesh's answers to the streamed queries
    over the same chunked lineitem."""
    ctx = Context(mesh=Mesh(["cpu"] * 8))
    ctx.create_table("lineitem", data[1]["lineitem"])
    W.register_stream(ctx, data[1])
    for name in ("part", "customer", "orders"):
        ctx.create_table(name, data[1][name])
    return {name: W.answer_arrays(ctx.sql(sql, return_futures=False))
            for name, sql in STREAMED.items()}


@pytest.mark.parametrize("name", sorted(STREAMED))
def test_each_rank_streams_only_its_rows_of_every_batch(ranks, data, name):
    world, _, out = ranks
    n = len(data[1]["lineitem"])
    batches = -(-n // W.STREAM_BATCH_ROWS)
    assert batches == 8
    for rank, (info, _) in enumerate(out):
        run = info["streams"][name]
        assert run["counters"]["stream_batches"] == batches, (rank, run)
        padded = W.STREAM_BATCH_ROWS          # a multiple of the 8 shards
        count = padded // world
        want = [[count, [padded, min(W.STREAM_BATCH_ROWS,
                                     n - b * W.STREAM_BATCH_ROWS),
                         rank * count],
                 None if b < batches - 1 else count]
                for b in range(batches)]
        assert run["entries"] == want, (rank, run["entries"])
        local = [p for p in run["plans"] if p["local"]]
        assert len(local) == batches, (rank, run["plans"])
        for p in local:
            if p["served"]:
                # the walker read this rank's rows: nothing gathered
                assert p["gathers"] == 0 and p["steps"] == 0, (rank, p)
            else:
                # the batch gathered whole once, the resident tables
                # found cached
                assert p["steps"] == 1 and p["gathers"] > 0, (rank, p)
        served = [bool(p["served"]) for p in local]
        if name in STREAM_SERVED:
            assert all(served), (rank, run["plans"])
        if name in STREAM_DECLINED:
            assert not any(served), (rank, run["plans"])
        # alike on every rank
        assert run["plans"] == out[0][0]["streams"][name]["plans"]
        assert run["stale"] == [], (rank, run["stale"])


@pytest.mark.parametrize("name", sorted(STREAMED))
def test_streamed_answers_equal_the_single_process_mesh(ranks,
                                                        streamed_mesh,
                                                        name):
    _, _, out = ranks
    want = pd.DataFrame(streamed_mesh[name])
    first = out[0][1]
    for rank, (_, answers) in enumerate(out):
        _assert_same(_rank_frame(answers, name), want,
                     "ORDER BY" in STREAMED[name])
        _assert_bits(answers, first, name, f"rank {rank} vs rank 0")


@pytest.mark.parametrize("name", sorted(STREAMED))
def test_streamed_answers_equal_jax_on_world_2x4(ranks_all, jax_mesh, name):
    _, _, out = ranks_all
    want_jax, _ = _jax(jax_mesh, name)
    for rank, (_, answers) in enumerate(out):
        _assert_same(_rank_frame(answers, name), want_jax,
                     "ORDER BY" in STREAMED[name])


@pytest.mark.parametrize("name", STREAM_AGAIN)
def test_a_repeated_streamed_query_builds_no_stage_program(ranks, name):
    _, _, out = ranks
    for rank, (info, answers) in enumerate(out):
        cold = info["streams"][name]
        again = info["streams"]["again_" + name]
        served = sum(p["served"] for p in cold["plans"])
        c = cold["counters"]
        # the full batch's program and the short last batch's, per stage
        per_plan = c["spmd_stages"] // served
        assert 0 < c["spmd_compiles"] <= 2 * per_plan, (rank, c)
        assert "spmd_compiles" not in again["counters"], (rank, again)
        assert again["counters"]["spmd_stages"] == c["spmd_stages"]
        assert again["stale"] == []
        _assert_bits({k[len("again_"):]: v for k, v in answers.items()
                      if k.startswith("again_")},
                     {k: v for k, v in answers.items()
                      if k.startswith(name + "/")}, name,
                     f"rank {rank} repeated")


def test_a_failed_stream_leaves_no_gathered_batch(ranks):
    _, _, out = ranks
    for rank, (info, _) in enumerate(out):
        fault = info["streams"]["fault"]
        assert fault["raised"] is not None, (rank, fault)
        # two batches gathered before the third upload failed
        local = [p for p in fault["plans"] if p["local"]]
        assert [p["steps"] for p in local] == [1, 1], (rank, fault)
        assert fault["stale"] == [], (rank, fault)
