"""A rank's upload of a streamed batch on a mesh across processes, in one
process: ``ChunkedSource.batch_table`` with a rank slice (a stand-in with
the mesh's ``size``, ``rank`` and ``world_size``) uploads only rows
``[first, first + count)`` of the batch that the single-process mesh
places whole (``streaming._set_batch_entry`` on ``Mesh(["cpu"] * size)``,
padded by ``shard_table_with_validity``), bit for bit: data, masks,
``row_valid`` and dictionaries; ``batch_rank_rows`` says what it holds,
and ``upload_bytes`` is this rank's share.  Worlds 2 and 4 of an 8-shard
mesh, every rank, a full batch and the short last one, and a
``batch_rows`` that is not a multiple of the mesh size.  The same for a
grace join's spill-backed output source (``morsel.SpillBackedSource``)."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.io.chunked import ChunkedSource, rank_slice
from dask_sql_tpu_torch.parallel.mesh import Mesh
from dask_sql_tpu_torch.physical import streaming as S
from dask_sql_tpu_torch.runtime import telemetry as tel

SIZE = 8
N_ROWS = 150
#: a multiple of the mesh size, and one that is not
BATCH_ROWS = (64, 61)
WORLDS = (2, 4)


def _columns(n: int) -> dict:
    rng = np.random.RandomState(20)
    strings = np.array(["ash", "birch", "cedar", "elm", "fir"])[
        rng.randint(0, 5, n)].astype(object)
    strings[rng.rand(n) < 0.2] = None
    ints = list(rng.randint(-9, 9, n))
    for i in np.flatnonzero(rng.rand(n) < 0.15):
        ints[i] = None
    return {"k": rng.randint(0, 1000, n).astype(np.int64),
            "v": np.round(rng.standard_normal(n), 6),
            "s": strings, "i": ints,
            "f": (rng.rand(n) < 0.5)}


@pytest.fixture(scope="module")
def meshed():
    """The single-process mesh whose batch entries are the reference."""
    return Context(mesh=Mesh(["cpu"] * SIZE))


def _whole_batch(ctx, source, i: int):
    """The single-process mesh's entry of batch ``i`` (every column)."""
    table, row_valid = source.batch_table(i, torch.device("cpu"))
    S._set_batch_entry(ctx, table, row_valid)
    entry = ctx.schema[S.STREAM_SCHEMA].tables[S.BATCH_TABLE]
    S._cleanup(ctx)
    return entry


def _bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.numpy().tobytes() == b.numpy().tobytes()


def _rank_upload(source, i: int, ranks):
    with tel.trace_scope("rank upload"):
        with tel.span("stream_batch") as s:
            table, row_valid = source.batch_table(i, torch.device("cpu"),
                                                  ranks=ranks)
    return table, row_valid, s.attrs["upload_bytes"]


def _assert_rank_part(whole, table, row_valid, first: int, count: int):
    assert table.names == whole.table.names
    for wc, c in zip(whole.table.columns, table.columns):
        assert _bits(c.data, wc.data.narrow(0, first, count))
        assert (c.mask is None) == (wc.mask is None)
        if c.mask is not None:
            assert _bits(c.mask, wc.mask.narrow(0, first, count))
        assert c.stype == wc.stype
        if wc.dictionary is None:
            assert c.dictionary is None
        else:
            assert list(c.dictionary) == list(wc.dictionary)
    if whole.row_valid is None:
        assert row_valid is None
    else:
        assert _bits(row_valid, whole.row_valid.narrow(0, first, count))


@pytest.mark.parametrize("batch_rows", BATCH_ROWS)
@pytest.mark.parametrize("world", WORLDS)
def test_a_ranks_batch_is_its_rows_of_the_whole_placement(meshed, world,
                                                          batch_rows):
    source = ChunkedSource.from_columns(_columns(N_ROWS),
                                        batch_rows=batch_rows)
    assert source.n_batches == 3
    last = N_ROWS - 2 * batch_rows
    for i in (0, source.n_batches - 1):   # a full batch, the short last
        whole = _whole_batch(meshed, source, i)
        padded = whole.table.num_rows
        assert padded == -(-batch_rows // SIZE) * SIZE
        count = padded // world
        row_bytes = sum(c.data.element_size() + (c.mask is not None)
                        for c in whole.table.columns)
        for rank in range(world):
            ranks = SimpleNamespace(size=SIZE, rank=rank, world_size=world)
            assert rank_slice(batch_rows, ranks) == (padded, rank * count,
                                                     count)
            table, row_valid, upload = _rank_upload(source, i, ranks)
            assert table.num_rows == count
            _assert_rank_part(whole, table, row_valid, rank * count, count)
            assert upload == count * row_bytes
            rr = source.batch_rank_rows(i, ranks)
            assert (rr.padded, rr.rows, rr.first) == (
                padded, batch_rows if i == 0 else last, rank * count)


def test_an_entry_with_rank_rows_is_kept_as_it_is(meshed):
    """``_set_batch_entry`` with ``rank_rows`` neither pads nor places the
    batch: it is this rank's part, as a rank-local catalog entry."""
    source = ChunkedSource.from_columns(_columns(N_ROWS), batch_rows=61)
    ranks = SimpleNamespace(size=SIZE, rank=1, world_size=2)
    table, row_valid = source.batch_table(2, torch.device("cpu"),
                                          ranks=ranks)
    rr = source.batch_rank_rows(2, ranks)
    S._set_batch_entry(meshed, table, row_valid, rank_rows=rr)
    entry = meshed.schema[S.STREAM_SCHEMA].tables[S.BATCH_TABLE]
    assert entry.table is table and entry.row_valid is row_valid
    assert entry.rank_rows == rr
    assert not S._scans_rank_local(
        S.LogicalTableScan(schema_name=S.STREAM_SCHEMA,
                           table_name=S.BATCH_TABLE, schema=[]), meshed)
    S._cleanup(meshed)


@pytest.mark.parametrize("world", WORLDS)
def test_a_spill_backed_chunk_is_its_rows_of_the_whole_chunk(world,
                                                             tmp_path,
                                                             monkeypatch):
    """A grace join's output source pads every chunk to one capacity with
    masks and a row_valid always present; a rank's upload is its rows of
    that chunk placed whole, row_valid included."""
    from dask_sql_tpu_torch.physical.morsel import SpillBackedSource
    from dask_sql_tpu_torch.runtime import spill
    from dask_sql_tpu_torch.types import BIGINT, DOUBLE

    monkeypatch.setenv("DSQL_SPILL_MB", "64")
    monkeypatch.setenv("DSQL_SPILL_DIR", str(tmp_path))
    spill.reset_store()
    try:
        store = spill.get_store()
        rng = np.random.RandomState(4)
        cap = 45                     # not a multiple of the mesh size
        rows = (45, 17)
        for n in rows:
            store.put_host("out", ["c0", "c1"], [
                (rng.randint(0, 99, n).astype(np.int64), None, BIGINT, None),
                (rng.standard_normal(n), rng.rand(n) < 0.7, DOUBLE, None)])
        src = SpillBackedSource(store, "out", ["c0", "c1"], [BIGINT, DOUBLE],
                                [None, None], sum(rows), cap)
        mesh_ctx = Context(mesh=Mesh(["cpu"] * SIZE))
        for i, n in enumerate(rows):
            whole = _whole_batch(mesh_ctx, src, i)
            padded = whole.table.num_rows
            assert padded == 48 and whole.row_valid is not None
            count = padded // world
            for rank in range(world):
                ranks = SimpleNamespace(size=SIZE, rank=rank,
                                        world_size=world)
                table, row_valid, upload = _rank_upload(src, i, ranks)
                _assert_rank_part(whole, table, row_valid, rank * count,
                                  count)
                assert row_valid is not None
                assert upload == count * (8 + 1) * 2
                rr = src.batch_rank_rows(i, ranks)
                assert (rr.padded, rr.rows, rr.first) == (padded, n,
                                                          rank * count)
    finally:
        spill.reset_store()


@pytest.mark.parametrize("compiled", ["1", "0"])
def test_a_tier_outside_a_gather_refuses_a_ranks_batch(compiled,
                                                       monkeypatch):
    """The compiled tier and the eager executor never answer from one
    rank's rows of a batch: outside ``parallel.gather.whole_tables`` a
    scan of it raises (``gather.check_whole``)."""
    from dask_sql_tpu_torch.plan.nodes import (AggCall, Field,
                                               LogicalAggregate)
    from dask_sql_tpu_torch.types import BIGINT

    monkeypatch.setenv("DSQL_COMPILE", compiled)
    ctx = Context(device="cpu")
    source = ChunkedSource.from_columns(_columns(N_ROWS), batch_rows=64)
    ranks = SimpleNamespace(size=SIZE, rank=0, world_size=2)
    table, row_valid = source.batch_table(0, torch.device("cpu"),
                                          columns=["k"], ranks=ranks)
    S._set_batch_entry(ctx, table, row_valid,
                       rank_rows=source.batch_rank_rows(0, ranks))
    scan = S.LogicalTableScan(schema_name=S.STREAM_SCHEMA,
                              table_name=S.BATCH_TABLE,
                              schema=[Field("k", BIGINT)])
    plan = LogicalAggregate(input=scan, group_keys=[],
                            aggs=[AggCall("SUM", [0], False, BIGINT, "s")],
                            schema=[Field("s", BIGINT)])
    try:
        with pytest.raises(RuntimeError, match="this rank's rows only"):
            S._run_tiers(plan, ctx)
    finally:
        S._cleanup(ctx)
