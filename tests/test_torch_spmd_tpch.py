"""TPC-H Q1-Q22 at SF 0.01 on ``Context(mesh=...)`` with the SPMD stage
executor on, on the CPU (a mesh of 8 CPU shards).

Every answer equals the port's single-device answer (``Context(device=
"cpu")`` over the same frames: ints and strings exact, doubles rtol 1e-9),
whether the SPMD executor served the query (``spmd_queries``) or declined
it (``spmd_unsupported``: outer, semi and anti joins, multi-key joins,
DISTINCT aggregates, windows) and the single-device tiers served the
padded tables.  Q1, Q3, Q5 and Q18 (a static GROUP BY, joins with a
flipped build side, a declined snowflake and a declined IN-subquery) are
also held to the JAX package's SPMD run on its 8-device CPU mesh: the
answers and every ``spmd_*`` counter equal.

The module name holds "spmd": the conftest's ``DSQL_MESH=0`` pin does not
apply.
"""
import numpy as np
import pandas as pd
import pytest
import torch

from benchmarks.tpch import QUERIES, generate_tpch
from dask_sql_tpu import Context as JaxContext
from dask_sql_tpu.parallel.mesh import default_mesh
from dask_sql_tpu.runtime import telemetry as jtel
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.parallel.mesh import Mesh
from dask_sql_tpu_torch.runtime import telemetry as tel

SF = 0.01
N_DEV = 8
JAX_CHECKED = (1, 3, 5, 18)
# the queries the walker serves (the rest decline up front, as in JAX)
SERVED = (1, 3, 6, 8, 12, 14)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several workers on one machine: torch's intra-op
    # threads on every core in each would oversubscribe it
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def tpch():
    return generate_tpch(SF, seed=11)


@pytest.fixture(scope="module")
def contexts(tpch):
    plain = Context(device="cpu")
    dist = Context(mesh=Mesh(["cpu"] * N_DEV))
    for name, frame in tpch.items():
        plain.create_table(name, frame)
        dist.create_table(name, frame)
    return plain, dist


@pytest.fixture(scope="module")
def jax_dist(tpch):
    mesh = default_mesh()
    if mesh.devices.size != N_DEV:
        pytest.skip("needs the 8-device virtual CPU mesh")
    ctx = JaxContext(mesh=mesh)
    for name, frame in tpch.items():
        ctx.create_table(name, frame)
    return ctx


def _deltas(registry, c0):
    now = registry.counters()
    return {k: v - c0.get(k, 0) for k, v in now.items()
            if k.startswith("spmd_") and v != c0.get(k, 0)}


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
        assert (g.isna().to_numpy() == w.isna().to_numpy()).all(), col
        live = ~w.isna().to_numpy()
        if pd.api.types.is_float_dtype(w):
            np.testing.assert_allclose(g.to_numpy(dtype=float)[live],
                                       w.to_numpy(dtype=float)[live],
                                       rtol=1e-9, err_msg=col)
        else:
            assert [str(x) for x in g[live]] == [str(x) for x in w[live]], col


@pytest.mark.parametrize("qid", sorted(QUERIES))
def test_tpch_spmd_matches_single_device(contexts, qid):
    plain, dist = contexts
    q = QUERIES[qid]
    want = plain.sql(q, return_futures=False)
    c0 = tel.REGISTRY.counters()
    got = dist.sql(q, return_futures=False)
    d = _deltas(tel.REGISTRY, c0)
    assert d.get("spmd_fallbacks", 0) == 0, d
    if qid in SERVED:
        assert d.get("spmd_queries") == 1, d
        assert d.get("spmd_partial_aggs", 0) >= 1, d
    else:
        assert d == {"spmd_unsupported": 1}, d
    _assert_same(got, want, "ORDER BY" in q)


@pytest.mark.parametrize("qid", JAX_CHECKED)
def test_tpch_spmd_matches_jax(contexts, jax_dist, qid):
    _, dist = contexts
    q = QUERIES[qid]
    c0 = jtel.REGISTRY.counters()
    want = jax_dist.sql(q, return_futures=False)
    dj = _deltas(jtel.REGISTRY, c0)
    c0 = tel.REGISTRY.counters()
    got = dist.sql(q, return_futures=False)
    dp = _deltas(tel.REGISTRY, c0)
    # a stage program the module's first test built is a cache hit here,
    # in the JAX package a first compile
    dj.pop("spmd_compiles", None)
    assert dp == dj
    _assert_same(got, want, "ORDER BY" in q)


def test_spmd_runs_give_identical_bits(contexts):
    _, dist = contexts
    a = dist.sql(QUERIES[1], return_futures=True)
    b = dist.sql(QUERIES[1], return_futures=True)
    for ca, cb in zip(a.columns, b.columns):
        assert ca.data.numpy().tobytes() == cb.data.numpy().tobytes()
