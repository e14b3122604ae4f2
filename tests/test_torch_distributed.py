"""The port's mesh and standalone collectives (``dask_sql_tpu_torch/parallel/
mesh.py`` and ``distributed.py``) against the JAX package's, on the CPU.

The JAX functions run as ``shard_map`` programs over the 8-device virtual
CPU mesh of ``tests/conftest.py``; the port's over a mesh of 8 CPU shards
(``Mesh(["cpu"] * 8)``).  The inputs come from a numpy seed; integers
must agree exactly and floats to rtol 1e-9.  Also: the catalog placement
(``shard_table_with_validity``, ``shard_table``) round trips against the
JAX package's, ``default_mesh``, ``init_multihost(None)`` and its
coordinator path, which the port refuses.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from dask_sql_tpu.parallel import distributed as JD
from dask_sql_tpu.parallel import mesh as JM
from dask_sql_tpu.table import Table as JTable
from dask_sql_tpu_torch.parallel import distributed as PD
from dask_sql_tpu_torch.parallel import mesh as PM
from dask_sql_tpu_torch.table import Table

CPU = torch.device("cpu")
N_DEV = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several workers on one machine: torch's intra-op
    # threads on every core in each would oversubscribe it
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def meshes():
    jmesh = JM.default_mesh()
    if jmesh.devices.size != N_DEV:
        pytest.skip("needs the 8-device virtual CPU mesh")
    return jmesh, PM.Mesh(["cpu"] * N_DEV)


def _j(mesh, x):
    return jax.device_put(jnp.asarray(x), JM.row_sharding(mesh))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got: torch.Tensor, want, exact: bool):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)


@pytest.mark.parametrize("dtype", ["float64", "int64"])
def test_dist_segment_sum(meshes, dtype):
    jmesh, pmesh = meshes
    rng = np.random.RandomState(1)
    n, g = 16 * N_DEV, 7
    vals = (rng.rand(n) * 100).astype(dtype)
    codes = rng.randint(0, g, n).astype(np.int32)
    want = JD.dist_segment_sum(jmesh, _j(jmesh, vals), _j(jmesh, codes), g)
    got = PD.dist_segment_sum(pmesh, _t(vals), _t(codes), g)
    _close(got, want, dtype == "int64")


@pytest.mark.parametrize("is_min", [True, False])
def test_dist_segment_minmax(meshes, is_min):
    jmesh, pmesh = meshes
    rng = np.random.RandomState(2)
    n, g = 16 * N_DEV, 9   # group 8 stays empty: the sentinel
    vals = rng.randn(n) * 10
    codes = rng.randint(0, g - 1, n).astype(np.int32)
    sent = np.inf if is_min else -np.inf
    want = JD.dist_segment_minmax(jmesh, _j(jmesh, vals), _j(jmesh, codes),
                                  g, is_min, sent)
    got = PD.dist_segment_minmax(pmesh, _t(vals), _t(codes), g, is_min, sent)
    _close(got, want, True)


def test_hash_exchange(meshes):
    jmesh, pmesh = meshes
    rng = np.random.RandomState(3)
    n = 12 * N_DEV
    codes = rng.randint(0, 31, n).astype(np.int64)
    codes[::5] = -1
    pay_f = rng.rand(n)
    pay_i = rng.randint(-100, 100, n).astype(np.int32)
    want = JD.hash_exchange(jmesh, _j(jmesh, codes), _j(jmesh, pay_f),
                            _j(jmesh, pay_i))
    got = PD.hash_exchange(pmesh, _t(codes), _t(pay_f), _t(pay_i))
    assert len(got) == len(want) == 3
    for g_, w_ in zip(got, want):
        _close(g_, w_, True)   # the same slots, bit for bit


def test_dist_groupby_sum_exchange(meshes):
    jmesh, pmesh = meshes
    rng = np.random.RandomState(4)
    n, g = 16 * N_DEV, 40
    codes = rng.randint(0, g, n).astype(np.int64)
    codes[::9] = -1
    vals = rng.rand(n)
    want = JD.dist_groupby_sum_exchange(jmesh, _j(jmesh, codes),
                                        _j(jmesh, vals), g)
    got = PD.dist_groupby_sum_exchange(pmesh, _t(codes), _t(vals), g)
    _close(got, want, False)


def test_dist_join_broadcast(meshes):
    jmesh, pmesh = meshes
    rng = np.random.RandomState(5)
    n = 16 * N_DEV
    build = rng.permutation(np.arange(N_DEV * 4, dtype=np.int64))
    bvals = rng.rand(len(build))
    probe = rng.randint(-2, N_DEV * 5, n).astype(np.int64)
    want = JD.dist_join_broadcast(jmesh, _j(jmesh, probe), _j(jmesh, build),
                                  _j(jmesh, bvals), -1.0)
    got = PD.dist_join_broadcast(pmesh, _t(probe), _t(build), _t(bvals),
                                 -1.0)
    _close(got, want, True)


@pytest.mark.parametrize("shift", [1, 3, -1])
def test_ring_shift(meshes, shift):
    jmesh, pmesh = meshes
    x = np.arange(5 * N_DEV, dtype=np.int64) * 7
    want = JD.ring_shift(jmesh, _j(jmesh, x), shift)
    got = PD.ring_shift(pmesh, _t(x), shift)
    _close(got, want, True)


@pytest.mark.parametrize("dtype", ["int32", "float64"])
def test_dist_prefix_sum(meshes, dtype):
    jmesh, pmesh = meshes
    rng = np.random.RandomState(6)
    x = (rng.rand(6 * N_DEV) * 50).astype(dtype)
    want = JD.dist_prefix_sum(jmesh, _j(jmesh, x))
    got = PD.dist_prefix_sum(pmesh, _t(x))
    assert got.numpy().dtype == np.asarray(want).dtype
    _close(got, want, dtype == "int32")


def _frame(n: int) -> pd.DataFrame:
    rng = np.random.RandomState(n)
    v = rng.rand(n)
    v[::4] = np.nan
    k = pd.array(rng.randint(0, 9, n), dtype="Int64")
    k[::3] = pd.NA
    return pd.DataFrame({"k": k, "v": v,
                         "s": rng.choice(["a", "b", "c"], n)})


@pytest.mark.parametrize("n", [3, 8 * N_DEV, 8 * N_DEV + 5])
def test_shard_table_with_validity_round_trip(meshes, n):
    jmesh, pmesh = meshes
    df = _frame(n)
    jt, jrv = JM.shard_table_with_validity(JTable.from_pandas(df), jmesh)
    pt, prv = PM.shard_table_with_validity(Table.from_pandas(df, CPU), pmesh)
    assert (jrv is None) == (prv is None) == (n % N_DEV == 0)
    if prv is not None:
        _close(prv, jrv, True)
    assert pt.num_rows == jt.num_rows and pt.num_rows % N_DEV == 0
    for pc, jc in zip(pt.columns, jt.columns):
        assert (pc.mask is None) == (jc.mask is None)
        _close(pc.data, jc.data, True)
        if pc.mask is not None:
            _close(pc.mask, jc.mask, True)
    # the valid prefix is the table itself
    back = pt.slice(0, n).to_pandas()
    pd.testing.assert_frame_equal(back, Table.from_pandas(df, CPU)
                                  .to_pandas())


@pytest.mark.parametrize("n", [5, 8 * N_DEV])
def test_shard_table_round_trip(meshes, n):
    jmesh, pmesh = meshes
    df = _frame(n)
    jt, jn = JM.shard_table(JTable.from_pandas(df), jmesh)
    pt, pn = PM.shard_table(Table.from_pandas(df, CPU), pmesh)
    assert pn == jn == n
    for pc, jc in zip(pt.columns, jt.columns):
        assert (pc.mask is None) == (jc.mask is None)
        _close(pc.data, jc.data, True)
        if pc.mask is not None:
            _close(pc.mask, jc.mask, True)


def test_split_gives_views_on_a_repeated_device_mesh(meshes):
    _, pmesh = meshes
    t = torch.arange(8 * N_DEV)
    parts = pmesh.split(t)
    assert len(parts) == N_DEV and pmesh.virtual
    for i, p in enumerate(parts):
        assert p.data_ptr() == t[i * 8:].data_ptr()   # a view, no copy
    assert pmesh.signature() == "data:8@" + ",".join(["cpu"] * N_DEV)
    assert pmesh.axis_names == ("data",) and pmesh.size == N_DEV


def test_default_mesh_and_init_multihost():
    m = PM.default_mesh(device="cpu")
    assert m.devices == (CPU,)
    assert PM.default_mesh(1, device="cpu").size == 1
    assert PM.init_multihost(None, device="cpu").devices == m.devices
    if torch.cuda.is_available():
        assert PM.default_mesh().size == torch.cuda.device_count()
        assert PM.init_multihost(None).devices == PM.default_mesh().devices
    else:
        # no card: the CPU only when the caller asks for it, as Context()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PM.default_mesh()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PM.init_multihost(None)
        # a coordinator means a process group: NCCL on a card unless the
        # caller asks for gloo on the CPU (device="cpu")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PM.init_multihost("127.0.0.1:1234", 2, 0)
    with pytest.raises(ValueError, match="outside a world"):
        PM.init_multihost("127.0.0.1:1234", 2, 2, device="cpu")


def test_context_mesh_must_start_at_its_device():
    from dask_sql_tpu_torch import Context

    ctx = Context(mesh=PM.Mesh(["cpu"] * 4))
    assert ctx.device == CPU and ctx.mesh.size == 4
    with pytest.raises(ValueError, match="first device"):
        Context(device="meta", mesh=PM.Mesh(["cpu"] * 2))
