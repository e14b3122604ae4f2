"""Tests of the port that need a CUDA card; they skip without one.

This file imports neither JAX nor ``dask_sql_tpu`` and needs no conftest,
so it runs on a machine that has only torch:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""
import numpy as np
import pytest
import torch

from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.ops import gpu_kernels as gk


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return bool(torch.equal(a.cpu().view(torch.int64), b.cpu().view(torch.int64)))


@pytest.mark.gpu
def test_kernel_bitwise_matches_plain_on_card(cuda_device):
    rng = np.random.RandomState(5)
    n, g = 100_003, 6
    vals = torch.from_numpy(np.vstack([rng.randn(n) * 1e4,
                                       rng.randint(-10**6, 10**6, n),
                                       (rng.rand(n) > 0.5)]).astype(np.float64))
    vals[0, ::997] = np.nan
    vals[1, 5] = np.inf
    codes = torch.from_numpy(rng.randint(0, g, n))
    mask = torch.from_numpy(rng.rand(n) > 0.1)
    args = [t.to(cuda_device) for t in (vals, codes, mask)]
    classes = ["float", "int", "unit"]
    gk.reset_launch_counts()
    got = gk.segmented_sums_fixedpoint(*args, g, row_classes=classes)
    assert gk.LAUNCHES["segsum_fixedpoint"] == 1
    plain = gk.segmented_sums_fixedpoint(
        *args, g, row_classes=classes, limb_totals=gk.segsum_limb_totals_plain)
    torch.cuda.synchronize()
    assert _same_bits(got, plain)
    cpu = gk.segmented_sums_fixedpoint(vals, codes, mask, g, row_classes=classes)
    assert _same_bits(got, cpu)


def _fixedpoint_case(name, rng):
    """(vals, codes, mask, groups, row classes) for the kernel's schedules:
    one group for every row, both signs in every warp, n off every chunk
    and range boundary, and 256 groups (block-shared accumulators)."""
    classes = ["unit", "float", "unit", "int", "unit"]
    n, g = 300_001, 6
    if name == "ragged_boundary":
        n = 32 * 4099 + 17
    vals = np.vstack([rng.rand(n) > 0.2, rng.uniform(900.0, 105_000.0, n),
                      rng.rand(n) > 0.5, rng.randint(0, 10**9, n),
                      np.ones(n)]).astype(np.float64)
    codes = rng.randint(0, g, n)
    if name == "one_group":
        codes[:] = 3
    elif name == "mixed_signs":
        vals[1] *= np.where(rng.rand(n) > 0.5, 1.0, -1.0)
        vals[3] -= 5 * 10**8
    elif name == "domain_256":
        g = 256
        codes = rng.randint(0, g, n)
    return vals, codes, rng.rand(n) > 0.05, g, classes


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["one_group", "mixed_signs", "ragged_boundary",
                                  "domain_256"])
def test_kernel_schedules_bitwise_match_plain(cuda_device, name):
    vals, codes, mask, g, classes = _fixedpoint_case(name, np.random.RandomState(8))
    args = [torch.from_numpy(x).to(cuda_device) for x in (vals, codes, mask)]
    got = gk.segmented_sums_fixedpoint(*args, g, row_classes=classes)
    plain = gk.segmented_sums_fixedpoint(
        *args, g, row_classes=classes, limb_totals=gk.segsum_limb_totals_plain)
    torch.cuda.synchronize()
    assert _same_bits(got, plain)


@pytest.mark.gpu
def test_fixedpoint_warm_call_makes_no_host_sync(cuda_device):
    """A call on a layout seen before copies nothing from the host: every
    index tensor of the route is cached on the card."""
    vals, codes, mask, g, classes = _fixedpoint_case("mixed_signs",
                                                     np.random.RandomState(9))
    args = [torch.from_numpy(x).to(cuda_device) for x in (vals, codes, mask)]
    first = gk.segmented_sums_fixedpoint(*args, g, row_classes=classes)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        warm = gk.segmented_sums_fixedpoint(*args, g, row_classes=classes)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert _same_bits(first, warm)


@pytest.mark.gpu
def test_kernel_wrapper_rejects_bad_inputs(cuda_device):
    vals = torch.zeros((2, 8), dtype=torch.float64, device=cuda_device)
    codes = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    mask = torch.ones(8, dtype=torch.uint8, device=cuda_device)
    scale = torch.ones(2, dtype=torch.float64, device=cuda_device)
    with pytest.raises(TypeError, match="codes"):
        gk.segsum_limb_totals_cuda(vals, codes.long(), mask, scale,
                                   ["float", "unit"], 3)
    with pytest.raises(ValueError, match="contiguous"):
        gk.segsum_limb_totals_cuda(vals.t().contiguous().t(), codes, mask,
                                   scale, ["float", "unit"], 3)


@pytest.mark.gpu
def test_static_group_by_on_card_matches_cpu(cuda_device):
    rng = np.random.RandomState(0)
    n = 50_000
    data = {"rf": rng.choice(["A", "N", "R"], n), "ls": rng.choice(["O", "F"], n),
            "qty": rng.randint(1, 51, n).astype(np.float64),
            "price": np.round(rng.uniform(900.0, 105_000.0, n), 2)}
    sql = ("SELECT rf, ls, SUM(qty) AS sq, AVG(price) AS ap, COUNT(*) AS c "
           "FROM t WHERE qty < 40 GROUP BY rf, ls ORDER BY rf, ls")
    results = []
    for dev in (cuda_device, torch.device("cpu")):
        ctx = Context(device=dev)
        ctx.create_table("t", data)
        results.append(ctx.sql(sql).to_numpy())
    gpu, cpu = results
    for col in gpu:
        assert gpu[col].tolist() == cpu[col].tolist(), col


@pytest.mark.gpu
def test_accumulate_kernel_within_bound_and_deterministic(cuda_device):
    """Kernel 2 through the float32 branch of segmented_sums_dispatch: held
    to the float64 sum within (1024 + ceil(n/1024)) * 2**-24 * sum|v| per
    (row, group), non-finite results exact, the same bits on a second run,
    and its plain version within the same bound."""
    rng = np.random.RandomState(6)
    n, g = 200_003, 9
    vals = torch.from_numpy((rng.randn(4, n) * 1e3).astype(np.float32))
    vals[0, 10], vals[1, 20], vals[2, 30] = np.nan, np.inf, -np.inf
    codes = torch.from_numpy(rng.randint(0, g, n))
    mask = torch.from_numpy(rng.rand(n) > 0.2)
    args = [t.to(cuda_device) for t in (vals, codes, mask)]
    gk.reset_launch_counts()
    got = gk.segmented_sums_dispatch(*args, g)
    assert gk.LAUNCHES == {"segsum_fixedpoint": 0, "segsum_accumulate": 1}
    again = gk.segmented_sums_dispatch(*args, g)
    plain = gk.segmented_sums(*args, g, accumulate=gk.segsum_accumulate_plain)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert torch.equal(got.cpu().view(torch.int32), again.cpu().view(torch.int32))
    want = gk.reference_segmented_sums(vals.double(), codes, mask, g)
    abs_sum = gk.reference_segmented_sums(
        vals.double().nan_to_num(0.0, 0.0, 0.0).abs(), codes, mask, g)
    bound = (1024 + -(-n // 1024)) * 2.0 ** -24 * abs_sum
    fin = torch.isfinite(want)
    for out in (got.cpu(), plain.cpu()):
        assert torch.equal(torch.isnan(out), torch.isnan(want))
        assert torch.equal(out[~fin & ~torch.isnan(want)].double(),
                           want[~fin & ~torch.isnan(want)])
        assert bool(((out.double() - want).abs()[fin] <= bound[fin]).all())


@pytest.mark.gpu
@pytest.mark.parametrize("name,n,g", [("one_group", 1_000_003, 1),
                                      ("groups_40", 1_000_003, 40),
                                      ("domain_256_f64", 300_007, 256),
                                      ("groups_4000", 300_007, 4000),
                                      ("groups_2600_f64", 300_007, 2600)])
def test_accumulate_schedules_within_bound(cuda_device, name, n, g):
    rng = np.random.RandomState(7)
    dtype = np.float64 if name.endswith("f64") else np.float32
    vals = torch.from_numpy((rng.randn(3, n) * 1e3).astype(dtype))
    codes = torch.from_numpy(rng.randint(0, g, n))
    mask = torch.from_numpy(rng.rand(n) > 0.1)
    args = [t.to(cuda_device) for t in (vals, codes, mask)]
    got = gk.segmented_sums(*args, g)
    again = gk.segmented_sums(*args, g)
    torch.cuda.synchronize()
    view = torch.int32 if dtype == np.float32 else torch.int64
    assert torch.equal(got.cpu().view(view), again.cpu().view(view))
    want = gk.reference_segmented_sums(vals.double(), codes, mask, g)
    abs_sum = gk.reference_segmented_sums(vals.double().abs(), codes, mask, g)
    eps = 2.0 ** -24 if dtype == np.float32 else 2.0 ** -53
    bound = (1024 + -(-n // 1024)) * eps * abs_sum
    assert bool(((got.cpu().double() - want).abs() <= bound).all())


@pytest.mark.gpu
def test_accumulate_wrapper_rejects_bad_inputs(cuda_device):
    vals = torch.zeros((2, 8), dtype=torch.float32, device=cuda_device)
    codes = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    mask = torch.ones(8, dtype=torch.uint8, device=cuda_device)
    with pytest.raises(TypeError, match="codes"):
        gk.segsum_accumulate_cuda(vals, codes.long(), mask, 3)
    with pytest.raises(TypeError, match="float32 or float64"):
        gk.segsum_accumulate_cuda(vals.half(), codes, mask, 3)
    with pytest.raises(ValueError, match="contiguous"):
        gk.segsum_accumulate_cuda(vals.t().contiguous().t(), codes, mask, 3)


@pytest.mark.gpu
def test_join_queries_on_card_match_cpu(cuda_device):
    rng = np.random.RandomState(1)
    n = 20_000
    fact = {"k": rng.randint(0, 500, n), "v": rng.rand(n),
            "s": rng.choice(["a", "b", "c"], n)}
    dim = {"k2": np.arange(400), "name": np.char.add("n", np.arange(400).astype(str)),
           "grp": rng.choice(["x", "y"], 400)}
    sqls = ["SELECT grp, s, SUM(v) AS t, COUNT(*) AS c FROM fact, dim "
            "WHERE k = k2 GROUP BY grp, s ORDER BY grp, s",
            "SELECT COUNT(*) AS c FROM fact WHERE k NOT IN (SELECT k2 FROM dim)",
            "SELECT name, COUNT(v) AS c FROM dim LEFT JOIN fact ON k = k2 "
            "AND v > 0.5 GROUP BY name ORDER BY c DESC, name LIMIT 5"]
    results = []
    for dev in (cuda_device, torch.device("cpu")):
        ctx = Context(device=dev)
        ctx.create_table("fact", fact)
        ctx.create_table("dim", dim)
        results.append([ctx.sql(q).to_numpy() for q in sqls])
    for gpu, cpu in zip(*results):
        for col in gpu:
            if gpu[col].dtype.kind == "f":
                np.testing.assert_allclose(gpu[col], cpu[col], rtol=1e-12)
            else:
                assert gpu[col].tolist() == cpu[col].tolist(), col


@pytest.mark.gpu
def test_float_group_sums_are_deterministic_on_card(cuda_device):
    """A float SUM ... GROUP BY gives the same bits on every run, so a
    TPC-H Q15-shaped query (a sum compared with the MAX of the same sums,
    computed again in a subquery) finds its row."""
    rng = np.random.RandomState(2)
    n = 2_000_000
    ctx = Context(device=cuda_device)
    ctx.create_table("f", {"k": rng.randint(0, 1000, n),
                           "v": np.round(rng.uniform(900.0, 105_000.0, n), 2)})
    sums = [ctx.sql("SELECT k, SUM(v) AS t, AVG(v) AS a FROM f GROUP BY k")
            .to_numpy() for _ in range(3)]
    for other in sums[1:]:
        for col in ("t", "a"):
            assert other[col].view(np.int64).tolist() == \
                sums[0][col].view(np.int64).tolist()
    q15 = ("WITH r AS (SELECT k, SUM(v) AS t FROM f GROUP BY k) "
           "SELECT k, t FROM r WHERE t = (SELECT MAX(t) FROM r)")
    for _ in range(5):
        assert ctx.sql(q15).num_rows == 1


def _count_syncs(fn):
    """(fn()'s result, its host synchronisations as counted by
    ``torch.cuda.set_sync_debug_mode("warn")``)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out, sum("synchroniz" in str(w.message) for w in caught)


def _stats_tables(rng, n=300_000):
    f = rng.randn(n)
    f[::1001] = np.nan
    return {"t": {
        "k": rng.randint(0, 5000, n),
        "wide": rng.randint(-2**40, 2**40, n),
        "neg": rng.randint(-3000, -1000, n).astype(np.int32),
        "x": f,                                  # NaN ingests as NULL
        "b": rng.rand(n) < 0.3,
        "s": rng.choice(["a", "bb", "ccc"], n),
        "d": np.datetime64("1992-01-01") + rng.randint(0, 2500, n)
        .astype("timedelta64[D]"),
    }}


@pytest.mark.gpu
def test_ingest_stats_on_card_match_cpu(cuda_device):
    tables = _stats_tables(np.random.RandomState(4))
    stats = []
    for dev in (cuda_device, torch.device("cpu")):
        ctx = Context(device=dev)
        ctx.create_table("t", tables["t"])
        stats.append(ctx.schema["root"].tables["t"].stats)
    gpu, cpu = stats
    assert gpu.rows == cpu.rows and list(gpu.cols) == list(cpu.cols)
    for name in cpu.cols:
        assert gpu.cols[name] == cpu.cols[name], name
    assert cpu.cols["wide"].domain > 2 ** 20 and cpu.cols["x"].null_frac > 0


@pytest.mark.gpu
def test_dense_codes_on_card_bit_equal_cpu(cuda_device):
    from dask_sql_tpu_torch.ops import groupby as G
    from dask_sql_tpu_torch.ops import kernels as K
    from dask_sql_tpu_torch.table import Column
    from dask_sql_tpu_torch.types import BIGINT

    rng = np.random.RandomState(6)
    n = 1_000_003
    data = torch.from_numpy(rng.randint(-700, 3000, n))
    mask = torch.from_numpy(rng.rand(n) < 0.95)
    other = torch.from_numpy(rng.randint(-100, 5000, n // 3))
    for hint in (None, (-700, 2999), (0, 10)):
        for m in (None, mask):
            outs = [G._dense_group_codes(
                [Column(data.to(dev), BIGINT, None if m is None else m.to(dev))],
                hint) for dev in (cuda_device, torch.device("cpu"))]
            assert outs[0][2] == outs[1][2]
            for a, b in zip(outs[0][:2], outs[1][:2]):
                assert torch.equal(a.cpu(), b)
    for null_equal in (False, True):
        outs = [K._dense_join_codes(
            [Column(data.to(dev), BIGINT, mask.to(dev))],
            [Column(other.to(dev), BIGINT, None)], null_equal)
            for dev in (cuda_device, torch.device("cpu"))]
        for a, b in zip(*outs):
            assert torch.equal(a.cpu(), b)


@pytest.mark.gpu
def test_dense_paths_make_only_their_named_syncs(cuda_device):
    """The dense join codes read their four bounds in one synchronisation
    (and under ``set_sync_debug_mode("error")`` that read is where they
    stop); the dense group codes make two (the bounds, the group count).
    A whole dense inner join makes no more syncs than the hash one."""
    import traceback

    from dask_sql_tpu_torch.ops import groupby as G
    from dask_sql_tpu_torch.ops import join as J
    from dask_sql_tpu_torch.ops import kernels as K
    from dask_sql_tpu_torch.table import Column, Table
    from dask_sql_tpu_torch.types import BIGINT

    rng = np.random.RandomState(8)
    n = 2_000_000
    left = Column(torch.from_numpy(rng.randint(0, 100_000, n)).to(cuda_device),
                  BIGINT, torch.from_numpy(rng.rand(n) < 0.9).to(cuda_device))
    right = Column(torch.arange(100_000, device=cuda_device), BIGINT, None)
    K._dense_join_codes([left], [right], False)        # warm-up
    _, syncs = _count_syncs(lambda: K._dense_join_codes([left], [right], False))
    assert syncs == 1
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError) as err:
            K._dense_join_codes([left], [right], False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    frames = traceback.extract_tb(err.value.__traceback__)
    assert any(f.filename.endswith("kernels.py") and "tolist" in (f.line or "")
               for f in frames)
    _, syncs = _count_syncs(lambda: G._dense_group_codes([left], None))
    assert syncs == 2
    lt, rt = Table(["k"], [left]), Table(["k2"], [right])
    counts = {}
    for variant in ("hash", "dense"):
        _, counts[variant] = _count_syncs(
            lambda: J.join_tables(lt, rt, [0], [0], "INNER", variant=variant))
    assert counts["dense"] <= counts["hash"]


def _window_frame(n, seed):
    rng = np.random.RandomState(seed)
    return {
        "p": rng.randint(0, 40, n),
        "o": rng.permutation(n),
        "t": rng.randint(0, 500, n),
        "v": rng.randn(n).round(3) * 100,
        "i": rng.randint(-50, 50, n),
        "s": rng.choice(["kiwi", "apple", "fig", "banana", "cherry"], n).astype(object),
    }


@pytest.mark.gpu
def test_window_queries_on_card_match_cpu(cuda_device):
    """Every window function and frame form on the card equals the CPU's:
    ints and strings exact, float sums rtol 1e-9 (the prefix sum adds in
    another order on the card)."""
    data = _window_frame(50_000, 7)
    on_card, on_cpu = Context(device=cuda_device), Context(device="cpu")
    for ctx in (on_card, on_cpu):
        ctx.create_table("w", data)
    over = "OVER (PARTITION BY p ORDER BY t, o)"
    queries = [
        f"SELECT ROW_NUMBER() {over} AS rn, RANK() {over} AS r, "
        f"DENSE_RANK() {over} AS dr, NTILE(4) {over} AS nt, "
        f"PERCENT_RANK() {over} AS pr, CUME_DIST() {over} AS cd FROM w",
        "SELECT SUM(v) OVER (PARTITION BY p ORDER BY o ROWS BETWEEN 6 PRECEDING "
        "AND CURRENT ROW) AS s, MIN(v) OVER (PARTITION BY p ORDER BY o ROWS "
        "BETWEEN 3 PRECEDING AND 3 FOLLOWING) AS mn, MAX(s) OVER (PARTITION BY p "
        "ORDER BY o ROWS BETWEEN 2 PRECEDING AND 1 FOLLOWING) AS mx, "
        f"AVG(i) {over} AS a, LAG(v, 2) {over} AS lg, LEAD(s) {over} AS ld FROM w",
        "SELECT SUM(v) OVER (PARTITION BY p ORDER BY t RANGE BETWEEN 20 PRECEDING "
        "AND CURRENT ROW) AS rs, FIRST_VALUE(s) OVER (PARTITION BY p ORDER BY t) "
        "AS fv, LAST_VALUE(s) OVER (PARTITION BY p ORDER BY t) AS lv, "
        "MIN(i) OVER (PARTITION BY p) AS mw, COUNT(*) OVER (PARTITION BY s) AS c "
        "FROM w",
    ]
    for q in queries:
        got, want = on_card.sql(q), on_cpu.sql(q)
        for name, g, w in zip(want.names, got.columns, want.columns):
            gv, wv = g.to_numpy(), w.to_numpy()
            if wv.dtype.kind == "f":
                np.testing.assert_allclose(gv, wv, rtol=1e-9, atol=1e-6,
                                           equal_nan=True, err_msg=name)
            else:
                assert gv.tolist() == wv.tolist(), name


@pytest.mark.gpu
def test_device_like_bitmap_on_card_matches_cpu(cuda_device):
    """The device bytes-matrix bitmap on the card equals the CPU's and the
    regex bitmap, bit for bit, and is kept per device."""
    import re

    from dask_sql_tpu_torch.ops import strings_fast as sf
    from dask_sql_tpu_torch.physical.rex.ops import sql_like_to_regex

    rng = np.random.RandomState(3)
    words = np.array(["special", "requests", "pending", "deposits", "quickly",
                      "Special", "REQUESTS", "x"], dtype=object)
    d = np.array([" ".join(rng.choice(words, rng.randint(0, 8)))
                  for _ in range(40_000)] + ["", "a_b"], dtype=object)
    for kind, pattern in (("LIKE", "%special%requests%"), ("ILIKE", "%SPECIAL%"),
                          ("LIKE", "special%"), ("LIKE", "%x"), ("LIKE", ""),
                          ("ILIKE", "pending deposits")):
        card = sf.device_like_bitmap(d, pattern, None, kind, cuda_device)
        cpu = sf.device_like_bitmap(d, pattern, None, kind, torch.device("cpu"))
        rx = re.compile(sql_like_to_regex(pattern),
                        re.IGNORECASE if kind == "ILIKE" else 0)
        want = np.array([rx.match(x) is not None for x in d])
        assert card.device.type == "cuda"
        assert torch.equal(card.cpu(), cpu)
        np.testing.assert_array_equal(cpu.numpy(), want, err_msg=pattern)
    assert sf._bytes_matrix(d, cuda_device)[0].device.type == "cuda"
    assert sf._bytes_matrix(d, torch.device("cpu"))[0].device.type == "cpu"


@pytest.mark.gpu
def test_window_calls_make_only_their_host_reads(cuda_device):
    """compute_window synchronises only where it reads a constant argument
    from column data: none for ranks, frame sums and bounded MIN/MAX, one
    for NTILE and for LAG with an offset."""
    from dask_sql_tpu_torch.ops import window as W
    from dask_sql_tpu_torch.table import Column, Table
    from dask_sql_tpu_torch.types import BIGINT, DOUBLE

    rng = np.random.RandomState(4)
    n = 500_000
    t = Table(["p", "o", "v", "k"], [
        Column(torch.from_numpy(rng.randint(0, 800, n)).to(cuda_device), BIGINT),
        Column(torch.from_numpy(rng.permutation(n)).to(cuda_device), BIGINT),
        Column(torch.from_numpy(rng.randn(n)).to(cuda_device), DOUBLE),
        Column(torch.full((n,), 3, device=cuda_device), BIGINT)])
    order = [(1, True, False)]
    cases = [("ROW_NUMBER", [], None, BIGINT, 0), ("DENSE_RANK", [], None, BIGINT, 0),
             ("SUM", [2], ("ROWS", ("PRECEDING", 6), ("CURRENT", None)), DOUBLE, 0),
             ("MIN", [2], ("ROWS", ("PRECEDING", 3), ("FOLLOWING", 3)), DOUBLE, 0),
             ("SUM", [2], ("RANGE", ("PRECEDING", 1000), ("CURRENT", None)), DOUBLE, 0),
             ("NTILE", [3], None, BIGINT, 1), ("LAG", [2, 3], None, DOUBLE, 1)]
    for op, args, frame, st, want in cases:
        W.compute_window(t, op, args, [0], order, frame, st)  # warm-up
        _, syncs = _count_syncs(
            lambda: W.compute_window(t, op, args, [0], order, frame, st))
        assert syncs == want, (op, frame, syncs)


# ---------------------------------------------------------------------------
# the compiled tier's graphs: copied inputs and threads
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_parameter_change_is_a_replay_not_a_capture(cuda_device, monkeypatch):
    """Two literal variants of one shape: one capture, then one replay,
    with the baked-literal answer (``DSQL_PARAM_PLANS=0``) bit for bit."""
    from dask_sql_tpu_torch.physical import compiled

    monkeypatch.setenv("DSQL_TIERED", "0")
    monkeypatch.setenv("DSQL_EAGER_FALLBACK", "0")
    rng = np.random.RandomState(8)
    n = 200_000
    c = Context(device=cuda_device)
    c.create_table("pt", {"k": rng.randint(0, 50, n), "x": rng.rand(n),
                          "d": rng.randint(9000, 9400, n).astype(np.int32)})
    q = "SELECT k, SUM(x) AS s, COUNT(*) AS n FROM pt WHERE x > {} GROUP BY k ORDER BY k"
    c.sql(q.format(0.25))
    before = dict(compiled.stats)
    got = c.sql(q.format(0.75))
    delta = {k: compiled.stats.get(k, 0) - before.get(k, 0)
             for k in ("graph_captures", "graph_replays", "param_plan_hits")}
    assert delta == {"graph_captures": 0, "graph_replays": 1,
                     "param_plan_hits": 1}
    monkeypatch.setenv("DSQL_PARAM_PLANS", "0")
    baked = c.sql(q.format(0.75))
    for g, w in zip(got.columns, baked.columns):
        assert _same_bits(g.data.to(torch.float64), w.data.to(torch.float64))


@pytest.mark.gpu
def test_two_threads_capture_concurrently(cuda_device):
    """Two programs warm up and capture at the same time on two threads
    (each capture on its own stream, thread-local capture mode); both
    replay to their eager answers."""
    import threading

    from dask_sql_tpu_torch.physical import graphs

    x = torch.arange(1 << 20, dtype=torch.float64, device=cuda_device)

    def f(t):
        y = t
        for i in range(200):
            y = torch.sin(y) + i
        return (y.sum(),)

    def g(t):
        y = t
        for i in range(200):
            y = torch.cos(y) * 0.5 + i
        return (y.amax(),)

    progs = [graphs.GraphProgram(f, cuda_device),
             graphs.GraphProgram(g, cuda_device)]
    barrier = threading.Barrier(2)
    errors = []

    def run(p):
        try:
            barrier.wait()
            p(x)
        except Exception as exc:   # reported below
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(p,)) for p in progs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert all(len(p.captures) == 1 for p in progs)
    for p, fn in zip(progs, (f, g)):
        got = p(x)[0].clone()
        assert torch.equal(got, fn(x)[0])


@pytest.mark.gpu
def test_eager_item_during_warm_up_does_not_raise(cuda_device):
    """Another thread's ``.item()`` while a program warms up neither raises
    nor counts against the warm-up; a synchronisation inside the warm-up
    itself is still reported as ``HostRead``."""
    import threading

    from dask_sql_tpu_torch.physical import graphs

    x = torch.arange(1000, dtype=torch.float64, device=cuda_device)
    inside = threading.Event()
    reads_done = threading.Event()

    def slow(t):
        inside.set()
        reads_done.wait(60)
        return (t * 2,)

    def reader():
        inside.wait(60)
        for _ in range(20):
            x.sum().item()
        reads_done.set()

    t = threading.Thread(target=reader)
    t.start()
    out = graphs.GraphProgram(slow, cuda_device)(x)
    t.join()
    assert torch.equal(out[0], x * 2)

    def syncs(t):
        k = torch.ones(3, device=t.device).sum().item()   # untraced data
        return (t + k,)

    with pytest.raises(graphs.HostRead, match="synchronisation"):
        graphs.GraphProgram(syncs, cuda_device)(x)


@pytest.mark.gpu
def test_streamed_batches_replay_one_graph(cuda_device, monkeypatch):
    """A chunked table of 5 batches, the last one short: a static GROUP BY
    takes at most two captures (the full and the padded last batch), the
    other batches are replays that launch kernel 1 each, and a repeated
    query captures nothing; the answer equals the CPU's."""
    from dask_sql_tpu_torch.physical import compiled

    monkeypatch.setenv("DSQL_TIERED", "0")
    monkeypatch.setenv("DSQL_EAGER_FALLBACK", "0")
    rng = np.random.RandomState(4)
    n = 4 * 65536 + 1234
    cols = {"g": rng.choice(np.array(["A", "N", "R"]), n),
            "x": np.round(rng.rand(n) * 1000, 2), "k": rng.randint(0, 9, n)}
    q = "SELECT g, SUM(x) AS s, AVG(x) AS a, COUNT(*) AS n FROM ct GROUP BY g"
    answers = {}
    for dev in (torch.device("cpu"), cuda_device):
        c = Context(device=dev)
        c.create_table("ct", cols, chunked=True, batch_rows=65536)
        gk.reset_launch_counts()
        before = dict(compiled.stats)
        answers[dev.type] = c.sql(q).to_pylist()
        delta = {k: compiled.stats.get(k, 0) - before.get(k, 0)
                 for k in ("graph_captures", "graph_replays")}
        if dev.type == "cuda":
            # 2 batch programs, 1 merge program over the partials
            assert delta["graph_captures"] <= 3, delta
            assert delta["graph_replays"] >= 3, delta
            assert gk.LAUNCHES["segsum_fixedpoint"] >= 5
            before = dict(compiled.stats)
            c.sql(q)
            assert compiled.stats["graph_captures"] == \
                before["graph_captures"]
    for want, got in zip(sorted(answers["cpu"]), sorted(answers["cuda"])):
        assert got[0] == want[0] and got[3] == want[3]
        assert got[1:3] == pytest.approx(want[1:3], rel=1e-12)
