"""The port's fixed-point segmented sums against the JAX package's Pallas
kernel (interpret mode on the CPU) and against exact numpy oracles.

Tolerances: unit and int rows must be bit-identical to the JAX package
(both are exact integer sums when sum(|v|) <= 2**53).  Float rows may differ
by grid truncation only -- the port scales to 2**84 by ``frexp`` where the
JAX package scales to 2**83 by ``floor(log2)+2`` -- so rtol 1e-12.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dask_sql_tpu.ops import pallas_kernels as pk
from dask_sql_tpu_torch.ops import gpu_kernels as gk


def _jax(vals, codes, mask, g, classes):
    return np.asarray(pk.segmented_sums_fixedpoint(
        jnp.asarray(vals), jnp.asarray(codes), jnp.asarray(mask), g,
        row_classes=classes, interpret=True))


def _port(vals, codes, mask, g, classes, **kw):
    return gk.segmented_sums_fixedpoint(
        torch.from_numpy(np.asarray(vals, dtype=np.float64)),
        torch.from_numpy(np.asarray(codes)), torch.from_numpy(np.asarray(mask)),
        g, row_classes=classes, **kw).numpy()


def _same_bits(a, b):
    return np.array_equal(np.asarray(a, np.float64).view(np.int64),
                          np.asarray(b, np.float64).view(np.int64))


@pytest.mark.parametrize("n,g,a,vs_jax", [(100, 3, 1, False),
                                           (5000, 25, 3, True),
                                           (9000, 8, 2, False)])
def test_exact_int_rows_bitwise_vs_int_oracle_and_jax(n, g, a, vs_jax):
    rng = np.random.RandomState(11)
    vals = rng.randint(-10**9, 10**9, (a, n)).astype(np.float64)
    vals[:, 0], vals[:, 1], vals[:, 2] = 2.0**50, -(2.0**50), 2.0**50
    codes = rng.randint(0, g, n)
    mask = rng.rand(n) > 0.3
    got = gk.segmented_sums_exact(torch.from_numpy(vals), torch.from_numpy(codes),
                                  torch.from_numpy(mask), g).numpy()
    want = np.zeros((a, g), dtype=np.int64)
    vn = vals.astype(np.int64)
    for gg in range(g):
        want[:, gg] = vn[:, mask & (codes == gg)].sum(axis=1)
    assert np.array_equal(got, want.astype(np.float64))
    if vs_jax:
        assert _same_bits(got, _jax(vals, codes, mask, g, ["int"] * a))


def test_mixed_row_classes_vs_jax():
    """unit and int rows bit-identical to the JAX kernel; float rows within
    rtol 1e-12 of it and of the f64 oracle."""
    rng = np.random.RandomState(3)
    n, g = 2048 + 37, 6
    vals = np.vstack([
        rng.randint(-10**9, 10**9, n).astype(np.float64),
        rng.randn(n) * 1e3,
        (rng.rand(n) > 0.5).astype(np.float64),
    ])
    codes = rng.randint(0, g, n)
    mask = rng.rand(n) > 0.2
    classes = ["int", "float", "unit"]
    got = _port(vals, codes, mask, g, classes)
    want = _jax(vals, codes, mask, g, classes)
    assert _same_bits(got[0], want[0])
    assert _same_bits(got[2], want[2])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-12)
    oracle = gk.reference_segmented_sums(
        torch.from_numpy(vals), torch.from_numpy(codes), torch.from_numpy(mask),
        g).numpy()
    np.testing.assert_allclose(got[1], oracle[1], rtol=1e-12)


_NAN, _INF = np.nan, np.inf


@pytest.mark.parametrize("vals,codes,mask,classes,want", [
    ([[_NAN, 1.0, 2.0, 3.0, _INF, -_INF, 5.0, 6.0]],
     [0, 1, 1, 1, 2, 3, 4, 4], [1] * 8, ["float"],
     [[_NAN, 6.0, _INF, -_INF, 11.0]]),
    ([[_NAN, 1.0, 2.0]], [0, 0, 1], [0, 1, 1], ["float"], [[1.0, 2.0]]),
    ([[_INF, -_INF, 1.0]], [0, 0, 1], [1, 1, 1], ["float"], [[_NAN, 1.0]]),
    ([[1.0, _NAN, 3.0, _INF, 5.0]], [0, 0, 1, 1, 1], [1, 0, 1, 0, 1], ["int"],
     [[1.0, 8.0]]),
    ([[1.0, _INF, 2.0, 4.0]], [0, 0, 1, 1], [1, 1, 1, 1], ["int"],
     [[_INF, 6.0]]),
], ids=["isolated", "masked-nan", "posneg-inf", "int-masked", "int-poison"])
def test_nonfinite_isolated_to_their_groups(vals, codes, mask, classes, want):
    got = _port(np.asarray(vals, dtype=np.float64), np.asarray(codes),
                np.asarray(mask, dtype=bool), len(want[0]), classes)
    assert _same_bits(got, np.asarray(want, dtype=np.float64))


def test_nonfinite_mixed_rows_vs_jax():
    rng = np.random.RandomState(9)
    n, g = 600, 5
    vals = np.vstack([rng.randn(n), rng.randint(-99, 99, n), rng.rand(n) > 0.5]
                     ).astype(np.float64)
    for row, col, v in [(0, 3, _NAN), (0, 10, _INF), (1, 11, -_INF),
                        (1, 12, _INF), (2, 20, _NAN), (0, 21, -_INF)]:
        vals[row, col] = v
    codes = rng.randint(0, g, n)
    mask = rng.rand(n) > 0.1
    mask[12] = False
    classes = ["float", "int", "unit"]
    got = _port(vals, codes, mask, g, classes)
    want = _jax(vals, codes, mask, g, classes)
    assert _same_bits(got[1:], want[1:])
    assert _same_bits(np.isnan(got[0]), np.isnan(want[0]))
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12)


@pytest.mark.parametrize("m", [1e-200, 1.0, 1e200])
def test_tiny_and_huge_magnitudes(m):
    vals = np.asarray([[m, 2 * m, -m, 3 * m]])
    codes, mask = np.asarray([0, 0, 1, 1]), np.ones(4, bool)
    got = _port(vals, codes, mask, 2, ["float"])
    np.testing.assert_allclose(got, [[3 * m, 2 * m]], rtol=1e-12)
    np.testing.assert_allclose(got, _jax(vals, codes, mask, 2, ["float"]),
                               rtol=1e-12)


def test_float_rows_within_grid_bound_of_true_sum():
    """Float rows over 12 orders of magnitude: within ~1 ulp of the true sum
    (float128 oracle) plus the grid bound n * max|v| * 2**-83."""
    rng = np.random.RandomState(7)
    n, g = 20000, 4
    vals = (rng.randn(2, n) * 10.0 ** rng.randint(-6, 7, (2, n)))
    codes = rng.randint(0, g, n)
    mask = rng.rand(n) > 0.1
    got = _port(vals, codes, mask, g, ["float", "float"])
    for i in range(2):
        for gg in range(g):
            sel = mask & (codes == gg)
            want = vals[i, sel].astype(np.float128).sum()
            tol = (2.0 * abs(float(want)) * 2.0 ** -52
                   + sel.sum() * np.abs(vals[i, sel]).max() * 2.0 ** -83)
            assert abs(float(want) - got[i, gg]) <= tol


def test_zero_rows_and_empty_input():
    z = _port(np.zeros((2, 5)), np.zeros(5, np.int32), np.ones(5, bool), 3,
              ["float", "int"])
    assert np.array_equal(z, np.zeros((2, 3)))
    e = _port(np.zeros((2, 0)), np.zeros(0, np.int32), np.ones(0, bool), 3,
              ["float", "int"])
    assert np.array_equal(e, np.zeros((2, 3)))
    assert _same_bits(e, _jax(np.zeros((2, 0)), np.zeros(0, np.int32),
                              np.ones(0, bool), 3, ["float", "int"]))


def test_masked_outlier_does_not_coarsen_grid():
    vals = np.asarray([[1.0, 2.0, 1e300, 3.0]])
    codes, mask = np.asarray([0, 0, 1, 1]), np.asarray([True, True, False, True])
    got = _port(vals, codes, mask, 2, ["float"])
    np.testing.assert_allclose(got, [[3.0, 3.0]], rtol=1e-12)
    assert _same_bits(got, _jax(vals, codes, mask, 2, ["float"]))


@pytest.mark.parametrize("n,vs_jax", [(1, False), (4095, False), (4097, True),
                                      (3 * 4096 + 5, False)])
def test_padding_rows_do_not_leak(n, vs_jax):
    """n not a multiple of the TPU kernel's 4096-row block."""
    vals = np.ones((2, n))
    codes, mask = np.zeros(n, np.int64), np.ones(n, bool)
    got = _port(vals, codes, mask, 2, ["unit", "int"])
    assert got[0, 0] == n and got[1, 0] == n and got[0, 1] == 0
    if vs_jax:
        assert _same_bits(got, _jax(vals, codes, mask, 2, ["unit", "int"]))


def test_int_rows_near_2_53_are_exact():
    vals = np.asarray([[2.0**52, 2.0**52 - 1, -(2.0**51), 7.0]])
    codes, mask = np.asarray([0, 1, 1, 0]), np.ones(4, bool)
    got = _port(vals, codes, mask, 2, ["int"])
    assert got[0, 0] == 2.0**52 + 7 and got[0, 1] == 2.0**52 - 1 - 2.0**51
    assert _same_bits(got, _jax(vals, codes, mask, 2, ["int"]))


def test_codes_outside_domain_contribute_nothing():
    vals = np.asarray([[1.0, 2.0, 4.0, 8.0]])
    got = _port(vals, np.asarray([0, 5, -1, 1]), np.ones(4, bool), 2, ["int"])
    assert np.array_equal(got, [[1.0, 8.0]])


def test_cpu_tensors_never_touch_the_kernel():
    gk.reset_launch_counts()
    rng = np.random.RandomState(0)
    vals = torch.from_numpy(rng.randn(3, 500))
    codes = torch.from_numpy(rng.randint(0, 4, 500))
    mask = torch.ones(500, dtype=torch.bool)
    gk.segmented_sums_dispatch(vals, codes, mask, 4,
                               row_classes=["float", "int", "unit"])
    assert gk.LAUNCHES["segsum_fixedpoint"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        gk.segsum_limb_totals_cuda(vals, codes.int(), mask.to(torch.uint8),
                                   torch.ones(3, dtype=torch.float64),
                                   ["float", "int", "unit"], 4)


def test_pow2_is_exact_over_full_range():
    e = np.arange(-1022, 1024)
    got = gk._pow2(torch.from_numpy(e)).numpy()
    assert (got == np.ldexp(np.ones(len(e)), e)).all()


def test_limb_totals_plain_matches_int_oracle():
    """The plain version of the kernel's function: integer limb totals that
    recombine exactly (here checked limb by limb for one int row)."""
    vals = torch.tensor([[5.0 * 2**42 + 3 * 2**21 + 7, -9.0]], dtype=torch.float64)
    codes = torch.tensor([0, 0], dtype=torch.int32)
    mask = torch.ones(2, dtype=torch.uint8)
    limbs, nonfinite = gk.segsum_limb_totals_plain(
        vals, codes, mask, torch.ones(1, dtype=torch.float64), ["int"], 1)
    assert limbs[:, 0].tolist() == [7, 3, 5, 9, 0, 0]
    assert nonfinite.abs().sum() == 0


@pytest.mark.parametrize("classes,g,tiles,private", [
    (["unit"] + ["float", "unit"] * 8, 6, 1, True),
    (["unit"] + ["float", "unit"] * 8, 256, 1, False),
    (["float"] * 20, 256, 2, False),
    (["float"] * 40, 6, 2, True),
])
def test_kernel_tiles_fit_shared_memory(classes, g, tiles, private):
    """Per-warp accumulators while a row's share fits PRIVATE_BUDGET (Q1's
    6 slots), block-shared ones under SMEM_BUDGET above it (256 slots)."""
    starts, largest, is_private = gk._kernel_tiles(classes, g)
    assert len(starts) - 1 == tiles and starts[-1] == len(classes)
    assert is_private == private
    assert largest <= (gk.PRIVATE_BUDGET if private else gk.SMEM_BUDGET)


def test_kernel_tiles_reject_oversized_row():
    with pytest.raises(ValueError, match="shared memory"):
        gk._kernel_tiles(["float"], 4096)


def test_layout_cache_reuses_tensors_per_key():
    """The per-layout index tensors are built once per (row classes, groups,
    device): the same key gives the same tensors, another layout others, and
    the sums do not change when the cache is warm or cleared."""
    cpu = torch.device("cpu")
    q1 = ("unit", "float", "unit", "int")
    lay = gk._row_layout(q1, cpu)
    assert gk._row_layout(q1, cpu) is lay
    other = gk._row_layout(("unit", "float"), cpu)
    assert other is not lay and other.src.shape != lay.src.shape
    plan = gk._kernel_plan(q1, 6, cpu)
    assert gk._kernel_plan(q1, 6, cpu) is plan
    assert gk._kernel_plan(q1, 7, cpu) is not plan
    limbs, _, out0 = gk.limb_layout(q1)
    assert plan.meta.tolist() == limbs + out0 + [0, len(q1)]
    assert lay.float_rows.tolist() == [1]

    rng = np.random.RandomState(4)
    n = 3000
    vals = np.vstack([rng.rand(n) > 0.5, rng.randn(n) * 1e3, rng.rand(n) > 0.5,
                      rng.randint(-10**6, 10**6, n)]).astype(np.float64)
    codes, mask = rng.randint(0, 6, n), rng.rand(n) > 0.1
    warm = _port(vals, codes, mask, 6, list(q1))
    gk._row_layout.cache_clear()
    gk._kernel_plan.cache_clear()
    cold = _port(vals, codes, mask, 6, list(q1))
    assert _same_bits(warm, cold)
    assert _same_bits(warm, _port(vals, codes, mask, 6, list(q1)))
