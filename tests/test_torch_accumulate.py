"""Kernel 2's function -- segmented sums accumulated in the input precision
-- in the port (its plain PyTorch version, which a CPU tensor takes) against
the JAX package's ``segmented_sums`` (its Pallas kernel in interpret mode).

Tolerance: an f32 sum cannot match a sum taken in another order bit for
bit, so both engines are held to the float64 sum of the same masked values,
per (row, group): |got - want| <= (1024 + ceil(n/1024)) * eps * sum|v|, the
bound of a two-level ordered sum, with eps = 2**-24 for float32 and 2**-53
for float64.  Non-finite results and empty groups (0.0) must match
exactly.  The cases are those of ``tests/unit/test_pallas_kernels.py``.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dask_sql_tpu.ops import pallas_kernels as pk
from dask_sql_tpu_torch.ops import gpu_kernels as gk

EPS = {np.float32: 2.0 ** -24, np.float64: 2.0 ** -53}


def _jax(vals, codes, mask, g):
    return np.asarray(pk.segmented_sums(jnp.asarray(vals), jnp.asarray(codes),
                                        jnp.asarray(mask), g, interpret=True))


def _port(vals, codes, mask, g):
    return gk.segmented_sums(torch.from_numpy(vals), torch.from_numpy(codes),
                             torch.from_numpy(mask), g).numpy()


def _f64_sums(vals, codes, mask, g):
    """(sum, sum of |v|) per (row, group) in float64 over the kept rows."""
    v = np.asarray(vals, np.float64)
    s = np.zeros((v.shape[0], g))
    a = np.zeros((v.shape[0], g))
    keep = mask & (codes >= 0) & (codes < g)
    for gg in range(g):
        sel = keep & (codes == gg)
        with np.errstate(invalid="ignore"):
            s[:, gg] = v[:, sel].sum(axis=1)
        a[:, gg] = np.abs(np.nan_to_num(v[:, sel], posinf=0, neginf=0)).sum(axis=1)
    return s, a


def _within_bound(got, vals, codes, mask, g, dtype):
    want, abs_sum = _f64_sums(vals, codes, mask, g)
    n = vals.shape[1]
    assert got.dtype == dtype
    fin = np.isfinite(want)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(got[~fin & ~np.isnan(want)], want[~fin & ~np.isnan(want)])
    bound = (1024 + math.ceil(n / 1024)) * EPS[dtype] * abs_sum
    with np.errstate(invalid="ignore"):
        err = np.abs(got.astype(np.float64) - want)
    assert (err[fin] <= bound[fin]).all(), float((err - bound)[fin].max())
    empty = abs_sum == 0
    assert (got[empty & fin] == 0.0).all()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,g,a", [(100, 3, 1), (1024, 8, 4), (5000, 60, 2)])
def test_plain_matches_jax_interpret(n, g, a, dtype):
    rng = np.random.RandomState(7)
    vals = (rng.randn(a, n) * 100).astype(dtype)
    codes = rng.randint(0, g, n)
    mask = rng.rand(n) > 0.3
    got = _port(vals, codes, mask, g)
    _within_bound(got, vals, codes, mask, g, dtype)
    _within_bound(_jax(vals, codes, mask, g).astype(dtype), vals, codes, mask,
                  g, dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_edge_cases_match_jax(dtype):
    cases = {
        "all_masked": (np.ones((2, 300)), np.zeros(300, np.int64),
                       np.zeros(300, bool), 4),
        "padding": (np.ones((1, pk.BLOCK + 17)), np.zeros(pk.BLOCK + 17, np.int64),
                    np.ones(pk.BLOCK + 17, bool), 2),
        "nan_inf_groups": (np.array([[np.nan, 1.0, 2.0, 3.0, np.inf, -np.inf,
                                      5.0, 6.0]]),
                           np.array([0, 1, 1, 1, 2, 3, 4, 4]), np.ones(8, bool), 5),
        "masked_nan": (np.array([[np.nan, 1.0, 2.0]]), np.array([0, 0, 1]),
                       np.array([False, True, True]), 2),
        "pos_neg_inf": (np.array([[np.inf, -np.inf, 1.0]]), np.array([0, 0, 1]),
                        np.ones(3, bool), 2),
        "out_of_range_codes": (np.ones((1, 6)), np.array([0, 1, 2, 3, -1, 9]),
                               np.ones(6, bool), 3),
    }
    for name, (v, c, m, g) in cases.items():
        v = v.astype(dtype)
        got = _port(v, c, m, g)
        want = _jax(v, c, m, g)
        assert np.array_equal(got, want.astype(dtype), equal_nan=True), name
        _within_bound(got, v, c, m, g, dtype)


def test_integer_values_sum_in_float64():
    rng = np.random.RandomState(2)
    vals = rng.randint(-1000, 1000, (3, 4000))
    codes = rng.randint(0, 5, 4000)
    mask = rng.rand(4000) > 0.5
    got = _port(vals, codes, mask, 5)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, _jax(vals, codes, mask, 5))


def test_empty_input():
    got = _port(np.zeros((3, 0), np.float32), np.zeros(0, np.int64),
                np.ones(0, bool), 4)
    assert got.shape == (3, 4) and got.dtype == np.float32 and not got.any()


def test_dispatch_keeps_cpu_float32_on_fixed_point():
    """segmented_sums_dispatch sends only a float32 stack on the card to
    kernel 2; on the CPU every stack takes the fixed-point sums."""
    rng = np.random.RandomState(4)
    vals = torch.from_numpy(rng.rand(2, 3000).astype(np.float32))
    codes = torch.from_numpy(rng.randint(0, 4, 3000))
    mask = torch.from_numpy(rng.rand(3000) > 0.2)
    got = gk.segmented_sums_dispatch(vals, codes, mask, 4)
    want = gk.segmented_sums_fixedpoint(vals, codes, mask, 4)
    assert got.dtype == torch.float64
    assert torch.equal(got, want)


def test_wrapper_raises_off_the_card():
    vals = torch.zeros((1, 4))
    codes = torch.zeros(4, dtype=torch.int32)
    mask = torch.ones(4, dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        gk.segsum_accumulate_cuda(vals, codes, mask, 2)
    with pytest.raises(TypeError, match="accumulation"):
        gk.segmented_sums(vals.half(), codes, mask, 2)
    with pytest.raises(ValueError, match="groups"):
        gk._acc_plan(torch.float64, 10**7)


@pytest.mark.parametrize("dtype,g,width,slices", [
    (torch.float32, 6, 6, 1),
    (torch.float64, 8, 8, 1),
    (torch.float32, 40, 40, 1),
    (torch.float32, 256, 128, 2),
    (torch.float64, 256, 86, 3),
    (torch.float32, 4000, 174, 23),
    (torch.float64, 2600, 87, 30),
])
def test_accumulate_plan_fits_shared_memory(dtype, g, width, slices):
    """Kernel 2 keeps 32 lane sums per group and warp in shared memory, and
    cuts the groups into equal slices over blockIdx.y as G grows."""
    w, smem = gk._acc_plan(dtype, g)
    n_slices = -(-g // w)
    assert (w, n_slices) == (width, slices)
    assert (w - 1) * n_slices < g
    assert smem <= gk.SMEM_BUDGET
    # rows per lane stay far inside the (1024 + ceil(n/1024)) chain bound
    assert gk.ACC_STAGE // (32 * 8) + 32 + 8 <= 512
