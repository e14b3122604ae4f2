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
