"""IEEE reassembly for sums taken over sanitized values.

The counterpart of ``dask_sql_tpu/ops/sorted_agg.py:ieee_reassemble``: a sum
of values with NaN/+Inf/-Inf replaced by 0, plus per-group counts of each
non-finite kind, recombines to the IEEE sum (the scatter-free sorted
aggregation around it in the JAX package is not ported yet).
"""
from __future__ import annotations

import math

import torch


def ieee_reassemble(clean: torch.Tensor, nan_c: torch.Tensor,
                    pos_c: torch.Tensor, neg_c: torch.Tensor) -> torch.Tensor:
    """Recombine a sanitized sum with non-finite indicator counts."""
    out = torch.where(pos_c > 0, math.inf, clean)
    out = torch.where(neg_c > 0, -math.inf, out)
    out = torch.where((pos_c > 0) & (neg_c > 0), math.nan, out)
    return torch.where(nan_c > 0, math.nan, out)
