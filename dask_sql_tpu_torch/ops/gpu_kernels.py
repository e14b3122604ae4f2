"""The segmented sums: two hand-written Hopper kernels and their plain
PyTorch versions.

Kernel 1, ``segsum_fixedpoint`` (below), carries the static-domain GROUP BY
of the engine.  Kernel 2, ``segsum_accumulate`` (after it), is the sum
accumulated in the input precision behind ``segmented_sums`` and the
float32 branch of ``segmented_sums_dispatch``.

``SELECT agg(x) ... GROUP BY k`` over a small static key domain (the TPC-H
Q1 shape) reduces to masked per-group sums of A value rows:

    out[a, g] = sum over rows i with codes[i] == g and mask[i] of vals[a, i]

The JAX package computes them on the TPU with the Pallas kernel
``_seg_matmul_perblock_kernel`` (``dask_sql_tpu/ops/pallas_kernels.py``):
exact fixed-point ("limb") sums.  The port keeps the contract and changes
the grid to suit the card (see ``csrc/segsum_fixedpoint.cu``):

- every value becomes sign-split 21-bit integer limbs on a fixed-point
  grid: 1 limb for a ``unit`` row (0/1 streams), 3 per sign for an ``int``
  row (|v| < 2**53), 4 per sign for a ``float`` row, which is first scaled by
  the exact power of two 2**k that puts its masked abs-max just below 2**84;
- the (limb row, group) totals are integer sums in int64 -- exact and
  independent of summation order;
- the totals recombine with exact power-of-two weights and Neumaier
  compensation, and NaN/+Inf/-Inf counts restore IEEE semantics.

Unit and int rows of kernel 1 are therefore bit-exact whenever sum(|v|) <= 2**53, as in
the JAX package; float rows are within one unit of 2**(e-84) per value,
where 2**e bounds the row's masked abs-max.

One function differs between the card and the CPU: the limb totals.
``segsum_limb_totals`` launches the CUDA kernel for a CUDA tensor and runs
``segsum_limb_totals_plain`` for a CPU tensor; everything around it (grid
exponents, layout, recombination) is shared, so the kernel and the plain
version give bit-identical results on the same inputs.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from .sorted_agg import ieee_reassemble

LIMB_BITS = 21
LIMB_BASE = float(1 << LIMB_BITS)
INV_LIMB_BASE = 1.0 / LIMB_BASE           # exact power of two
# float rows are scaled so that |v| * 2**k < 2**GRID_BITS: 4 limbs per sign
GRID_BITS = 84
CLASS_LIMBS = {"unit": 1, "int": 3, "float": GRID_BITS // LIMB_BITS}
# a limb total is below n * 2**21; n < 2**32 keeps it below 2**53, so every
# total converts to f64 exactly (and stays far from int64 overflow)
MAX_ROWS = 1 << 32
# shared memory one block of the kernel may use for its accumulators
SMEM_BUDGET = 200 * 1024
# kernel 1 gives each warp its own accumulators when a row's share fits this
# (kept small so that several blocks stay resident on an SM)
PRIVATE_BUDGET = 64 * 1024
_K1_WARPS = 8

#: launches of each hand-written kernel; only the kernel wrappers add to it
#: (``count_launch``), and ``physical/graphs.py`` once per replay for the
#: launches a CUDA graph holds
LAUNCHES: Dict[str, int] = {"segsum_fixedpoint": 0, "segsum_accumulate": 0}
_launch_lock = threading.Lock()
_launch_tls = threading.local()

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SOURCES = {name: _CSRC / f"{name}.cu" for name in LAUNCHES}
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def reset_launch_counts() -> None:
    with _launch_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def count_launch(name: str) -> None:
    """One launch of kernel ``name`` on this thread: into ``LAUNCHES``, or,
    while this thread captures a CUDA graph (``recording_launches``), into
    the capture's own record."""
    rec = getattr(_launch_tls, "record", None)
    if rec is not None:
        rec[name] = rec.get(name, 0) + 1
        return
    with _launch_lock:
        LAUNCHES[name] += 1


def add_launches(counts: Dict[str, int]) -> None:
    """A graph replay: the launches its capture recorded."""
    with _launch_lock:
        for name, n in counts.items():
            LAUNCHES[name] += n


# a program's warm-up under DSQL_PROFILE counts its work (the cost count of
# ``physical/graphs.py``, installed on this thread by ``counting_work``)
_work_tls = threading.local()


@contextmanager
def counting_work(count):
    """Install ``count`` (an object with ``suspended`` and ``kernel(name,
    nbytes, flops)``) as this thread's work count for the block."""
    prev = getattr(_work_tls, "count", None)
    _work_tls.count = count
    try:
        yield count
    finally:
        _work_tls.count = prev


@contextmanager
def kernel_work(name: str, work):
    """The block computes the function of hand kernel ``name``: under a
    work count, its ops (the launch's own, or the plain version's on the
    CPU) are hidden from the count, and the function's work, ``work()``
    -> (bytes, operations), is added as one record when the block
    succeeds (the bytes its bound counts: each input read once, each
    output written once), so the count of a program is the same whichever
    of the two ran.  Without a count the block runs as it is."""
    count = getattr(_work_tls, "count", None)
    if count is None:
        yield
        return
    count.suspended += 1
    try:
        yield
    finally:
        count.suspended -= 1
    count.kernel(name, *work())


@contextmanager
def recording_launches():
    """Launches made on this thread in the block are recorded in the
    yielded dict instead of ``LAUNCHES``: a capture records kernels into a
    graph, which launches them once per replay.  Other threads count as
    usual."""
    prev = getattr(_launch_tls, "record", None)
    rec: Dict[str, int] = {}
    _launch_tls.record = rec
    try:
        yield rec
    finally:
        _launch_tls.record = prev


# cached uploads: device tensors that a cache of this process filled from
# the host (kernel 1's layouts below, the string byte matrices of
# ``strings_fast``), each with its host source.  A program's warm-up notes
# the ones it reads (``noting_cached``), so that its build record carries
# them (``physical/graphs.py``): a process whose cache is cold makes those
# copies inside the capture taken from the record
_uploads: Dict[int, tuple] = {}
_note_tls = threading.local()


def cached_upload(host: torch.Tensor, device) -> torch.Tensor:
    """``host`` copied to ``device`` for a cache, remembered with its host
    source while the copy lives."""
    dev = host.to(device)
    if dev.is_cuda:
        k = id(dev)

        def forget(ref, k=k):
            hit = _uploads.get(k)
            if hit is not None and hit[0] is ref:
                _uploads.pop(k, None)

        _uploads[k] = (weakref.ref(dev, forget), host)
    return dev


@contextmanager
def noting_cached(note):
    """While the block runs on this thread, ``note(device tensor, host
    source)`` for every cached upload it reads (``note_cached``); None
    notes nothing."""
    prev = getattr(_note_tls, "note", None)
    _note_tls.note = note
    try:
        yield
    finally:
        _note_tls.note = prev


def note_cached(*tensors) -> None:
    """The caller read these cached tensors (a cache hit)."""
    note = getattr(_note_tls, "note", None)
    if note is None:
        return
    for t in tensors:
        hit = None if t is None else _uploads.get(id(t))
        if hit is not None and hit[0]() is t:
            note(t, hit[1])


# ---------------------------------------------------------------------------
# shared pieces: exact powers of two, grid exponents, limb layout
# ---------------------------------------------------------------------------

def _pow2(e: torch.Tensor) -> torch.Tensor:
    """Exact 2.0**e (float64) for integer e in [-1022, 1023], built from the
    IEEE bit pattern."""
    return ((e.to(torch.int64) + 1023) << 52).view(torch.float64)


def _grid_exponents(vals: torch.Tensor, mask: torch.Tensor,
                    row_classes: Sequence[str]) -> torch.Tensor:
    """Per-row k (int64): the float rows' values are scaled by 2**k.

    k = 84 - e with 2**(e-1) <= absmax < 2**e (``frexp``), where absmax is
    taken over the finite values of rows that contribute (mask) only: a huge
    value in a filtered-out row must not coarsen the grid for the others.
    k is clipped so that every scale and recombination weight stays a
    normal power of two; rows with absmax 0, and unit/int rows, take k = 0.
    """
    a = vals.shape[0]
    k = torch.zeros(a, dtype=torch.int64, device=vals.device)
    idx = _noted(_row_layout(tuple(row_classes), vals.device)).float_rows
    if idx is None:
        return k
    fv = vals.index_select(0, idx)
    keep = mask.bool()[None, :] & torch.isfinite(fv)
    absmax = torch.where(keep, fv.abs(), 0.0).amax(dim=1)
    _, ex = torch.frexp(absmax)
    kf = torch.where(absmax > 0, (GRID_BITS - ex.to(torch.int64)).clamp(-940, 1000),
                     0)
    return k.index_copy(0, idx, kf)


def limb_layout(row_classes: Sequence[str]) -> Tuple[List[int], List[int],
                                                     List[int]]:
    """(limbs per sign, signed flag, first limb row) per value row, plus the
    total limb-row count as the last entry of the third list.  Row i owns
    limb rows [out0[i], out0[i+1]): the positive half's limbs 0..L-1, then,
    for signed rows, the negative half's."""
    limbs, signed, out0 = [], [], [0]
    for c in row_classes:
        n_limbs = CLASS_LIMBS[c]
        is_signed = c != "unit"
        limbs.append(n_limbs)
        signed.append(int(is_signed))
        out0.append(out0[-1] + n_limbs * (2 if is_signed else 1))
    return limbs, signed, out0


# ---------------------------------------------------------------------------
# the limb totals: plain version and kernel
# ---------------------------------------------------------------------------

def segsum_limb_totals_plain(vals: torch.Tensor, codes: torch.Tensor,
                             mask: torch.Tensor, scale: torch.Tensor,
                             row_classes: Sequence[str], num_groups: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, on any device.

    vals (A, n) f64, codes (n,) int32, mask (n,) uint8, scale (A,) f64.
    Returns (limb totals (L, G) int64, non-finite counts (3*A, G) int64:
    NaN rows, then +Inf rows, then -Inf rows).  As in the JAX package, the
    non-finite values are zeroed and 3*A indicator rows of class 'unit' are
    summed alongside; rows whose code is outside [0, G) contribute nothing.
    """
    a, _ = vals.shape
    g = num_groups
    keep = (mask != 0) & (codes >= 0) & (codes < g)
    index = codes.long().clamp(0, g - 1)
    isnan = torch.isnan(vals)
    ispos = torch.isposinf(vals)
    isneg = torch.isneginf(vals)
    clean = torch.where(isnan | ispos | isneg, 0.0, vals)
    stacked = torch.cat([clean, isnan.double(), ispos.double(), isneg.double()])
    classes = list(row_classes) + ["unit"] * (3 * a)
    scales = torch.cat([scale, torch.ones(3 * a, dtype=torch.float64,
                                          device=vals.device)])
    limbs, signed, out0 = limb_layout(classes)
    totals = torch.zeros((out0[-1], g), dtype=torch.int64, device=vals.device)
    for i in range(stacked.shape[0]):
        v = torch.where(keep, stacked[i], 0.0) * scales[i]
        halves = [v.clamp_min(0.0).floor()]
        if signed[i]:
            halves.append((-v).clamp_min(0.0).floor())
        r = out0[i]
        for h in halves:
            for _ in range(limbs[i]):
                q = (h * INV_LIMB_BASE).floor()
                totals[r].index_add_(0, index, (h - q * LIMB_BASE).to(torch.int64))
                h = q
                r += 1
    n_limb_rows = out0[a]
    return totals[:n_limb_rows], totals[n_limb_rows:]


def _kernel_tiles(row_classes: Sequence[str], num_groups: int
                  ) -> Tuple[List[int], int, bool]:
    """Plan the kernel's shared memory: (tile start rows + the end row, the
    largest tile's bytes, whether each warp owns its accumulators).

    A warp owns its accumulators when every row's share of them (8 warps of
    u64 limb totals) fits PRIVATE_BUDGET; otherwise the block shares one set
    under SMEM_BUDGET.  Either way each row also takes 3 u32 non-finite
    counts per group and 16 bytes of metadata, and the value rows are split
    into tiles (over ``blockIdx.y``) whose shared memory fits the budget."""
    def need(c: str, warps: int) -> int:
        limb_rows = CLASS_LIMBS[c] * (2 if c != "unit" else 1)
        return limb_rows * num_groups * 8 * warps + 3 * num_groups * 4 + 16

    private = all(need(c, _K1_WARPS) <= PRIVATE_BUDGET for c in row_classes)
    budget, warps = (PRIVATE_BUDGET, _K1_WARPS) if private else (SMEM_BUDGET, 1)
    starts, largest, used = [0], 0, 0
    for i, c in enumerate(row_classes):
        row_bytes = need(c, warps)
        if row_bytes > budget:
            raise ValueError(
                f"segsum_fixedpoint: {num_groups} groups need {row_bytes} bytes "
                f"of shared memory for one {c} row (budget {budget})")
        if used + row_bytes > budget:
            starts.append(i)
            used = 0
        used += row_bytes
        largest = max(largest, used)
    starts.append(len(row_classes))
    return starts, largest, private


class _RowLayout(NamedTuple):
    """A row-class layout's index tensors on one device: the float rows
    (None without any), and the recombination's gather index, limb index and
    sign, each (A, width)."""
    float_rows: Optional[torch.Tensor]
    src: torch.Tensor
    limb: torch.Tensor
    sign: torch.Tensor


class _KernelPlan(NamedTuple):
    """The kernel's int32 metadata on the device and its launch plan."""
    meta: torch.Tensor
    n_tiles: int
    smem: int
    private: bool


# Both are built once per key and shared between calls (never written), so
# that a warm call copies nothing from the host: each ``torch.tensor`` on a
# card is a synchronising copy.

@functools.lru_cache(maxsize=256)
def _row_layout(row_classes: Tuple[str, ...], device: torch.device) -> _RowLayout:
    a = len(row_classes)
    float_rows = [i for i, c in enumerate(row_classes) if c == "float"]
    limbs, signed, out0 = limb_layout(row_classes)
    width = max((limbs[i] * (1 + signed[i]) for i in range(a)), default=0)
    src = [[out0[-1]] * width for _ in range(a)]   # out0[-1]: the zero row
    lk = [[0] * width for _ in range(a)]
    sign = [[0.0] * width for _ in range(a)]
    for i in range(a):
        for j in range(limbs[i] * (1 + signed[i])):
            src[i][j] = out0[i] + j
            lk[i][j] = j % limbs[i]
            sign[i][j] = 1.0 if j < limbs[i] else -1.0

    def up(rows, dtype):
        return cached_upload(torch.tensor(rows, dtype=dtype).reshape(a, width),
                             device)

    return _RowLayout(
        cached_upload(torch.tensor(float_rows, dtype=torch.int64), device)
        if float_rows else None,
        up(src, torch.int64), up(lk, torch.int64), up(sign, torch.float64))


@functools.lru_cache(maxsize=256)
def _kernel_plan(row_classes: Tuple[str, ...], num_groups: int,
                 device: torch.device) -> _KernelPlan:
    limbs, _, out0 = limb_layout(row_classes)
    tiles, smem, private = _kernel_tiles(row_classes, num_groups)
    meta = cached_upload(torch.tensor(limbs + out0 + tiles, dtype=torch.int32),
                         device)
    return _KernelPlan(meta, len(tiles) - 1, smem, private)


def _noted(cached):
    """A cache hit's tuple, its tensors noted (``note_cached``)."""
    note_cached(*(t for t in cached if isinstance(t, torch.Tensor)))
    return cached


def segsum_limb_totals_cuda(vals: torch.Tensor, codes: torch.Tensor,
                            mask: torch.Tensor, scale: torch.Tensor,
                            row_classes: Sequence[str], num_groups: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/segsum_fixedpoint.cu`` on the tensors' CUDA device.

    Same arguments and results as ``segsum_limb_totals_plain``.  Raises on
    any input the kernel does not take, and when the launch fails."""
    a, n = vals.shape
    dev = vals.device
    if dev.type != "cuda":
        raise ValueError(f"segsum_fixedpoint kernel needs CUDA tensors, got {dev}")
    for name, t, dtype, shape in (("vals", vals, torch.float64, (a, n)),
                                  ("codes", codes, torch.int32, (n,)),
                                  ("mask", mask, torch.uint8, (n,)),
                                  ("scale", scale, torch.float64, (a,))):
        if t.device != dev:
            raise ValueError(f"segsum_fixedpoint: {name} on {t.device}, vals on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"segsum_fixedpoint: {name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"segsum_fixedpoint: {name} shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"segsum_fixedpoint: {name} must be contiguous")
    if len(row_classes) != a:
        raise ValueError(f"{len(row_classes)} row classes for {a} rows")
    if n >= MAX_ROWS:
        raise ValueError(f"segsum_fixedpoint: {n} rows, limit {MAX_ROWS - 1}")
    out0 = limb_layout(row_classes)[2]
    out_limbs = torch.zeros((out0[-1], num_groups), dtype=torch.int64, device=dev)
    out_nonfinite = torch.zeros((3 * a, num_groups), dtype=torch.int64, device=dev)
    if n == 0 or a == 0:
        return out_limbs, out_nonfinite
    plan = _noted(_kernel_plan(tuple(row_classes), num_groups, dev))
    lib = _load_library("segsum_fixedpoint")
    stream = torch.cuda.current_stream(dev).cuda_stream
    # the entry point launches on the calling thread's current device (a
    # worker thread's is cuda:0 unless set)
    with torch.cuda.device(dev):
        rc = lib.dsql_segsum_fixedpoint(
            vals.data_ptr(), n, a, codes.data_ptr(), mask.data_ptr(),
            scale.data_ptr(), plan.meta.data_ptr(), plan.n_tiles,
            num_groups, int(plan.private), plan.smem, out_limbs.data_ptr(),
            out_nonfinite.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"segsum_fixedpoint launch failed: CUDA error {rc}")
    count_launch("segsum_fixedpoint")
    return out_limbs, out_nonfinite


def segsum_fixedpoint_work(a: int, n: int, row_classes: Sequence[str],
                           num_groups: int) -> Tuple[int, int]:
    """(bytes, operations) of kernel 1's function: vals (f64), codes
    (int32), mask (uint8) and scale (f64) read once, the limb and
    non-finite totals (int64) written once; one add per value."""
    n_limb_rows = limb_layout(row_classes)[2][-1]
    return (a * n * 8 + n * 4 + n + a * 8
            + (n_limb_rows + 3 * a) * num_groups * 8, a * n)


def segsum_limb_totals(vals, codes, mask, scale, row_classes, num_groups):
    """The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    a, n = vals.shape
    with kernel_work("segsum_fixedpoint", lambda: segsum_fixedpoint_work(
            a, n, row_classes, num_groups)):
        if vals.device.type == "cuda":
            return segsum_limb_totals_cuda(vals, codes, mask, scale,
                                           row_classes, num_groups)
        if vals.device.type == "cpu":
            return segsum_limb_totals_plain(vals, codes, mask, scale,
                                            row_classes, num_groups)
        raise ValueError(
            f"segsum_fixedpoint: no kernel for device {vals.device}")


# ---------------------------------------------------------------------------
# the full segmented sums
# ---------------------------------------------------------------------------

def _recombine(totals: torch.Tensor, row_classes: Sequence[str],
               k: torch.Tensor) -> torch.Tensor:
    """(A, G) f64 sums from (L, G) int64 limb totals: limb total * +-2**(21*lk
    - k[row]) -- every product exact -- added per row in layout order with
    Neumaier compensation, all rows at once."""
    g = totals.shape[1]
    dev = totals.device
    lay = _noted(_row_layout(tuple(row_classes), dev))
    a, width = lay.src.shape
    ext = torch.cat([totals, torch.zeros((1, g), dtype=totals.dtype, device=dev)])
    weight = _pow2(LIMB_BITS * lay.limb - k[:, None]) * lay.sign
    terms = ext[lay.src].double() * weight[:, :, None]         # (A, width, G)
    s = torch.zeros((a, g), dtype=torch.float64, device=dev)
    c = torch.zeros_like(s)
    for j in range(width):
        term = terms[:, j]
        t = s + term
        c = c + torch.where(s.abs() >= term.abs(), (s - t) + term, (term - t) + s)
        s = t
    return s + c


def segmented_sums_fixedpoint(vals: torch.Tensor, codes: torch.Tensor,
                              mask: torch.Tensor, num_groups: int, *,
                              row_classes: Optional[Sequence[str]] = None,
                              limb_totals=segsum_limb_totals) -> torch.Tensor:
    """Exact masked segmented sums (A, num_groups) float64 of ``vals`` (A, n)
    over ``codes`` (n,) and ``mask`` (n,) bool, on the limb grid.

    ``row_classes`` (default all ``float``) picks each row's grid, as in
    the JAX package.  ``limb_totals`` is the function that sums the limbs:
    by default the kernel on the card and the plain version on the CPU;
    ``segsum_limb_totals_plain`` runs the plain version on any device."""
    a, n = vals.shape
    cls = ["float"] * a if row_classes is None else list(row_classes)
    if len(cls) != a:
        raise ValueError(f"{len(cls)} row classes for {a} rows")
    dev = vals.device
    if n == 0 or a == 0:
        return torch.zeros((a, num_groups), dtype=torch.float64, device=dev)
    if n >= MAX_ROWS:
        raise ValueError(f"segmented_sums_fixedpoint: {n} rows, limit {MAX_ROWS - 1}")
    vals = vals.to(torch.float64).contiguous()
    codes = codes.to(torch.int32).contiguous()
    mask = mask.to(torch.uint8).contiguous()
    k = _grid_exponents(vals, mask, cls)
    limb_tot, nonfinite = limb_totals(vals, codes, mask, _pow2(k), cls, num_groups)
    sums = _recombine(limb_tot, cls, k)
    return ieee_reassemble(sums, nonfinite[:a], nonfinite[a:2 * a],
                           nonfinite[2 * a:])


def segmented_sums_exact(vals: torch.Tensor, codes: torch.Tensor,
                         mask: torch.Tensor, num_groups: int,
                         **kw) -> torch.Tensor:
    """The all-'int' case of segmented_sums_fixedpoint (bit-exact whenever
    sum(|v|) <= 2**53)."""
    return segmented_sums_fixedpoint(vals, codes, mask, num_groups,
                                     row_classes=["int"] * vals.shape[0], **kw)


def segmented_sums_dispatch(vals: torch.Tensor, codes: torch.Tensor,
                            mask: torch.Tensor, num_groups: int,
                            row_classes=None) -> torch.Tensor:
    """The segmented-sum policy of the JAX package, with the card in the
    TPU's place: a float32 stack on the card goes to kernel 2 (sums
    accumulated in float32); any other stack to the fixed-point sums
    (kernel 1 on the card, its plain version on the CPU).  The engine's
    static-domain route always stacks float64."""
    if vals.device.type == "cuda" and vals.dtype == torch.float32:
        return segmented_sums(vals, codes, mask, num_groups)
    return segmented_sums_fixedpoint(vals, codes, mask, num_groups,
                                     row_classes=row_classes)


# ---------------------------------------------------------------------------
# kernel 2: sums accumulated in the input precision
# ---------------------------------------------------------------------------

#: rows per tile of kernel 2's plain version (the TPU kernel's BLOCK)
ACC_TILE = 1024
#: rows of group codes one block of kernel 2 stages in shared memory
ACC_STAGE = 8192
_ACC_WARPS = 8
# blocks of kernel 2 take group slices over ``blockIdx.y``, at most 65535
_MAX_GRID_Y = 65535


def segsum_accumulate_plain(vals: torch.Tensor, codes: torch.Tensor,
                            mask: torch.Tensor, num_groups: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``csrc/segsum_accumulate.cu``, on any device.

    vals (A, n) float32 or float64, codes (n,) ints, mask (n,) bool/uint8.
    Returns (sums (A, G) in the dtype of ``vals`` over the finite values,
    non-finite counts (3*A, G) int64: NaN rows, then +Inf, then -Inf).
    Rows that are masked out or whose code is outside [0, G) contribute
    nothing.  The sums are taken per 1024-row tile (the TPU kernel's block)
    and then over the tiles; within a tile the order is index_add_'s.  The
    kernel takes another fixed order, within the same error bound.
    """
    a, n = vals.shape
    g = num_groups
    dev = vals.device
    keep = (mask != 0) & (codes >= 0) & (codes < g)
    index = codes.long().clamp(0, max(g - 1, 0))
    kinds = (torch.isnan(vals), torch.isposinf(vals), torch.isneginf(vals))
    finite = ~(kinds[0] | kinds[1] | kinds[2])
    clean = torch.where(keep & finite, vals, 0.0)
    tiles = -(-n // ACC_TILE)
    slot = torch.div(torch.arange(n, device=dev), ACC_TILE,
                     rounding_mode="floor") * g + index
    partial = torch.zeros((a, tiles * g), dtype=vals.dtype, device=dev)
    partial.index_add_(1, slot, clean)
    sums = partial.view(a, tiles, g).sum(dim=1)
    counts = torch.zeros((3 * a, g), dtype=torch.int64, device=dev)
    for k, kind in enumerate(kinds):
        counts[k * a:(k + 1) * a].index_add_(1, index, (kind & keep).long())
    return sums, counts


def _acc_plan(dtype: torch.dtype, num_groups: int) -> Tuple[int, int]:
    """Kernel 2's launch plan: (groups per slice, shared-memory bytes).  Each of a block's 8 warps keeps 32 lane sums and one warp sum
    per group in shared memory, beside ACC_STAGE staged int16 codes and 3
    u32 non-finite counts per group; the groups are cut into equal slices
    (over ``blockIdx.y``) that fit SMEM_BUDGET.  Raises when the slices
    would not fit the grid."""
    itemsize = torch.finfo(dtype).bits // 8
    per_group = _ACC_WARPS * 33 * itemsize + 3 * 4
    most = (SMEM_BUDGET - 2 * ACC_STAGE) // per_group
    slices = max(1, -(-num_groups // most))
    if slices > _MAX_GRID_Y:
        raise ValueError(
            f"segsum_accumulate: {num_groups} groups need {slices} slices of "
            f"{most} {dtype} groups (at most {_MAX_GRID_Y * most} groups)")
    width = max(1, -(-num_groups // slices))
    return width, width * per_group + 2 * ACC_STAGE


def segsum_accumulate_cuda(vals: torch.Tensor, codes: torch.Tensor,
                           mask: torch.Tensor, num_groups: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/segsum_accumulate.cu`` on the tensors' CUDA device.

    Same results as ``segsum_accumulate_plain``; codes must be int32 and the
    mask uint8.  Raises on any input the kernel does not take, and when the
    launch fails."""
    a, n = vals.shape
    dev = vals.device
    if dev.type != "cuda":
        raise ValueError(f"segsum_accumulate kernel needs CUDA tensors, got {dev}")
    if vals.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"segsum_accumulate: vals must be float32 or float64, "
                        f"got {vals.dtype}")
    for name, t, dtype, shape in (("vals", vals, vals.dtype, (a, n)),
                                  ("codes", codes, torch.int32, (n,)),
                                  ("mask", mask, torch.uint8, (n,))):
        if t.device != dev:
            raise ValueError(f"segsum_accumulate: {name} on {t.device}, vals on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"segsum_accumulate: {name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"segsum_accumulate: {name} shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"segsum_accumulate: {name} must be contiguous")
    width, smem = _acc_plan(vals.dtype, num_groups)
    out = torch.zeros((a, num_groups), dtype=vals.dtype, device=dev)
    nonfinite = torch.zeros((3 * a, num_groups), dtype=torch.int64, device=dev)
    if n == 0 or a == 0 or num_groups == 0:
        return out, nonfinite
    # the kernel fills the card with ranges of at most ACC_STAGE rows: no
    # more blocks per slice than stay resident (2,048 threads per SM), or
    # n / ACC_STAGE
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = max(sms * (2048 // (32 * _ACC_WARPS)), -(-n // ACC_STAGE))
    partial = torch.empty(blocks * a * num_groups, dtype=vals.dtype, device=dev)
    lib = _load_library("segsum_accumulate")
    fn = (lib.dsql_segsum_accumulate_f32 if vals.dtype == torch.float32
          else lib.dsql_segsum_accumulate_f64)
    with torch.cuda.device(dev):  # as in segsum_limb_totals_cuda
        rc = fn(vals.data_ptr(), n, a, codes.data_ptr(), mask.data_ptr(),
                num_groups, width, ACC_STAGE, smem, partial.data_ptr(),
                partial.numel(), nonfinite.data_ptr(), out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"segsum_accumulate launch failed: CUDA error {rc}")
    count_launch("segsum_accumulate")
    return out, nonfinite


def segsum_accumulate_work(a: int, n: int, element_size: int,
                           num_groups: int) -> Tuple[int, int]:
    """(bytes, operations) of kernel 2's function: vals, codes (int32)
    and mask (uint8) read once, the sums (input precision) and the
    non-finite counts (int64) written once; one add per value."""
    return (a * n * element_size + n * 4 + n + a * num_groups * element_size
            + 3 * a * num_groups * 8, a * n)


def segsum_accumulate(vals, codes, mask, num_groups):
    """The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    a, n = vals.shape
    with kernel_work("segsum_accumulate", lambda: segsum_accumulate_work(
            a, n, vals.element_size(), num_groups)):
        if vals.device.type == "cuda":
            return segsum_accumulate_cuda(vals, codes, mask, num_groups)
        if vals.device.type == "cpu":
            return segsum_accumulate_plain(vals, codes, mask, num_groups)
        raise ValueError(
            f"segsum_accumulate: no kernel for device {vals.device}")


def segmented_sums(vals: torch.Tensor, codes: torch.Tensor, mask: torch.Tensor,
                   num_groups: int, *, accumulate=segsum_accumulate
                   ) -> torch.Tensor:
    """Masked segmented sums (A, num_groups) of ``vals`` (A, n) over
    ``codes`` (n,) and ``mask`` (n,), accumulated in the dtype of ``vals``
    (float64 for integer values), with IEEE NaN/+-Inf semantics.

    The counterpart of the JAX package's ``segmented_sums``.
    ``accumulate`` is the function that sums: by default the kernel on the
    card and the plain version on the CPU; ``segsum_accumulate_plain`` runs
    the plain version on any device."""
    if not vals.dtype.is_floating_point:
        vals = vals.to(torch.float64)
    elif vals.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"segmented_sums: no accumulation in {vals.dtype}")
    a = vals.shape[0]
    sums, nonfinite = accumulate(vals.contiguous(), codes.to(torch.int32).contiguous(),
                                 mask.to(torch.uint8).contiguous(), num_groups)
    return ieee_reassemble(sums, nonfinite[:a], nonfinite[a:2 * a],
                           nonfinite[2 * a:])


def reference_segmented_sums(vals: torch.Tensor, codes: torch.Tensor,
                             mask: torch.Tensor, num_groups: int) -> torch.Tensor:
    """One ``index_add_``: the library yardstick and test oracle (masked NaN
    rows contribute nothing).  The engine never calls it."""
    out = torch.zeros((vals.shape[0], num_groups), dtype=torch.float64,
                      device=vals.device)
    return out.index_add_(1, codes.long(),
                          torch.where(mask.bool(), vals.to(torch.float64), 0.0))


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------

def _build_dir() -> Path:
    return Path(__file__).resolve().parents[2] / "build" / "dask_sql_tpu_torch"


def _library_path(name: str) -> Path:
    digest = hashlib.sha256(_SOURCES[name].read_bytes()
                            + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    return _build_dir() / f"lib{name}-{digest}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    home = os.environ.get("CUDA_HOME") or CUDA_HOME
    if not home:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return str(Path(home) / "bin" / "nvcc")


def _build_one(name: str) -> Dict[str, object]:
    out = _library_path(name)
    if out.exists():
        return {"path": str(out), "seconds": 0.0, "built": False, "log": ""}
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *_NVCC_FLAGS, "-o", tmp,
                               str(_SOURCES[name])],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name} ({proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return {"path": str(out), "seconds": time.perf_counter() - t0,
            "built": True, "log": proc.stderr}


def build_kernels() -> Dict[str, Dict[str, object]]:
    """Compile every ``csrc/*.cu`` with nvcc for sm_90a into the build
    directory, one nvcc per source, all started together (a source whose
    library exists is skipped).  Returns, per kernel, {"path", "seconds",
    "built", "log"}; ``log`` holds ptxas's register and shared-memory
    report when it built."""
    with ThreadPoolExecutor(len(_SOURCES)) as pool:
        results = dict(zip(_SOURCES, pool.map(_build_one, _SOURCES)))
    return results


# the C entry points' arguments: P pointer (or stream), l int64, i int32
_ARGTYPES = {
    "segsum_fixedpoint": {"dsql_segsum_fixedpoint": "PliPPPPiiiiPPP"},
    "segsum_accumulate": {"dsql_segsum_accumulate_f32": "PliPPiiiiPlPPP",
                          "dsql_segsum_accumulate_f64": "PliPPiiiiPlPPP"},
}
_CTYPES = {"P": ctypes.c_void_p, "l": ctypes.c_longlong, "i": ctypes.c_int}


def load_kernel_library(name: str) -> None:
    """Build (where missing) and load kernel ``name``'s library: before a
    CUDA graph capture that launches it, which must not load it itself."""
    if name in _SOURCES:
        _load_library(name)


@functools.lru_cache(maxsize=None)
def _load_library(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(_build_one(name)["path"])
    for fn_name, sig in _ARGTYPES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = [_CTYPES[c] for c in sig]
        fn.restype = ctypes.c_int
    return lib
