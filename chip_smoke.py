#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``dask_sql_tpu_torch``) on one card.

    python3 chip_smoke.py [--sf 1.0] [--seed 0]

Phases, in order; any failure exits non-zero before the last line:

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: compile every hand-written kernel from ``dask_sql_tpu_torch/csrc``
   with nvcc (sm_90a) and report the build time;
3. data: ``lineitem`` at ``--sf`` (SF 1 = 6.0 M rows, generated here from
   ``--seed`` with the column set and distributions of
   ``benchmarks/tpch.py``), registered on ``Context(device="cuda")``;
4. kernels: each kernel against its plain PyTorch version on the card --
   on the inputs Q1 hands it (captured from one Q1 run) and on edge cases
   -- required bit-identical; then, on Q1's inputs, its time beside the
   plain version's, one library call's, and the bound the data sheet
   allows (3.35 TB/s HBM3, 34 TFLOP/s FP64);
5. slice: TPC-H Q1 and Q6 through the Context: one cold and three warm
   runs each (Q1's cold run is the capture run of phase 4), answers checked against a numpy oracle on the host (counts
   exact, doubles to rtol 1e-12; per-group sums by ``math.fsum``), with
   the launch counts set to 0 just before and every kernel of the path
   required to have launched; then one more warm run of each under
   ``torch.profiler`` (device time by kernel, device idle share).

The last two lines are a JSON object ``{"kernels": [...]}`` and
``{"ok": true, "device": {...}}``.  Without CUDA, or without the package
beside it, the script exits non-zero and prints neither.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP64_OPS_PER_S = 34e12         # H100 SXM data sheet, FP64 outside tensor cores

Q1 = """
    SELECT l_returnflag, l_linestatus,
           SUM(l_quantity) AS sum_qty,
           SUM(l_extendedprice) AS sum_base_price,
           SUM(l_extendedprice * (1 - l_discount)) AS sum_disc_price,
           SUM(l_extendedprice * (1 - l_discount) * (1 + l_tax)) AS sum_charge,
           AVG(l_quantity) AS avg_qty,
           AVG(l_extendedprice) AS avg_price,
           AVG(l_discount) AS avg_disc,
           COUNT(*) AS count_order
    FROM lineitem
    WHERE l_shipdate <= DATE '1998-09-02'
    GROUP BY l_returnflag, l_linestatus
    ORDER BY l_returnflag, l_linestatus
"""

Q6 = """
    SELECT SUM(l_extendedprice * l_discount) AS revenue
    FROM lineitem
    WHERE l_shipdate >= DATE '1994-01-01'
      AND l_shipdate < DATE '1995-01-01'
      AND l_discount BETWEEN 0.05 AND 0.07
      AND l_quantity < 24
"""

# Q1's static-domain reduction: the occupancy row, then (value, count) rows
# for 4 SUMs and 3 AVGs over doubles, then COUNT(*)'s two count rows
Q1_CLASSES = ["unit"] + ["float", "unit"] * 7 + ["unit", "unit"]


def _days(s: str) -> int:
    return int((np.datetime64(s, "D") - np.datetime64("1970-01-01", "D"))
               .astype(np.int64))


# ---------------------------------------------------------------------------
# data: TPC-H lineitem with the columns and distributions of
# benchmarks/tpch.py (dbgen-shaped), in numpy only
# ---------------------------------------------------------------------------

_SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
_INSTRUCTS = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]


def generate_lineitem(sf: float, seed: int) -> dict:
    rng = np.random.RandomState(seed)
    n_part = max(int(200_000 * sf), 50)
    n_supp = max(int(10_000 * sf), 10)
    n_ord = max(int(1_500_000 * sf), 150)
    o_dates = rng.randint(_days("1992-01-01"), _days("1998-08-02"), n_ord)
    lines = rng.randint(1, 8, n_ord)
    n = int(lines.sum())
    orderkey = np.repeat(np.arange(1, n_ord + 1) * 4, lines)
    odate = np.repeat(o_dates, lines)
    ship = odate + rng.randint(1, 122, n)
    commit = odate + rng.randint(30, 91, n)
    receipt = ship + rng.randint(1, 31, n)
    cut = _days("1995-06-17")
    partkey = rng.randint(1, n_part + 1, n)
    step = max(n_supp // 4, 1)
    day = np.timedelta64(1, "D")
    epoch = np.datetime64("1970-01-01", "D")
    return {
        "l_orderkey": orderkey,
        "l_partkey": partkey,
        "l_suppkey": (partkey - 1 + rng.randint(0, 4, n) * step) % n_supp + 1,
        "l_linenumber": np.arange(n) - np.repeat(np.cumsum(lines) - lines, lines) + 1,
        "l_quantity": rng.randint(1, 51, n).astype(np.float64),
        "l_extendedprice": np.round(rng.uniform(900.0, 105_000.0, n), 2),
        "l_discount": np.round(rng.randint(0, 11, n) / 100.0, 2),
        "l_tax": np.round(rng.randint(0, 9, n) / 100.0, 2),
        "l_returnflag": np.where(receipt <= cut, rng.choice(["R", "A"], n), "N"),
        "l_linestatus": np.where(ship > cut, "O", "F"),
        "l_shipdate": (epoch + ship * day).astype("datetime64[s]"),
        "l_commitdate": (epoch + commit * day).astype("datetime64[s]"),
        "l_receiptdate": (epoch + receipt * day).astype("datetime64[s]"),
        "l_shipinstruct": rng.choice(_INSTRUCTS, n),
        "l_shipmode": rng.choice(_SHIPMODES, n),
        "l_comment": np.full(n, "", dtype="<U1"),
    }


# ---------------------------------------------------------------------------
# numpy oracles
# ---------------------------------------------------------------------------

def oracle_q1(li: dict) -> dict:
    ship = li["l_shipdate"].astype("datetime64[D]").astype(np.int64)
    keep = ship <= _days("1998-09-02")
    price, disc = li["l_extendedprice"][keep], li["l_discount"][keep]
    qty, tax = li["l_quantity"][keep], li["l_tax"][keep]
    disc_price = price * (1 - disc)
    charge = disc_price * (1 + tax)
    rf, ls = li["l_returnflag"][keep], li["l_linestatus"][keep]
    out = {k: [] for k in ("l_returnflag", "l_linestatus", "sum_qty",
                           "sum_base_price", "sum_disc_price", "sum_charge",
                           "avg_qty", "avg_price", "avg_disc", "count_order")}
    for r in sorted(set(rf.tolist())):
        for s in sorted(set(ls.tolist())):
            sel = (rf == r) & (ls == s)
            cnt = int(sel.sum())
            if not cnt:
                continue
            out["l_returnflag"].append(r)
            out["l_linestatus"].append(s)
            out["sum_qty"].append(math.fsum(qty[sel]))
            out["sum_base_price"].append(math.fsum(price[sel]))
            out["sum_disc_price"].append(math.fsum(disc_price[sel]))
            out["sum_charge"].append(math.fsum(charge[sel]))
            out["avg_qty"].append(math.fsum(qty[sel]) / cnt)
            out["avg_price"].append(math.fsum(price[sel]) / cnt)
            out["avg_disc"].append(math.fsum(disc[sel]) / cnt)
            out["count_order"].append(cnt)
    return out


def oracle_q6(li: dict) -> dict:
    ship = li["l_shipdate"].astype("datetime64[D]").astype(np.int64)
    d, q = li["l_discount"], li["l_quantity"]
    keep = ((ship >= _days("1994-01-01")) & (ship < _days("1995-01-01"))
            & (d >= 0.05) & (d <= 0.07) & (q < 24))
    return {"revenue": [math.fsum(li["l_extendedprice"][keep] * d[keep])]}


def check_answer(name: str, got: dict, want: dict) -> None:
    if list(got) != list(want):
        raise AssertionError(f"{name}: columns {list(got)} != {list(want)}")
    for col, w in want.items():
        g = got[col]
        if len(g) != len(w):
            raise AssertionError(f"{name}.{col}: {len(g)} rows, expected {len(w)}")
        if w and isinstance(w[0], str) or col.startswith("count"):
            if list(g) != list(w):
                raise AssertionError(f"{name}.{col}: {list(g)} != {w}")
        else:
            np.testing.assert_allclose(np.asarray(g, np.float64), w, rtol=1e-12,
                                       err_msg=f"{name}.{col}")


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean time of fn() in ms by CUDA events over ``reps`` runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def wall_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_environment() -> str:
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(card)
    return card


def phase_build() -> None:
    from dask_sql_tpu_torch.ops import gpu_kernels as gk

    info = gk.build_kernels()
    print(f"build: segsum_fixedpoint {'built' if info['built'] else 'cached'} "
          f"in {info['seconds']:.1f} s -> {info['path']}")
    for line in str(info["log"]).splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.shape == b.shape and a.dtype == b.dtype
            and bool(torch.equal(a.contiguous().view(torch.int64),
                                 b.contiguous().view(torch.int64))))


def _segsum_case(rng, n: int, g: int, classes) -> tuple:
    rows = []
    for c in classes:
        if c == "unit":
            rows.append((rng.rand(n) > 0.1).astype(np.float64))
        elif c == "int":
            rows.append(rng.randint(-10**9, 10**9, n).astype(np.float64))
        else:
            rows.append(np.round(rng.uniform(900.0, 105_000.0, n), 2))
    vals = np.vstack(rows) if rows else np.zeros((0, n))
    codes = rng.randint(0, g, n)
    mask = rng.rand(n) > 0.02
    return vals, codes, mask


def capture_q1_reduction(ctx) -> tuple:
    """Run Q1 once -- its cold run, the first in the process -- with a spy on
    the executor's static-domain reduction.  Returns the inputs the main
    path hands the kernel, (values, codes, mask, groups, row classes), and
    the run's wall time in ms."""
    from dask_sql_tpu_torch.physical.rel import executor as ex

    real = ex.segmented_sums_dispatch
    box = {}

    def spy(vals, codes, mask, num_groups, row_classes=None):
        box["args"] = (vals, codes, mask, num_groups, list(row_classes))
        return real(vals, codes, mask, num_groups, row_classes=row_classes)

    ex.segmented_sums_dispatch = spy
    try:
        cold_ms = wall_ms(lambda: ctx.sql(Q1))
    finally:
        ex.segmented_sums_dispatch = real
    return box["args"], cold_ms


def phase_kernels(dev, q1_args: tuple) -> dict:
    """segsum_fixedpoint against its plain version: bit-identical on Q1's
    own reduction and on edge cases; timed on Q1's reduction."""
    from dask_sql_tpu_torch.ops import gpu_kernels as gk

    rng = np.random.RandomState(1)
    cases = {}
    v, c, m = _segsum_case(rng, 500_000, 256, Q1_CLASSES)
    cases["domain_256"] = (v, c, m, 256, Q1_CLASSES)
    v, c, m = _segsum_case(rng, 1_000_003, 4, ["float", "int", "unit"])
    cases["ragged_n"] = (v, c, m, 4, ["float", "int", "unit"])
    v, c, m = _segsum_case(rng, 200_000, 5, ["float", "int", "unit"])
    for row, col, x in [(0, 5, np.nan), (0, 9, np.inf), (1, 7, -np.inf),
                        (1, 8, np.inf), (2, 11, np.nan), (0, 12, -np.inf)]:
        v[row, col] = x
    cases["nonfinite"] = (v, c, m, 5, ["float", "int", "unit"])
    v, c, m = _segsum_case(rng, 100_000, 3, ["float"])
    v[0, 17], m[17] = 1e300, False
    cases["masked_outlier"] = (v, c, m, 3, ["float"])
    v, c, m = _segsum_case(rng, 100_000, 3, ["int", "int"])
    v[:, :4] = [[2.0**52, -(2.0**52), 2.0**52 - 1, -1.0]] * 2
    v[:, 4:] = 0.0
    cases["int_near_2_53"] = (v, c, m, 3, ["int", "int"])
    cases["empty"] = (np.zeros((3, 0)), np.zeros(0, np.int64), np.ones(0, bool),
                      3, ["float", "int", "unit"])
    tensors = {"q1_main_path": q1_args}
    for name, (v, c, m, g, cls) in cases.items():
        tensors[name] = (torch.from_numpy(v).to(dev), torch.from_numpy(c).to(dev),
                         torch.from_numpy(m).to(dev), g, cls)
    max_err = 0.0
    for name, (vals, codes, mask, g, cls) in tensors.items():
        got = gk.segmented_sums_fixedpoint(vals, codes, mask, g, row_classes=cls)
        plain = gk.segmented_sums_fixedpoint(
            vals, codes, mask, g, row_classes=cls,
            limb_totals=gk.segsum_limb_totals_plain)
        torch.cuda.synchronize()
        diff = ((got - plain).nan_to_num(0.0).abs().max().item()
                if got.numel() else 0.0)
        if not _bits_equal(got, plain):
            raise AssertionError(f"kernel vs plain differ on {name}: max {diff}")
        max_err = max(max_err, diff)
        print(f"kernel case {name}: {tuple(vals.shape)} x {g} groups, "
              f"{len(cls)} row classes: bit-identical")

    # timing on Q1's own reduction: the kernel's function (limb totals)
    vals, codes, mask, g, cls = q1_args
    codes32 = codes.to(torch.int32).contiguous()
    mask_u8 = mask.to(torch.uint8).contiguous()
    scale = gk._pow2(gk._grid_exponents(vals, mask_u8, cls))
    args = (vals, codes32, mask_u8, scale, cls, g)
    ms = cuda_ms(lambda: gk.segsum_limb_totals_cuda(*args), reps=20)
    plain_ms = cuda_ms(lambda: gk.segsum_limb_totals_plain(*args), reps=3)
    library_ms = cuda_ms(
        lambda: gk.reference_segmented_sums(vals, codes, mask, g), reps=20)
    full_ms = cuda_ms(lambda: gk.segmented_sums_fixedpoint(
        vals, codes, mask, g, row_classes=cls), reps=10)
    a, n = vals.shape
    n_limb_rows = gk.limb_layout(cls)[2][-1]
    moved = (a * n * 8 + n * 4 + n * 1 + a * 8
             + (n_limb_rows + 3 * a) * g * 8)
    ops = a * n                     # one add per contributing value
    bound_ms = max(moved / HBM_BYTES_PER_S, ops / FP64_OPS_PER_S) * 1e3
    bound_by = "bytes" if moved / HBM_BYTES_PER_S >= ops / FP64_OPS_PER_S \
        else "operations"
    print(f"segsum_fixedpoint on Q1's reduction ({a} x {n}, {g} groups): "
          f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, index_add_ "
          f"{library_ms:.3f} ms, full fixed-point sums {full_ms:.3f} ms, "
          f"bound {bound_ms:.3f} ms ({bound_by}: {moved / 1e9:.3f} GB)")
    return {"name": "segsum_fixedpoint", "route": "cuda",
            "source": "dask_sql_tpu_torch/csrc/segsum_fixedpoint.cu",
            "replaces": "dask_sql_tpu/ops/pallas_kernels.py:103",
            "launches": 0, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def profile_query(ctx, name: str, text: str) -> None:
    """One warm run under torch.profiler: device time by kernel, and the
    device's busy share of the host wall time (profiler on)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ctx.sql(text)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType

    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in events) / 1e3
    print(f"profile {name}: wall {wall:.2f} ms, device busy {busy:.2f} ms "
          f"({100 * busy / wall:.1f}%), idle {100 * (1 - busy / wall):.1f}%")
    for e in events[:10]:
        print(f"  {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:90]}")


def phase_data(dev, sf: float, seed: int):
    """Generate lineitem and register it on a Context on the card."""
    from dask_sql_tpu_torch import Context

    t0 = time.perf_counter()
    li = generate_lineitem(sf, seed)
    print(f"lineitem: {len(li['l_orderkey'])} rows at SF {sf} "
          f"(generated in {time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    ctx = Context(device=dev)
    ctx.create_table("lineitem", li)
    torch.cuda.synchronize()
    table = ctx.schema["root"].tables["lineitem"].table
    nbytes = sum(c.data.numel() * c.data.element_size() for c in table.columns)
    print(f"create_table: {time.perf_counter() - t0:.1f} s, "
          f"{nbytes / 1e9:.3f} GB on {dev}")
    return ctx, li


def phase_slice(ctx, li: dict, q1_cold_ms: float) -> dict:
    """Q1 and Q6 through the Context, checked against the numpy oracle:
    Q6 cold and three warm runs, Q1 three warm runs (its cold run was the
    kernel phase's capture run).  Returns the kernels' launches."""
    from dask_sql_tpu_torch.ops import gpu_kernels as gk

    want = {"Q1": oracle_q1(li), "Q6": oracle_q6(li)}
    gk.reset_launch_counts()
    launches_q1 = 0
    for name, text in (("Q1", Q1), ("Q6", Q6)):
        times = [q1_cold_ms] if name == "Q1" else []
        result = None
        while len(times) < 4:
            before = gk.LAUNCHES["segsum_fixedpoint"]
            box = {}
            times.append(wall_ms(lambda: box.update(r=ctx.sql(text))))
            result = box["r"]
            if name == "Q1":
                launches_q1 += gk.LAUNCHES["segsum_fixedpoint"] - before
        got = {k: v.tolist() for k, v in result.to_numpy().items()}
        check_answer(name, got, want[name])
        print(f"{name}: cold {times[0]:.1f} ms, warm "
              + ", ".join(f"{t:.1f}" for t in times[1:])
              + f" ms; {result.num_rows} rows match the numpy oracle")
    launches = dict(gk.LAUNCHES)
    if launches_q1 < 1 or launches["segsum_fixedpoint"] < 1:
        raise AssertionError(f"Q1 did not launch segsum_fixedpoint: {launches}")
    profile_query(ctx, "Q1", Q1)
    profile_query(ctx, "Q6", Q6)
    return launches


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--sf", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        import dask_sql_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable: {exc}", file=sys.stderr)
        return 3
    dev = torch.device("cuda")
    card = phase_environment()
    phase_build()
    ctx, li = phase_data(dev, args.sf, args.seed)
    q1_args, q1_cold_ms = capture_q1_reduction(ctx)
    kernel = phase_kernels(dev, q1_args)
    launches = phase_slice(ctx, li, q1_cold_ms)
    kernel["launches"] = launches[kernel["name"]]
    print(f"card: {card}")
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
