"""One run of one cell of the benchmark of ``dask_sql_tpu_torch``.

    python3 sqlbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

In order: make the cell's data on the card from the seed; register it
through ``Context.create_table``; warm the cell's templates; run the closed
loop for ``--seconds``; with ``--trace 1`` run a profiled stretch after it;
then compare a sample of the window's answers, drawn from the seed, with
the plain reference, and print the result as the last line of standard
output (the numbers compared, each with its limit, also as the last lines
of standard error).  Without a CUDA card it fails and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "dask_sql_tpu", "benchmarks")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def fail(message: str, code: int = 2):
    print(f"sqlbench: {message}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from sqlbench.core import manifest

    cell = manifest.cell(args.workload)
    spec = importlib.util.find_spec("dask_sql_tpu_torch")
    if spec is None or not Path(spec.origin).resolve().is_relative_to(ROOT):
        fail("dask_sql_tpu_torch, the system under test, is not in this "
             "checkout")
    if not torch.cuda.is_available():
        fail("no CUDA device: this benchmark runs only on the card")
    if torch.cuda.device_count() < int(cell["chips"]):
        fail(f"{cell['chips']} CUDA devices needed, "
             f"{torch.cuda.device_count()} present")
    from sqlbench.core import harness

    result, checks = harness.run_cell(
        cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
        device=torch.device("cuda", 0), t_start=T_START)
    gc.collect()
    found = forbidden_modules()
    if found:
        fail(f"modules that must not load are loaded: {found}", 4)
    for name, (value, limit) in checks.items():
        print(f"check {name}: {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    code = main()
    # the port's tiering builds on daemon threads; every build was waited
    # for, and the interpreter's teardown is skipped so that a library's
    # thread state cannot turn a finished run into an abort
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
