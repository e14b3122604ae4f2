"""Time the port's compiled tier on TPC-H Q1-Q22 (phase 12 of
``chip_smoke.py``) for one source tree, to compare two trees on one card.

    python3 scripts/torch_compiled_ab.py [--tree DIR] [--sf 1] [--rounds 4]

``--tree`` is the root of a checkout of the repo (default: this one); its
``dask_sql_tpu_torch`` and ``chip_smoke.py`` are the ones imported, and
its kernels are built from its own sources.  The script sets the
environment ``chip_smoke.py``'s main sets before phase 12, registers the
TPC-H tables at ``--sf``, runs each query once cold (trace, warm-up and
capture), then ``--rounds`` rounds of three warm runs per query.  Every
query must be served by the compiled tier (Q2 may fall back at run time,
as in phase 12).  Prints one JSON line per round (``round:``; per query
the median of its three warm walls in ms, and their sum) and a last line
``ab:`` with the tree, the card's name and power limit, and the median
and spread of the round sums.  Needs a CUDA card.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    p.add_argument("--sf", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--rounds", type=int, default=4)
    args = p.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("torch_compiled_ab: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs

    if not cs.__file__.startswith(tree):
        raise RuntimeError(f"imported {cs.__file__}, not from {tree}")
    # chip_smoke.main's environment before phase 12
    for name in ("DSQL_ADAPTIVE", "DSQL_FORCE_GROUPBY", "DSQL_COMPILE"):
        os.environ.pop(name, None)
    os.environ["DSQL_TIERED"] = "0"
    os.environ["DSQL_EAGER_FALLBACK"] = "0"
    os.environ.update(cs.SERVING_PINS)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cs.phase_build()
    ctx, _ = cs.phase_data(torch.device("cuda"), args.sf, args.seed)
    qids = sorted(cs.QUERIES)
    cold = {}
    for q in qids:
        cold[q] = cs.wall_ms(lambda: ctx.sql(cs.QUERIES[q]))
        tier, reason, _ = cs._last_tier(ctx)
        if tier != "compiled" and "runtime" not in reason:
            raise AssertionError(f"Q{q} took {tier} ({reason})")
    sums = []
    for r in range(args.rounds):
        med = {}
        for q in qids:
            walls = [cs.wall_ms(lambda: ctx.sql(cs.QUERIES[q]))
                     for _ in range(3)]
            med[q] = sorted(walls)[1]
        sums.append(sum(med.values()))
        print("round: " + json.dumps({"round": r, "warm_sum_ms": sums[-1],
                                      "warm_median_ms": med}))
    print("ab: " + json.dumps({
        "tree": tree, "card": card, "sf": args.sf,
        "cold_sum_ms": sum(cold.values()),
        "warm_sum_ms": sums, "warm_sum_median_ms": statistics.median(sums),
        "warm_sum_spread_ms": max(sums) - min(sums),
        "at": time.strftime("%Y-%m-%dT%H:%M:%S")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
