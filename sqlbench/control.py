"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place, computed one precision below the
configuration's (float32 for TPC-H's float64 columns), on the answers a run of the cell would
compare, at the cell's own size.  It must come out as not correct.

    python3 sqlbench/control.py --workload tpch1_untiered.power18 --seeds 11 12 13

Prints one JSON line per seed with the readings the run would compare,
each beside the configuration's limit.  The benchmark's runs never run it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def control_readings(cell: dict, seed: int, device, overrides=None,
                     per_template: int = 1, low=None) -> dict:
    """The readings of the reference in ``low`` precision (default float32)
    against the reference, on ``per_template`` answers per template drawn
    as a run draws its window's."""
    import numpy as np
    import torch

    from sqlbench.core import harness, loop, manifest
    from sqlbench.core.compare import combine, compare

    low = torch.float32 if low is None else low
    config = {**manifest.config(cell["config"]), **(overrides or {})}
    traffic = manifest.traffic(cell["traffic"])
    gen, ref = harness.family_modules(config["family"])
    order = list(traffic["order"])
    templates = manifest.templates(config["family"], order)
    draws = harness.plan_draws(traffic, templates, seed,
                               float(config["scale"]))
    stream = loop.schedule(order, draws, int(traffic["warmup_passes"]))
    rng = np.random.default_rng([int(seed) % (1 << 63), 7])
    data = gen.generate(config, seed, device)
    readings, per = [], {}
    for tid in order:
        arrivals = [q for q in stream[:len(order) * 8] if q.tid == tid]
        for i in rng.permutation(len(arrivals))[:per_template]:
            q = arrivals[int(i)]
            t = templates[tid]
            want, _ = ref.QUERIES[tid](data, q.values, torch.float64)
            got, _ = ref.QUERIES[tid](data, q.values, low)
            r = compare(got, want, t["key"], t["order"])
            readings.append(r)
            per[tid] = r
    out = combine(readings)
    limits = config["limits"]
    return {"seed": seed, "workload": cell["name"],
            "checks": {k: {"value": out[k], "limit": limits[k]}
                       for k in ("exact_mismatches", "order_violations",
                                 "max_rel_gap")},
            "fails": any(out[k] > limits[k] for k in limits),
            "per_template": per}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--per-template", type=int, default=1)
    args = ap.parse_args(argv)
    import torch

    from sqlbench.core import manifest

    if not torch.cuda.is_available():
        print("sqlbench control: no CUDA device", file=sys.stderr)
        return 2
    cell = manifest.cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = control_readings(cell, seed, torch.device("cuda", 0),
                             per_template=args.per_template)
        r["seconds"] = time.perf_counter() - t0
        print(json.dumps(r), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
