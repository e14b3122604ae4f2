"""17(e) of ``chip_smoke.py``'s queries on ``default_mesh()`` over every
card, for one source tree, to compare two trees on one machine.

    python3 scripts/torch_distinct_cards_ab.py DIR LABEL SF PHASE

``DIR`` is the root of a checkout of the repo; its ``dask_sql_tpu_torch``
and ``chip_smoke.py`` are the ones imported, and its kernels are built
from its own sources.  Sets up as ``chip_smoke.py --only multiprocess``
does (kernels, TPC-H at ``SF``, seed 0, phase 7's eager answers), then
runs Q1, Q3, Q6, Q12 and Q14 cold and three times warm on a mesh of one
shard per card, printing one ``distinct walls:`` JSON line per query
(walls and, per run, graph replays and captures, eager stages, stage
programs built, fallbacks, tier) with the card's name and power limit;
each answer is held to phase 7's.  With ``PHASE=1`` it then runs
``chip_smoke.mesh_distinct_cards`` (17(e) itself, with its checks).
Needs two CUDA cards or more; ``scripts/torch_distinct_cards_ab.sh``
runs it in turns over this tree and a parent's.
"""
import json
import os
import sys
import time

tree, label, sf, phase = sys.argv[1], sys.argv[2], float(sys.argv[3]), \
    sys.argv[4] == "1"
tree = os.path.abspath(tree)
os.chdir(tree)
sys.path.insert(0, tree)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

if not cs.__file__.startswith(tree):
    raise RuntimeError(f"imported {cs.__file__}, not from {tree}")

QS = (1, 3, 6, 12, 14)
WARM = 3
KEYS = ("spmd_queries", "spmd_fallbacks", "spmd_eager_stages",
        "spmd_compiles", "spmd_errors", "graph_replays", "graph_captures")

os.environ.pop("DSQL_ADAPTIVE", None)
os.environ.update({"DSQL_TIERED": "0", "DSQL_EAGER_FALLBACK": "0",
                   **cs.SERVING_PINS})
t0 = time.perf_counter()
dev = torch.device("cuda")
card = cs.phase_environment()
cs.phase_build()
ctx, tables = cs.phase_data(dev, sf, 0)
base = {n: e.table for n, e in ctx.schema["root"].tables.items()}
os.environ["DSQL_COMPILE"] = "0"
answers = {q: ctx.sql(cs.QUERIES[q]) for q in QS}
os.environ.pop("DSQL_COMPILE")
del ctx, tables
from dask_sql_tpu_torch.parallel import spmd  # noqa: E402
from dask_sql_tpu_torch.parallel.mesh import default_mesh  # noqa: E402

mesh = default_mesh()
dctx, create_s = cs._mesh_context(mesh, base)
print(f"{label}: setup {time.perf_counter() - t0:.1f} s, mesh {mesh}, "
      f"create {create_s:.1f} s, card {card}", flush=True)
for q in QS:
    walls, runs = [], []
    for _ in range(1 + WARM):
        box = {}
        walls.append(cs.wall_ms(lambda: box.update(r=dctx.sql(cs.QUERIES[q]))))
        c = dctx.last_report.counters
        runs.append({k: c.get(k, 0) for k in KEYS})
        runs[-1]["fallback"] = cs._span_attr(dctx, "spmd_fallback")
        runs[-1]["tier"] = cs._last_tier(dctx)[0]
    cs.check_same_result(f"{label} Q{q}", box["r"], answers[q], rtol=1e-9)
    print("distinct walls: " + json.dumps(
        {"label": label, "q": q, "cold_ms": walls[0], "warm_ms": walls[1:],
         "warm_median_ms": sorted(walls[1:])[len(walls[1:]) // 2],
         "runs": runs, "card": card}), flush=True)
if phase:
    del dctx
    spmd.clear_programs()
    cs.forget_programs()
    row = cs.mesh_distinct_cards(base, answers)
    print(f"{label}: phase 17(e) passed", flush=True)
print(f"{label}: done in {time.perf_counter() - t0:.1f} s", flush=True)
