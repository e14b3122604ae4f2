"""Phase 18(a) of ``chip_smoke.py`` alone for one source tree, to compare
two trees on one card.

    python3 scripts/torch_multiprocess_ab.py DIR

``DIR`` is the root of a checkout of the repo; its ``dask_sql_tpu_torch``
and ``chip_smoke.py`` are the ones imported, and its kernels are built
from its own sources.  The script sets the environment ``chip_smoke.py``
sets before phase 18, registers TPC-H at SF 1 (seed 0), takes the eager
answers, then runs ``multiprocess_world1``: one NCCL rank holding four
shards, Q1-Q22 cold and three times warm, each run's walls on a
``multiprocess table:`` line.  Needs a CUDA card.
"""
import os
import sys

tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
os.chdir(tree)
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

if not cs.__file__.startswith(tree):
    raise RuntimeError(f"imported {cs.__file__}, not from {tree}")
for name in ("DSQL_ADAPTIVE", "DSQL_FORCE_GROUPBY", "DSQL_COMPILE"):
    os.environ.pop(name, None)
os.environ.update({"DSQL_TIERED": "0", "DSQL_EAGER_FALLBACK": "0",
                   **cs.SERVING_PINS})
cs.phase_build()
dev = torch.device("cuda")
ctx, tables = cs.phase_data(dev, 1.0, 0)
base = {n: e.table for n, e in ctx.schema["root"].tables.items()}
os.environ["DSQL_COMPILE"] = "0"
answers = {q: ctx.sql(cs.QUERIES[q]) for q in sorted(cs.QUERIES)}
os.environ.pop("DSQL_COMPILE")
del ctx, tables
cs._mp_env()
cs.forget_programs()
summary, _ = cs.multiprocess_world1(dev, base, answers)
print("ab18a done", tree, summary["seconds"])
