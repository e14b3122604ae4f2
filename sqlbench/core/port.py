"""The only module of the harness that touches the system under test,
``dask_sql_tpu_torch``: its environment, the catalog, the user's call
``Context.sql`` and the reports it keeps of each call.

The port runs at its defaults (result cache, workload manager, tiering and
parameterized plans on), except for what the configuration's ``port_env``
states as a setting of the deployment (``tpch_sf1_untiered`` turns tiering
off).  Profiler, history, events, ingest, fleet, program store and every
other file the port can keep between processes stay unarmed, so that no
run inherits what another built or learned.  Only the libraries
the port compiles with nvcc and g++ persist, in its own ``build/``
directory inside the checkout, named by their sources' digest.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from .data import Dataset

# the port's variables a user who sets nothing leaves unset
UNARMED = ("DSQL_PROFILE", "DSQL_HISTORY_FILE", "DSQL_EVENTS",
           "DSQL_EVENTS_FILE", "DSQL_INGEST_DIR", "DSQL_FLEET_DIR",
           "DSQL_AUTOPILOT", "DSQL_AUTOPILOT_FILE", "DSQL_CAPS_FILE",
           "DSQL_PROGRAM_STORE", "DSQL_QUARANTINE_FILE",
           "DSQL_CHROME_TRACE_DIR")


def prepare_environment(root: Path, deployment: Dict[str, str]
                        ) -> Dict[str, str]:
    """The variables set before the port is imported: every compiler cache
    a library might use inside the checkout, at fixed paths; the port's
    own files unarmed; and the deployment's settings of the port that its
    configuration states (``port_env``)."""
    cache = root / "sqlbench" / "cache"
    env = {**{k: str(v) for k, v in deployment.items()},
           "TRITON_CACHE_DIR": str(cache / "triton"),
           "TORCH_EXTENSIONS_DIR": str(cache / "torch_extensions"),
           "TORCHINDUCTOR_CACHE_DIR": str(cache / "inductor"),
           "USE_FLAX": "0", "USE_JAX": "0"}
    for name in UNARMED:
        os.environ.pop(name, None)
    os.environ.update(env)
    return env


def port_columns(table: dict, device: torch.device) -> dict:
    """The benchmark's columns as the port's (``Column``), sharing the
    tensors: strings as codes with their dictionary, dates as TIMESTAMP
    microseconds, as the port's own ingestion would encode them."""
    from dask_sql_tpu_torch.table import Column
    from dask_sql_tpu_torch.types import BIGINT, DOUBLE, TIMESTAMP, VARCHAR

    out = {}
    for name, col in table.items():
        if col.kind == "str":
            out[name] = Column(col.data.to(device=device, dtype=torch.int32),
                               VARCHAR, None, col.dictionary)
        elif col.kind == "date":
            out[name] = Column((col.data * 86_400_000_000).to(device),
                               TIMESTAMP)
        elif col.kind == "float":
            out[name] = Column(col.data.to(device=device,
                                           dtype=torch.float64), DOUBLE)
        else:
            out[name] = Column(col.data.to(device=device, dtype=torch.int64),
                               BIGINT)
    return out


def register(data: Dataset, device: torch.device):
    """A fresh ``Context`` on ``device`` with every table registered through
    ``create_table``."""
    from dask_sql_tpu_torch import Context

    ctx = Context(device=device)
    for name, table in data.items():
        ctx.create_table(name, port_columns(table, device))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return ctx


def query(ctx, sql: str):
    """The user's call: SQL text in, a host pandas frame out
    (``return_futures=False``: the port's ``fetch`` span holds the copy to
    the host).  Returns (the frame's columns as numpy arrays, their names,
    the port's report of the call)."""
    frame = ctx.sql(sql, return_futures=False)
    cols = [np.asarray(frame.iloc[:, i].to_numpy(dtype=object)
                       if frame.dtypes.iloc[i].kind not in "iufbM"
                       else frame.iloc[:, i].to_numpy())
            for i in range(frame.shape[1])]
    return cols, list(frame.columns), ctx.last_report


def report_facts(report) -> dict:
    """What the per-layer readers take from one query's report.  Builds and
    replays are read from the query's own spans (a ``compile`` span, a
    capture's ``graph_capture_ms``, a replay's ``graph_pool_bytes``): the
    counters' deltas also hold what background builds did meanwhile."""
    if report is None:
        return {}
    built = replayed = False
    for s in report.root.walk():
        if s.name == "compile" or "graph_capture_ms" in s.attrs \
                or "graph_warmup_ms" in s.attrs:
            built = True
        elif "graph_pool_bytes" in s.attrs:
            replayed = True
    return {"plan_ms": report.phases.get("parse", 0.0)
            + report.phases.get("plan", 0.0),
            "tier": report.tier, "cache_hit": bool(report.cache.get("hit")),
            "cache_hits": int(bool(report.cache.get("hit")))
            + int(report.cache.get("subplan_hits", 0)),
            "built": built, "replayed": replayed}


def spans(report) -> List[tuple]:
    """(name, depth, t0, t1) of every span of the report, host clock."""
    out = []
    if report is None:
        return out

    def walk(span, depth):
        out.append((span.name, depth, span.t0, span.t1 if span.t1 is not None
                    else span.t0))
        for child in list(span.children):
            walk(child, depth + 1)

    walk(report.root, 0)
    return out


def wait_for_builds(timeout_s: float = 600.0) -> None:
    """Block until the port's tiering has no program building in the
    background (a cold plan is answered eagerly while it builds)."""
    from dask_sql_tpu_torch.physical import compiled

    compiled.wait_background_compiles(timeout_s)


def building() -> list:
    """The plans the port's tiering is building in the background now."""
    from dask_sql_tpu_torch.physical import compiled

    return compiled.inflight_background_compiles()


def memory_note(device: torch.device) -> str:
    """Device memory now: allocated, reserved, and held by graph pools."""
    if device.type != "cuda":
        return "memory: cpu"
    from dask_sql_tpu_torch.physical import graphs

    gib = 1 << 30
    return (f"memory: allocated {torch.cuda.memory_allocated(device) / gib:.2f}"
            f" GiB, reserved {torch.cuda.memory_reserved(device) / gib:.2f} "
            f"GiB, graph pools {graphs.live_pool_bytes() / gib:.2f} GiB, "
            f"peak {torch.cuda.max_memory_allocated(device) / gib:.2f} GiB")


def device_memory_peak(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) \
        if device.type == "cuda" else 0


def release(ctx) -> None:
    """Drop the catalog and the port's result cache, so that the reference
    runs in the memory they held."""
    import gc

    from dask_sql_tpu_torch.runtime import result_cache

    try:
        result_cache.get_cache().clear()
    except Exception:      # noqa: BLE001 -- a cache that cannot clear keeps
        pass               # its memory; the reference then has less
    for schema in list(ctx.schema.values()):
        schema.tables.clear()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()

