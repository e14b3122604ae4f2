"""One run of a cell, from data to the result's line: the steps of
``run.py``, with the device passed in, so that the tests can drive every
step but the look for a card on the CPU."""
from __future__ import annotations

import importlib
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import data as D
from . import loop, manifest, params, port
from .compare import combine, compare

ROOT = manifest.ROOT


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _say(msg: str) -> None:
    print(f"sqlbench: {msg}", file=sys.stderr, flush=True)


def family_modules(family: str):
    return (importlib.import_module(f"sqlbench.gen.{family}"),
            importlib.import_module(f"sqlbench.reference.{family}"))


def plan_draws(traffic: dict, templates: dict, seed: int, scale: float):
    """Every template's value sets: the warm-up's first, then the window's."""
    n = int(traffic["warmup_passes"]) + int(traffic["draws_per_template"])
    return {tid: params.draws(t, seed, stream=i + 1, n=n, scale=scale,
                              reserve=int(traffic["warmup_passes"]))
            for i, (tid, t) in enumerate(templates.items())}


def warm_up(ctx, order, draws, passes: int) -> dict:
    """Each template once per pass, each pass with its own value set (the
    window's are never among them); the port's background build of a
    query is waited for before the next query, so that builds never
    overlap one another or a query in set-up."""
    counts = {"queries": 0, "compiles": 0}
    for k in range(passes):
        for tid in order:
            _, _, report = port.query(ctx, draws[tid][k]["sql"])
            counts["queries"] += 1
            counts["compiles"] += int(port.report_facts(report)["built"])
            port.wait_for_builds()
    return counts


def by_template(queries) -> dict:
    """Per template: arrivals, median and largest ms, and how they were
    answered (tier, with ``+build`` where the query built, or ``cache``)."""
    out = {}
    for q in queries:
        tag = "cache" if q.facts.get("cache_hit") else (
            f"{q.facts.get('tier')}{'+build' if q.facts.get('built') else ''}"
            if q.ok else "failed")
        e = out.setdefault(q.tid, {"n": 0, "ms": [], "how": {}})
        e["n"] += 1
        e["ms"].append(q.ms)
        e["how"][tag] = e["how"].get(tag, 0) + 1
    return {tid: {"n": e["n"], "p50_ms": round(float(np.median(e["ms"])), 3),
                  "max_ms": round(max(e["ms"]), 3), "how": e["how"]}
            for tid, e in sorted(out.items())}


def sample(window, per_template: int, seed: int):
    """The window's answers that are compared: per template up to
    ``per_template`` of its answered queries, drawn from the seed."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 99])
    by_tid = {}
    for q in window:
        if q.ok:
            by_tid.setdefault(q.tid, []).append(q)
    out = []
    for tid in sorted(by_tid):
        qs = by_tid[tid]
        pick = rng.permutation(len(qs))[:per_template]
        out.extend(qs[int(i)] for i in sorted(pick))
    return out


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float, query_hook=None,
             overrides: dict = None, traffic_overrides: dict = None):
    """Returns (the result's line as a dict, {check: (value, limit)}).
    ``query_hook(port)`` may replace the harness's calls into the port (the
    tests' broken timed path); ``overrides`` and ``traffic_overrides``
    replace keys of the configuration and the traffic (the tests' sizes)."""
    config = {**manifest.config(cell["config"]), **(overrides or {})}
    traffic = {**manifest.traffic(cell["traffic"]),
               **(traffic_overrides or {})}
    family = config["family"]
    if traffic["family"] != family:
        raise ValueError(f"traffic {traffic['name']} is for {traffic['family']}"
                         f", configuration {config['name']} for {family}")
    port.prepare_environment(ROOT, config.get("port_env", {}))
    import dask_sql_tpu_torch
    if not Path(dask_sql_tpu_torch.__file__).resolve().is_relative_to(ROOT):
        raise RuntimeError("dask_sql_tpu_torch is not the checkout's")
    if query_hook is not None:
        query_hook(port)
    gen, ref = family_modules(family)
    scale = float(config["scale"])

    t0 = time.perf_counter()
    data = gen.generate(config, seed, device)
    _sync(device)
    digest = D.digest(data)
    rows = {t: D.rows(cols) for t, cols in data.items()}
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ctx = port.register(data, device)
    load_s = time.perf_counter() - t0
    del data
    gc_collect(device)

    order = list(traffic["order"])
    templates = manifest.templates(family, order)
    draws = plan_draws(traffic, templates, seed, scale)
    passes = int(traffic["warmup_passes"])
    t0 = time.perf_counter()
    warm = warm_up(ctx, order, draws, passes)
    _sync(device)
    warmup_s = time.perf_counter() - t0
    setup_s = time.perf_counter() - t_start
    _say(f"set-up {setup_s:.3f} s: data {gen_s:.3f} s, load {load_s:.3f} s,"
         f" warm-up {warmup_s:.3f} s ({warm['queries']} queries, "
         f"{warm['compiles']} built on the query path); rows {rows}")

    stream = loop.schedule(order, draws, passes)
    run = loop.Run(setup={"setup_s": setup_s, "load_s": load_s,
                          "warmup_s": warmup_s, "gen_s": gen_s})
    import gc
    if _gc_clock not in gc.callbacks:
        gc.callbacks.append(_gc_clock)
    host0 = host_times()
    run.window, run.window_s = loop.closed_loop(ctx, stream, 0, seconds)
    _say("host in the window: " + ", ".join(
        f"{k} {v:.3f}" for k, v in host_delta(host0, host_times()).items()))
    lat = np.array([q.ms for q in run.window])
    _say("latency ms: " + ", ".join(f"p{p} {np.percentile(lat, p):.3f}"
                                    for p in (50, 80, 90, 95)))
    _say("sequence (template:ms): " + ",".join(
        f"{q.tid[1:]}:{q.ms:.0f}" for q in run.window))
    _say(f"window {run.window_s:.3f} s: {len(run.window)} queries, "
         f"{sum(not q.ok for q in run.window)} failed; per template "
         f"{json.dumps(by_template(run.window))}")
    t0 = time.perf_counter()
    backlog = len(port.building())
    port.wait_for_builds()
    _say(f"after the window: {backlog} background builds in flight, "
         f"drained in {time.perf_counter() - t0:.3f} s; "
         f"{port.memory_note(device)}")
    if trace and device.type == "cuda":
        from . import trace as tr
        run.stretch, run.trace = tr.stretch(
            ctx, stream, len(run.window), len(order), device)
        rate = len(run.stretch) / run.trace["window_s"]
        _say(f"traced stretch: {len(run.stretch)} queries in "
             f"{run.trace['window_s']:.3f} s, {rate:.4f} queries/s under the "
             f"profiler against {len(run.window) / run.window_s:.4f} in the "
             f"window; idle by host activity {run.trace['idle_by_activity']}")
    peak = port.device_memory_peak(device)
    port.release(ctx)
    del ctx
    gc_collect(device)

    # the reference, from a fresh generation of the same inputs
    t0 = time.perf_counter()
    data = gen.generate(config, seed, device)
    same_data = D.digest(data) == digest
    picked = sample(run.window, int(traffic["sample_per_template"]), seed)
    readings, per_template = [], {}
    for q in picked:
        t = templates[q.tid]
        want, _ = ref.QUERIES[q.tid](data, q.values, torch.float64)
        r = compare(q.cols, want, t["key"], t["order"])
        readings.append(r)
        per_template[q.tid] = r
        if r["exact_mismatches"] or r["order_violations"]:
            _say(f"{q.tid} differs from the reference: {r}; {q.sql!r}")
    facts_cache = {}

    def facts_of(q):
        if q.sql not in facts_cache:
            _, facts_cache[q.sql] = ref.QUERIES[q.tid](data, q.values,
                                                       torch.float64)
        return facts_cache[q.sql]

    run.facts_of = facts_of
    metrics = {}
    for entry in manifest.metrics_of(cell["name"], "per_layer" if trace
                                     else "end_to_end"):
        value = manifest.reader(entry["name"])(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    ref_s = time.perf_counter() - t0
    _say(f"reference: {len(picked)} answers compared in {ref_s:.3f} s; "
         f"largest gaps {json.dumps(sorted(((r['max_rel_gap'], tid) for tid, r in per_template.items()), reverse=True)[:5])}")
    del data
    gc_collect(device)

    got = combine(readings)
    failed = sum(not q.ok for q in run.window)
    limits = config["limits"]
    checks = {"failed_queries": (failed, 0),
              "data_digest_differs": (int(not same_data), 0),
              "answers_compared": (len(picked), None),
              "exact_mismatches": (got["exact_mismatches"],
                                   limits["exact_mismatches"]),
              "order_violations": (got["order_violations"],
                                   limits["order_violations"]),
              "max_rel_gap": (got["max_rel_gap"], limits["max_rel_gap"])}
    correct = all(lim is None or v <= lim for v, lim in checks.values()) \
        and len(picked) > 0
    for q in run.window:
        if not q.ok:
            _say(f"{q.tid} failed: {q.error}")
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": len(run.window),
              "failed": failed, "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result, checks


_GC = {"s": 0.0, "gen2": 0, "t0": 0.0}


def _gc_clock(phase: str, info: dict) -> None:
    if phase == "start":
        _GC["t0"] = time.perf_counter()
    else:
        _GC["s"] += time.perf_counter() - _GC["t0"]
        _GC["gen2"] += info.get("generation") == 2


def host_times() -> dict:
    """This process's CPU seconds, its threads, and the seconds and the
    full collections of Python's garbage collector: what the host did
    while the window ran, to tell a slow run's cause."""
    import os

    task = "/proc/self/task"
    return {"process_cpu_s": time.process_time(), "gc_s": _GC["s"],
            "gc_gen2": float(_GC["gen2"]),
            "threads": float(len(os.listdir(task)))
            if os.path.isdir(task) else 0.0}


def host_delta(before: dict, after: dict) -> dict:
    return {k: (after[k] if k == "threads" else after[k] - before[k])
            for k in after if k in before}


def gc_collect(device: torch.device) -> None:
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
