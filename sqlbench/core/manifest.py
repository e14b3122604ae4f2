"""Everything the harness knows it finds by name: the cell in
``BENCHMARK.json``, its configuration file, its traffic mix, its templates
and the reader of each metric.  A later cell, mix or metric is new files and
new entries, never an edit here."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

from .params import load_template

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def manifest() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell(name: str) -> dict:
    for w in manifest()["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    for c in manifest()["configs"]:
        if c["name"] == name:
            with open(ROOT / c["file"]) as f:
                out = json.load(f)
            out["name"] = name
            return out
    raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    with open(BENCH_DIR / "traffic" / f"{name}.json") as f:
        out = json.load(f)
    out["name"] = name
    return out


def templates(family: str, ids: List[str]) -> Dict[str, dict]:
    return {tid: load_template(family, tid) for tid in dict.fromkeys(ids)}


def metrics_of(cell_name: str, section: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those
    that list it, or list no cells (a per-layer metric without a list goes
    where the end-to-end metric it moves is reported)."""
    m = manifest()
    e2e_here = {e["name"] for e in m["end_to_end"]
                if "workloads" not in e or cell_name in e["workloads"]}
    out = []
    for entry in m[section]:
        listed = entry.get("workloads")
        if listed is not None:
            if cell_name in listed:
                out.append(entry)
        elif section == "end_to_end" or entry["moves"] in e2e_here:
            out.append(entry)
    return out


def reader(metric: str) -> Callable:
    """``metrics/<metric>.py``'s ``read(run)``."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"sqlbench.metrics.{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
