"""BENCHMARK.json against the rules it is checked by, and everything it
names found by name: configurations, traffic mixes, templates, generators,
references and metric readers."""
import importlib
import json
import re

import pytest

from sqlbench_helpers import ROOT
from sqlbench.core import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
M = manifest.manifest()


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_and_size():
    assert set(M) == TOP_KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(M["paths"]) <= 16 and len(M["command"]) <= 32
    for p in M["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    for word in M["command"]:
        assert _line(word) and not word.startswith("/") and ".." not in word


def test_run_seconds_fits_the_full_check():
    rs = M["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_fields():
    names = [c["name"] for c in M["configs"]] + \
        [w["name"] for w in M["workloads"]] + \
        [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(c["name"] for c in M["configs"])) == len(M["configs"])
    assert len(set(w["name"] for w in M["workloads"])) == len(M["workloads"])
    metrics = M["end_to_end"] + M["per_layer"]
    assert len(set(m["name"] for m in metrics)) == len(metrics)
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k)
                                               for k in c["reduced"])
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert sum(w["chips"] == 4 for w in M["workloads"]) <= max(
        1, len(M["workloads"]) // 4)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in M["end_to_end"])
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])


def test_each_metric_moves_what_its_cells_report():
    cells = [w["name"] for w in M["workloads"]]
    e2e = {m["name"]: m.get("workloads", cells) for m in M["end_to_end"]}
    for m in M["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells and cell in e2e[m["moves"]], (m, cell)
    for cell in cells:
        reported = {m["name"] for m in manifest.metrics_of(cell,
                                                           "end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2
        assert manifest.metrics_of(cell, "per_layer")


def test_everything_is_found_by_name():
    used = set()
    for w in M["workloads"]:
        config = manifest.config(w["config"])
        traffic = manifest.traffic(w["traffic"])
        used.add(w["config"])
        assert traffic["family"] == config["family"]
        gen = importlib.import_module(f"sqlbench.gen.{config['family']}")
        ref = importlib.import_module(
            f"sqlbench.reference.{config['family']}")
        assert callable(gen.generate)
        templates = manifest.templates(config["family"], traffic["order"])
        for tid, t in templates.items():
            assert tid in ref.QUERIES and t["sql"].strip()
            assert set(t) >= {"clause", "key", "order", "sql"}
        assert set(config["limits"]) == {"exact_mismatches",
                                         "order_violations", "max_rel_gap"}
    for c in M["configs"]:
        assert c["name"] in used
        path = ROOT / c["file"]
        assert path.is_file() and path.is_relative_to(ROOT / "sqlbench")
        assert json.loads(path.read_text())["reduced"] == c["reduced"]
    for m in M["end_to_end"] + M["per_layer"]:
        assert callable(manifest.reader(m["name"]))


@pytest.mark.parametrize("path", sorted(
    p for p in (ROOT / "sqlbench").rglob("*")
    if "__pycache__" not in p.parts and "cache" not in p.parts))
def test_file_names_use_name_characters(path):
    for part in path.relative_to(ROOT).parts:
        assert NAME.match(part), part
