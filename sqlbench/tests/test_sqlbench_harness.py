"""The harness over the port on the CPU at SF 0.01 (it measures nothing
here): each cell's answers match the reference; a run without a card or
without the port fails with no result; a broken timed path and the
control come out as not correct."""
import json
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from sqlbench_helpers import CPU, ROOT
from sqlbench.control import control_readings
from sqlbench.core import harness, manifest

CELLS = [w["name"] for w in manifest.manifest()["workloads"]]
SMALL = {name: {"scale": 0.01} for name in CELLS}
QUICK = {"warmup_passes": 1, "draws_per_template": 24}


def _run(name, seconds=2.0, hook=None):
    return harness.run_cell(manifest.cell(name), seed=4_000_000_123,
                            seconds=seconds, trace=False, device=CPU,
                            t_start=time.perf_counter(), query_hook=hook,
                            overrides=SMALL[name], traffic_overrides=QUICK)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_cell_answers_match_reference_on_cpu(name):
    result, checks = _run(name)
    templates = manifest.traffic(manifest.cell(name)["traffic"])["order"]
    assert result["correct"], result["checks"]
    assert result["failed"] == 0
    assert checks["answers_compared"][0] == min(len(templates),
                                               result["attempted"])
    assert set(result["metrics"]) == {"queries_per_s", "query_p95_ms",
                                      "query_geomean_ms", "setup_s"}
    assert list(result)[-1] == "checks"


def _alter(port):
    """An answer altered where it is produced: one value of each answer
    off by a part in a million (one unit in an integer column)."""
    real = port.query

    def query(ctx, sql):
        cols, names, report = real(ctx, sql)
        cols = [np.array(c, copy=True) for c in cols]
        for c in cols:
            if len(c) and c.dtype.kind == "f" and np.isfinite(c[0]):
                c[0] = c[0] * (1 + 1e-6) + 1e-6
                break
            if len(c) and c.dtype.kind in "iu":
                c[0] += 1
                break
        return cols, names, report
    port.query = query
    return real


def _half_batch(port):
    """Half of the largest table left out of what the port is given."""
    real = port.register

    def register(data, device):
        big = max(data, key=lambda t: next(iter(data[t].values()))
                  .data.shape[0])
        n = next(iter(data[big].values())).data.shape[0] // 2
        cut = {**data, big: {k: type(c)(c.kind, c.data[:n], c.dictionary)
                             for k, c in data[big].items()}}
        return real(cut, device)
    port.register = register
    return real


@pytest.mark.parametrize("fault", [_alter, _half_batch])
@pytest.mark.parametrize("name", sorted(SMALL))
def test_broken_timed_path_is_not_correct(fault, name, monkeypatch):
    from sqlbench.core import port

    monkeypatch.setattr(port, "query", port.query)
    monkeypatch.setattr(port, "register", port.register)
    result, _ = _run(name, seconds=1.0, hook=fault)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("name", sorted(SMALL))
def test_control_is_not_correct(name):
    r = control_readings(manifest.cell(name), 5_000_000_017, CPU,
                         overrides=SMALL[name])
    assert r["fails"], r["checks"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct_at_the_cells_size(name, card):
    """The control at the cell's own size, on the card."""
    r = control_readings(manifest.cell(name), 6_000_000_001, card)
    assert r["fails"], r["checks"]


def _cli(cwd, extra_env=None):
    env = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
           "HOME": str(cwd)}
    env.update(extra_env or {})
    return subprocess.run(
        [sys.executable, "sqlbench/run.py", "--workload", CELLS[0],
         "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_run_without_a_card_fails_with_no_result():
    proc = _cli(ROOT)
    assert proc.returncode != 0
    assert "correct" not in proc.stdout
    assert "CUDA" in proc.stderr


def test_run_without_the_port_fails_with_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "sqlbench", tmp_path / "sqlbench",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    proc = _cli(tmp_path)
    assert proc.returncode != 0
    assert "correct" not in proc.stdout
    assert "dask_sql_tpu_torch" in proc.stderr


def test_result_line_shape():
    """The line a run prints: the contract's keys, the checks last."""
    result, _ = _run(CELLS[-1], seconds=1.0)
    line = json.loads(json.dumps(result))
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        line["device"])
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert list(line)[-1] == "checks"
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    assert torch.cuda.is_available() or line["device"]["platform"] == "cpu"
