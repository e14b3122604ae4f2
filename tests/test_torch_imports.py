"""The port stands alone: importing it pulls in neither JAX nor any module
of the JAX package, and its entry points run on the card unless asked
otherwise."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, json, pkgutil, sys
import dask_sql_tpu_torch
for info in pkgutil.walk_packages(dask_sql_tpu_torch.__path__, "dask_sql_tpu_torch."):
    importlib.import_module(info.name)
import chip_smoke
print(json.dumps(sorted(m for m in sys.modules
                        if m == "jax" or m.startswith("jax.")
                        or m == "jaxlib" or m.startswith("jaxlib.")
                        or m.startswith("dask_sql_tpu") and not (
                            m == "dask_sql_tpu_torch"
                            or m.startswith("dask_sql_tpu_torch."))
                        or m == "pandas")))
"""


def test_import_pulls_in_no_jax_and_no_jax_package():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_context_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from dask_sql_tpu_torch import Context

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Context()
    assert Context(device="cpu").device == torch.device("cpu")


def test_chip_smoke_refuses_to_run_without_cuda(tmp_path):
    """Without a card the smoke script fails and prints no result; alone in
    a directory it fails too."""
    for cwd in (ROOT, tmp_path):
        script = ROOT / "chip_smoke.py"
        if cwd == tmp_path:
            script = tmp_path / "chip_smoke.py"
            script.write_text((ROOT / "chip_smoke.py").read_text())
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120,
                             env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


_MAPS_PROBE = """
import json, numpy as np
from dask_sql_tpu_torch import Context
c = Context(device="cpu")
c.create_table("t", {"k": np.array([1, 2, 3]), "s": np.array(["a", "b", "a"])})
c.sql("SELECT s, SUM(k) AS n FROM t GROUP BY s")
print(json.dumps([line.split()[-1] for line in open("/proc/self/maps")
                  if line.rstrip().endswith(".so")]))
"""


def test_port_never_maps_the_jax_native_library():
    """After a query the port's process maps its own parser library (built
    from dask_sql_tpu_torch/native) and never the JAX package's."""
    out = subprocess.run([sys.executable, "-c", _MAPS_PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    libs = json.loads(out.stdout.strip().splitlines()[-1])
    assert not any("/dask_sql_tpu/native/" in p for p in libs)
    assert any("/build/dask_sql_tpu_torch/libdsqlparser-" in p for p in libs)


def test_walk_covers_the_compiled_tier():
    """The import probe above walks every module of the port, the compiled
    tier's among them."""
    import pkgutil

    import dask_sql_tpu_torch

    names = {info.name for info in pkgutil.walk_packages(
        dask_sql_tpu_torch.__path__, "dask_sql_tpu_torch.")}
    assert {"dask_sql_tpu_torch.physical.compiled",
            "dask_sql_tpu_torch.physical.graphs",
            "dask_sql_tpu_torch.runtime.kvstore",
            "dask_sql_tpu_torch.ops.sorted_agg"} <= names
