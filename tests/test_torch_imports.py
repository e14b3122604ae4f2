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
    tier's among them: parameters, stage graphs, the ladder's taxonomy,
    fault injection and quarantine, and the canonical plan text."""
    import pkgutil

    import dask_sql_tpu_torch

    names = {info.name for info in pkgutil.walk_packages(
        dask_sql_tpu_torch.__path__, "dask_sql_tpu_torch.")}
    assert {"dask_sql_tpu_torch.physical.compiled",
            "dask_sql_tpu_torch.physical.graphs",
            "dask_sql_tpu_torch.runtime.kvstore",
            "dask_sql_tpu_torch.ops.sorted_agg",
            "dask_sql_tpu_torch.physical.stages",
            "dask_sql_tpu_torch.plan.parameterize",
            "dask_sql_tpu_torch.runtime.faults",
            "dask_sql_tpu_torch.runtime.quarantine",
            "dask_sql_tpu_torch.runtime.resilience",
            "dask_sql_tpu_torch.runtime.result_cache"} <= names


def test_walk_covers_the_serving_path():
    """The import probe walks the serving path too: admission, tenancy,
    the cache, the spill store, the gates, the server and the REPL."""
    import pkgutil

    import dask_sql_tpu_torch

    names = {info.name for info in pkgutil.walk_packages(
        dask_sql_tpu_torch.__path__, "dask_sql_tpu_torch.")}
    assert {"dask_sql_tpu_torch.runtime.scheduler",
            "dask_sql_tpu_torch.runtime.tenancy",
            "dask_sql_tpu_torch.runtime.spill",
            "dask_sql_tpu_torch.runtime.gates",
            "dask_sql_tpu_torch.server.app",
            "dask_sql_tpu_torch.cmd"} <= names


def test_walk_covers_the_out_of_core_path():
    """The import probe walks the out-of-core modules: the chunked source,
    the streaming executor and the grace-hash join."""
    import pkgutil

    import dask_sql_tpu_torch

    names = {info.name for info in pkgutil.walk_packages(
        dask_sql_tpu_torch.__path__, "dask_sql_tpu_torch.")}
    assert {"dask_sql_tpu_torch.io",
            "dask_sql_tpu_torch.io.chunked",
            "dask_sql_tpu_torch.physical.streaming",
            "dask_sql_tpu_torch.physical.morsel"} <= names


_NO_PANDAS_CHUNKED = """
import sys
sys.modules["pandas"] = None          # the card's machine has no pandas
import json
import numpy as np
from dask_sql_tpu_torch import Context

rng = np.random.RandomState(0)
n = 5000
cols = {"k": rng.choice(["a", "b", "c"], n), "x": rng.rand(n),
        "j": np.arange(n) % 97}
c = Context(device="cpu")
c.create_table("t", cols, chunked=True, batch_rows=1024)
c.create_table("u", {"j": np.arange(97), "w": np.arange(97) * 2.0},
               chunked=True, batch_rows=40)
got = c.sql("SELECT k, SUM(x) AS s, COUNT(*) AS n FROM t GROUP BY k "
            "ORDER BY k").to_pylist()
join = c.sql("SELECT SUM(t.x * u.w) AS s FROM t JOIN u ON t.j = u.j"
             ).to_pylist()
want = [[k, float(cols["x"][cols["k"] == k].sum()),
         int((cols["k"] == k).sum())] for k in ("a", "b", "c")]
print(json.dumps({"got": got, "want": want, "join": join[0][0],
                  "join_want": float((cols["x"] * (cols["j"] * 2.0)).sum()),
                  "batches": c.schema["root"].tables["t"].chunked.n_batches,
                  "pandas": sys.modules.get("pandas") is None}))
"""


def test_chunked_query_without_pandas(tmp_path):
    """A chunked table from a dict of numpy arrays, its streamed GROUP BY
    and a grace-hash join of two chunked tables, in a process where
    ``import pandas`` fails."""
    env = {**os.environ, "DSQL_SPILL_MB": "64",
           "DSQL_SPILL_DIR": str(tmp_path), "DSQL_TIERED": "0"}
    out = subprocess.run([sys.executable, "-c", _NO_PANDAS_CHUNKED],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120, check=True, env=env)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["pandas"] and res["batches"] == 5
    assert [r[0] for r in res["got"]] == ["a", "b", "c"]
    for (_, s, n), (_, ws, wn) in zip(res["got"], res["want"]):
        assert n == wn and s == pytest.approx(ws, rel=1e-12)
    assert res["join"] == pytest.approx(res["join_want"], rel=1e-12)


_NO_PANDAS_SERVER = """
import sys
sys.modules["pandas"] = None          # the card's machine has no pandas
import json, time, urllib.request
import numpy as np
from dask_sql_tpu_torch import Context, run_server

c = Context(device="cpu")
c.create_table("t", {"k": np.array(["a", "b", "a"], dtype=object),
                     "x": np.array([1.5, 2.0, 4.0]),
                     "d": np.array(["2020-01-01", "2021-06-30", "NaT"],
                                   dtype="datetime64[D]")})
srv = run_server(context=c, host="127.0.0.1", port=0, blocking=False)
base = f"http://127.0.0.1:{srv.server_port}"
req = urllib.request.Request(
    base + "/v1/statement", method="POST",
    data=b"SELECT k, SUM(x) AS s, MAX(d) AS d FROM t GROUP BY k ORDER BY k")
with urllib.request.urlopen(req) as r:
    p = json.loads(r.read())
while "nextUri" in p:
    time.sleep(0.02)
    with urllib.request.urlopen(p["nextUri"]) as r:
        p = json.loads(r.read())
with urllib.request.urlopen(base + "/metrics") as r:
    metrics = r.read().decode()
with urllib.request.urlopen(base + "/v1/engine") as r:
    engine = json.loads(r.read())
srv.shutdown()
print(json.dumps({"data": p["data"], "types": [c["type"] for c in p["columns"]],
                  "metrics": "dsql_sched_admitted_interactive_total 1" in metrics,
                  "engine": sorted(engine)[:3],
                  "pandas": sys.modules.get("pandas") is None}))
"""


def test_server_round_trip_without_pandas():
    """A server round trip in a process where ``import pandas`` fails."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("DSQL_MAX_CONCURRENT_QUERIES", "DSQL_RESULT_CACHE_MB")}
    env.update(DSQL_TIERED="0", CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", _NO_PANDAS_SERVER], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=env, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"data": [["a", 5.5, "2020-01-01 00:00:00"],
                            ["b", 2.0, "2021-06-30 00:00:00"]],
                   "types": ["varchar", "double", "timestamp"],
                   "metrics": True, "engine": ["active",
                                               "backgroundCompiles",
                                               "cache"],
                   "pandas": True}


@pytest.mark.parametrize("variable,module", [
    ("DSQL_EVENTS", "runtime/events.py"),
    ("DSQL_FLEET_DIR", "runtime/fleet.py"),
    ("DSQL_AUTOPILOT", "runtime/autopilot.py"),
    ("DSQL_HISTORY_FILE", "runtime/flight_recorder.py"),
    ("DSQL_PROFILE", "runtime/profiler.py"),
    ("DSQL_PROGRAM_STORE", "runtime/program_store.py"),
])
def test_armed_unported_subsystems_raise(monkeypatch, tmp_path, variable,
                                         module):
    """A subsystem that only its variable arms, and whose module is not
    ported, raises NotImplementedError naming the module wherever the JAX
    package would import it; the server refuses to start with it armed."""
    import numpy as np

    from dask_sql_tpu_torch import Context, run_server

    c = Context(device="cpu")
    c.create_table("t", {"a": np.arange(3)})
    monkeypatch.setenv(variable, str(tmp_path / "x") if variable in (
        "DSQL_FLEET_DIR", "DSQL_HISTORY_FILE", "DSQL_PROGRAM_STORE")
        else "1")
    with pytest.raises(NotImplementedError, match=module):
        if variable == "DSQL_FLEET_DIR":
            Context(device="cpu")
        else:
            c.sql("SELECT SUM(a) AS s FROM t")
    with pytest.raises(NotImplementedError, match=module):
        run_server(context=c, host="127.0.0.1", port=0, blocking=False)


def test_ingest_dir_arms_the_ported_log(monkeypatch, tmp_path):
    """DSQL_INGEST_DIR arms runtime/ingest.py in the Context and the
    server (it no longer raises); DSQL_INGEST=0 keeps it off."""
    import numpy as np

    from dask_sql_tpu_torch import Context, run_server
    from dask_sql_tpu_torch.runtime import gates, ingest

    assert "DSQL_INGEST_DIR" not in gates.UNPORTED
    monkeypatch.setenv("DSQL_INGEST_DIR", str(tmp_path / "ing"))
    monkeypatch.setenv("DSQL_INGEST", "0")
    c = Context(device="cpu")
    assert c.__dict__.get("_ingest_log") is None
    monkeypatch.setenv("DSQL_INGEST", "1")
    c = Context(device="cpu")
    c.create_table("t", {"a": np.arange(3)})
    srv = run_server(context=c, host="127.0.0.1", port=0, blocking=False)
    try:
        assert c.append_rows("t", {"a": np.array([7])}) == 1
        assert (tmp_path / "ing" / "wal").is_dir()
        assert ingest.engine_section(c)["armed"]
    finally:
        srv.shutdown()
        srv.server_close()
        ingest._reset_for_tests()


def test_default_layers_and_their_switches(monkeypatch):
    """With no variable set a query passes tenancy, the workload manager
    and the result cache; each switch turns its layer off."""
    import numpy as np

    from dask_sql_tpu_torch import Context
    from dask_sql_tpu_torch.runtime import result_cache, tenancy

    for name in ("DSQL_RESULT_CACHE_MB", "DSQL_MAX_CONCURRENT_QUERIES",
                 "DSQL_TENANCY"):
        monkeypatch.delenv(name, raising=False)
    tenancy.get_registry()._reset_for_tests()
    c = Context(device="cpu")
    c.create_table("t", {"a": np.arange(3)})
    q = "SELECT SUM(a) AS s FROM t"
    c.sql(q)
    c.sql(q)
    assert c.last_report.cache["hit"]
    assert c.last_report.priority == "interactive"
    assert tenancy.tenant_rows()[0]["admitted"] == 2
    monkeypatch.setenv("DSQL_RESULT_CACHE_MB", "0")
    monkeypatch.setenv("DSQL_MAX_CONCURRENT_QUERIES", "0")
    monkeypatch.setenv("DSQL_TENANCY", "0")
    c.sql(q)
    assert not c.last_report.cache["hit"] and not c.last_report.cache["stored"]
    assert c.last_report.priority is None
    assert tenancy.tenant_rows()[0]["admitted"] == 2
    tenancy.get_registry()._reset_for_tests()
    result_cache.get_cache().clear()
