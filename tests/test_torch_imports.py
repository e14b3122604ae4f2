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
for name in ("mesh", "exchange", "partial_agg", "distributed", "spmd"):
    assert f"dask_sql_tpu_torch.parallel.{name}" in sys.modules, name
print(json.dumps(sorted(m for m in sys.modules
                        if m == "jax" or m.startswith("jax.")
                        or m == "jaxlib" or m.startswith("jaxlib.")
                        or m.startswith("dask_sql_tpu") and not (
                            m == "dask_sql_tpu_torch"
                            or m.startswith("dask_sql_tpu_torch."))
                        or m.split(".")[0] in _HOST_LIBRARIES)))
"""

#: the libraries of the host boundary: imported only inside the functions
#: that need them, never when a module of the port is imported
_HOST_LIBRARIES = ("pandas", "pyarrow", "sklearn", "joblib", "IPython",
                   "fugue", "intake", "fsspec")
_PROBE = _PROBE.replace("_HOST_LIBRARIES", repr(_HOST_LIBRARIES))


def test_import_pulls_in_no_jax_and_no_jax_package():
    """Nor any library of the host boundary (pandas, pyarrow, sklearn,
    joblib, IPython, fugue, intake, fsspec)."""
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


def test_walk_covers_the_host_boundary():
    """The import probe walks the input plugins, Hive, the models and the
    integrations."""
    import pkgutil

    import dask_sql_tpu_torch

    names = {info.name for info in pkgutil.walk_packages(
        dask_sql_tpu_torch.__path__, "dask_sql_tpu_torch.")}
    assert {"dask_sql_tpu_torch.io.inputs",
            "dask_sql_tpu_torch.io.hive",
            "dask_sql_tpu_torch.models.training",
            "dask_sql_tpu_torch.models.incremental",
            "dask_sql_tpu_torch.models.executor_bridge",
            "dask_sql_tpu_torch.integrations.ipython",
            "dask_sql_tpu_torch.integrations.fugue"} <= names


_NO_PANDAS_MODELS = """
import sys
sys.modules["pandas"] = None          # a machine without pandas
sys.modules["sklearn"] = None         # nor sklearn (the card's has none)
import json, os, pickle
import numpy as np
from dask_sql_tpu_torch import Context


class Lstsq:
    def fit(self, X, y):
        A = np.column_stack([X, np.ones(len(X))])
        self.coef_ = np.linalg.solve(A.T @ A, A.T @ y)
        return self

    def partial_fit(self, X, y):
        A = np.column_stack([X, np.ones(len(X))])
        self.ata_ = getattr(self, "ata_", 0) + A.T @ A
        self.aty_ = getattr(self, "aty_", 0) + A.T @ y
        self.coef_ = np.linalg.solve(self.ata_, self.aty_)
        return self

    def predict(self, X):
        return X @ self.coef_[:-1] + self.coef_[-1]

    def get_params(self, deep=True):
        return {}


rng = np.random.RandomState(0)
n = 3000
cols = {"a": rng.rand(n), "b": rng.randint(0, 9, n), "k": rng.choice(
    ["x", "y"], n)}
cols["t"] = 2 * cols["a"] - 0.5 * cols["b"] + 1.0
c = Context(device="cpu")
c.create_table("t", cols)
c.create_table("tc", {k: cols[k] for k in ("a", "b", "t")}, chunked=True,
               batch_rows=700)
c.sql("CREATE MODEL m WITH (model_class = '__main__.Lstsq', "
      "target_column = 't') AS (SELECT a, b, t FROM t)")
c.sql("CREATE MODEL ms WITH (model_class = '__main__.Lstsq', wrap_fit = "
      "True, target_column = 't') AS (SELECT a, b, t FROM tc)")
got = c.sql("SELECT k, SUM(target) AS s, COUNT(*) AS n FROM PREDICT(MODEL m, "
            "SELECT k, a, b FROM t) GROUP BY k ORDER BY k").to_pylist()
c.sql("EXPORT MODEL m WITH (format = 'pickle', location = 'm.pkl')")
loaded = pickle.load(open("m.pkl", "rb"))
errors = {}
c.register_function(lambda r: r["a0"], "rowf", [("x", np.float64)],
                    np.float64, row_udf=True)
c.register_aggregation(lambda s: s.max(), "smax", [("x", np.float64)],
                       np.float64)
np.savetxt("t.csv", np.arange(4.0))
for name, fn in (
        ("csv", lambda: c.create_table("u", "t.csv")),
        ("location", lambda: c.sql(
            "CREATE TABLE u WITH (location = 't.csv', format = 'csv')")),
        ("row_udf", lambda: c.sql("SELECT rowf(a) FROM t")),
        ("udaf", lambda: c.sql("SELECT k, smax(a) FROM t GROUP BY k"))):
    try:
        fn()
        errors[name] = None
    except ImportError as exc:
        errors[name] = str(exc)
want = [[k, float((cols["t"][cols["k"] == k]).sum()),
         int((cols["k"] == k).sum())] for k in ("x", "y")]
print(json.dumps({
    "got": got, "want": want,
    "coef": c.schema["root"].models["m"][0].coef_.tolist(),
    "stream_coef": c.schema["root"].models["ms"][0].coef_.tolist(),
    "loaded": loaded.coef_.tolist(), "errors": errors,
    "blocked": [sys.modules.get(m) is None for m in ("pandas", "sklearn")]}))
"""


def test_models_and_host_boundary_without_pandas(tmp_path):
    """A machine without pandas, here: with pandas and sklearn blocked, CREATE
    MODEL over numeric columns (gathered and streamed with wrap_fit),
    PREDICT under a GROUP BY and EXPORT MODEL work with a numpy model
    class; a csv path, CREATE TABLE ... WITH (location), a row UDF and a
    UDAF raise ImportError naming pandas."""
    env = {**os.environ, "DSQL_TIERED": "0", "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "-c", _NO_PANDAS_MODELS],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=180, check=True,
                         env={**env, "PYTHONPATH": str(ROOT)})
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["blocked"] == [True, True]
    assert res["coef"] == pytest.approx([2.0, -0.5, 1.0], rel=1e-9)
    assert res["stream_coef"] == pytest.approx(res["coef"], rel=1e-9)
    assert res["loaded"] == res["coef"]
    for (k, s, n), (wk, ws, wn) in zip(res["got"], res["want"]):
        assert (k, n) == (wk, wn) and s == pytest.approx(ws, rel=1e-9)
    assert set(res["errors"]) == {"csv", "location", "row_udf", "udaf"}
    for name, message in res["errors"].items():
        assert message is not None and "pandas" in message, name


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


#: what arming the fleet writes into os.environ (setdefault, which
#: monkeypatch does not see)
_FLEET_ENV = ("DSQL_EVENTS", "DSQL_EVENTS_FILE", "DSQL_HISTORY_FILE",
              "DSQL_REPLICA_ID")


@pytest.mark.parametrize("variable,module", [
    ("DSQL_EVENTS", "events"),
    ("DSQL_HISTORY_FILE", "flight_recorder"),
    ("DSQL_PROFILE", "profiler"),
    ("DSQL_FLEET_DIR", "fleet"),
    ("DSQL_AUTOPILOT", "autopilot"),
])
def test_armed_observability_runs(monkeypatch, tmp_path, variable, module):
    """Each observability variable arms its ported module: the query runs
    and leaves its mark there (an event, an envelope, a sample, this
    replica's heartbeat and id on the report, the autopilot's context),
    and the server starts with it armed.  The fleet and the autopilot
    raised here before they were ported."""
    import importlib

    import numpy as np

    from dask_sql_tpu_torch import Context, run_server

    if variable in ("DSQL_HISTORY_FILE", "DSQL_FLEET_DIR"):
        monkeypatch.setenv(variable, str(tmp_path / "hist.jsonl"))
    else:
        monkeypatch.setenv(variable, "1")
    if module == "fleet":
        for key in _FLEET_ENV:
            monkeypatch.delenv(key, raising=False)
        monkeypatch.setenv("DSQL_REPLICA_ID", "r-imports")
    else:
        monkeypatch.setenv("DSQL_AUTOPILOT_INTERVAL_S", "0")
    mod = importlib.import_module(f"dask_sql_tpu_torch.runtime.{module}")
    if module in ("fleet", "autopilot"):
        mod._reset_for_tests()
    try:
        c = Context(device="cpu")
        c.create_table("t", {"a": np.arange(3)})
        samples = mod.snapshots() if module == "profiler" else None
        assert c.sql("SELECT SUM(a) AS s FROM t").to_pylist() == [[3]]
        assert f"dask_sql_tpu_torch.runtime.{module}" in sys.modules
        if module == "events":
            assert c.last_report.trace_id
            done = [e for e in mod.get_bus().snapshot()
                    if e["type"] == "query.done"
                    and e["trace"] == c.last_report.trace_id]
            assert done and done[0]["rows_out"] == 1
        elif module == "flight_recorder":
            (env,) = mod.read_events(kind="query")
            assert env["outcome"] == "ok" and env["rows_out"] == 1
        elif module == "fleet":
            assert c.last_report.replica == "r-imports"
            assert [r["replica"] for r in mod.read_replicas()] == [
                "r-imports"]
        elif module == "autopilot":
            assert mod._CTX_REF() is c
        else:
            assert len(mod.snapshots()) > len(samples)
        srv = run_server(context=c, host="127.0.0.1", port=0,
                         blocking=False)
        try:
            assert srv.server_port > 0
        finally:
            srv.shutdown()
            srv.server_close()
    finally:
        if module in ("fleet", "autopilot"):
            mod._reset_for_tests()
        if module == "fleet":
            from dask_sql_tpu_torch.runtime import events
            events._reset_for_tests()
            for key in _FLEET_ENV:
                os.environ.pop(key, None)


_UNARMED = """
import json, sys
import numpy as np
from dask_sql_tpu_torch import Context
c = Context(device="cpu")
c.create_table("t", {"a": np.arange(4)})
assert c.sql("SELECT SUM(a) AS s FROM t").to_pylist() == [[6]]
c.sql("EXPLAIN PROFILE SELECT SUM(a) AS s FROM t")
print(json.dumps(sorted(m for m in sys.modules if m.split(".")[-1] in (
    "events", "flight_recorder", "profiler") and m.startswith("dask_sql"))))
"""


def test_unarmed_query_loads_none_of_the_three():
    """With DSQL_EVENTS, DSQL_HISTORY_FILE and DSQL_PROFILE unset a query
    (and an EXPLAIN PROFILE, which then only prints the plan) never
    imports runtime/events.py, flight_recorder.py or profiler.py."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("DSQL_EVENTS", "DSQL_HISTORY_FILE", "DSQL_PROFILE")}
    env.update(DSQL_TIERED="0", CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", _UNARMED], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=env, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


_UNARMED_SLICE = """
import json, sys
import numpy as np
from dask_sql_tpu_torch import Context
c = Context(device="cpu")
c.create_table("t", {"a": np.arange(4)})
assert c.sql("SELECT SUM(a) AS s FROM t").to_pylist() == [[6]]
assert c.sql("SELECT * FROM system.devices").num_rows == 1
for name in ("queries", "events", "replicas", "autopilot", "mesh"):
    c.sql(f"SELECT * FROM system.{name}")
print(json.dumps(sorted(m for m in sys.modules if m.split(".")[-1] in (
    "fleet", "autopilot", "profiler", "program_store")
    and m.startswith("dask_sql"))))
"""


def test_unarmed_query_loads_neither_fleet_nor_autopilot():
    """With DSQL_FLEET_DIR and DSQL_AUTOPILOT unset a query, and reads of
    the system tables they feed, import neither runtime/fleet.py nor
    runtime/autopilot.py; system.devices reads the card's memory without
    importing runtime/profiler.py."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("DSQL_FLEET_DIR", "DSQL_AUTOPILOT", "DSQL_PROFILE",
                        "DSQL_PROGRAM_STORE")}
    env.update(DSQL_TIERED="0", CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", _UNARMED_SLICE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=env, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


_JAX_UNARMED = """
import sys
from dask_sql_tpu import Context
c = Context()
c.create_table('t', {'a': [1, 2, 3]})
assert c.sql('SELECT SUM(a) AS s FROM t').to_pylist() == [[6]]
print(sorted(m for m in sys.modules if m in (
    'dask_sql_tpu.runtime.events', 'dask_sql_tpu.runtime.profiler')))
"""


def test_jax_package_unarmed_query_loads_neither():
    """The JAX package's own rule, which the port keeps for all three
    modules (above): an unarmed query loads neither the bus nor the
    profiler.  (Its workload manager imports the
    flight recorder for the estimate ladder whatever the variable says;
    the port checks the variable first.)"""
    env = {k: v for k, v in os.environ.items() if not k.startswith("DSQL_")}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, "-c", _JAX_UNARMED], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_ingest_dir_arms_the_ported_log(monkeypatch, tmp_path):
    """DSQL_INGEST_DIR arms runtime/ingest.py in the Context and the
    server (it no longer raises); DSQL_INGEST=0 keeps it off."""
    import numpy as np

    from dask_sql_tpu_torch import Context, run_server
    from dask_sql_tpu_torch.runtime import gates, ingest

    assert not hasattr(gates, "UNPORTED")   # nothing is left unported
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
