"""The port's native front end against the JAX package's.

- Parse: the port's library (built from ``dask_sql_tpu_torch/native``) gives
  the same JSON envelope as the JAX package's over TPC-H Q1-Q22 and the
  statement corpus of ``tests/unit/test_native_parser.py``, errors and their
  positions included; the AST the bridge makes of it equals the port's
  Python parser's.  Parameter markers are the one difference: the port's
  grammar numbers them, the JAX package's gives each index 0.
- Optimize: ``explain()`` of Q1-Q22 is the same three ways: the port's
  native optimizer, the JAX package's, and the port's Python pipeline
  (``DSQL_NATIVE=0``), with the statistics-driven join order on and off;
  every query counts ``planner_native``.  A plan with a UDF takes the
  Python pipeline and counts ``planner_python``.
- The loader raises when the library does not build.
"""
import os
import re
import sys

import numpy as np
import pandas as pd
import pytest
import torch

import dask_sql_tpu.native as jax_native
from benchmarks.tpch import QUERIES, generate_tpch
from dask_sql_tpu import Context as JaxContext
from dask_sql_tpu.sql import native_bridge as jax_bridge
from dask_sql_tpu.utils import ParsingException as JaxParsingException
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch import native as port_native
from dask_sql_tpu_torch.runtime import telemetry as port_tel
from dask_sql_tpu_torch.sql import native_bridge as port_bridge
from dask_sql_tpu_torch.sql.parser import Parser
from dask_sql_tpu_torch.utils import ParsingException

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "unit"))
from test_native_parser import CORPUS, ERROR_CORPUS  # noqa: E402

sys.path.pop(0)

CPU = torch.device("cpu")
TPCH = [QUERIES[q] for q in sorted(QUERIES)]


@pytest.mark.parametrize("sql", CORPUS + TPCH, ids=range(len(CORPUS + TPCH)))
def test_parse_envelope_and_ast_match(sql):
    envelope = port_native.parse_to_json(sql)
    assert envelope == jax_native.parse_to_json(sql)
    assert port_bridge.json_to_statements(envelope, sql) == \
        Parser(sql).parse_statements()


PARAMS = ["SELECT a FROM t WHERE x > ? AND k <> ?",
          "SELECT ? + 1; SELECT a FROM t WHERE a BETWEEN ? AND ?",
          "SELECT a FROM t WHERE a IN (?, ?, ?) OR b = (SELECT MAX(c) FROM u "
          "WHERE d < ?)"]


@pytest.mark.parametrize("sql", PARAMS, ids=range(len(PARAMS)))
def test_parameter_markers_number_left_to_right(sql):
    """The port's grammar numbers ``?`` markers as its Python parser does;
    the JAX package's native grammar gives each index 0."""
    envelope = port_native.parse_to_json(sql)
    assert port_bridge.json_to_statements(envelope, sql) == \
        Parser(sql).parse_statements()
    jax_envelope = jax_native.parse_to_json(sql)
    assert set(re.findall(r"'index': (\d+)", str(jax_envelope))) == {"0"}
    assert re.sub(r"'index': \d+", "", str(envelope)) == \
        re.sub(r"'index': \d+", "", str(jax_envelope))


@pytest.mark.parametrize("sql", ERROR_CORPUS, ids=range(len(ERROR_CORPUS)))
def test_parse_errors_match(sql):
    envelope = port_native.parse_to_json(sql)
    assert "error" in envelope
    assert envelope == jax_native.parse_to_json(sql)
    with pytest.raises(ParsingException) as port_exc:
        port_bridge.json_to_statements(envelope, sql)
    with pytest.raises(JaxParsingException) as jax_exc:
        jax_bridge.json_to_statements(envelope, sql)
    assert str(port_exc.value) == str(jax_exc.value)


@pytest.fixture(scope="module")
def tpch_contexts():
    jc, pc = JaxContext(), Context(device=CPU)
    for name, frame in generate_tpch(0.001).items():
        jc.create_table(name, frame)
        pc.create_table(name, frame)
    return jc, pc


@pytest.mark.parametrize("adaptive", ["on", "off"])
@pytest.mark.parametrize("qid", sorted(QUERIES))
def test_explain_three_ways(tpch_contexts, monkeypatch, qid, adaptive):
    jc, pc = tpch_contexts
    if adaptive == "on":
        monkeypatch.delenv("DSQL_ADAPTIVE", raising=False)
    sql = QUERIES[qid]
    want = jc.explain(sql)
    before = port_tel.REGISTRY.counters()
    assert pc.explain(sql) == want
    after = port_tel.REGISTRY.counters()
    assert after.get("planner_native", 0) - before.get("planner_native", 0) == 1
    assert after.get("planner_python", 0) == before.get("planner_python", 0)
    monkeypatch.setenv("DSQL_NATIVE", "0")
    assert pc.explain(sql) == want
    assert port_tel.REGISTRY.counters().get("planner_python", 0) - \
        after.get("planner_python", 0) == 1


def test_queries_report_their_planner(tpch_contexts):
    _, pc = tpch_contexts
    pc.sql(QUERIES[6])
    assert pc.last_report.counters.get("planner_native") == 1
    assert "planner_python" not in pc.last_report.counters
    assert port_tel.last_report() is pc.last_report


def test_udf_plan_takes_the_python_pipeline():
    pc = Context(device=CPU)
    pc.create_table("a", pd.DataFrame({"id": np.arange(10),
                                       "x": np.arange(10) * 0.5}))
    pc.register_function(lambda v: v + 1, "plus_one", [("v", np.float64)],
                         np.float64)
    out = pc.sql("SELECT plus_one(x) AS y FROM a WHERE id < 5",
                 return_futures=False)
    assert out["y"].tolist() == [1.0, 1.5, 2.0, 2.5, 3.0]
    assert pc.last_report.counters.get("planner_python") == 1
    assert "planner_native" not in pc.last_report.counters


def test_a_failed_build_raises(monkeypatch, tmp_path):
    """A compiler that fails, or is missing, raises with its output; no
    Python parser takes over."""
    failing = tmp_path / "cxx"
    failing.write_text("#!/bin/sh\necho 'no compiler here' >&2\nexit 1\n")
    failing.chmod(0o755)
    monkeypatch.setattr(port_native, "_lib", None)
    monkeypatch.setattr(port_native, "_build_dir", lambda: tmp_path / "build")
    monkeypatch.setattr(port_native, "_CXX", str(failing))
    with pytest.raises(RuntimeError, match="no compiler here"):
        port_native.load()
    with pytest.raises(RuntimeError, match="no compiler here"):
        Context(device=CPU).sql("SELECT 1")
    monkeypatch.setattr(port_native, "_CXX", str(tmp_path / "missing-g++"))
    with pytest.raises(RuntimeError, match="cannot run"):
        port_native.load()
    assert not (tmp_path / "build").exists() or not any(
        (tmp_path / "build").glob("*.so"))


def test_native_off_takes_the_python_parser(monkeypatch):
    monkeypatch.setenv("DSQL_NATIVE", "0")
    assert port_native.load() is None and not port_native.available()
    pc = Context(device=CPU)
    assert pc.sql("SELECT 1 + 1 AS two", return_futures=False)["two"].tolist() \
        == [2]
    assert pc.last_report.counters.get("planner_python") == 1
