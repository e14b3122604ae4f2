"""The port's device profiler (``runtime/profiler.py``), its cost count
(``physical/graphs.py``) and ``EXPLAIN PROFILE`` / ``Context.profile`` /
``Context.visualize``, against the JAX package's.

It mirrors ``tests/unit/test_profiler.py``: the degradation of
``cost_summary``, the model-vs-measured ledger, the scheduler's
``cost_model`` rung, memory sampling and ``EXPLAIN PROFILE`` armed and
unarmed.  XLA counts a program's bytes after fusion and the port per op,
so cost values are compared only with hand counts, never with the JAX
package's: the JAX package is held to the presence of a cost, the keys,
the ladder's ``est_source`` and the shape of ``EXPLAIN PROFILE``'s lines.
Hand counts: ``SELECT SUM(x)`` over ``n`` int64 rows counts at least
``8n`` bytes, and TPC-H Q1's program counts kernel 1's function once,
with the bytes its bound is computed from, whether kernel 1 or its plain
version ran.  Functions with the same arithmetic in both packages
(``cost_error``, ``_fp_key``) agree exactly.
"""
import json
import os
import re
import time

import numpy as np
import pytest
import torch

from benchmarks.tpch import QUERIES, generate_tpch
from dask_sql_tpu import Context as JaxContext
from dask_sql_tpu.plan.parameterize import parameterize_plan as jax_param
from dask_sql_tpu.runtime import profiler as jax_prof
from dask_sql_tpu.runtime import scheduler as jax_sched
from dask_sql_tpu.runtime import telemetry as jax_tel
from dask_sql_tpu.sql.parser import parse_sql as jax_parse
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.ops import gpu_kernels as gk
from dask_sql_tpu_torch.physical import compiled
from dask_sql_tpu_torch.runtime import profiler as prof
from dask_sql_tpu_torch.runtime import scheduler as sched
from dask_sql_tpu_torch.runtime import telemetry as tel
from dask_sql_tpu_torch.sql.parser import parse_sql

CPU = torch.device("cpu")
SUM_SQL = "SELECT SUM(a) AS s FROM t"


@pytest.fixture(autouse=True)
def _fresh_profiler():
    prof.reset()
    yield
    prof.reset()


def _plan(ctx, sql, jax=False):
    if jax:
        return ctx._get_plan(jax_parse(sql)[0].query, sql)
    return ctx._get_plan(parse_sql(sql)[0].query, sql)


def _forget_programs():
    for entry in list(compiled._cache.values()):
        if isinstance(entry, compiled._Compiled):
            entry.fn.release()
    compiled._cache.clear()


# ---------------------------------------------------------------------------
# cost_summary degradation
# ---------------------------------------------------------------------------

class _Program:
    def __init__(self, cost):
        self.cost = cost


@pytest.mark.parametrize("cost", [
    None,                                      # never counted
    "garbage",                                 # not a dict
    {},                                        # empty
    {"flops": 0.0, "bytes": 0},                # all zero: no signal
    {"flops": float("nan"), "bytes": float("inf")},
    {"flops": "garbage"},
])
def test_cost_summary_degrades_to_none(cost):
    assert prof.cost_summary(_Program(cost)) is None


def test_cost_summary_absent_and_present():
    assert prof.cost_summary(object()) is None
    want = {"flops": 12.0, "bytes": 34.0, "transcendentals": 2.0}
    got = prof.cost_summary(_Program(dict(want, kernels={"k": {}})))
    assert got == want and set(got) == {"flops", "bytes", "transcendentals"}


# ---------------------------------------------------------------------------
# the ledger
# ---------------------------------------------------------------------------

def test_fp_key_and_cost_error_equal_the_jax_packages():
    assert prof._fp_key(None) is None and prof._fp_key("") is None
    for text in ("plan-text", "other-plan", "x" * 300):
        assert prof._fp_key(text) == jax_prof._fp_key(text)
    assert prof._fp_key("plan-text") != prof._fp_key("other-plan")
    grid = [None, 0, 10, 50.0, 100.0, 150.0]
    for p in grid:
        for m in grid:
            assert prof.cost_error(p, m) == jax_prof.cost_error(p, m)
    assert prof.cost_error(150.0, 100.0) == pytest.approx(0.5)


def test_ledger_roundtrip_overwrites_not_double_counts():
    cost = {"flops": 10.0, "bytes": 100.0, "transcendentals": 0.0}
    prof.record_program_cost("fp1", "digA", cost)
    prof.record_program_cost("fp1", "digA", cost)
    prof.record_program_cost("fp1", "digB", {"flops": 1.0, "bytes": 7.0})
    prof.record_program_cost("fp1", "digC", None)
    prof.record_program_cost(None, "digA", {"bytes": 1.0})
    got = prof.program_costs("fp1")
    assert set(got) == {"digA", "digB"} and got["digA"]["bytes"] == 100.0
    prof.record_measured("digA", nbytes=50, wall_ms=1.5, device_ms=0.5)
    got = prof.program_costs("fp1")["digA"]
    assert (got["measured_bytes"], got["measured_ms"],
            got["measured_device_ms"]) == (50.0, 1.5, 0.5)
    assert prof.program_costs("nope") == {}
    sec = prof.engine_section()
    assert sec["enabled"] is True and sec["sampleMs"] >= 10.0
    assert (sec["costPlans"], sec["costPrograms"]) == (1, 2)


# ---------------------------------------------------------------------------
# the cost count and the scheduler's rung
# ---------------------------------------------------------------------------

def test_sum_counts_at_least_its_column(monkeypatch):
    """``SELECT SUM(x)`` over n int64 rows reads the column: >= 8n bytes;
    the cost is counted once, at the program's build, and rides every
    later run's span."""
    monkeypatch.setenv("DSQL_PROFILE", "1")
    n = 5000
    c = Context(device=CPU)
    c.create_table("t", {"a": np.arange(n, dtype=np.int64)})
    _forget_programs()
    assert c.sql(SUM_SQL).to_pylist() == [[n * (n - 1) // 2]]
    (entry,) = [e for e in compiled._cache.values()
                if isinstance(e, compiled._Compiled)]
    cost = entry.fn.cost
    assert set(cost) == {"flops", "bytes", "transcendentals", "kernels"}
    assert cost["bytes"] >= 8 * n and cost["flops"] >= n
    spans = list(c.last_report.root.walk())
    assert any(s.attrs.get("cost_bytes") == cost["bytes"] for s in spans)
    c.sql(SUM_SQL)                               # a hit: no second count
    assert entry.fn.cost == cost
    assert any(s.attrs.get("cost_bytes") == cost["bytes"]
               for s in c.last_report.root.walk())


def test_unarmed_build_counts_nothing(monkeypatch):
    monkeypatch.delenv("DSQL_PROFILE", raising=False)
    c = Context(device=CPU)
    c.create_table("t", {"a": np.arange(10, dtype=np.int64)})
    _forget_programs()
    c.sql(SUM_SQL)
    assert all(e.fn.cost is None for e in compiled._cache.values()
               if isinstance(e, compiled._Compiled))
    assert not any(s.attrs.get("cost_bytes")
                   for s in c.last_report.root.walk())


@pytest.fixture(scope="module")
def tpch_small():
    data = generate_tpch(0.001)
    c = Context(device=CPU)
    for name, df in data.items():
        c.create_table(name, df)
    return data, c


def _q1_cost(c):
    _forget_programs()
    c.sql(QUERIES[1])
    (entry,) = [e for e in compiled._cache.values()
                if isinstance(e, compiled._Compiled)]
    return entry.fn.cost


def test_q1_counts_kernel_1_once_whichever_version_ran(monkeypatch,
                                                       tpch_small):
    """Q1's static-domain GROUP BY is kernel 1's: its function counts as
    one record with the bytes of its bound (vals, codes, mask and scale
    read once, the limb and non-finite totals written once), and the
    program's count is the same when the limb totals take another route
    (a card's launch here stands in for an extra op chain)."""
    monkeypatch.setenv("DSQL_PROFILE", "1")
    data, c = tpch_small
    seen = []
    plain = gk.segsum_limb_totals_plain

    def spy(vals, codes, mask, scale, row_classes, num_groups):
        seen.append((tuple(vals.shape), tuple(row_classes), num_groups))
        return plain(vals, codes, mask, scale, row_classes, num_groups)

    monkeypatch.setattr(gk, "segsum_limb_totals_plain", spy)
    _q1_cost(c)      # fills the caches a first run fills (dictionaries)
    seen.clear()
    cost = _q1_cost(c)
    (shape, classes, groups), = seen
    a, n = shape
    want = gk.segsum_fixedpoint_work(a, n, classes, groups)[0]
    assert n == len(data["lineitem"])
    assert want == (a * n * 8 + n * 4 + n + a * 8
                    + (gk.limb_layout(classes)[2][-1] + 3 * a) * groups * 8)
    assert cost["kernels"] == {"segsum_fixedpoint": {
        "launches": 1, "bytes": want, "flops": a * n}}
    assert cost["bytes"] >= want

    def other_route(vals, codes, mask, scale, row_classes, num_groups):
        # more ops than the plain version: none of them may count
        tmp = (vals * 1.0).contiguous() + 0.0
        return plain(tmp, codes.clone(), mask.clone(), scale.clone(),
                     row_classes, num_groups)

    monkeypatch.setattr(gk, "segsum_limb_totals_plain", other_route)
    assert _q1_cost(c) == cost


def test_cost_model_rung_matches_the_jax_package(monkeypatch):
    """tests/unit/test_profiler.py's rung: unarmed nothing is consulted;
    armed before a build the heuristic answers; after a compiled run of a
    literal-free plan the counted bytes answer (``cost_model``), in both
    packages."""
    monkeypatch.delenv("DSQL_PROFILE", raising=False)
    sources = {}
    for pkg in ("jax", "port"):
        jax = pkg == "jax"
        c = JaxContext() if jax else Context(device=CPU)
        c.create_table("t", {"a": np.arange(100, dtype=np.int64)})
        plan = _plan(c, SUM_SQL, jax)
        s, reg = (jax_sched, jax_tel.REGISTRY) if jax else (sched,
                                                           tel.REGISTRY)
        got = [s.estimate_working_set(plan, c)[1]]
        monkeypatch.setenv("DSQL_PROFILE", "1")
        if jax:
            jax_prof.reset()
        else:
            _forget_programs()
        got.append(s.estimate_working_set(plan, c)[1])
        c.sql(SUM_SQL)
        before = reg.get("estimate_from_cost_model")
        est, src = s.estimate_working_set(plan, c)
        got.append(src)
        assert est > 0
        assert reg.get("estimate_from_cost_model") == before + 1
        sources[pkg] = got
        monkeypatch.delenv("DSQL_PROFILE")
    assert sources["port"] == sources["jax"] == \
        ["heuristic", "heuristic", "cost_model"]


def test_tpch_est_source_with_only_the_profiler_armed(monkeypatch,
                                                      tpch_small):
    """Q1-Q22 planned in both packages with only DSQL_PROFILE armed: the
    same rung before any build.  After the port's compiled runs the rung
    answers ``cost_model`` exactly for the plans the JAX package's own
    parameterizer hoists no literal from: both tiers key a program by the
    parameterized plan and the rung by the plan as planned."""
    monkeypatch.setenv("DSQL_PROFILE", "1")
    data, pc = tpch_small
    jc = JaxContext()
    for name, df in data.items():
        jc.create_table(name, df)
    plans = {q: (_plan(pc, QUERIES[q]), _plan(jc, QUERIES[q], jax=True))
             for q in sorted(QUERIES)}
    _forget_programs()
    for q, (pp, jp) in plans.items():
        assert sched.estimate_working_set(pp, pc)[1] == \
            jax_sched.estimate_working_set(jp, jc)[1], q
    ran = (1, 6, 9, 11, 13, 16, 17, 22)
    for q in ran:
        pc.sql(QUERIES[q])
    for q in ran:
        pp, jp = plans[q]
        literal_free = jax_param(jp)[1] == 0
        want = "cost_model" if literal_free else \
            jax_sched.estimate_working_set(jp, jc)[1]
        assert sched.estimate_working_set(pp, pc)[1] == want, q
    assert sum(jax_param(plans[q][1])[1] == 0 for q in ran) >= 5


# ---------------------------------------------------------------------------
# device memory
# ---------------------------------------------------------------------------

def test_memory_rows_sample_ring_and_gauges():
    Context(device=CPU)
    rows = prof.device_memory_rows()
    assert rows and all(
        r == {"id": 0, "platform": "cpu", "kind": "cpu", "bytes_in_use": 0,
              "peak_bytes_in_use": 0, "bytes_limit": 0} for r in rows)
    assert set(rows[0]) == set(jax_prof.device_memory_rows()[0])
    n0 = len(prof.snapshots())
    prof.sample()
    snaps = prof.snapshots()
    assert len(snaps) == n0 + 1 and {"unix", "devices"} <= set(snaps[-1])
    assert tel.REGISTRY.get_gauge("profile_hbm_bytes_in_use") == 0


def test_card_rows_read_only_used_cards_and_their_size_once(monkeypatch):
    """A card's row comes from the allocator's host-side statistics of
    the cards a Context uses, never another card's, and its total memory
    is read once."""
    calls = {"stats": [], "props": []}

    class _Props:
        total_memory = 80 * 2**30

    def stats(i):
        calls["stats"].append(i)
        return {"allocated_bytes.all.current": 5 + i,
                "allocated_bytes.all.peak": 9 + i}

    def props(i):
        calls["props"].append(i)
        return _Props()

    monkeypatch.setattr(torch.cuda, "memory_stats", stats)
    monkeypatch.setattr(torch.cuda, "get_device_properties", props)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: "card")
    monkeypatch.setattr(tel, "used_devices",
                        lambda: [torch.device("cuda", 2)])
    prof._limits.clear()
    for _ in range(2):
        (row,) = prof.device_memory_rows()
    assert row == {"id": 2, "platform": "gpu", "kind": "card",
                   "bytes_in_use": 7, "peak_bytes_in_use": 11,
                   "bytes_limit": 80 * 2**30}
    assert calls == {"stats": [2, 2], "props": [2]}
    # a Context's own devices, each once (a mesh of one card repeated)
    rows = prof.device_memory_rows([torch.device("cuda", 2)] * 4)
    assert [r["id"] for r in rows] == [2]
    prof._limits.clear()


def _wait(cond, seconds: float = 5.0) -> bool:
    deadline = time.monotonic() + seconds
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


def test_sampler_runs_while_armed(monkeypatch):
    monkeypatch.setenv("DSQL_PROFILE", "1")
    monkeypatch.setenv("DSQL_PROFILE_SAMPLE_MS", "10")
    assert prof.sample_interval_ms() == 10.0
    before = tel.REGISTRY.get("profile_samples")
    prof.ensure_sampler()
    assert _wait(lambda: tel.REGISTRY.get("profile_samples") >= before + 3)
    monkeypatch.delenv("DSQL_PROFILE")
    # disarmed: the thread ends, and a later armed query starts another
    assert _wait(lambda: not prof._sampler_started)


# ---------------------------------------------------------------------------
# EXPLAIN PROFILE
# ---------------------------------------------------------------------------

def test_parser_explain_profile_flag():
    (stmt,) = parse_sql("EXPLAIN PROFILE SELECT 1")
    assert stmt.profile is True and stmt.analyze is False
    (stmt,) = parse_sql("EXPLAIN ANALYZE SELECT 1")
    assert stmt.profile is False and stmt.analyze is True


def _lines(ctx, sql, jax=False):
    if jax:
        return [str(x) for x in ctx.sql(sql, return_futures=False)["PLAN"]]
    return [r[0] for r in ctx.sql(sql).to_pylist()]


GROUP_SQL = "EXPLAIN PROFILE SELECT b, SUM(a) AS s FROM t GROUP BY b"


def _tables():
    return {"a": np.arange(500, dtype=np.int64),
            "b": np.arange(500, dtype=np.int64) % 5}


def test_explain_profile_unarmed_prints_the_plan_and_runs_nothing(
        monkeypatch):
    monkeypatch.delenv("DSQL_PROFILE", raising=False)
    got = {}
    for pkg in ("jax", "port"):
        c = JaxContext() if pkg == "jax" else Context(device=CPU)
        c.create_table("t", _tables())
        reg = jax_tel.REGISTRY if pkg == "jax" else tel.REGISTRY
        compiles = reg.get("compiles")
        got[pkg] = _lines(c, GROUP_SQL, pkg == "jax")
        assert reg.get("compiles") == compiles
    assert got["port"] == got["jax"]
    assert got["port"][-1] == "-- profile: disabled (set DSQL_PROFILE=1)"


def _shape(line: str) -> tuple:
    """A line's kind and its keys, without the values."""
    head = line.split(":", 1)[0]
    head = re.sub(r"\[\d+\]|\d+$", "", head).strip()
    return head, tuple(re.findall(r"(\w+)=", line))


def test_explain_profile_armed_lines_equal_in_shape(monkeypatch):
    """Armed, both packages run the query on the normal path and print the
    same kinds of lines with the same keys: wall and tier, the admission
    estimate, the whole-plan stage row, one row per device."""
    monkeypatch.setenv("DSQL_PROFILE", "1")
    monkeypatch.setenv("DSQL_MAX_CONCURRENT_QUERIES", "2")
    got = {}
    for pkg in ("jax", "port"):
        c = JaxContext() if pkg == "jax" else Context(device=CPU)
        c.create_table("t", _tables())
        got[pkg] = _lines(c, GROUP_SQL, pkg == "jax")
    shapes = {pkg: [_shape(l) for l in lines if l.startswith("-- ")]
              for pkg, lines in got.items()}
    # the JAX package has a device line per virtual CPU device
    assert sorted(set(shapes["port"])) == sorted(set(shapes["jax"]))
    port = got["port"]
    assert any(l.startswith("-- profile: wall=") and "tier=compiled" in l
               for l in port)
    assert any(l.startswith("-- estimate: source=") for l in port)
    (stage,) = [l for l in port if l.startswith("-- stage whole:")]
    assert " flops=n/a" not in stage and " bytes=n/a" not in stage
    # one row per device of the Context (here one CPU device), whatever
    # else the process uses
    dev = [l for l in port if l.startswith("-- device")]
    assert len(dev) == 1 and "platform=cpu" in dev[0]


def test_explain_profile_bypasses_the_result_cache(monkeypatch):
    monkeypatch.setenv("DSQL_PROFILE", "1")
    monkeypatch.setenv("DSQL_RESULT_CACHE_MB", "64")
    c = Context(device=CPU)
    c.create_table("t", {"a": np.arange(100, dtype=np.int64)})
    c.sql(SUM_SQL)
    c.sql(SUM_SQL)                      # primes a hit
    hits0 = tel.REGISTRY.get("result_cache_hits")
    lines = _lines(c, "EXPLAIN PROFILE " + SUM_SQL)
    assert tel.REGISTRY.get("result_cache_hits") == hits0
    assert any(l.startswith("-- stage") for l in lines)
    assert c._rc_bypass is False


# ---------------------------------------------------------------------------
# Context.profile and Context.visualize
# ---------------------------------------------------------------------------

def test_context_profile_writes_a_cpu_trace(tmp_path):
    c = Context(device=CPU)
    c.create_table("t", {"a": np.arange(100, dtype=np.int64)})
    out = c.profile(SUM_SQL, trace_dir=str(tmp_path / "tr"))
    assert out.to_pylist() == [[4950]]
    path = c.last_profile_trace
    assert os.path.dirname(path) == str(tmp_path / "tr")
    with open(path) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("aten::" in n for n in names)


def test_visualize_writes_the_text_plan(tmp_path):
    pc, jc = Context(device=CPU), JaxContext()
    for c in (pc, jc):
        c.create_table("t", {"a": np.arange(4, dtype=np.int64)})
    target = str(tmp_path / "plan.png")
    text = pc.visualize(SUM_SQL, target)
    with open(str(tmp_path / "plan.txt")) as f:
        assert f.read() == text == pc.explain(SUM_SQL)
    assert text == jc.visualize(SUM_SQL, str(tmp_path / "jax.png"))
