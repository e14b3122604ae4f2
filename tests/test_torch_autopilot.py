"""The port's autopilot (``runtime/autopilot.py``) against the JAX package's.

It mirrors ``tests/unit/test_autopilot_unit.py`` and
``tests/integration/test_autopilot.py``.  The same query sequence in both
packages (each with its own history file) gives equal journals (action,
fingerprint, view name, verdict kind) and equal served answers: a repeated
GROUP BY is materialized as ``auto_mv_<fp[:12]>`` at a tick, and after an
append its repeat is served from the view, refreshed incrementally.  The
kill switch restores the baseline, the budget, the cold drop and the
blacklist act as in the JAX package, the ``autopilot`` fault site turns a
tick into a journaled no-op, a hint file written by either package is read
by the other, and a query text of 500 characters or more never
materializes in either (the history cuts texts at 500).

Re-planning: stub reports give both packages the same hints and the same
two-strike verdicts; a forced-skew grace join records a partition hint and
its next run partitions twice as finely, with the pair join built as a
program of its own; an SPMD join hinted to ``exchange`` records and builds
its own stage programs (the CPU's counterpart of a new CUDA graph
capture), and the answers stay equal.
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from dask_sql_tpu import Context as JaxContext
from dask_sql_tpu.runtime import autopilot as jax_ap
from dask_sql_tpu.runtime import flight_recorder as jax_fr
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.runtime import autopilot as ap
from dask_sql_tpu_torch.runtime import faults
from dask_sql_tpu_torch.runtime import flight_recorder as fr
from dask_sql_tpu_torch.runtime import matview as mv
from dask_sql_tpu_torch.runtime import spill as spill_mod
from dask_sql_tpu_torch.runtime import telemetry as tel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
BOTH = {"jax": jax_ap, "port": ap}
SQL = "SELECT a, SUM(b) AS s FROM t GROUP BY a"


@pytest.fixture()
def armed(tmp_path, monkeypatch):
    """Both packages' autopilots armed with explicit ticks only; each
    package gets its own history file (``use``)."""
    monkeypatch.setenv("DSQL_AUTOPILOT", "1")
    monkeypatch.setenv("DSQL_AUTOPILOT_INTERVAL_S", "0")
    monkeypatch.setenv("DSQL_AUTOPILOT_MIN_HITS", "2")
    monkeypatch.setenv("DSQL_RESULT_CACHE_MB", "64")
    for mod in BOTH.values():
        mod._reset_for_tests()

    def use(pkg: str) -> None:
        monkeypatch.setenv("DSQL_HISTORY_FILE", str(tmp_path / f"{pkg}.jsonl"))

    use("port")
    yield use
    for mod in BOTH.values():
        mod._reset_for_tests()


def _table(n: int = 20) -> dict:
    return {"a": np.array([1, 2, 3, 1, 2, 3] * n, dtype=np.int64),
            "b": np.arange(6 * n, dtype=np.float64)}


def _context(pkg: str, table=None):
    c = JaxContext() if pkg == "jax" else Context(device=CPU)
    c.create_table("t", table or _table())
    return c


def _rows(result) -> list:
    return sorted(result.to_pylist())


def _journal(mod) -> list:
    """The journal's comparable part: action, fingerprint, view name and
    the verdict's kind (its first word)."""
    import json

    out = []
    for r in mod.journal_rows():
        detail = json.loads(r["detail"]) if r["detail"] else {}
        out.append((r["action"], r["fingerprint"], detail.get("view", ""),
                    r["verdict"].split(" ", 1)[0]))
    return out


# ---------------------------------------------------------------------------
# the materialized-view loop, in both packages
# ---------------------------------------------------------------------------

def test_repeat_workload_materializes_and_serves_as_in_the_jax_package(
        armed):
    base = _table(50)
    extra = {"a": np.array([1, 1], dtype=np.int64),
             "b": np.array([1000.0, 2000.0])}
    got = {}
    for pkg, mod in BOTH.items():
        armed(pkg)
        c = _context(pkg, base)
        first = [_rows(c.sql(SQL)) for _ in range(3)][-1]
        assert mod.tick(c)["created"] == 1
        c.append_rows("t", extra)
        before = tel.REGISTRY.get("autopilot_mv_serves") or 0
        served = _rows(c.sql(SQL))
        if pkg == "port":
            assert tel.REGISTRY.get("autopilot_mv_serves") == before + 1
        got[pkg] = (first, served, _journal(mod),
                    mod.engine_section()["managedViews"])
    assert got["port"] == got["jax"]
    (action, fp, view, _), = got["port"][2]
    assert action == "mv_create" and view == f"auto_mv_{fp[:12]}"
    want = {}
    for a, b in zip(np.concatenate([base["a"], extra["a"]]),
                    np.concatenate([base["b"], extra["b"]])):
        want[int(a)] = want.get(int(a), 0.0) + float(b)
    assert got["port"][1] == [[k, v] for k, v in sorted(want.items())]


@pytest.mark.parametrize("pkg", sorted(BOTH))
def test_the_kill_switch_runs_the_baseline(armed, monkeypatch, pkg):
    mod = BOTH[pkg]
    armed(pkg)
    monkeypatch.setenv("DSQL_AUTOPILOT", "0")
    c = _context(pkg, {"a": np.array([1, 2, 2]),
                       "b": np.array([1.0, 2.0, 3.0])})
    for _ in range(3):
        got = _rows(c.sql(SQL))
    assert got == [[1, 1.0], [2, 5.0]]
    assert mod.tick(c) == {}
    assert mod.journal_rows() == []
    assert mod.engine_section()["managedViews"] == []


def test_tick_creates_the_top_candidate_once(armed):
    c = _context("port")
    for _ in range(3):
        c.sql(SQL)
    before = tel.REGISTRY.get("autopilot_mv_creates")
    assert ap.tick(c)["created"] == 1
    assert tel.REGISTRY.get("autopilot_mv_creates") == before + 1
    (name,) = ap.engine_section()["managedViews"]
    assert name.startswith("auto_mv_")
    assert len(c.sql(f"SELECT * FROM {name}").to_pylist()) == 3
    assert any(r["action"] == "mv_create" and r["bytes"] > 0
               for r in ap.journal_rows())
    # the shape-mode candidate and the value-mode view: never twice
    assert ap.tick(c)["created"] == 0
    rows = c.sql("SELECT action, fingerprint, bytes FROM system.autopilot"
                 ).to_pylist()
    assert [r[0] for r in rows] == ["mv_create"] and rows[0][2] > 0


def test_budget_accounting(armed, monkeypatch):
    c = _context("port")
    for _ in range(3):
        c.sql(SQL)
    monkeypatch.setenv("DSQL_AUTOPILOT_MV_MB", "0")
    assert ap.tick(c)["created"] == 0
    assert any(r["action"] == "mv_skip" and r["trigger"] == "budget"
               for r in ap.journal_rows())
    assert ap.engine_section()["mvUsedBytes"] == 0
    monkeypatch.setenv("DSQL_AUTOPILOT_MV_MB", "64")
    assert ap.tick(c)["created"] == 1
    sec = ap.engine_section()
    assert 0 < sec["mvUsedBytes"] <= sec["mvBudgetBytes"] == 64 * 2**20


def test_a_cold_view_drops_and_a_serve_keeps_it_warm(armed):
    c = _context("port")
    for _ in range(3):
        c.sql(SQL)
    now = time.time()
    assert ap.tick(c, now=now)["created"] == 1
    (name,) = ap.engine_section()["managedViews"]
    reg = mv.get_registry(c)
    reg.views[(c.schema_name, name)].serves += 1
    assert ap.tick(c, now=now + 400)["dropped"] == 0
    before = tel.REGISTRY.get("autopilot_mv_drops")
    assert ap.tick(c, now=now + 800)["dropped"] == 1
    assert tel.REGISTRY.get("autopilot_mv_drops") == before + 1
    assert ap.engine_section()["managedViews"] == []
    assert name not in c.schema[c.schema_name].tables
    drops = [r for r in ap.journal_rows() if r["action"] == "mv_drop"]
    assert drops and drops[-1]["bytes"] > 0
    # the cooldown: the still-hot candidate is not made again at once
    assert ap.tick(c, now=now + 801)["created"] == 0


@pytest.mark.parametrize("pkg", sorted(BOTH))
def test_an_unparseable_candidate_is_blacklisted_once(armed, pkg):
    mod, rec = BOTH[pkg], {"jax": jax_fr, "port": fr}[pkg]
    armed(pkg)
    c = _context(pkg)
    fp = "deadbeef" * 8
    rec._observe_stat(fp, nbytes=1024, rows=10, ms=50.0)
    rec._observe_stat(fp, nbytes=1024, rows=10, ms=50.0)
    rec._append(rec.history_path(),
                {"kind": "query", "plan_fp": fp, "query": "NOT REAL SQL ("})
    assert mod.tick(c)["created"] == 0
    mod.tick(c)
    rejects = [r for r in mod.journal_rows() if r["action"] == "mv_reject"]
    assert len(rejects) == 1 and rejects[0]["fingerprint"] == fp


def test_candidate_hits_accrue_through_a_warm_cache(armed):
    c = _context("port")
    c.sql(SQL)
    (cand,) = mv.view_candidate_rows(c)
    assert cand["hits"] == 1
    for _ in range(2):
        c.sql(SQL)
    assert [e["outcome"] for e in fr.read_events(kind="query")[-2:]] == \
        ["cache_hit", "cache_hit"]
    (again,) = mv.view_candidate_rows(c)
    assert again["hits"] == 3
    assert again["ewma_ms"] == pytest.approx(cand["ewma_ms"])


@pytest.mark.parametrize("spaces", [0, 520])
def test_a_text_of_500_characters_never_materializes(armed, spaces):
    """The history keeps ``query.strip()[:500]``: a longer text would be
    cut into another query, so neither package acts on it."""
    sql = "SELECT a, SUM(b) AS s" + " " * spaces + " FROM t GROUP BY a"
    made = {}
    for pkg, mod in BOTH.items():
        armed(pkg)
        c = _context(pkg)
        for _ in range(3):
            c.sql(sql)
        made[pkg] = mod.tick(c)["created"]
    assert made == ({"jax": 0, "port": 0} if spaces else
                    {"jax": 1, "port": 1})


@pytest.mark.parametrize("pkg", sorted(BOTH))
def test_the_fault_site_turns_a_tick_into_a_no_op(armed, pkg):
    from dask_sql_tpu.runtime import faults as jax_faults

    mod = BOTH[pkg]
    inject = (jax_faults if pkg == "jax" else faults).inject
    armed(pkg)
    c = _context(pkg)
    want = _rows(c.sql(SQL))
    with inject("autopilot:1+"):
        for _ in range(3):
            assert _rows(c.sql(SQL)) == want
        assert mod.tick(c) == {"faulted": True}
        assert mod.tick(c) == {"faulted": True}
    assert [r["action"] for r in mod.journal_rows()[-2:]] == \
        ["tick_fault", "tick_fault"]
    assert mod.engine_section()["managedViews"] == []
    assert mod.tick(c)["created"] == 1          # recovered
    assert _rows(c.sql(SQL)) == want


# ---------------------------------------------------------------------------
# re-planning: hints from stub reports, in both packages
# ---------------------------------------------------------------------------

class _Span:
    def __init__(self, name="query", attrs=None, children=()):
        self.name, self.attrs, self.children = name, dict(attrs or {}), \
            list(children)

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()


class _Report:
    def __init__(self, fp, wall_ms, *, hinted=False, operators=(),
                 skew=None, cerr=None, partitions=None, cache_hit=False):
        attrs = {"plan_fp": fp}
        if hinted:
            attrs["autopilot_hinted"] = 1
        kids = [_Span("grace_join", {"partitions": partitions})] \
            if partitions else []
        self.root = _Span("query", attrs, kids)
        self.wall_ms = float(wall_ms)
        self.cache = {"hit": cache_hit}
        self.operators = list(operators)
        self.skew_ratio, self.cost_err = skew, cerr
        self.rows_out = 0


def _both(use, fn):
    """``fn(module)`` in each package, each with its own history and hint
    files; the results must be equal."""
    out = {}
    for pkg, mod in BOTH.items():
        use(pkg)
        out[pkg] = fn(mod)
    assert out["port"] == out["jax"]
    return out["port"]


def test_hint_records_flip_the_measured_decisions(armed):
    def run(mod):
        mod.on_query_complete(_Report(
            "fp-skew", 100.0, skew=5.0, partitions=8,
            operators=["spmd_join=broadcast build=left rows=10",
                       "groupby=hash rows=10 ndv=3"]))
        mod.on_query_complete(_Report(
            "fp-cost", 10.0, cerr=3.0,
            operators=["spmd_join=exchange build=right",
                       "groupby=sorted rows=5"]))
        mod.on_query_complete(_Report("fp-ok", 100.0, skew=1.2, cerr=0.3,
                                      operators=["groupby=hash rows=10"]))
        mod.on_query_complete(_Report("fp-c", 1.0, skew=9.0, cache_hit=True,
                                      operators=["groupby=hash rows=1"]))
        mod.on_query_complete(_Report("fp-e", 1.0, skew=9.0,
                                      operators=["groupby=hash rows=1"]),
                              error=RuntimeError("boom"))
        hints = {fp: (mod.get_hint(fp) or {}).get("hints")
                 for fp in ("fp-skew", "fp-cost", "fp-ok", "fp-c", "fp-e")}
        return hints, _journal(mod), [r["trigger"]
                                      for r in mod.journal_rows()]

    hints, journal, triggers = _both(armed, run)
    assert hints["fp-skew"] == {"join": "exchange", "groupby": "sorted",
                                "partitions": 16}
    assert hints["fp-cost"] == {"join": "broadcast", "groupby": "hash"}
    assert hints["fp-ok"] is hints["fp-c"] is hints["fp-e"] is None
    assert [j[0] for j in journal] == ["hint_record", "hint_record"]
    assert triggers == ["skew_ratio=5>=2", "cost_err=3>=1"]


def test_a_hint_applies_to_the_next_execution(armed):
    c = _context("port")
    ap.on_query_complete(_Report("fp-a", 100.0, skew=5.0, partitions=4))
    before = tel.REGISTRY.get("autopilot_hints_applied")
    ap.begin_query("fp-a", c)
    try:
        assert ap.current_hint("partitions") == 8
        assert ap.current_hint("join") is None
    finally:
        ap.end_query()
    assert ap.current_hint("partitions") is None
    assert tel.REGISTRY.get("autopilot_hints_applied") == before + 1


def test_two_strikes_revert_a_hint_as_in_the_jax_package(armed):
    def run(mod):
        mod.on_query_complete(_Report("fp-r", 100.0, skew=5.0, partitions=4))
        states = []
        for wall in (150.0, 80.0, 150.0, 150.0):
            mod.on_query_complete(_Report("fp-r", wall, hinted=True))
            e = mod.get_hint("fp-r")
            states.append((e["state"], e["strikes"], e["verdict"],
                           e["hinted_ms"]))
        mod.on_query_complete(_Report("fp-r", 500.0, skew=9.0, partitions=4))
        return states, mod.get_hint("fp-r")["state"], _journal(mod)

    states, final, journal = _both(armed, run)
    assert states == [("active", 1, "slower", None),
                      ("active", 0, "faster", 80.0),
                      ("active", 1, "slower", 80.0),
                      ("reverted", 2, "slower", 80.0)]
    assert final == "reverted"
    assert [j[0] for j in journal] == ["hint_record", "hint_strike",
                                       "hint_verdict", "hint_strike",
                                       "hint_revert"]
    c = _context("port")
    ap.begin_query("fp-r", c)
    try:
        assert ap.current_hint("partitions") is None
    finally:
        ap.end_query()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_hints_file_written_by_either_package_reads_in_the_other(
        armed, writer):
    BOTH[writer].on_query_complete(
        _Report("fp-x", 100.0, skew=5.0, partitions=4))
    path = ap.hints_path()
    assert path == jax_ap.hints_path() and os.path.exists(path)
    reader = "port" if writer == "jax" else "jax"
    pkg = "dask_sql_tpu_torch" if reader == "port" else "dask_sql_tpu"
    code = (f"from {pkg}.runtime import autopilot as ap\n"
            "e = ap.get_hint('fp-x')\n"
            "assert e['state'] == 'active' and "
            "e['hints'] == {'partitions': 8}, e\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, timeout=300)
    assert proc.returncode == 0, proc.stderr.decode()[-2000:]


def test_engine_section_has_the_jax_packages_keys(armed):
    def run(mod):
        mod.on_query_complete(_Report("fp-s", 100.0, skew=5.0, partitions=4))
        sec = mod.engine_section()
        sec["lastAction"] = {k: v for k, v in sec["lastAction"].items()
                             if k != "unix"}
        return sec

    sec = _both(armed, run)
    assert sec["enabled"] is True and sec["hintsActive"] == 1
    assert sec["lastAction"]["action"] == "hint_record"


# ---------------------------------------------------------------------------
# hinted decisions on the port's tiers
# ---------------------------------------------------------------------------

def _plan_fp(c) -> str:
    (fp,) = {s.attrs["plan_fp"] for s in c.last_report.root.walk()
             if "plan_fp" in s.attrs}
    return fp


def test_a_groupby_hint_flips_the_eager_variant(armed, monkeypatch):
    monkeypatch.setenv("DSQL_COMPILE", "0")
    monkeypatch.setenv("DSQL_RESULT_CACHE_MB", "0")
    c = Context(device=CPU)
    rng = np.random.default_rng(3)
    c.create_table("g", {"k": rng.integers(0, 10**9, 2000),
                         "v": rng.random(2000)})
    sql = "SELECT k, SUM(v) AS s FROM g GROUP BY k"
    want = _rows(c.sql(sql))
    # DSQL_ADAPTIVE=0 here: the unrecorded default, hash codes
    assert not any(o.startswith("groupby=")
                   for o in c.last_report.operators)
    fp = _plan_fp(c)
    ap._write_hint(fp, {"hints": {"groupby": "sorted"}, "state": "active",
                        "strikes": 0, "verdict": "", "baseline_ms": 1e9,
                        "hinted_ms": None, "trigger": "test"})
    assert _rows(c.sql(sql)) == want
    assert any(o.startswith("groupby=sorted autopilot=1")
               for o in c.last_report.operators)


def test_a_forced_skew_grace_join_repartitions_finer_next_run(
        armed, tmp_path, monkeypatch):
    monkeypatch.setenv("DSQL_AUTOPILOT_SKEW", "1.5")
    monkeypatch.setenv("DSQL_SPILL_MB", "64")
    monkeypatch.setenv("DSQL_SPILL_DIR", str(tmp_path / "spill"))
    monkeypatch.setenv("DSQL_RESULT_CACHE_MB", "0")
    spill_mod.reset_store()
    rng = np.random.default_rng(7)
    n_fact, n_dim = 6_000, 1_000
    key = rng.integers(0, n_dim, n_fact).astype(np.int64)
    key[rng.random(n_fact) < 0.9] = 3            # 90% of rows on one key
    val = np.round(rng.random(n_fact) * 100, 3)
    w = np.round(rng.random(n_dim) * 10, 3)
    c = Context(device=CPU)
    c.create_table("fact", {"fk": key, "val": val}, chunked=True,
                   batch_rows=512)
    c.create_table("dim", {"dk": np.arange(n_dim, dtype=np.int64), "w": w},
                   chunked=True, batch_rows=512)
    sql = ("SELECT SUM(fact.val * dim.w) AS s, COUNT(*) AS n "
           "FROM fact JOIN dim ON fact.fk = dim.dk")
    want_s, want_n = float((val * w[key]).sum()), n_fact

    def partitions() -> int:
        for s in c.last_report.root.walk():
            if s.name == "grace_join":
                return int(s.attrs["partitions"])
        raise AssertionError("the grace join did not run")

    (s1, n1), = c.sql(sql).to_pylist()
    assert n1 == want_n and s1 == pytest.approx(want_s, rel=1e-9)
    p1 = partitions()
    (rec,) = [r for r in ap.journal_rows() if r["action"] == "hint_record"]
    assert rec["trigger"].startswith("skew_ratio=")
    assert ap.get_hint(rec["fingerprint"])["hints"] == {"partitions": p1 * 2}
    compiles = tel.REGISTRY.get("compiles") or 0
    (s2, n2), = c.sql(sql).to_pylist()
    assert partitions() == p1 * 2
    # the finer pairs' capacities key a program of their own
    assert (tel.REGISTRY.get("compiles") or 0) > compiles
    assert (s2, n2) == (s1, n1)
    assert any(s.attrs.get("autopilot_hinted")
               for s in c.last_report.root.walk())
    verdicts = [r for r in ap.journal_rows()
                if r["action"] in ("hint_verdict", "hint_strike")]
    assert verdicts and verdicts[-1]["fingerprint"] == rec["fingerprint"]
    spill_mod.reset_store()


def test_a_join_hint_builds_its_own_spmd_stage_programs(armed, monkeypatch):
    from dask_sql_tpu_torch.parallel.mesh import Mesh

    monkeypatch.setenv("DSQL_MESH", "1")
    monkeypatch.setenv("DSQL_RESULT_CACHE_MB", "0")
    rng = np.random.default_rng(5)
    c = Context(device=CPU, mesh=Mesh(["cpu"] * 4))
    c.create_table("f", {"fk": rng.integers(0, 500, 4000),
                         "v": rng.random(4000)})
    c.create_table("d", {"dk": np.arange(500, dtype=np.int64),
                         "w": rng.random(500)})
    sql = ("SELECT SUM(f.v * d.w) AS s, COUNT(*) AS n "
           "FROM f JOIN d ON f.fk = d.dk")
    want = c.sql(sql).to_pylist()
    ops = c.last_report.operators
    assert c.last_report.tier == "spmd"
    (line,) = [o for o in ops if o.startswith("spmd_join=")]
    variant = line.split(" ", 1)[0].split("=", 1)[1]
    flipped = "exchange" if variant == "broadcast" else "broadcast"
    fp = _plan_fp(c)
    ap._write_hint(fp, {"hints": {"join": flipped}, "state": "active",
                        "strikes": 0, "verdict": "", "baseline_ms": 1e9,
                        "hinted_ms": None, "trigger": "test"})
    before = tel.REGISTRY.get("spmd_compiles") or 0
    got = c.sql(sql).to_pylist()
    assert c.last_report.tier == "spmd"
    assert any(o.startswith(f"spmd_join={flipped}")
               for o in c.last_report.operators)
    assert (tel.REGISTRY.get("spmd_compiles") or 0) > before
    assert got[0][1] == want[0][1]
    assert got[0][0] == pytest.approx(want[0][0], rel=1e-12)
    # the unhinted program is kept and replayed once the hint reverts
    e = ap.get_hint(fp)
    e["state"] = "reverted"
    ap._write_hint(fp, e)
    before = tel.REGISTRY.get("spmd_compiles") or 0
    assert c.sql(sql).to_pylist() == want
    assert (tel.REGISTRY.get("spmd_compiles") or 0) == before
