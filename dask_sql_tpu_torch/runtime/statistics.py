"""Table statistics and the adaptive operator choices built on them.

The counterpart of ``dask_sql_tpu/runtime/statistics.py``: the same
``TableStats`` from the same data, the same estimates and the same
decisions, so that both packages plan and dispatch a query alike.

- Ingest (``collect_table_stats``, called by ``Context.create_table``):
  row count and, per column, NDV, min/max, null fraction and dense-integer
  detection.  The reductions run on the table's device; only a few scalars
  per column reach the host (the JAX version copies each column to the
  host).  Integer domains up to 2**20 get an exact NDV by ``bincount``;
  wider ones, and floats, the NDV of a strided 65,536-row sample.
- Estimation (``selectivity``, ``estimate_rows``): System-R style rules
  over those stats; the planner orders join chains by them
  (``plan/optimizer.py:reorder_joins_stats``).
- Dispatch (``groupby_decision``, ``join_decision``): the executor's
  GROUP BY codes (``hash``, ``sorted`` or ``dense``) and join key codes
  (``hash`` or ``dense``).  Every variant gives the same answer;
  ``DSQL_ADAPTIVE=0`` restores the statistics-free dispatch, and
  ``DSQL_FORCE_GROUPBY=hash|sorted|dense`` pins the GROUP BY codes of the
  GROUP BYs that the static-domain route (``executor._aggregate``) does
  not take, as it pins only the JAX package's eager variant.
- Reporting: ``record_choice`` counts each choice
  (``operator_choice_<op>_<variant>``), lists it on the current span and
  in an open ``capture`` (EXPLAIN ANALYZE's choices); ``explain_lines``
  gives EXPLAIN's predicted ``-- operator:`` lines.

- The compiled tier's capacity hints (``compiled_cap_hints``) and the
  workload manager's statistics rung (``estimate_plan_bytes_stats``: the
  scanned bytes plus each heavy operator's estimated output).

Not part of the port (each waits for the part of the system that needs
it): the flight recorder's measured rows, the autopilot's hint and the
``system.table_stats`` rows.
"""
from __future__ import annotations

import logging
import math
import os
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..types import is_int_dtype
from . import telemetry as _tel

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# environment gates (the JAX package's variables)
# ---------------------------------------------------------------------------

def adaptive_enabled() -> bool:
    """``DSQL_ADAPTIVE=0`` turns the statistics-driven choices off
    (collection still runs at ingest)."""
    return os.environ.get("DSQL_ADAPTIVE", "1") != "0"


def forced_groupby() -> Optional[str]:
    """``DSQL_FORCE_GROUPBY=hash|sorted|dense`` pins the GROUP BY variant;
    any other value is ignored."""
    v = os.environ.get("DSQL_FORCE_GROUPBY", "").strip().lower()
    return v if v in ("hash", "sorted", "dense") else None


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def dense_domain_cap() -> int:
    """Largest key domain (max - min + 1) a column may have to be
    ``dense``: the direct-index GROUP BY allocates one slot per value."""
    return _env_int("DSQL_DENSE_DOMAIN_CAP", 4096)


#: integer domain above which the exact NDV (bincount) is not taken
_NDV_PROBE_DOMAIN = 1 << 20
#: sample size of the strided NDV estimate
_NDV_SAMPLE = 65536
#: the sorted GROUP BY pays up to this many groups ...
SORT_NDV_CAP = 4096
#: ... and only while groups are fat (ndv <= rows / SORT_ROW_FRACTION)
SORT_ROW_FRACTION = 16


# ---------------------------------------------------------------------------
# the stats objects
# ---------------------------------------------------------------------------

@dataclass
class ColumnStats:
    """Per-column ingest statistics.  ``ndv`` is exact for integer domains
    up to 2**20 and for dictionary strings, else a sampled estimate."""

    name: str
    ndv: Optional[int] = None
    min: Optional[float] = None
    max: Optional[float] = None
    null_frac: float = 0.0
    is_int: bool = False
    #: integer column whose domain (max - min + 1) fits dense_domain_cap()
    dense: bool = False
    domain: Optional[int] = None

    def to_row(self) -> dict:
        return {
            "column": self.name,
            "ndv": -1 if self.ndv is None else int(self.ndv),
            "min": float("nan") if self.min is None else float(self.min),
            "max": float("nan") if self.max is None else float(self.max),
            "null_frac": float(self.null_frac),
            "is_int": bool(self.is_int),
            "dense": bool(self.dense),
            "domain": -1 if self.domain is None else int(self.domain),
        }


@dataclass
class TableStats:
    rows: int = 0
    cols: Dict[str, ColumnStats] = field(default_factory=dict)
    collected_ms: float = 0.0

    def col(self, name: str) -> Optional[ColumnStats]:
        return self.cols.get(name)


def collect_table_stats(table) -> Optional[TableStats]:
    """Ingest-time statistics of a device ``Table``.

    Never raises: a column that fails is left out, and a failure of the
    whole collection returns None (the engine then plans and dispatches
    without statistics)."""
    t0 = time.perf_counter()
    try:
        rows = int(table.num_rows)
        ts = TableStats(rows=rows)
        for name, col in zip(table.names, table.columns):
            cs = _collect_column(name, col, rows)
            if cs is not None:
                ts.cols[name] = cs
        ts.collected_ms = (time.perf_counter() - t0) * 1e3
        _tel.inc("stats_tables_collected")
        return ts
    except (KeyboardInterrupt, SystemExit):
        raise
    except Exception:
        logger.debug("stats collection failed", exc_info=True)
        _tel.inc("stats_collect_errors")
        return None


def _collect_column(name: str, col, rows: int) -> Optional[ColumnStats]:
    try:
        mask = col.mask
        n = rows if rows else 1
        nulls = 0 if mask is None else rows - int(mask.sum())
        null_frac = max(0.0, min(1.0, nulls / n))

        if col.stype.is_string:
            # dictionary-encoded: the dictionary bounds the NDV exactly
            ndv = None if col.dictionary is None else int(len(col.dictionary))
            return ColumnStats(name=name, ndv=ndv, null_frac=null_frac)

        data = col.data.reshape(-1)
        vals = data if mask is None else data[mask]
        is_int = is_int_dtype(data.dtype)
        if vals.numel() == 0:
            return ColumnStats(name=name, ndv=0, null_frac=null_frac,
                               is_int=is_int)
        if data.dtype == torch.bool:
            has_true, has_false = torch.stack([vals.any(), (~vals).any()]
                                              ).tolist()
            return ColumnStats(name=name, ndv=int(has_true) + int(has_false),
                               min=0.0 if has_false else 1.0,
                               max=1.0 if has_true else 0.0,
                               null_frac=null_frac)
        mn, mx = torch.stack([vals.min(), vals.max()]).tolist()
        domain = None
        ndv: Optional[int] = None
        if is_int:
            domain = int(mx) - int(mn) + 1
            if 0 < domain <= _NDV_PROBE_DOMAIN:
                # exact NDV in O(n + domain): one bincount over the domain
                counts = torch.bincount(vals.to(torch.int64) - int(mn),
                                        minlength=domain)
                ndv = int(torch.count_nonzero(counts))
        if ndv is None:
            ndv = _sampled_ndv(vals)
        dense = bool(is_int and domain is not None
                     and domain <= dense_domain_cap())
        mnf, mxf = float(mn), float(mx)
        if not (math.isfinite(mnf) and math.isfinite(mxf)):
            mnf = mxf = None  # type: ignore[assignment]
        return ColumnStats(name=name, ndv=ndv, min=mnf, max=mxf,
                           null_frac=null_frac, is_int=is_int, dense=dense,
                           domain=domain)
    except (KeyboardInterrupt, SystemExit):
        raise
    except Exception:
        logger.debug("column stats failed for %s", name, exc_info=True)
        return None


def _distinct_count(vals: torch.Tensor) -> int:
    """Distinct values of a 1-D tensor, counted as ``np.unique`` counts
    them: all NaNs are one value (``torch.unique`` would keep each NaN
    apart), and -0.0 equals 0.0."""
    s = torch.sort(vals).values
    new = s[1:] != s[:-1]
    if s.dtype.is_floating_point:
        new = new & ~(torch.isnan(s[1:]) & torch.isnan(s[:-1]))
    return 1 + int(new.sum())


def _sampled_ndv(vals: torch.Tensor) -> int:
    """Strided-sample NDV estimate for wide domains: a high distinct
    fraction in the sample extrapolates linearly (key-like columns), a low
    one is reported as the sample's own count (a lower bound)."""
    n = int(vals.numel())
    if n <= _NDV_SAMPLE:
        return _distinct_count(vals)
    stride = max(1, n // _NDV_SAMPLE)
    sample = vals[::stride]
    d = _distinct_count(sample)
    s = int(sample.numel())
    if d >= 0.5 * s:
        return min(n, int(n * (d / s)))
    return d


# ---------------------------------------------------------------------------
# plan-level estimation: column stats and cardinality through operators
# ---------------------------------------------------------------------------

def _scan_entry(rel, context):
    """The scanned table's entry as the executors read it
    (``Context.catalog_entry``): under the ingest log's snapshot pin the
    dispatch reads the statistics of the pinned table, whose value range
    a table replaced since may not cover."""
    try:
        return context.catalog_entry(rel.schema_name, rel.table_name)
    except KeyError:
        return None


def table_stats_for_scan(rel, context) -> Optional[TableStats]:
    entry = _scan_entry(rel, context)
    return getattr(entry, "stats", None) if entry is not None else None


def column_stats_for(rel, ordinal: int, context) -> Optional[ColumnStats]:
    """Trace output ordinal ``ordinal`` of ``rel`` back to a base-table
    column and return its ingest stats (None when the column is computed
    or its lineage cannot be followed)."""
    from ..plan import nodes as N

    if isinstance(rel, N.LogicalTableScan):
        ts = table_stats_for_scan(rel, context)
        if ts is None or ordinal >= len(rel.schema):
            return None
        return ts.col(rel.schema[ordinal].name)
    if isinstance(rel, N.LogicalProject):
        e = rel.exprs[ordinal] if ordinal < len(rel.exprs) else None
        if isinstance(e, N.RexInputRef):
            return column_stats_for(rel.input, e.index, context)
        return None
    if isinstance(rel, (N.LogicalFilter, N.LogicalSort)):
        # filters and sorts keep values: NDV and min/max stay upper bounds
        return column_stats_for(rel.input, ordinal, context)
    if isinstance(rel, N.LogicalAggregate):
        if ordinal < len(rel.group_keys):
            return column_stats_for(rel.input, rel.group_keys[ordinal],
                                    context)
        return None
    if isinstance(rel, N.LogicalJoin):
        nl = len(rel.left.schema)
        if rel.join_type in ("SEMI", "ANTI") or ordinal < nl:
            return column_stats_for(rel.left, ordinal, context)
        return column_stats_for(rel.right, ordinal - nl, context)
    return None


_DEFAULT_EQ_SEL = 0.1
_DEFAULT_RANGE_SEL = 0.3
_DEFAULT_SEL = 0.25
_MIN_SEL = 5e-4


def _literal_value(rex):
    from ..plan import nodes as N

    if isinstance(rex, (N.RexLiteral, N.RexParam)):
        v = rex.value
        if isinstance(v, bool):
            return float(v)
        if isinstance(v, (int, float)):
            return float(v)
    return None


def selectivity(rex, rel, context) -> float:
    """Fraction of ``rel``'s rows estimated to satisfy ``rex``: System-R
    style rules over the ingest min/max/NDV."""
    from ..plan import nodes as N

    if isinstance(rex, N.RexLiteral):
        if rex.value is True:
            return 1.0
        if rex.value is False:
            return 0.0
        return _DEFAULT_SEL
    if not isinstance(rex, N.RexCall):
        return _DEFAULT_SEL
    op = rex.op
    if op == "AND":
        s = 1.0
        for o in rex.operands:
            s *= selectivity(o, rel, context)
        return max(s, _MIN_SEL)
    if op == "OR":
        s = 0.0
        for o in rex.operands:
            s += selectivity(o, rel, context)
        return min(s, 1.0)
    if op == "NOT":
        return min(max(1.0 - selectivity(rex.operands[0], rel, context),
                       _MIN_SEL), 1.0)
    if op in ("IS NULL", "IS NOT NULL") and len(rex.operands) == 1:
        o = rex.operands[0]
        cs = column_stats_for(rel, o.index, context) \
            if isinstance(o, N.RexInputRef) else None
        nf = cs.null_frac if cs is not None else 0.05
        return max(nf if op == "IS NULL" else 1.0 - nf, _MIN_SEL)
    if op in ("=", "<>", "!=", "<", "<=", ">", ">=") \
            and len(rex.operands) == 2:
        a, b = rex.operands
        ref, lit = (a, b) if isinstance(a, N.RexInputRef) else (b, a)
        if not isinstance(ref, N.RexInputRef):
            return _DEFAULT_SEL
        cs = column_stats_for(rel, ref.index, context)
        if op == "=":
            if cs is not None and cs.ndv:
                return max(1.0 / cs.ndv, _MIN_SEL)
            return _DEFAULT_EQ_SEL
        if op in ("<>", "!="):
            if cs is not None and cs.ndv:
                return max(1.0 - 1.0 / cs.ndv, _MIN_SEL)
            return 1.0 - _DEFAULT_EQ_SEL
        lv = _literal_value(lit)
        if cs is None or lv is None or cs.min is None or cs.max is None \
                or cs.max <= cs.min:
            return _DEFAULT_RANGE_SEL
        frac = (lv - cs.min) / (cs.max - cs.min)
        if (op in ("<", "<=")) == (ref is a):
            s = frac          # col < lit  (or lit > col)
        else:
            s = 1.0 - frac    # col > lit  (or lit < col)
        return min(max(s, _MIN_SEL), 1.0)
    return _DEFAULT_SEL


def estimate_rows(rel, context, _depth: int = 0) -> Optional[float]:
    """Estimated output cardinality of a plan subtree; None = unknown."""
    from ..plan import nodes as N

    if _depth > 64:
        return None
    if isinstance(rel, N.LogicalTableScan):
        ts = table_stats_for_scan(rel, context)
        if ts is not None:
            return float(ts.rows)
        entry = _scan_entry(rel, context)
        if entry is None:
            return None
        chunked = getattr(entry, "chunked", None)
        if chunked is not None:
            # the entry's table is a 1-row binding stub: the source counts
            return float(getattr(chunked, "n_rows", 0))
        table = getattr(entry, "table", None)
        return float(table.num_rows) if table is not None else None
    if isinstance(rel, N.LogicalValues):
        return float(len(rel.rows))
    if isinstance(rel, N.LogicalFilter):
        child = estimate_rows(rel.input, context, _depth + 1)
        if child is None:
            return None
        return child * selectivity(rel.condition, rel.input, context)
    if isinstance(rel, N.LogicalProject):
        return estimate_rows(rel.input, context, _depth + 1)
    if isinstance(rel, N.LogicalSort):
        child = estimate_rows(rel.input, context, _depth + 1)
        if child is None:
            return None
        if rel.limit is not None:
            return min(child, float(rel.limit))
        return child
    if isinstance(rel, N.LogicalAggregate):
        child = estimate_rows(rel.input, context, _depth + 1)
        if not rel.group_keys:
            return 1.0
        if child is None:
            return None
        prod = 1.0
        for k in rel.group_keys:
            cs = column_stats_for(rel.input, k, context)
            if cs is None or not cs.ndv:
                return child  # unknown key: no group reduction claimed
            prod *= cs.ndv
            if prod > child:
                return child
        return min(child, prod)
    if isinstance(rel, N.LogicalJoin):
        return _estimate_join_rows(rel, context, _depth)
    # set operations and anything else with inputs: sum of the inputs
    if rel.inputs:
        total = 0.0
        for i in rel.inputs:
            c = estimate_rows(i, context, _depth + 1)
            if c is None:
                return None
            total += c
        return total
    return None


def _equi_pairs(rel):
    from ..plan.optimizer import split_join_condition
    try:
        equi, _residual = split_join_condition(rel)
        return equi
    except (KeyboardInterrupt, SystemExit):
        raise
    except Exception:
        return []


def _estimate_join_rows(rel, context, _depth: int) -> Optional[float]:
    lrows = estimate_rows(rel.left, context, _depth + 1)
    rrows = estimate_rows(rel.right, context, _depth + 1)
    if lrows is None or rrows is None:
        return None
    jt = rel.join_type
    if jt in ("SEMI", "ANTI"):
        return lrows * 0.5
    out = lrows * rrows
    for lk, rk in _equi_pairs(rel):
        lcs = column_stats_for(rel.left, lk, context)
        rcs = column_stats_for(rel.right, rk, context)
        ndv = max(lcs.ndv if lcs is not None and lcs.ndv else 0,
                  rcs.ndv if rcs is not None and rcs.ndv else 0)
        out /= max(ndv, 10) if ndv else 10
    if jt in ("LEFT", "FULL"):
        out = max(out, lrows)
    if jt in ("RIGHT", "FULL"):
        out = max(out, rrows)
    return max(out, 1.0)


# ---------------------------------------------------------------------------
# the crossover table (GROUP BY dispatch) and the join key coding
# ---------------------------------------------------------------------------

def choose_groupby_variant(rows: Optional[float], ndv: Optional[float],
                           dense_ok: bool) -> str:
    """``dense`` for a single integer key over a small domain (direct
    index, no sort); ``sorted`` for few fat groups (NDV <= min(4096,
    rows/16)): one stable lexsort and a boundary scan; ``hash`` (the
    factorize of ``torch.unique``) otherwise and whenever stats are
    unknown."""
    if dense_ok:
        return "dense"
    if rows is None or ndv is None:
        return "hash"
    if ndv <= min(SORT_NDV_CAP, rows / SORT_ROW_FRACTION):
        return "sorted"
    return "hash"


def groupby_decision(rel, context) -> Tuple[str, Dict[str, Any]]:
    """(variant, info) for a LogicalAggregate.  ``info`` carries the stats
    behind the choice and, for ``dense``, the (lo, hi) domain hint.
    ``DSQL_FORCE_GROUPBY`` wins over everything; adaptive off, or no
    group keys, gives ``hash``."""
    info: Dict[str, Any] = {}
    forced = forced_groupby()
    if forced is not None:
        info["forced"] = 1
        return forced, info
    if not adaptive_enabled() or not rel.group_keys:
        return "hash", info
    rows = estimate_rows(rel.input, context)
    ndv: Optional[float] = 1.0
    dense_ok = False
    for k in rel.group_keys:
        cs = column_stats_for(rel.input, k, context)
        if cs is None or not cs.ndv:
            ndv = None
            break
        ndv *= cs.ndv
    if len(rel.group_keys) == 1:
        cs = column_stats_for(rel.input, rel.group_keys[0], context)
        if cs is not None and cs.dense and cs.min is not None \
                and cs.max is not None:
            dense_ok = True
            info["lo"] = int(cs.min)
            info["hi"] = int(cs.max)
    if rows is not None:
        info["rows"] = int(rows)
    if ndv is not None:
        info["ndv"] = int(ndv)
    return choose_groupby_variant(rows, ndv, dense_ok), info


def join_decision(rel, left_cols, right_cols, context
                  ) -> Tuple[str, Dict[str, Any]]:
    """(variant, info) for an equi join's key codes: ``dense`` (``code =
    key - lo`` on both sides, no sort) for a single integer key pair,
    else ``hash`` (the shared ``torch.unique`` factorize)."""
    info: Dict[str, Any] = {}
    if not adaptive_enabled() or len(left_cols) != 1:
        return "hash", info
    lc, rc = left_cols[0], right_cols[0]
    if lc.stype.is_string or rc.stype.is_string:
        return "hash", info
    if not (is_int_dtype(lc.data.dtype) and is_int_dtype(rc.data.dtype)):
        return "hash", info
    if context is not None and rel is not None:
        lrows = estimate_rows(rel.left, context)
        rrows = estimate_rows(rel.right, context)
        if lrows is not None:
            info["lrows"] = int(lrows)
        if rrows is not None:
            info["rrows"] = int(rrows)
    return "dense", info


# ---------------------------------------------------------------------------
# choice recording: counters, spans and an optional thread-local capture
# ---------------------------------------------------------------------------

_tls = threading.local()


@contextmanager
def capture():
    """Collect every ``record_choice`` on this thread in the block, as
    (op, variant, info) tuples: EXPLAIN ANALYZE prints the choices its run
    took."""
    prev = getattr(_tls, "capture", None)
    buf: List[Tuple[str, str, Dict[str, Any]]] = []
    _tls.capture = buf
    try:
        yield buf
    finally:
        _tls.capture = prev


def record_choice(op: str, variant: str, **info) -> None:
    """One dispatch decision: counter ``operator_choice_<op>_<variant>``,
    an ``operators`` entry on the current span (the QueryReport's
    ``operators``), and an entry in the open ``capture`` buffer."""
    _tel.inc(f"operator_choice_{op}_{variant}")
    line = format_choice(op, variant, info)
    span = _tel.current_span()
    if span is not None:
        span.attrs.setdefault("operators", []).append(line)
    buf = getattr(_tls, "capture", None)
    if buf is not None:
        buf.append((op, variant, dict(info)))


def format_choice(op: str, variant: str, info: Dict[str, Any]) -> str:
    parts = [f"{op}={variant}"]
    for k in sorted(info):
        parts.append(f"{k}={info[k]}")
    return " ".join(parts)


# ---------------------------------------------------------------------------
# EXPLAIN
# ---------------------------------------------------------------------------

def explain_lines(plan, context) -> List[str]:
    """EXPLAIN's ``-- operator:`` lines: the variant each GROUP BY and
    join would take under the current stats.  None when adaptive is off
    and nothing is forced."""
    if not adaptive_enabled() and forced_groupby() is None:
        return []
    from ..plan import nodes as N

    lines: List[str] = []

    def walk(rel) -> None:
        for i in rel.inputs:
            walk(i)
        if isinstance(rel, N.LogicalAggregate) and rel.group_keys:
            try:
                variant, info = groupby_decision(rel, context)
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception:
                return
            lines.append("-- operator: "
                         + format_choice("groupby", variant, info))
        elif isinstance(rel, N.LogicalJoin):
            pairs = _equi_pairs(rel)
            if len(pairs) != 1:
                return
            try:
                lk, rk = pairs[0]
                lcs = column_stats_for(rel.left, lk, context)
                rcs = column_stats_for(rel.right, rk, context)
                dense = bool(lcs is not None and rcs is not None
                             and lcs.is_int and rcs.is_int
                             and adaptive_enabled())
                info: Dict[str, Any] = {}
                lrows = estimate_rows(rel.left, context)
                rrows = estimate_rows(rel.right, context)
                if lrows is not None:
                    info["lrows"] = int(lrows)
                if rrows is not None:
                    info["rrows"] = int(rrows)
                lines.append("-- operator: " + format_choice(
                    "join", "dense" if dense else "hash", info))
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception:
                return

    try:
        walk(plan)
    except (KeyboardInterrupt, SystemExit):
        raise
    except Exception:
        return []
    return lines


# ---------------------------------------------------------------------------
# the compiled tier's starting group capacities (physical/compiled.py)
# ---------------------------------------------------------------------------

def _pad_pow2(n: int, lo: int = 64, hi: int = 1 << 20) -> int:
    n = max(int(n), 1)
    return min(max(1 << (n - 1).bit_length(), lo), hi)


def compiled_cap_hints(plan, context) -> Dict[str, int]:
    """Statistics-derived starting caps for the compiled tier's padded
    group capacities, as in the JAX package: offered only when the plan
    holds exactly one grouped aggregate (then unambiguously ``agg0``, the
    first tag in trace order).  A wrong hint is safe: too small trips the
    overflow flag into one recompile, too large is padding."""
    if not adaptive_enabled() or forced_groupby() is not None:
        return {}
    from ..plan import nodes as N

    aggs: List[Any] = []

    def walk(rel) -> None:
        if isinstance(rel, N.LogicalAggregate) and rel.group_keys:
            aggs.append(rel)
        for i in rel.inputs:
            walk(i)

    try:
        walk(plan)
        if len(aggs) != 1:
            return {}
        groups = estimate_rows(aggs[0], context)
        if groups is None:
            return {}
        return {"agg0": _pad_pow2(int(groups * 1.25) + 1)}
    except (KeyboardInterrupt, SystemExit):
        raise
    except Exception:
        logger.debug("cap hints failed", exc_info=True)
        return {}


def estimate_plan_bytes_stats(plan, context) -> Optional[int]:
    """Stats-driven working-set estimate for the scheduler: the resident
    scan bytes (they are touched regardless) plus every heavy operator's
    estimated output (rows × 9 bytes/column — 8 data + amortized mask).
    None when adaptive is off or the plan's cardinality can't be
    estimated — the caller keeps the shape heuristic."""
    if not adaptive_enabled():
        return None
    from ..plan import nodes as N

    try:
        scan_bytes = 0
        inter_bytes = 0.0
        ok = True
        stack = [plan]
        while stack:
            rel = stack.pop()
            if isinstance(rel, N.LogicalTableScan):
                entry = _scan_entry(rel, context)
                if entry is not None:
                    from .scheduler import _entry_bytes
                    scan_bytes += _entry_bytes(entry)
            elif isinstance(rel, (N.LogicalJoin, N.LogicalAggregate,
                                  N.LogicalWindow, N.LogicalSort)):
                est = estimate_rows(rel, context)
                if est is None:
                    ok = False
                    break
                inter_bytes += est * max(len(rel.schema), 1) * 9
            stack.extend(getattr(rel, "inputs", ()) or ())
        if not ok:
            return None
        return int(scan_bytes + inter_bytes)
    except (KeyboardInterrupt, SystemExit):
        raise
    except Exception:
        logger.debug("stats byte estimate failed", exc_info=True)
        return None
