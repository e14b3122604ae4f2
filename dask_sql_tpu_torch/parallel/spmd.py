"""SPMD stage execution: whole query stages over the mesh's row shards.

The counterpart of ``dask_sql_tpu/parallel/spmd.py``.  Each stage of the
stage graph (``physical/stages.py``) runs as one function over the
shards of its row-sharded inputs, with the collectives placed explicitly:

- base-table scans read the catalog's global padded columns split into
  the mesh's shards (``Mesh.split``);
- Project and Filter run per shard through the rex evaluator;
- equi joins run as a hash-partitioned all_to_all exchange and a local
  probe, or as an all_gather broadcast of a small build side, chosen by
  the statistics' row estimates (``parallel/exchange.py``);
- GROUP BY and global aggregates run as per-shard partials combined by a
  psum tree (a small static key domain) or by a hash exchange and an
  all_gather of disjoint slot tables (``parallel/partial_agg.py``);
- a stage's output is registered as a ``__spmd__`` temp, row-sharded
  (a replicated output padded to a multiple of the mesh size, as JAX's
  ``shard_replicated`` emits it) for the stages that scan it.

Where the JAX body runs once per device inside ``shard_map``, the walker
here holds one local ``Table`` per shard in a list (one table on the
first device for a replicated value) and maps the local operators over
it; every collective combines the list in shard order, so answers and
the byte counters (``spmd_exchange_bytes``, ``spmd_all_gather_bytes``,
``spmd_psum_bytes``) equal the JAX package's.

A stage's function has fixed shapes.  On a card whose mesh is one device
repeated it is captured as a CUDA graph (``physical/graphs.GraphProgram``,
as the compiled tier does) and replayed; the runtime flags are outputs,
read on the host after the replay.  A stage that cannot be captured (a
host read in its body, a mesh of distinct cards) runs eagerly, counted
``spmd_eager_stages``.  The dispatch decisions of a stage program (join
side and variant, group-by variant) are recorded on its first run and
replayed by every later one; the program's key holds the canonical stage
plan, the input layout, the mesh, the scanned tables' statistics and the
caps, as the JAX stage digest does.

Correctness over silent degradation: what the walker cannot express
(non-INNER or multi-key joins, DISTINCT aggregates, float keys, windows,
set operations) refuses up front (``spmd_unsupported``); a runtime flag
(duplicate build keys, a key equal to the sentinel, radix or group-cap
overflow) refuses after the run (``spmd_fallbacks``), except duplicate
build keys, where the join's build side flips and the stage runs again
(``spmd_join_flips``).  A stage that raises counts ``spmd_fallbacks``
too, as in the JAX package, and ``spmd_errors`` apart.  Either way None
sends the query to the single-device tiers; the query's span carries the
tripped flags (``spmd_fallback``) or the error (``spmd_error``).

A mesh across processes (``init_multihost`` with a coordinator) runs the
same walker on every rank over that rank's shards (``Mesh.split``), and
each collective goes on through the process group
(``parallel/group.py``).  A stage's output stays on its rank (a
``__spmd__`` temp holds this rank's rows); the root stage's output is
gathered to every rank, and every rank compacts it and runs the
epilogue.  Ranks must take the same host decisions, so:

- the stage's flag vector is agreed inside the stage (``group.agree``,
  the max over the ranks), and every rank reads the same flags;
- after each stage every rank reports through the group's store how the
  stage ended (``group.rendezvous``: ok, unsupported, a runtime flag, an
  error or a failed collective, with its count of collectives and its
  recorded decisions).  Alike on every rank, the outcome is handled as
  on one process: an error on every rank at the same collective falls
  back on every rank (``spmd_fallbacks``, ``spmd_errors``).  Ranks that
  ended differently, or one that did not report within the group's
  timeout, raise ``RankError`` on every rank, naming the ranks that
  raised; where their collectives no longer pair (a collective failed,
  or the ranks stopped at different ones) the group is marked broken
  and every later query that needs it raises at once;
- a stage that holds a collective of the process group runs eagerly
  (``spmd_eager_stages``): no CUDA graph captures an NCCL call yet.

Not ported yet: the stage programs' persistence in the program store and
the profiling skew probe (their modules are not ported).

Variables: ``DSQL_MESH=0`` turns the backend off;
``DSQL_SPMD_BROADCAST_ROWS`` (65536) is the build-side estimate above
which a join of two sharded sides exchanges; ``DSQL_SPMD_GROUP_CAP``
(8192) caps distinct groups per shard after the exchange;
``DSQL_SPMD_DENSE_CAP`` (4096) caps the static key-domain product of the
psum-tree GROUP BY.
"""
from __future__ import annotations

import logging
import os
import re
import threading
import weakref
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..plan.nodes import (AggCall, Field, LogicalAggregate, LogicalFilter,
                          LogicalJoin, LogicalProject, LogicalSort,
                          LogicalTableScan, RelNode, RexScalarSubquery,
                          RexUdf)
from ..runtime import telemetry as _tel
from ..table import Column, Scalar, Table
from ..types import torch_dtype
from . import exchange as X
from . import group as G
from . import partial_agg as PA
from .mesh import on

logger = logging.getLogger(__name__)

_SPMD_SCHEMA = "__spmd__"
_TEMP_NAME_RE = re.compile(r"__spmd__\.t[0-9a-f]{16}")
_SUPPORTED_AGGS = ("SUM", "$SUM0", "COUNT", "AVG", "MIN", "MAX")
_FLOAT_TYPES = ("DOUBLE", "FLOAT", "REAL", "DECIMAL")
_BIG = 1 << 62


class Unsupported(Exception):
    """A plan shape outside the SPMD walker's envelope (clean refusal)."""


class RankError(RuntimeError):
    """The ranks of a mesh across processes did not end a step of a query
    alike (one raised, or did not report in time): no rank may answer
    from a path the others did not take, so the query fails on every
    rank."""


def spmd_enabled(context) -> bool:
    """The backend runs when the context has a mesh of at least two
    shards and ``DSQL_MESH`` is not 0: ``Context(mesh=...)`` opts in."""
    mesh = getattr(context, "mesh", None)
    if mesh is None:
        return False
    if os.environ.get("DSQL_MESH", "1") == "0":
        return False
    return mesh.size >= 2


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, str(default)))
    except ValueError:
        return default


def _broadcast_rows_cap() -> int:
    return _env_int("DSQL_SPMD_BROADCAST_ROWS", 65536)


def _group_cap() -> int:
    return max(1, _env_int("DSQL_SPMD_GROUP_CAP", 8192))


def _dense_cap() -> int:
    return max(2, _env_int("DSQL_SPMD_DENSE_CAP", 4096))


# ---------------------------------------------------------------------------
# the walker's table
# ---------------------------------------------------------------------------

class _ST:
    """A table inside a stage: one local ``Table`` per shard (``sharded``)
    or one on the first device (a replicated aggregate output, on which
    no combine may run), with its validity masks (None = all live)."""

    __slots__ = ("tables", "valids", "sharded")

    def __init__(self, tables: List[Table], valids: List, sharded: bool):
        self.tables = tables
        self.valids = valids
        self.sharded = sharded

    @property
    def n(self) -> int:
        """Local rows (every shard has as many)."""
        return self.tables[0].num_rows

    @property
    def proto(self) -> Table:
        return self.tables[0]

    def vmask(self, i: int) -> torch.Tensor:
        v = self.valids[i]
        if v is None:
            return torch.ones(self.n, dtype=torch.bool,
                              device=_table_device(self.tables[i]))
        return v


def _table_device(t: Table) -> torch.device:
    return t.columns[0].data.device


def _has_masks(st: _ST) -> List[bool]:
    return [any(t.columns[j].mask is not None for t in st.tables)
            for j in range(st.proto.num_columns)]


# ---------------------------------------------------------------------------
# static support gate (no device work)
# ---------------------------------------------------------------------------

def _check_rex(rex) -> None:
    if isinstance(rex, (RexScalarSubquery, RexUdf)):
        raise Unsupported(type(rex).__name__)
    for o in getattr(rex, "operands", None) or ():
        _check_rex(o)


def _gate_plan(rel: RelNode) -> None:
    """Refuse the plan shapes the walker cannot lower, before any stage
    runs."""
    if isinstance(rel, LogicalTableScan):
        return
    if isinstance(rel, LogicalProject):
        for e in rel.exprs:
            _check_rex(e)
    elif isinstance(rel, LogicalFilter):
        _check_rex(rel.condition)
    elif isinstance(rel, LogicalJoin):
        if rel.join_type != "INNER":
            raise Unsupported(f"join type {rel.join_type}")
        from ..plan.optimizer import split_join_condition
        equi, residual = split_join_condition(rel)
        if residual or len(equi) != 1:
            raise Unsupported("non-single-key equi join")
        li, ri = equi[0]
        for side, i in ((rel.inputs[0], li), (rel.inputs[1], ri)):
            st = side.schema[i].stype
            if st.is_string or st.name in _FLOAT_TYPES:
                raise Unsupported(f"join key type {st.name}")
    elif isinstance(rel, LogicalAggregate):
        for agg in rel.aggs:
            if agg.udaf is not None or agg.distinct:
                raise Unsupported("distinct/udaf agg")
            if agg.op not in _SUPPORTED_AGGS:
                raise Unsupported(f"agg {agg.op}")
            if agg.op in ("MIN", "MAX") and agg.args:
                if rel.inputs[0].schema[agg.args[0]].stype.is_string:
                    raise Unsupported("string MIN/MAX")
        for k in rel.group_keys:
            st = rel.inputs[0].schema[k].stype
            if st.name in _FLOAT_TYPES:
                raise Unsupported(f"float group key {st.name}")
    else:
        # a Sort inside the core (the root chain was peeled), Window,
        # Union, Values, set operations, samples: no SPMD lowering
        raise Unsupported(type(rel).__name__)
    for i in rel.inputs:
        _gate_plan(i)


# ---------------------------------------------------------------------------
# the stage walker
# ---------------------------------------------------------------------------

class _Walker:
    """Lowers one stage subtree over the shards.

    ``meta`` belongs to the stage program: its first run records the
    dispatch decisions, counters and output description, and every later
    run replays the recorded decisions, so that all runs of the program
    do the same work even if the statistics shift meanwhile."""

    def __init__(self, context, mesh, scan_tables: Dict, meta: Dict):
        self.context = context
        self.devices = mesh.devices
        self.n_dev = mesh.size          # global: the byte ledgers' factor
        self.group = mesh.group
        self.scan_tables = scan_tables
        self.meta = meta
        self.record = not meta.get("recorded")
        self._decision_idx = 0
        self.flags: List[Tuple[str, torch.Tensor]] = []

    # -- bookkeeping -------------------------------------------------------
    def _count(self, key: str, n: int = 1) -> None:
        if self.record:
            self.meta["counts"][key] = self.meta["counts"].get(key, 0) + n

    def _decide(self, op: str, variant: str, **info) -> str:
        if self.record:
            self.meta["decisions"].append((op, variant, info))
            return variant
        op_, variant_, _ = self.meta["decisions"][self._decision_idx]
        self._decision_idx += 1
        assert op_ == op, f"decision replay drift: {op_} vs {op}"
        return variant_

    def _flag(self, label: str, flag: torch.Tensor) -> None:
        self.flags.append((label, flag))

    def _dev(self, st: _ST, i: int) -> torch.device:
        return self.devices[i] if st.sharded else self.devices[0]

    def _g(self, st: _ST):
        """The process group a combine over ``st`` goes through: none for
        a replicated table (every rank holds all of it)."""
        return self.group if st.sharded else None

    # -- dispatch ----------------------------------------------------------
    def walk(self, rel: RelNode) -> _ST:
        if isinstance(rel, LogicalTableScan):
            return self._scan(rel)
        if isinstance(rel, LogicalProject):
            return self._project(rel)
        if isinstance(rel, LogicalFilter):
            return self._filter(rel)
        if isinstance(rel, LogicalJoin):
            return self._join(rel)
        if isinstance(rel, LogicalAggregate):
            return self._aggregate(rel)
        raise Unsupported(type(rel).__name__)

    def _scan(self, rel: LogicalTableScan) -> _ST:
        st = self.scan_tables[(rel.schema_name, rel.table_name)]
        # the optimizer prunes and reorders scan schemas: honour them
        want = [f.name for f in rel.schema]
        if st.proto.names != want:
            st = _ST([t.limit_to(want) for t in st.tables], st.valids,
                     st.sharded)
        return st

    def _project(self, rel: LogicalProject) -> _ST:
        from ..physical.rex.evaluate import evaluate_rex

        src = self.walk(rel.inputs[0])
        names = [f.name for f in rel.schema]
        tables = []
        for i, t in enumerate(src.tables):
            cols = []
            for expr in rel.exprs:
                v = evaluate_rex(expr, t)
                if isinstance(v, Scalar):
                    v = Column.from_scalar(v, t.num_rows, self._dev(src, i))
                cols.append(v)
            tables.append(Table(names, cols))
        return _ST(tables, src.valids, src.sharded)

    def _filter(self, rel: LogicalFilter) -> _ST:
        from ..physical.rex.evaluate import evaluate_predicate

        src = self.walk(rel.inputs[0])
        valids = []
        for i, t in enumerate(src.tables):
            pred = evaluate_predicate(rel.condition, t)
            if isinstance(pred, bool):
                valids.append(src.valids[i] if pred else torch.zeros(
                    src.n, dtype=torch.bool, device=self._dev(src, i)))
            else:
                valids.append(src.vmask(i) & pred)
        return _ST(src.tables, valids, src.sharded)

    # -- joins -------------------------------------------------------------
    def _join_key(self, st: _ST, idx: int, sentinel: int
                  ) -> List[torch.Tensor]:
        """Per shard: the key as int64 with ``sentinel`` for dead rows."""
        keys, hits = [], []
        for i, t in enumerate(st.tables):
            col = t.columns[idx]
            if col.data.dtype.is_floating_point or col.data.dtype.is_complex:
                raise Unsupported(f"join key dtype {col.data.dtype}")
            live = st.vmask(i)
            if col.mask is not None:
                live = live & col.mask
            d = col.data.to(torch.int64)
            # a live key equal to the sentinel would silently drop its row
            hits.append((live & (d == sentinel)).any())
            keys.append(torch.where(live, d, torch.full_like(d, sentinel)))
        self._flag("join_key_sentinel", X.replicated_flag(hits))
        return keys

    def _join(self, rel: LogicalJoin) -> _ST:
        from ..plan.optimizer import split_join_condition
        from ..runtime import statistics as _stats

        left = self.walk(rel.inputs[0])
        right = self.walk(rel.inputs[1])
        equi, residual = split_join_condition(rel)
        if rel.join_type != "INNER" or residual or len(equi) != 1:
            raise Unsupported("join shape")
        li, ri = equi[0]

        # build/probe and broadcast/exchange: statistics' estimates where
        # there are any, physical (padded) row counts otherwise; recorded
        # once and replayed, so that no later run flips a side
        if self.record:
            def est(node, st):
                try:
                    e = _stats.estimate_rows(node, self.context)
                except Exception:
                    e = None
                if e is None:
                    e = st.n * (self.n_dev if st.sharded else 1)
                return float(e)

            est_l, est_r = est(rel.inputs[0], left), est(rel.inputs[1], right)
            build_side = "right" if est_r <= est_l else "left"
            est_build = min(est_l, est_r)
            both_sharded = left.sharded and right.sharded
            variant = ("exchange" if both_sharded
                       and est_build > _broadcast_rows_cap() else "broadcast")
            di = len(self.meta["decisions"])
            self._decide("spmd_join", variant, build=build_side,
                         est_build=int(est_build),
                         est_probe=int(max(est_l, est_r)))
        else:
            di = self._decision_idx
            _, variant, info = self.meta["decisions"][self._decision_idx]
            self._decision_idx += 1
            build_side = info["build"]

        if build_side == "right":
            build, bi, probe, pi = right, ri, left, li
        else:
            build, bi, probe, pi = left, li, right, ri

        if variant == "exchange":
            bcols, pcols, valids = self._join_exchange(build, bi, probe, pi,
                                                       di)
            self._count("spmd_exchange_joins")
        else:
            bcols, pcols, valids = self._join_broadcast(build, bi, probe,
                                                        pi, di)
            self._count("spmd_broadcast_joins")
        names = [f.name for f in rel.schema]
        tables = [Table(names, (p + b) if build_side == "right" else (b + p))
                  for b, p in zip(bcols, pcols)]
        return _ST(tables, valids, probe.sharded)

    @staticmethod
    def _pick(cols: List[Column], idx, hit, dev) -> List[Column]:
        """Build-side columns at the probe's match positions."""
        out = []
        for c in cols:
            mask = None
            if c.mask is not None:
                mask = on(c.mask, dev)[idx] & hit
            out.append(Column(on(c.data, dev)[idx], c.stype, mask,
                              c.dictionary))
        return out

    def _join_broadcast(self, build: _ST, bi, probe: _ST, pi, di):
        sent = X.BROADCAST_SENTINEL
        bkeys = self._join_key(build, bi, sent)
        pkeys = self._join_key(probe, pi, sent)
        if build.sharded:
            # the key and every build column (data and mask) ride an
            # all_gather: the per-kind ledger counts them
            gathered = [bkeys[0]]
            for c in build.proto.columns:
                gathered.append(c.data)
                if c.mask is not None:
                    gathered.append(c.mask)
            self._count("spmd_all_gather_bytes",
                        X.gather_bytes(gathered, self.n_dev))
            g = self.group
            bkey = X.gather_build(bkeys, g)
            has = _has_masks(build)
            bcols = [Column(
                X.gather_build([t.columns[j].data for t in build.tables], g),
                c.stype,
                X.gather_build([t.columns[j].valid_mask()
                                for t in build.tables], g)
                if has[j] else None,
                c.dictionary) for j, c in enumerate(build.proto.columns)]
        else:
            bkey, bcols = bkeys[0], build.proto.columns
        dups, out_b, out_p, valids = [], [], [], []
        for i, pt in enumerate(probe.tables):
            dev = self._dev(probe, i)
            idx, hit, dup = X.sorted_probe(on(bkey, dev), pkeys[i], sent)
            dups.append(dup)
            valids.append(probe.vmask(i) & hit)
            out_b.append(self._pick(bcols, idx, hit, dev))
            out_p.append(list(pt.columns))
        # tagged with the decision index: the stage runner can flip this
        # join's build side and run again instead of giving up the query
        self._flag(f"dup_build_keys@{di}", X.replicated_flag(dups))
        return out_b, out_p, valids

    def _join_exchange(self, build: _ST, bi, probe: _ST, pi, di):
        sent = X.BROADCAST_SENTINEL
        bkeys = self._join_key(build, bi, sent)
        pkeys = self._join_key(probe, pi, sent)
        # non-negative partition codes through the joint minimum
        local_min = [torch.minimum(
            torch.where(bk == sent, torch.full_like(bk, _BIG), bk).amin(),
            torch.where(pk == sent, torch.full_like(pk, _BIG), pk).amin())
            for bk, pk in zip(bkeys, pkeys)]
        gmin = PA.pminmax(local_min, True, self.group)

        def codes(keys):
            return [torch.where(k == sent, torch.full_like(k, -1),
                                k - on(gmin, k.device)) for k in keys]

        bcode, pcode = codes(bkeys), codes(pkeys)
        bpay, bspec = _flatten_st(build)
        ppay, pspec = _flatten_st(probe)
        self._count("spmd_exchanges", 2)
        self._count("spmd_exchange_bytes",
                    X.exchange_bytes(bcode[0], bpay[0], self.n_dev)
                    + X.exchange_bytes(pcode[0], ppay[0], self.n_dev))
        bcode2, bpay2 = X.exchange(bcode, bpay, self.devices, self.group)
        pcode2, ppay2 = X.exchange(pcode, ppay, self.devices, self.group)
        build2 = _unflatten_st(build, bpay2, bspec, [c >= 0 for c in bcode2])
        probe2 = _unflatten_st(probe, ppay2, pspec, [c >= 0 for c in pcode2])

        dups, out_b, out_p, valids = [], [], [], []
        for i in range(len(self.devices)):
            bk = torch.where(bcode2[i] >= 0, bcode2[i],
                             torch.full_like(bcode2[i], sent))
            pk = torch.where(pcode2[i] >= 0, pcode2[i],
                             torch.full_like(pcode2[i], sent))
            idx, hit, dup = X.sorted_probe(bk, pk, sent)
            dups.append(dup)
            valids.append(probe2.vmask(i) & hit)
            out_b.append(self._pick(build2.tables[i].columns, idx, hit,
                                    self.devices[i]))
            out_p.append(list(probe2.tables[i].columns))
        self._flag(f"dup_build_keys@{di}", X.replicated_flag(dups))
        return out_b, out_p, valids

    # -- aggregates --------------------------------------------------------
    def _agg_inputs(self, agg: AggCall, src: _ST):
        """Per shard: (argument column or None, its live-row mask)."""
        out = []
        for i, t in enumerate(src.tables):
            ok = src.vmask(i)
            col = t.columns[agg.args[0]] if agg.args else None
            if col is not None and col.mask is not None:
                ok = ok & col.mask
            if agg.filter_arg is not None:
                fc = t.columns[agg.filter_arg]
                fm = fc.data.to(torch.bool)
                if fc.mask is not None:
                    fm = fm & fc.mask
                ok = ok & fm
            out.append((col, ok))
        return out

    def _aggregate(self, rel: LogicalAggregate) -> _ST:
        src = self.walk(rel.inputs[0])
        self._count("spmd_partial_aggs", max(1, len(rel.aggs)))
        if not rel.group_keys:
            return self._agg_global(rel, src)
        key_cols = [[t.columns[i] for i in rel.group_keys]
                    for t in src.tables]
        doms = _static_domains(key_cols)
        if doms is not None and int(np.prod(doms)) <= _dense_cap():
            self._decide("spmd_groupby", "psum_tree",
                         domain=int(np.prod(doms)))
            return self._agg_grouped_static(rel, src, key_cols, doms)
        self._decide("spmd_groupby", "exchange", cap=_group_cap())
        return self._agg_grouped_exchange(rel, src, key_cols)

    def _agg_global(self, rel: LogicalAggregate, src: _ST) -> _ST:
        cols = []
        for agg, f in zip(rel.aggs, rel.schema):
            inputs = self._agg_inputs(agg, src)
            col = inputs[0][0]
            oks = [ok for _, ok in inputs]
            out_dt = torch_dtype(f.stype)
            g = self._g(src)
            if agg.op == "COUNT":
                c = PA.global_count(oks, g)
                cols.append(Column(c.reshape(1).to(out_dt), f.stype, None))
                continue
            if col is None:
                raise Unsupported(f"{agg.op} without argument")
            datas = [c.data for c, _ in inputs]
            if agg.op in ("SUM", "$SUM0", "AVG"):
                s, c = PA.global_sum(datas, oks, g)
                has = (c > 0).reshape(1)
                if agg.op == "AVG":
                    mean = s.to(torch.float64) / torch.clamp(c, min=1)
                    cols.append(Column(mean.reshape(1).to(out_dt), f.stype,
                                       has))
                else:
                    mask = None if agg.op == "$SUM0" else has
                    cols.append(Column(s.reshape(1).to(out_dt), f.stype,
                                       mask))
                continue
            # MIN / MAX (not of strings: gated)
            m = PA.global_minmax(datas, oks, agg.op == "MIN", g)
            c = PA.global_count(oks, g)
            cols.append(Column(m.reshape(1).to(out_dt), f.stype,
                               (c > 0).reshape(1)))
        if src.sharded:
            # scalar psums: tiny, but the per-kind ledger stays complete
            self._count("spmd_psum_bytes",
                        X.psum_bytes([c.data for c in cols], self.n_dev))
        names = [f.name for f in rel.schema]
        return _ST([Table(names, cols)], [None], sharded=False)

    def _slot_agg_columns(self, rel, src: _ST, slots, cap: int,
                          combine) -> List[Column]:
        """The slot-table aggregates of both grouped paths; ``combine(parts,
        is_minmax, is_min)`` folds the per-shard slot tables into the
        global group table."""
        cols = []
        nk = len(rel.group_keys)
        for agg, f in zip(rel.aggs, rel.schema[nk:]):
            inputs = self._agg_inputs(agg, src)
            col = inputs[0][0]
            oks = [ok & (slot < cap) for (_, ok), slot in zip(inputs, slots)]
            out_dt = torch_dtype(f.stype)
            if agg.op == "COUNT":
                c = combine([PA.slot_count(ok, s, cap)
                             for ok, s in zip(oks, slots)], False, False)
                cols.append(Column(c.to(out_dt), f.stype, None))
                continue
            if col is None:
                raise Unsupported(f"{agg.op} without argument")
            if agg.op in ("SUM", "$SUM0", "AVG"):
                parts = [PA.slot_sum(c.data, ok, s, cap)
                         for (c, _), ok, s in zip(inputs, oks, slots)]
                s = combine([p[0] for p in parts], False, False)
                c = combine([p[1] for p in parts], False, False)
                has = c > 0
                if agg.op == "AVG":
                    mean = s.to(torch.float64) / torch.clamp(c, min=1)
                    cols.append(Column(mean.to(out_dt), f.stype, has))
                elif agg.op == "$SUM0":
                    cols.append(Column(s.to(out_dt), f.stype, None))
                else:
                    cols.append(Column(s.to(out_dt), f.stype, has))
                continue
            is_min = agg.op == "MIN"
            m = combine([PA.slot_minmax(c.data, ok, s, cap, is_min)
                         for (c, _), ok, s in zip(inputs, oks, slots)],
                        True, is_min)
            c = combine([PA.slot_count(ok, s, cap)
                         for ok, s in zip(oks, slots)], False, False)
            cols.append(Column(m.to(out_dt), f.stype, c > 0))
        return cols

    def _agg_grouped_static(self, rel, src: _ST, key_cols, doms) -> _ST:
        """A small static key domain (dictionary strings, bools): dense
        codes, local segment partials, a psum-tree combine, no exchange."""
        G = int(np.prod(doms))
        slots, rows_ok = [], []
        for i, keys in enumerate(key_cols):
            ok = src.vmask(i)
            code = torch.zeros(src.n, dtype=torch.int64,
                               device=self._dev(src, i))
            for j, (col, dom) in enumerate(zip(keys, doms)):
                d = col.data.to(torch.int64)
                if _nullable(key_cols, j):         # slot 0 = NULL
                    d = torch.where(col.valid_mask(), d + 1,
                                    torch.zeros_like(d))
                code = code * dom + d
            slots.append(torch.where(ok, code, torch.full_like(code, G)))
            rows_ok.append(ok)

        def combine(parts, is_minmax, is_min):
            if src.sharded:
                # psum, pmin and pmax all reduce the slot table across
                # the mesh: the psum kind accounts for them
                self._count("spmd_psum_bytes",
                            X.psum_bytes([parts[0]], self.n_dev))
            if not is_minmax:
                return PA.psum_table(parts, self._g(src))
            return PA.pminmax(parts, is_min, self._g(src))

        rows = combine([PA.slot_count(ok, s, G)
                        for ok, s in zip(rows_ok, slots)], False, False)
        acols = self._slot_agg_columns(rel, src, slots, G, combine)
        nullable = [_nullable(key_cols, j) for j in range(len(doms))]
        kcols = _decode_static_keys(key_cols[0], nullable, doms, G,
                                    self.devices[0])
        names = [f.name for f in rel.schema]
        return _ST([Table(names, kcols + acols)], [rows > 0], sharded=False)

    def _agg_grouped_exchange(self, rel, src: _ST, key_cols) -> _ST:
        """Integer-typed keys: mixed-radix codes from the global min/max
        spans, a hash exchange for disjoint ownership, local slot tables,
        an all_gather combine, the keys decoded from the slot codes."""
        cap = _group_cap()
        n_keys = len(key_cols[0])
        rows_ok = [src.vmask(i) for i in range(len(src.tables))]
        codes = [torch.zeros(src.n, dtype=torch.int64,
                             device=self._dev(src, i))
                 for i in range(len(src.tables))]
        gmins, spans = [], []
        prod = torch.ones((), dtype=torch.float64, device=self.devices[0])
        for k in range(n_keys):
            cols = [keys[k] for keys in key_cols]
            if cols[0].data.dtype.is_floating_point:
                raise Unsupported(f"group key dtype {cols[0].data.dtype}")
            ds, oks, los, his = [], [], [], []
            for i, col in enumerate(cols):
                d = col.data.to(torch.int64)
                ok = rows_ok[i] if col.mask is None else rows_ok[i] & col.mask
                los.append(torch.where(ok, d, torch.full_like(d, _BIG)).amin())
                his.append(torch.where(ok, d, torch.full_like(d, -_BIG))
                           .amax())
                ds.append(d)
                oks.append(ok)
            g = self._g(src)
            lo, hi = PA.pminmax(los, True, g), PA.pminmax(his, False, g)
            span = torch.clamp(hi - lo + 2, min=2)   # +1 NULL, +1 range
            for i, (d, ok) in enumerate(zip(ds, oks)):
                dev = d.device
                term = torch.where(ok, d - on(lo, dev) + 1,
                                   torch.zeros_like(d))
                codes[i] = codes[i] * on(span, dev) + term
            prod = prod * span.to(torch.float64)
            gmins.append(lo)
            spans.append(span)
        self._flag("radix_overflow", prod > float(2.0 ** 62))
        codes = [torch.where(ok, c, torch.full_like(c, -1))
                 for c, ok in zip(codes, rows_ok)]

        if src.sharded:
            pay, spec = _flatten_st(src)
            self._count("spmd_exchanges")
            self._count("spmd_exchange_bytes",
                        X.exchange_bytes(codes[0], pay[0], self.n_dev))
            codes, pay2 = X.exchange(codes, pay, self.devices, self.group)
            src = _unflatten_st(src, pay2, spec, [c >= 0 for c in codes])
            rows_ok = [c >= 0 for c in codes]

        slotted = [PA.local_slots(c, cap) for c in codes]
        slots = [s[0] for s in slotted]
        self._flag("group_cap_overflow",
                   X.replicated_flag([s[2] for s in slotted]))

        def combine(parts, is_minmax, is_min):
            if src.sharded:
                self._count("spmd_all_gather_bytes",
                            X.gather_bytes([parts[0]], self.n_dev))
            return PA.gather_groups(parts, self._g(src))

        rows = combine([PA.slot_count(ok, s, cap)
                        for ok, s in zip(rows_ok, slots)], False, False)
        acols = self._slot_agg_columns(rel, src, slots, cap, combine)
        gcodes = combine([s[1] for s in slotted], False, False)
        kcols = _decode_runtime_keys(
            key_cols[0], [_nullable(key_cols, j) for j in range(n_keys)],
            gcodes, gmins, spans)
        names = [f.name for f in rel.schema]
        return _ST([Table(names, kcols + acols)], [rows > 0], sharded=False)


def _flatten_st(st: _ST) -> Tuple[List[List[torch.Tensor]], List[bool]]:
    """Per shard, a table's tensors for an exchange ride: each column's
    data (and mask when any shard has one), then the validity mask."""
    spec = _has_masks(st)
    pay = []
    for i, t in enumerate(st.tables):
        p = []
        for c, has in zip(t.columns, spec):
            p.append(c.data)
            if has:
                p.append(c.valid_mask())
        p.append(st.vmask(i))
        pay.append(p)
    return pay, spec


def _unflatten_st(st: _ST, pay: List[List[torch.Tensor]], spec: List[bool],
                  live: List[torch.Tensor]) -> _ST:
    tables, valids = [], []
    for p, lv in zip(pay, live):
        cols = []
        i = 0
        for c, has in zip(st.proto.columns, spec):
            data = p[i]
            i += 1
            mask = None
            if has:
                mask = p[i]
                i += 1
            cols.append(Column(data, c.stype, mask, c.dictionary))
        tables.append(Table(list(st.proto.names), cols))
        valids.append(p[i] & lv)
    return _ST(tables, valids, st.sharded)


def _nullable(key_cols, j: int) -> bool:
    """Key ``j`` has a NULL mask on some shard."""
    return any(keys[j].mask is not None for keys in key_cols)


def _static_domains(key_cols) -> Optional[List[int]]:
    """The per-key domain sizes when EVERY key is a dictionary-coded
    string or a bool (a NULL adds one slot), else None."""
    doms = []
    for j, c in enumerate(key_cols[0]):
        if c.stype.is_string and c.dictionary is not None:
            base = max(1, len(c.dictionary))
        elif c.data.dtype == torch.bool:
            base = 2
        else:
            return None
        doms.append(base + (1 if _nullable(key_cols, j) else 0))
    return doms


def _decode_static_keys(key_cols, nullable, doms, G: int,
                        device) -> List[Column]:
    """Slot index -> key columns, computed on the host (the domain is
    static) and uploaded as the program's constants."""
    slots = np.arange(G, dtype=np.int64)
    strides = []
    s = 1
    for dom in reversed(doms):
        strides.append(s)
        s *= dom
    strides = list(reversed(strides))
    cols = []
    for c, has_null, dom, stride in zip(key_cols, nullable, doms, strides):
        v = (slots // stride) % dom
        null = None
        if has_null:
            null = v == 0
            v = np.maximum(v - 1, 0)
        if c.stype.is_string:
            data = torch.as_tensor(
                np.clip(v, 0, max(len(c.dictionary) - 1, 0))
                .astype(np.int32), device=device)
        elif c.data.dtype == torch.bool:
            data = torch.as_tensor(v.astype(bool), device=device)
        else:
            data = torch.as_tensor(v.astype(np.int64),
                                   device=device).to(c.data.dtype)
        mask = torch.as_tensor(~null, device=device) if has_null else None
        cols.append(Column(data, c.stype, mask, c.dictionary))
    return cols


def _decode_runtime_keys(key_cols, nullable, gcodes, gmins,
                         spans) -> List[Column]:
    """Global slot codes -> key columns (the spans are device values)."""
    live = gcodes >= 0
    c0 = torch.where(live, gcodes, torch.zeros_like(gcodes))
    cols: List[Column] = []
    for col, has_null, lo, span in zip(reversed(key_cols),
                                       reversed(nullable), reversed(gmins),
                                       reversed(spans)):
        v = torch.remainder(c0, span)
        c0 = torch.div(c0, span, rounding_mode="floor")
        null = v == 0
        data = lo + torch.clamp(v, min=1) - 1
        if col.stype.is_string:
            hi = max(len(col.dictionary) - 1, 0)
            data = torch.clamp(data, 0, hi).to(torch.int32)
        else:
            data = data.to(col.data.dtype)
        mask = ((~null) & live) if has_null else None
        cols.append(Column(data, col.stype, mask, col.dictionary))
    return list(reversed(cols))


# ---------------------------------------------------------------------------
# epilogue peel: the terminal ORDER BY / LIMIT (and projections above it)
# run on the first device over the compacted result; a global sort inside
# the stage would repartition rows that are gathered anyway
# ---------------------------------------------------------------------------

def _peel_epilogue(plan: RelNode) -> Tuple[RelNode, List[RelNode]]:
    from ..plan.optimizer import peel_root_epilogue
    return peel_root_epilogue(plan)


def _apply_epilogue(table: Table, epilogue: List[RelNode], device) -> Table:
    from ..ops.sort import apply_offset_limit, apply_sort
    from ..physical.rex.evaluate import evaluate_rex

    for node in epilogue:
        if isinstance(node, LogicalSort):
            if node.collation:
                table = apply_sort(
                    table, [(c.index, c.ascending, c.effective_nulls_first)
                            for c in node.collation])
            if node.limit is not None or node.offset is not None:
                table = apply_offset_limit(table, node.offset, node.limit)
        else:
            cols = []
            for expr in node.exprs:
                v = evaluate_rex(expr, table)
                if isinstance(v, Scalar):
                    v = Column.from_scalar(v, table.num_rows, device)
                cols.append(v)
            table = Table([f.name for f in node.schema], cols)
    return table


# ---------------------------------------------------------------------------
# stage programs: build, cache, run
# ---------------------------------------------------------------------------

class _Fallback(Exception):
    """A runtime flag tripped: the answer would be wrong, and the query
    falls back to the single-device tiers (unless the stage runner can
    repair the plan by flipping a join's build side)."""

    def __init__(self, tripped: List[str]):
        super().__init__(", ".join(tripped))
        self.tripped = list(tripped)


class _StageProgram:
    """One stage's function, its recorded ``meta`` and its CUDA graph
    (None where the stage runs eagerly).  ``lock`` serializes an eager
    run that records, so that two first runs do not both record."""

    __slots__ = ("body", "meta", "graph", "lock")

    def __init__(self, body, meta: Dict, graph):
        self.body = body
        self.meta = meta
        self.graph = graph
        self.lock = threading.Lock()


_prog_lock = threading.Lock()
_prog_cache: "OrderedDict[tuple, _StageProgram]" = OrderedDict()
_PROG_CACHE_CAP = 64


def _make_spmd_scan(node: RelNode, context) -> LogicalTableScan:
    from ..physical.compiled import _stage_table_name
    return LogicalTableScan(
        schema_name=_SPMD_SCHEMA,
        table_name=_stage_table_name(node, context),
        schema=[Field(f"c{i}", f.stype)
                for i, f in enumerate(node.schema)])


def _scan_specs(scans) -> list:
    """What the stage function needs to know of its inputs: per scan its
    key, column names, types, mask presence, dictionaries and whether a
    row_valid follows (no tensors: a cached program holds no table)."""
    return [(key, list(tbl.names),
             [(c.stype, c.mask is not None, c.dictionary)
              for c in tbl.columns], row_valid is not None)
            for key, tbl, row_valid in scans]


def _make_stage_body(stage_plan: RelNode, context, specs, mesh, meta: Dict,
                     root: bool = False):
    """The stage function: the flat inputs (``compiled._flatten_tables``
    order) split into shards, the stage plan walked, every output
    returned as a global tensor on the first device (a replicated one
    padded to a multiple of the mesh size), the flags last.  On a mesh
    across processes a ``__spmd__`` input holds this rank's rows and so
    does an output, but the ``root`` stage's, which every rank gets
    whole; the flags are agreed over the ranks."""
    ctx_ref = weakref.ref(context)
    n_dev = mesh.size
    n_loc = mesh.local_size
    first = mesh.rank * n_loc
    group = mesh.group
    dev0 = mesh.devices[0]

    def body(*flat):
        scan_tables: Dict[Tuple[str, str], _ST] = {}
        i = 0
        for key, names, colspecs, has_rv in specs:
            split = (mesh.split_local if key[0] == _SPMD_SCHEMA
                     else mesh.split)
            per_shard: List[List[Column]] = [[] for _ in range(n_loc)]
            for stype, has_mask, dictionary in colspecs:
                data = split(flat[i])
                i += 1
                mask = [None] * n_loc
                if has_mask:
                    mask = split(flat[i])
                    i += 1
                for s in range(n_loc):
                    per_shard[s].append(Column(data[s], stype, mask[s],
                                               dictionary))
            valid = [None] * n_loc
            if has_rv:
                valid = split(flat[i])
                i += 1
            scan_tables[key] = _ST([Table(names, cols) for cols in per_shard],
                                   valid, sharded=True)
        walker = _Walker(ctx_ref(), mesh, scan_tables, meta)
        st = walker.walk(stage_plan)

        outs: List[torch.Tensor] = []
        has = _has_masks(st)
        if st.sharded:
            # this process's shards; the root's gathered from every rank
            gather = group if root else None
            for j in range(st.proto.num_columns):
                outs.append(X.gather_build([t.columns[j].data
                                            for t in st.tables], gather))
                if has[j]:
                    outs.append(X.gather_build(
                        [t.columns[j].valid_mask() for t in st.tables],
                        gather))
            outs.append(X.gather_build([st.vmask(s) for s in range(n_loc)],
                                       gather))
            layout = {"sharded": True, "k": None, "kp": None}
        else:
            # every rank holds the whole value: it keeps its own shards,
            # and the root all of them
            mine = (0, None) if root or group is None else (first, n_loc)
            kp = 0
            for c, hm in zip(st.proto.columns, has):
                parts, kp = X.shard_replicated(c.data, n_dev, *mine)
                outs.append(torch.cat(parts))
                if hm:
                    outs.append(torch.cat(X.shard_replicated(
                        c.valid_mask(), n_dev, *mine)[0]))
            parts, kp = X.shard_replicated(st.vmask(0), n_dev, *mine)
            outs.append(torch.cat(parts))
            layout = {"sharded": False, "k": st.n, "kp": kp}
        if walker.flags:
            flags = torch.stack([on(f, dev0).to(torch.int32).reshape(())
                                 for _, f in walker.flags])
            outs.append(flags if group is None else G.agree(group, flags))
        meta["out"] = [(c.stype, hm, c.dictionary)
                       for c, hm in zip(st.proto.columns, has)]
        meta["layout"] = layout
        meta["flags"] = [lbl for lbl, _ in walker.flags]
        meta["recorded"] = True
        return tuple(outs)

    return body


def _stats_fingerprint(context, scans) -> tuple:
    """The statistics the recorded decisions were made from: per scanned
    table its row count and per-column NDV, range and NULL share."""
    out = []
    for key, _, _ in scans:
        try:
            ts = context.catalog_entry(*key).stats
        except KeyError:
            ts = None
        if ts is None:
            out.append(None)
            continue
        out.append((ts.rows, tuple(sorted(
            (name, cs.ndv, cs.min, cs.max, cs.null_frac)
            for name, cs in ts.cols.items()))))
    return tuple(out)


def _stage_key(plan_fp: str, inputs_fp, mesh, stats_fp, params,
               root: bool = False) -> tuple:
    """The identity of one stage program: the canonical plan (temp names
    replaced by position-stable placeholders), the input layout, the
    mesh, the statistics, the parameters' values and the caps (and
    whether it is the root of a mesh across processes, which gathers
    its output)."""
    mapping: Dict[str, str] = {}

    def sub(m):
        return mapping.setdefault(m.group(0), f"__spmd__.#{len(mapping)}")

    canon = _TEMP_NAME_RE.sub(sub, plan_fp)
    key = ("spmd1", canon, inputs_fp, mesh.signature(), stats_fp,
           tuple(repr(p.value) for p in params),
           (_broadcast_rows_cap(), _group_cap(), _dense_cap()))
    return key + (("root",) if root else ())


def _program(key: tuple, stage_plan, context, scans, mesh, meta: Dict,
             counts: Dict[str, int], root: bool = False) -> _StageProgram:
    """The cached stage program for ``key``, made (and counted
    ``spmd_compiles``) on a miss.  A mesh across processes is never
    ``virtual``: its stages hold collectives of the process group, which
    no CUDA graph captures yet, so they run eagerly on every rank."""
    from ..physical import compiled as _C
    from ..physical.graphs import GraphProgram

    with _prog_lock:
        prog = _prog_cache.get(key)
        if prog is not None:
            _prog_cache.move_to_end(key)
            return prog
    body = _make_stage_body(stage_plan, context, _scan_specs(scans), mesh,
                            meta, root)
    graph = None
    if mesh.virtual:
        # the inputs of __spmd__ temps change per query: a graph copies
        # them into its buffers instead of keying a capture on them
        copied = _C._copied_positions(scans, 0)
        copied.extend(i for i, temp in enumerate(_flat_in_temps(scans))
                      if temp)
        graph = GraphProgram(body, mesh.devices[0], copied=copied)
    prog = _StageProgram(body, meta, graph)
    counts["spmd_compiles"] = counts.get("spmd_compiles", 0) + 1
    with _prog_lock:
        _prog_cache[key] = prog
        while len(_prog_cache) > _PROG_CACHE_CAP:
            _release(_prog_cache.popitem(last=False)[1])
    return prog


def _release(prog: _StageProgram) -> None:
    if prog.graph is not None:
        prog.graph.release()


def clear_programs() -> None:
    """Drop every stage program and its graphs' memory."""
    with _prog_lock:
        progs = list(_prog_cache.values())
        _prog_cache.clear()
    for prog in progs:
        _release(prog)


def _run_program(prog: _StageProgram, flat, counts: Dict[str, int]):
    """Run the stage: its graph where it has one (the first call warms up
    and captures, later ones replay; the outputs are copied out of the
    graph's pool), else eagerly.  A stage whose first graph call fails
    (a host read in its body, an op a capture cannot hold) runs eagerly
    from then on."""
    graph = prog.graph
    if graph is not None:
        first = not (graph.checked or graph.captures)
        try:
            with graph.lock:
                outs = graph(*flat)
                if graph.device.type == "cuda":
                    outs = tuple(o.clone() for o in outs)
            return outs
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as e:
            if not first:
                raise
            logger.debug("spmd: stage not capturable (%s: %s); eager",
                         type(e).__name__, str(e)[:160])
            prog.graph = None
    counts["spmd_eager_stages"] = counts.get("spmd_eager_stages", 0) + 1
    if prog.meta.get("recorded"):
        return prog.body(*flat)
    with prog.lock:
        # a run that failed before recording may have left part of a
        # record behind; a concurrent first run may have recorded meanwhile
        if not prog.meta.get("recorded"):
            prog.meta["counts"].clear()
            prog.meta["decisions"].clear()
        return prog.body(*flat)


def _parse_stage_outputs(stage_plan: RelNode, outs, meta: Dict):
    """(table, valid): the outputs per the recorded layout; raises
    _Fallback if a runtime flag tripped (one host read, after the run)."""
    outs = list(outs)
    if meta["flags"]:
        fl = outs.pop().cpu().tolist()[:len(meta["flags"])]
        tripped = [lbl for lbl, v in zip(meta["flags"], fl) if int(v) != 0]
        if tripped:
            raise _Fallback(tripped)
    cols: List[Column] = []
    i = 0
    for stype, has_mask, dictionary in meta["out"]:
        data = outs[i]
        i += 1
        mask = None
        if has_mask:
            mask = outs[i]
            i += 1
        cols.append(Column(data, stype, mask, dictionary))
    # a replicated layout keeps its padded length (divisible by the mesh
    # size, so that a consumer stage can split it); its pad rows are
    # invalid, and _compact drops them at the root
    valid = outs[i]
    return Table([f.name for f in stage_plan.schema], cols), valid


def _register_temp(context, name: str, table: Table, valid) -> None:
    from ..datacontainer import TableEntry

    if _SPMD_SCHEMA not in context.schema:
        context.create_schema(_SPMD_SCHEMA)
    table = Table([f"c{i}" for i in range(table.num_columns)],
                  list(table.columns))
    context.schema[_SPMD_SCHEMA].tables[name] = TableEntry(
        table=table, row_valid=valid)


def _unregister_temp(context, name: str) -> None:
    sch = context.schema.get(_SPMD_SCHEMA)
    if sch is not None:
        sch.tables.pop(name, None)


def _compact(table: Table, valid) -> Table:
    """The root stage's output compacted to its live rows."""
    from ..ops.kernels import mask_to_indices
    return table.take(mask_to_indices(valid))


def _flat_in_temps(scans) -> List[bool]:
    """Per flat input (``compiled._flatten_tables`` order): whether it
    belongs to a ``__spmd__`` temp, which on a mesh across processes holds
    this rank's rows only."""
    out: List[bool] = []
    for skey, tbl, row_valid in scans:
        n = (sum(2 if c.mask is not None else 1 for c in tbl.columns)
             + (row_valid is not None))
        out.extend([skey[0] == _SPMD_SCHEMA] * n)
    return out


def _outcome(err: Optional[BaseException], group) -> Dict:
    """How a step ended on this rank, as the rendezvous carries it."""
    from ..physical import compiled as _C

    if err is None:
        status = "ok"
    elif isinstance(err, (Unsupported, _C.Unsupported)):
        status = "unsupported"
    elif isinstance(err, _Fallback):
        status = "fallback"
    elif isinstance(err, G.CollectiveError):
        status = "collective"
    else:
        status = "error"
    return {"status": status, "collectives": group.collectives,
            "tripped": getattr(err, "tripped", None),
            "error": (None if err is None
                      else f"{type(err).__name__}: {str(err)[:300]}")}


def _alike(a: Dict, b: Dict) -> bool:
    return all(a.get(k) == b.get(k) for k in ("status", "collectives",
                                               "tripped", "decisions"))


def _disagreement(group, peers: List[Optional[Dict]]) -> RankError:
    """The error every rank raises when the ranks ended a step apart; the
    group is marked broken where their collectives no longer pair."""
    parts, absent = [], []
    for r, p in enumerate(peers):
        if p is None:
            absent.append(r)
        elif p["status"] == "collective":
            parts.append(f"rank {r}: a collective failed ({p['error']})")
        elif p["error"] is not None:
            parts.append(f"rank {r} raised {p['error']}")
        elif p["status"] != "ok":
            parts.append(f"rank {r}: {p['status']} {p['tripped']}")
    if absent:
        parts.append(f"ranks {absent} did not report within "
                     f"{group.timeout_s:g} s")
    seen = [p for p in peers if p is not None]
    if not parts:
        parts.append("the ranks recorded different decisions or collective "
                     "counts")
    msg = (f"SPMD step ended differently on the ranks of the mesh (this is "
           f"rank {group.rank}): " + "; ".join(parts))
    if absent or any(p["status"] == "collective" for p in seen) \
            or len({p["collectives"] for p in seen}) > 1:
        group.broken = group.broken or msg[:300]
    return RankError(msg)


def _agreed(mesh, fn, decisions=None):
    """``fn()``; on a mesh across processes, then how it ended agreed with
    every other rank through the group's store.  Alike on every rank (and
    no collective failed), the result is returned or this rank's
    exception raised (marked agreed), so every rank goes on the same way;
    otherwise ``RankError`` on every rank.  ``decisions()``, after a success, is the recorded dispatch
    decisions, which must be equal too."""
    if not mesh.spans_processes:
        return fn()
    import hashlib

    group = mesh.group
    out, err = None, None
    try:
        out = fn()
    except (KeyboardInterrupt, SystemExit):
        raise
    except Exception as e:  # reported to every rank, then acted on alike
        err = e
    mine = _outcome(err, group)
    if err is None and decisions is not None:
        mine["decisions"] = hashlib.sha1(
            repr(decisions()).encode()).hexdigest()[:16]
    peers = G.rendezvous(group, mine)
    # a failed collective is never an outcome to go on from, even alike
    if mine["status"] != "collective" \
            and all(p is not None and _alike(p, mine) for p in peers):
        if err is not None:
            err.spmd_agreed = True
            raise err
        return out
    raise _disagreement(group, peers) from err


def _run_stage(stage, context, mesh, counts: Dict[str, int],
               root: bool = False):
    """One stage over the mesh: (table, valid, meta).  Raises
    Unsupported, compiled.Unsupported or _Fallback (alike on every rank
    of a mesh across processes, else RankError)."""
    from ..physical import compiled as _C

    st: Dict = {}

    def prepare() -> None:
        scans: list = []
        params: list = []
        plan_fp = _C._fp_plan(stage.plan, context, scans, params)
        flat = _C._flatten_tables(scans)
        for a, temp in zip(flat, _flat_in_temps(scans)):
            # a temp of a mesh across processes holds this rank's rows
            n = (mesh.local_size if temp and mesh.spans_processes
                 else mesh.size)
            if a.shape[0] % n:
                raise Unsupported(f"length {a.shape[0]} not divisible "
                                  f"by {n} shards")
        st.update(scans=scans, flat=flat, flipped=set(),
                  meta={"counts": {}, "decisions": []},
                  key=_stage_key(plan_fp, _C._fp_inputs(scans), mesh,
                                 _stats_fingerprint(context, scans), params,
                                 root))

    def launch():
        if not st:
            prepare()
        prog = _program(st["key"], stage.plan, context, st["scans"], mesh,
                        st["meta"], counts, root)
        st["meta"] = prog.meta
        return _run_program(prog, st["flat"], counts)

    while True:
        outs = _agreed(mesh, launch, lambda: st["meta"]["decisions"])
        try:
            table, valid = _parse_stage_outputs(stage.plan, outs, st["meta"])
        except _Fallback as e:
            # the flipped variant is a program of its own, with its own
            # copy of the decisions (the counts stay those recorded)
            meta = st["meta"]
            meta = dict(meta, decisions=list(meta["decisions"]),
                        counts=dict(meta["counts"]))
            if not _flip_dup_joins(meta, e.tripped, st["flipped"]):
                raise
            counts["spmd_join_flips"] = (counts.get("spmd_join_flips", 0)
                                         + len(e.tripped))
            st["meta"] = meta
            st["key"] = st["key"] + (("flip",)
                                     + tuple(sorted(st["flipped"])),)
            continue
        return table, valid, st["meta"]


_DUP_FLAG_RE = re.compile(r"^dup_build_keys@(\d+)$")


def _flip_dup_joins(meta: Dict, tripped: List[str], flipped: set) -> bool:
    """Repair duplicate build keys by flipping the offending joins' build
    sides (duplicates on the probe side are fine for ``sorted_probe``; on
    both, the join is many-to-many, which the walker does not attempt).
    True if EVERY tripped flag is such a join not flipped yet: the stage
    then runs again in replay mode against the edited decisions, as a
    program of its own."""
    idxs = []
    for lbl in tripped:
        m = _DUP_FLAG_RE.match(lbl)
        if m is None or int(m.group(1)) in flipped:
            return False
        idxs.append(int(m.group(1)))
    for di in idxs:
        op, variant, info = meta["decisions"][di]
        info = dict(info,
                    build=("left" if info["build"] == "right" else "right"),
                    flip="dup_build_keys")
        meta["decisions"][di] = (op, variant, info)
        flipped.add(di)
        logger.info("spmd: dup build keys at join decision %d; retrying "
                    "with build=%s", di, info["build"])
    return True


def try_execute_spmd(plan: RelNode, context) -> Optional[Table]:
    """Execute ``plan`` over the context's mesh.

    Returns the result Table, or None when the plan is outside the SPMD
    envelope (``spmd_unsupported``) or a runtime flag tripped
    (``spmd_fallbacks``): the caller then serves the query through the
    single-device tiers.  Raises only on a mesh across processes whose
    ranks did not end a step alike, or whose group broke earlier
    (``RankError``, counted ``spmd_rank_errors``)."""
    if not spmd_enabled(context):
        return None
    from ..physical import compiled as _C
    from ..physical.stages import partition, stage_budget
    from ..runtime.statistics import record_choice

    mesh = context.mesh
    n_dev = mesh.size
    counts: Dict[str, int] = {}
    try:
        core, epilogue = _peel_epilogue(plan)
        _gate_plan(core)
        graph = partition(core, stage_budget(None),
                          lambda sub: _make_spmd_scan(sub, context))
    except (Unsupported, _C.Unsupported) as e:
        _tel.inc("spmd_unsupported")
        logger.debug("spmd: unsupported plan (%s)", e)
        return None
    except (KeyboardInterrupt, SystemExit):
        raise
    except Exception as e:  # the gate must never fail a query
        _tel.inc("spmd_unsupported")
        logger.debug("spmd: gate error (%s: %s)", type(e).__name__, e)
        return None

    spans = mesh.spans_processes
    if spans and mesh.group.broken is not None:
        _tel.inc("spmd_rank_errors")
        raise RankError(f"rank {mesh.rank}: the mesh's process group broke "
                        f"earlier ({mesh.group.broken}); set it up again "
                        f"with init_multihost")
    registered: List[str] = []
    metas: List[Dict] = []
    # one query's collectives stay contiguous on this rank
    lock = mesh.group.lock if spans else threading.Lock()
    lock.acquire()
    try:
        result = None
        for si, stage in enumerate(graph.stages):
            root = stage.scan is None
            with _tel.span("spmd_stage", index=si):
                table, valid, meta = _run_stage(stage, context, mesh, counts,
                                                root and spans)
            metas.append(meta)
            if not root:
                name = stage.scan.table_name
                _register_temp(context, name, table, valid)
                registered.append(name)
            else:
                result = _agreed(mesh, lambda: _apply_epilogue(
                    _compact(table, valid), epilogue, mesh.devices[0]))
    except RankError as e:
        _tel.inc("spmd_rank_errors")
        _tel.annotate(spmd_error=f"RankError: {str(e)[:200]}")
        raise
    except (Unsupported, _C.Unsupported) as e:
        _tel.inc("spmd_unsupported")
        logger.debug("spmd: unsupported at run (%s)", e)
        return None
    except _Fallback as e:
        _tel.inc("spmd_fallbacks")
        _tel.annotate(spmd_fallback=",".join(e.tripped))
        logger.info("spmd: runtime flag tripped (%s); falling back", e)
        return None
    except (KeyboardInterrupt, SystemExit):
        raise
    except Exception as e:
        if spans and not getattr(e, "spmd_agreed", False):
            # this rank alone, outside an agreed step: the other ranks
            # wait at their next rendezvous and name this rank absent
            msg = (f"rank {mesh.rank} raised {type(e).__name__}: "
                   f"{str(e)[:200]} outside an agreed step")
            mesh.group.broken = mesh.group.broken or msg
            _tel.inc("spmd_rank_errors")
            _tel.annotate(spmd_error=f"RankError: {msg}")
            raise RankError(msg) from e
        # counted a fallback, as in the JAX package, and apart as an error
        # (no flag tripped: the walker itself failed)
        _tel.inc("spmd_fallbacks")
        _tel.inc("spmd_errors")
        _tel.annotate(spmd_error=f"{type(e).__name__}: {str(e)[:200]}")
        logger.warning("spmd: execution failed (%s: %s); falling back",
                       type(e).__name__, str(e)[:200])
        return None
    finally:
        lock.release()
        for name in registered:
            _unregister_temp(context, name)

    # success: counters, dispatch choices and span attributes, once
    _tel.inc("spmd_queries")
    _tel.inc("spmd_stages", len(graph.stages))
    for k, v in counts.items():
        _tel.inc(k, v)
    moved = {"spmd_exchange_bytes": 0, "spmd_all_gather_bytes": 0,
             "spmd_psum_bytes": 0}
    for meta in metas:
        for k, v in meta["counts"].items():
            _tel.inc(k, v)
            if k in moved:
                moved[k] += int(v)
        for op, variant, info in meta["decisions"]:
            try:
                record_choice(op, variant, **info)
            except Exception:  # pragma: no cover
                pass
    ann = dict(tier="spmd", spmd_devices=n_dev,
               spmd_stages=len(graph.stages),
               spmd_exchange_bytes=moved["spmd_exchange_bytes"])
    # per-kind collective bytes annotate only here (a report sums byte
    # attributes over all spans, so the stage spans do not repeat them)
    if moved["spmd_all_gather_bytes"]:
        ann["spmd_all_gather_bytes"] = moved["spmd_all_gather_bytes"]
    if moved["spmd_psum_bytes"]:
        ann["spmd_psum_bytes"] = moved["spmd_psum_bytes"]
    if counts.get("spmd_eager_stages"):
        ann["spmd_eager_stages"] = counts["spmd_eager_stages"]
    _tel.annotate(**ann)
    return result
