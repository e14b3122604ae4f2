"""The compiled tier: whole query plans as single programs with static shapes.

The counterpart of ``dask_sql_tpu/physical/compiled.py``.  A plan is traced
into one program: filters keep rows and flip a validity mask instead of
compacting, GROUP BY takes dense codes from a hash table (or straight from
dictionary ranks for a small static key domain, which sums through kernel
1) with a static group capacity, and equi-joins probe a hash table of the
build side.  Each program is cached by (plan fingerprint, input
shapes/dtypes and dictionary content, strategy, device).  On the card a
program is captured once as a CUDA graph and replayed
(``physical/graphs.py``): steady state is one graph replay and one
transfer of the flags (with the outputs, when they are small) per query.

Conditions a static program cannot express surface through a flags
vector read after the run: a group count above the capacity (recompile
with a larger one), a hash table that needed more probing rounds than the
program ran (recompile with twice the rounds, up to the JAX package's 64),
a non-unique join build side, a 64-bit hash collision or an int sum past
2**53 (fall back to the eager executor; the verdict is pinned to the
exact tables).  Plans outside the traceable subset raise ``Unsupported``
(or ``graphs.HostRead`` where the trace would read device data on the
host) and are cached as such.

``Context._run_query_plan`` calls ``try_execute_compiled`` first and the
eager ``RelExecutor`` on ``None``; ``DSQL_COMPILE=0`` (read per call)
opts out.  ``DSQL_STRATEGY=auto|host|tpu`` picks the tracing strategy as
in the JAX package: ``auto`` is ``host`` here (the JAX package takes it on
a GPU).  ``DSQL_CAPS_FILE`` / ``DSQL_CAPS_SEED`` persist learned
capacities.  Under ``DSQL_STRATEGY=tpu`` the tracer takes the JAX
package's sorted strategy: a group sort with scatter-free aggregates,
sorted-probe merge joins, learned-capacity compaction after selective
filters (``DSQL_COMPACT``) and the terminal sort inside the program.

Around that single-program path, as in the JAX package:

- **Parameters** (``plan/parameterize.py``): comparison literals are
  hoisted into ``RexParam`` nodes that fingerprint as ``P{i}:{TYPE}``, so
  every literal variant of a shape shares one program; the values ride as
  trailing 0-d tensors that a CUDA graph copies into its own buffers
  before each replay.  ``DSQL_PARAM_PLANS=0`` restores value-baked keys.
  Counters ``param_plans``, ``param_literals_hoisted``,
  ``param_plan_hits``, ``param_plan_misses``.
- **Stage graphs** (``physical/stages.py``): a plan with more heavy nodes
  than the budget (``DSQL_STAGE_HEAVY``, default 6) runs as a DAG of
  bounded programs; each stage's output is materialized into a padded
  power-of-2 ``__split__`` table that its consumers scan (a copied input
  of their graphs).  Independent stages run on ``DSQL_COMPILE_WORKERS``
  threads (default 4); a transient stage failure replays that stage alone
  from its materialized inputs.  Counters ``stage_graphs``,
  ``stage_execs``, ``stage_compiles``, ``stage_hits``,
  ``cross_query_hits``, ``stage_replays``.
- **The compile-error ladder** (``runtime/resilience.py``): a failed
  build (trace, warm-up or capture) is classified; a transient one retries
  in place, anything else walks whole program, then stages, then eager.
  A fatal verdict exiles the program and marks it in the quarantine store
  (``runtime/quarantine.py``), which other processes read; a build runs
  inside the compile watchdog.  Concurrent builds of one program wait for
  the first (``_inflight``); consecutive failures halve the worker width
  (``DSQL_COMPILE_BACKOFF_AFTER``).  ``DSQL_EAGER_FALLBACK=0`` surfaces the
  typed error instead of an eager answer; a sticky CUDA error
  (``DeviceLost``) always surfaces.  Counters ``compile_errors``,
  ``retries``, ``degradations``, ``split_hints``, ``exiled``,
  ``quarantine_skips``, ``quarantine_probes``, ``compile_backoffs``.
- **Tiering** (``DSQL_TIERED``, on by default): the first arrival of a
  cold plan is answered by the eager executor while its programs build on
  a daemon thread; the next arrival runs compiled.  ``tier_probe`` says
  which tier a plan would take now.  Background builds run outside the
  workload manager's admission (no slot, no reservation);
  ``inflight_background_compiles`` lists them for the server's
  ``/v1/engine``.
- **The subplan cache**: a stage whose boundary output is in the result
  cache (``result_cache.stage_key``) is answered from it, counter
  ``result_cache_subplan_hits``; a stage that ran stores its output.

Not ported yet: the persistent program store (the JAX package serializes
XLA executables; a CUDA graph cannot be serialized, and what a fresh
process could reuse needs a design of its own); ``DSQL_PROGRAM_STORE``
raises ``NotImplementedError``.
"""
from __future__ import annotations

import hashlib
import logging
import math
import os
import threading
import time
import weakref
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops import groupby as G
from ..ops.kernels import (canon_f64, comparable_data,
                           key_parts as _key_parts, orderable_int64,
                           unify_string_codes)
from ..plan.nodes import (
    LogicalAggregate, LogicalFilter, LogicalJoin, LogicalProject, LogicalSort,
    LogicalTableScan, LogicalUnion, LogicalValues, LogicalWindow, RelNode,
    RexCall, RexInputRef, RexLiteral, RexNode, RexParam, RexScalarSubquery,
)
from ..runtime import faults as _faults
from ..runtime import kvstore as _kv
from ..runtime import quarantine as _quar
from ..runtime import resilience as _res
from ..runtime import result_cache as _rcache
from ..runtime import telemetry as _tel
from ..runtime.gates import refuse
from ..table import dict_sort_order, tensors_to_host, Column, Scalar, Table
from ..types import exact_decimal_scale, torch_dtype
from .graphs import GraphProgram, HostRead
from .rex.evaluate import evaluate_predicate, evaluate_rex
from .stages import StageGraph, heavy_count, stage_budget
from .stages import annotate_stats as _annotate_stage_stats
from .stages import partition as _partition

logger = logging.getLogger(__name__)

_I64 = torch.iinfo(torch.int64)
_INT64_MIN = _I64.min


def _i64(u: int) -> int:
    """The int64 view of an unsigned 64-bit constant."""
    u &= (1 << 64) - 1
    return u - (1 << 64) if u >= 1 << 63 else u


# 64-bit hashes are uint64 in the JAX package; here they are the same bits
# held in int64 (two's-complement wrap, logical shifts masked)
_U64_MAX = _i64(0xFFFFFFFFFFFFFFFF)
_GOLDEN_U = 0x9E3779B97F4A7C15
_GOLDEN = _i64(_GOLDEN_U)
_MIX1 = _i64(0xBF58476D1CE4E5B9)
_MIX2 = _i64(0x94D049BB133111EB)

DEFAULT_GROUP_CAP = 4096
_CACHE_LIMIT = 128

# ops whose kernels are host-bound or non-deterministic: never compile
_DENY_OPS = {"RAND", "RAND_INTEGER"}

# counters of the telemetry registry, under the JAX package's names:
# compiles / hits / unsupported / fallbacks / recompiles, and the graph
# counters graph_captures / graph_replays
stats = _tel.CounterAlias()


class Unsupported(Exception):
    """Plan (or expression) outside the compilable subset."""


def _strategy_on_tpu() -> bool:
    """The tracing strategy (``DSQL_STRATEGY``): ``tpu`` = sorted group-by
    and merge joins, ``host`` (and ``auto``: the JAX package takes ``host``
    on a GPU and on the CPU) = hash tables and scatters."""
    return os.environ.get("DSQL_STRATEGY", "auto").lower() == "tpu"


# ---------------------------------------------------------------------------
# fingerprinting
# ---------------------------------------------------------------------------

def _fp_rex(rex: RexNode, context=None, scans=None, params=None) -> str:
    if params is None:
        params = []
    if isinstance(rex, RexInputRef):
        return f"@{rex.index}"
    if isinstance(rex, RexParam):
        # a hoisted literal: identity is its position in this walk and its
        # type, never its value; ``params`` collects the nodes in the same
        # order, which is the order of the program's trailing inputs
        for i, p in enumerate(params):
            if p is rex:
                return f"P{i}:{rex.stype.name}"
        params.append(rex)
        return f"P{len(params) - 1}:{rex.stype.name}"
    if isinstance(rex, RexLiteral):
        return f"L{rex.stype.name}:{rex.value!r}"
    if isinstance(rex, RexCall):
        if rex.op in _DENY_OPS:
            raise Unsupported(rex.op)
        extra = ""
        info = getattr(rex, "info", None)
        if info is not None:
            extra = f"!{getattr(info, 'name', info)}"
        return (f"C{rex.op}{extra}["
                + ",".join(_fp_rex(o, context, scans, params)
                           for o in rex.operands)
                + f"]:{rex.stype.name}")
    if isinstance(rex, RexScalarSubquery) and context is not None:
        # uncorrelated scalar subquery: its plan joins the key and its
        # scans the inputs; the tracer inlines it as a broadcast 1-row result
        return ("S[" + _fp_plan(rex.plan, context, scans, params)
                + f"]:{rex.stype.name}")
    raise Unsupported(type(rex).__name__)


def _fp_plan(rel: RelNode, context, scans: list, params=None) -> str:
    """Serialize the plan for cache keying; collects the scanned tables
    (and the plan's RexParam nodes, in serialization order, into
    ``params``)."""
    if params is None:
        params = []
    t = type(rel).__name__
    schema = ";".join(f"{f.name}:{f.stype.name}" for f in rel.schema)
    if isinstance(rel, LogicalTableScan):
        entry = context.catalog_entry(rel.schema_name, rel.table_name)
        if entry.table is None:
            raise Unsupported("view scan")
        if entry.table.num_rows == 0:
            raise Unsupported("empty table")
        scans.append(((rel.schema_name, rel.table_name), entry.table,
                      entry.row_valid))
        rv = "+rv" if entry.row_valid is not None else ""
        return f"Scan({rel.schema_name}.{rel.table_name}{rv})[{schema}]"
    if isinstance(rel, LogicalProject):
        body = ",".join(_fp_rex(e, context, scans, params)
                        for e in rel.exprs)
    elif isinstance(rel, LogicalFilter):
        body = _fp_rex(rel.condition, context, scans, params)
    elif isinstance(rel, LogicalAggregate):
        for agg in rel.aggs:
            if agg.udaf is not None:
                raise Unsupported("udaf agg")
            if agg.distinct and (
                    agg.op not in ("COUNT", "SUM", "$SUM0", "AVG",
                                   "MIN", "MAX")
                    or agg.filter_arg is not None or not agg.args):
                # FILTER + DISTINCT: the first occurrence of a value may be
                # filtered away while a later duplicate passes
                raise Unsupported("distinct agg shape")
            if agg.op in ("LISTAGG", "BIT_AND", "BIT_OR", "BIT_XOR"):
                raise Unsupported(agg.op)
        body = (f"g={rel.group_keys}|" + ",".join(
            f"{a.op}{'d' if a.distinct else ''}({a.args})f{a.filter_arg}"
            for a in rel.aggs))
    elif isinstance(rel, LogicalJoin):
        if rel.join_type not in ("INNER", "LEFT", "RIGHT", "SEMI", "ANTI"):
            raise Unsupported(rel.join_type)
        na = "N" if getattr(rel, "null_aware", False) else ""
        cond = ("T" if rel.condition is None
                else _fp_rex(rel.condition, context, scans, params))
        body = f"{rel.join_type}{na}|{cond}"
    elif isinstance(rel, LogicalSort):
        body = (",".join(f"{c.index}{'a' if c.ascending else 'd'}"
                         f"{'nf' if c.effective_nulls_first else 'nl'}"
                         for c in rel.collation)
                + f"|o={rel.offset}|l={rel.limit}")
    elif isinstance(rel, LogicalWindow):
        from ..ops.window import TRACE_SAFE_OPS
        for call in rel.calls:
            if call.op not in TRACE_SAFE_OPS:
                raise Unsupported(f"window op {call.op}")
        body = ";".join(
            f"{call.op}({call.args})p{call.partition}"
            + "o" + ",".join(f"{c.index}{'a' if c.ascending else 'd'}"
                             f"{'nf' if c.effective_nulls_first else 'nl'}"
                             for c in call.order)
            + f"f{call.frame!r}" for call in rel.calls)
    elif isinstance(rel, LogicalUnion):
        body = f"all={rel.all}"
    elif isinstance(rel, LogicalValues):
        body = repr([[lit.value for lit in row] for row in rel.rows])
    else:
        raise Unsupported(type(rel).__name__)
    kids = ",".join(_fp_plan(i, context, scans, params) for i in rel.inputs)
    return f"{t}({body})[{schema}]<{kids}>"


_dict_fp_memo: Dict[int, tuple] = {}


def _dict_fingerprint(arr) -> str:
    """Content hash of a string dictionary, memoized per array object:
    dictionaries are baked into a program as constants, so they join the
    key by content (reloaded equal data hits the same program)."""
    key = id(arr)
    hit = _dict_fp_memo.get(key)
    if hit is not None and hit[0]() is arr:
        return hit[1]
    h = hashlib.blake2b(digest_size=16)
    h.update(str(len(arr)).encode())
    for s in arr:
        b = str(s).encode()
        # a length prefix, not a separator: elements may hold any byte
        h.update(str(len(b)).encode() + b":" + b)
    fp = h.hexdigest()
    _dict_fp_memo[key] = (
        weakref.ref(arr, lambda _r, k=key: _dict_fp_memo.pop(k, None)), fp)
    return fp


def _fp_inputs(scans: list) -> tuple:
    out = []
    for _, tbl, row_valid in scans:
        cols = tuple(
            (tuple(c.data.shape), str(c.data.dtype), c.mask is not None,
             None if c.dictionary is None else _dict_fingerprint(c.dictionary))
            for c in tbl.columns)
        out.append((cols, row_valid is not None))
    return tuple(out)


def _mesh_signature(context) -> str:
    """The device component of a program's identity (the JAX package's
    mesh layout; ``parallel/`` is not ported, so it is the device)."""
    return str(getattr(context, "device", ""))


# ---------------------------------------------------------------------------
# hashing (bit for bit the JAX package's uint64 values, as int64)
# ---------------------------------------------------------------------------

def _srl(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of 64-bit words held in int64."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def _mix64(z: torch.Tensor) -> torch.Tensor:
    z = (z ^ _srl(z, 30)) * _MIX1
    z = (z ^ _srl(z, 27)) * _MIX2
    return z ^ _srl(z, 31)


def _f64_hash_part(x: torch.Tensor) -> torch.Tensor:
    """64-bit encoding of f64 for hashing, the JAX package's: the
    double-float (hi, lo) f32 split, each bitcast to i32.  Lossy (about 48
    mantissa bits): it can only add collisions, which callers catch;
    equality is checked on raw values."""
    x = canon_f64(x)
    hi = x.to(torch.float32)
    lo = (x - hi.to(torch.float64)).to(torch.float32)
    hi_b = hi.view(torch.int32).to(torch.int64)
    lo_b = lo.view(torch.int32).to(torch.int64)
    return (hi_b << 32) | (lo_b & 0xFFFFFFFF)


class _VT:
    """A padded device table + row-validity mask (None = all rows valid).
    ``weight`` is the pre-compaction row count, which the INNER join's
    probe/build choice reads."""

    __slots__ = ("table", "valid", "weight")

    def __init__(self, table: Table, valid: Optional[torch.Tensor],
                 weight: Optional[int] = None):
        self.table = table
        self.valid = valid
        self.weight = weight if weight is not None else table.num_rows

    @property
    def n(self) -> int:
        return self.table.num_rows

    def vmask(self, device) -> torch.Tensor:
        if self.valid is None:
            return torch.ones(self.n, dtype=torch.bool, device=device)
        return self.valid


def _hash_group_parts(parts) -> torch.Tensor:
    """Mix all group-key parts (data + class flags) into one 64-bit word
    per row; float parts ride the lossy double-float encoding."""
    d0 = parts[0][0]
    h = torch.full(d0.shape, _GOLDEN, dtype=torch.int64, device=d0.device)
    for d, flag in parts:
        hp = _f64_hash_part(d) if d.dtype.is_floating_point \
            else d.to(torch.int64)
        h = _mix64(h + hp + _GOLDEN)
        if flag is not None:
            h = _mix64(h + flag.to(torch.int64) + _GOLDEN)
    return h


def _lexsort(arrays: List[torch.Tensor], n: int, device) -> torch.Tensor:
    """``jnp.lexsort`` (last array most significant): chained stable sorts."""
    perm = torch.arange(n, device=device)
    for a in arrays:
        if a.dtype == torch.bool:
            a = a.to(torch.int8)
        perm = perm[torch.sort(a[perm], stable=True).indices]
    return perm


class _GroupSorted:
    """Group-sorted stream (the sorted GROUP BY and its dedup); ``collision``
    is a 0-dim bool: a 64-bit key-hash collision may have interleaved two
    groups (hash-combined sort only)."""

    __slots__ = ("perm", "valid_sorted", "codes_sorted", "num_groups",
                 "starts", "ends", "first_rows", "n", "cap", "collision",
                 "payload_sorted")


def _group_sorted_codes(key_cols: List[Column],
                        row_valid: Optional[torch.Tensor], cap: int,
                        payload: Tuple[torch.Tensor, ...] = (),
                        tpu: bool = False) -> _GroupSorted:
    """Sort rows into group order and derive dense codes in sorted space.

    Invalid rows and groups beyond ``cap`` land in the trash slot ``cap``;
    the stable sort makes ``first_rows[g]`` the group's first row.  Under
    the ``tpu`` strategy, more than two key operands collapse into one
    64-bit hash (group order is then hash order, and a collision of two
    distinct keys is reported).  Keys are sorted, everything else gathered
    by the permutation: the same permutation as the JAX package's
    payload-carrying sort."""
    from ..ops import sorted_agg as sa

    n = len(key_cols[0])
    dev = key_cols[0].device
    parts = _key_parts(key_cols)
    invalid = torch.zeros(n, dtype=torch.bool, device=dev) \
        if row_valid is None else ~row_valid
    n_operands = sum(2 if flag is not None else 1 for _, flag in parts)
    hashed = tpu and n_operands > 2

    key_ops: List[torch.Tensor] = [invalid]
    hs_key = None
    if hashed:
        # unsigned order of the hash: flip the sign bit
        hs_key = _hash_group_parts(parts) ^ _INT64_MIN
        key_ops.append(hs_key)
    else:
        for d, flag in parts:
            if flag is not None:
                key_ops.append(flag)
            key_ops.append(d)
    perm = _lexsort(list(reversed(key_ops)), n, dev)
    valid_sorted = ~invalid[perm]
    payload_sorted = tuple(p[perm] for p in payload)
    parts_sorted = [(d[perm], None if flag is None else flag[perm])
                    for d, flag in parts]

    diff = torch.zeros(max(n - 1, 0), dtype=torch.bool, device=dev)
    for d, flag in parts_sorted:
        diff = diff | (d[1:] != d[:-1])
        if flag is not None:
            diff = diff | (flag[1:] != flag[:-1])
    boundary = torch.cat([torch.ones(min(n, 1), dtype=torch.bool,
                                     device=dev), diff]) & valid_sorted

    collision = torch.zeros((), dtype=torch.bool, device=dev)
    if hashed:
        hs = hs_key[perm]
        adj_pair = valid_sorted[1:] & valid_sorted[:-1]
        collision = (adj_pair & (hs[1:] == hs[:-1]) & boundary[1:]).any()

    codes_sorted = torch.cumsum(boundary.to(torch.int64), 0) - 1
    num_groups = torch.where(
        valid_sorted.any(),
        torch.where(valid_sorted, codes_sorted, -1).max() + 1
        if n else torch.zeros((), dtype=torch.int64, device=dev), 0)
    codes_sorted = torch.where(valid_sorted, codes_sorted.clamp_max(cap), cap)

    gs = _GroupSorted()
    gs.perm, gs.valid_sorted, gs.codes_sorted = perm, valid_sorted, codes_sorted
    gs.num_groups, gs.n, gs.cap = num_groups, n, cap
    gs.collision = collision
    gs.payload_sorted = payload_sorted
    gs.starts, gs.ends = sa.segment_bounds(codes_sorted, cap)
    gs.first_rows = perm[gs.starts.clamp(0, max(n - 1, 0))]
    return gs


def _traced_factorize(key_cols: List[Column],
                      row_valid: Optional[torch.Tensor], cap: int,
                      rounds: int, tpu: bool = False):
    """Row-order codes (UNION DISTINCT and DISTINCT aggregates).  Returns
    (codes, first_rows, num_groups, collision, unresolved); under the host
    strategy an unresolved table folds into the collision flag, as in the
    JAX package (callers pass cap >= the worst case)."""
    if not tpu:
        codes, first, ng, coll, unres = _group_hashed_codes(
            key_cols, row_valid, cap, rounds)
        return codes, first, ng, coll | (ng > cap), unres
    gs = _group_sorted_codes(key_cols, row_valid, cap, tpu=True)
    codes = torch.empty_like(gs.codes_sorted)
    codes[gs.perm] = gs.codes_sorted
    return codes, gs.first_rows, gs.num_groups, gs.collision, None


STATIC_DOMAIN_CAP = 4096


def _try_static_codes(cols: List[Column]):
    """Direct group codes when every key has a statically enumerable domain
    (dictionary strings, booleans): (codes int64 in [0, domain), domain,
    key_meta) or None.  Code order is the eager group order (NULL slot
    first, then dictionary rank order)."""
    domain = 1
    parts: List[Tuple[torch.Tensor, int]] = []
    key_meta: List[Tuple[int, bool]] = []
    for c in cols:
        nullable = c.mask is not None
        if c.stype.is_string:
            size = len(c.dictionary)
            code = c.dict_ranks().data.to(torch.int64)
        elif c.data.dtype == torch.bool:
            size = 2
            code = c.data.to(torch.int64)
        else:
            return None
        if nullable:
            code = torch.where(c.mask, code + 1, 0)
            size += 1
        size = max(size, 1)
        domain *= size
        if domain > STATIC_DOMAIN_CAP:
            return None
        parts.append((code, size))
        key_meta.append((size, nullable))
    combined = parts[0][0]
    for code, size in parts[1:]:
        combined = combined * size + code
    return combined, domain, key_meta


def _decode_static_keys(cols: List[Column], key_meta, domain: int,
                        device) -> List[Column]:
    """Group-key output columns from the slot index alone (mixed-radix
    digits of ``arange(domain)``; a rank -> dictionary-code gather)."""
    g = torch.arange(domain, dtype=torch.int64, device=device)
    stride = domain
    out: List[Column] = []
    for c, (size, nullable) in zip(cols, key_meta):
        stride //= size
        code = torch.div(g, stride, rounding_mode="floor") % size
        mask = None
        if nullable:
            mask = code != 0
            code = (code - 1).clamp_min(0)
        if c.stype.is_string:
            order = torch.from_numpy(
                dict_sort_order(c.dictionary).astype(np.int32)).to(device)
            out.append(Column(order[code], c.stype, mask, c.dictionary))
        else:
            out.append(Column(code.to(torch.bool), c.stype, mask))
    return out


def _join_key_parts(lcols: List[Column], rcols: List[Column]):
    """Per key, (hash part, raw verify array) on a shared domain.  Float
    hash parts are lossy; matches always verify the raw arrays, which keep
    NaN as NaN (NaN joins nothing, as in the eager path)."""
    lparts, rparts = [], []
    for lc, rc in zip(lcols, rcols):
        if lc.stype.is_string or rc.stype.is_string:
            la, ra = unify_string_codes([lc, rc])
            la, ra = la.to(torch.int64), ra.to(torch.int64)
            lh, rh = la, ra
        else:
            dt = torch.promote_types(lc.data.dtype, rc.data.dtype)
            la = lc.data.to(dt)
            ra = rc.data.to(dt)
            if dt.is_floating_point:
                la = la.to(torch.float64) + 0.0
                ra = ra.to(torch.float64) + 0.0
                lh, rh = _f64_hash_part(la), _f64_hash_part(ra)
            else:
                la, ra = orderable_int64(la), orderable_int64(ra)
                lh, rh = la, ra
        lparts.append((lh, la))
        rparts.append((rh, ra))
    return lparts, rparts


def _hash_parts(parts, key_valid: torch.Tensor) -> torch.Tensor:
    d0 = parts[0][0]
    h = torch.full(d0.shape, _GOLDEN, dtype=torch.int64, device=d0.device)
    for hp, _ in parts:
        h = _mix64(h + hp + _GOLDEN)
    h = torch.where(h == _U64_MAX, _U64_MAX - 1, h)
    return torch.where(key_valid, h, _U64_MAX)


def _keys_valid(cols: List[Column], row_valid: Optional[torch.Tensor]
                ) -> torch.Tensor:
    v = torch.ones(len(cols[0]), dtype=torch.bool, device=cols[0].device) \
        if row_valid is None else row_valid
    for c in cols:
        if c.mask is not None:
            v = v & c.mask
    return v


# ---------------------------------------------------------------------------
# open-addressing hash table (the host strategy's joins and group-bys)
#
# Each round, still-unresolved rows claim an empty slot (one scatter-min of
# priority-encoded row ids) and every row whose round slot holds an
# equal-hash resident adopts it; all rows of one key resolve to one slot
# whose resident is the key's first row.  The JAX package loops while any
# row is unresolved (at most 64 rounds); a CUDA graph cannot read that
# condition, so the port runs a fixed number of rounds per site, learned
# like a capacity: a site left unresolved reports it through the flags and
# the program is recaptured with twice the rounds, up to 64.  Extra rounds
# change nothing, so the result is the JAX package's bit for bit.
# ---------------------------------------------------------------------------

_HASH_MAX_ROUNDS = 64
# one round: a key that addresses its table directly resolves in it; a
# hashed site learns the rounds it needs (each round costs every replay)
DEFAULT_HASH_ROUNDS = 1

# Scatters send the rows that do not count to spare slots past the real
# ones (the JAX package drops them with ``mode="drop"``); spreading them
# over TRASH slots keeps millions of them off one address, where the
# card's atomics (compare-and-swap loops for integer min/max) serialise.
TRASH = 1 << 16


def _trash(keep: torch.Tensor, idx: torch.Tensor, base: int) -> torch.Tensor:
    """``idx`` where ``keep``, else one of the TRASH spare slots from
    ``base`` on."""
    spare = base + (torch.arange(keep.shape[0], device=keep.device)
                    & (TRASH - 1))
    return torch.where(keep, idx, spare)


def _hash_table_size(n_keys: int) -> int:
    """Power-of-2 table size at load factor <= 1/16 (room for sparse
    integer keys to address directly)."""
    return max(16, 1 << int(16 * max(n_keys, 1) - 1).bit_length())


def _single_int_part(parts):
    """The raw int64 array when the key is ONE non-nullable integer part
    (``_mix64`` is a bijection: no collisions, direct addressing), else
    None."""
    if len(parts) != 1 or parts[0][1] is not None:
        return None
    d = parts[0][0]
    if d.dtype.is_floating_point:
        return None
    return d.to(torch.int64)


def _direct_info(raw: Optional[torch.Tensor], valid: torch.Tensor,
                 size: int):
    """(raw, lo, fits) for direct addressing: when the key range fits the
    table, round 0 gives every distinct key its own slot ``key - lo``."""
    if raw is None:
        return None
    lo = torch.where(valid, raw, _I64.max).min()
    hi = torch.where(valid, raw, _I64.min).max()
    fits = (hi.to(torch.float64) - lo.to(torch.float64)) < size
    return raw, lo, fits & valid.any()


def _combined_int_key(part_sides):
    """Mixed-radix combination of 2+ non-float key parts into one int64 per
    row and side (``part_sides``: per part, one (data, flag, valid) per
    side).  Returns (keys per side, ok, span_prod): where ``ok`` every
    stride product stayed below 2**62, so the combination is injective.
    None when any part is floating."""
    for sides in part_sides:
        for d, _, _ in sides:
            if d.dtype.is_floating_point:
                return None
    dev = part_sides[0][0][0].device
    n_sides = len(part_sides[0])
    keys = [torch.zeros(part_sides[0][s][0].shape[0], dtype=torch.int64,
                        device=dev) for s in range(n_sides)]
    span_prod = torch.ones((), dtype=torch.float64, device=dev)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    for sides in part_sides:
        lo = torch.full((), _I64.max, dtype=torch.int64, device=dev)
        hi = torch.full((), _I64.min, dtype=torch.int64, device=dev)
        any_v = torch.zeros((), dtype=torch.bool, device=dev)
        svalids = []
        for d, flag, valid in sides:
            d = d.to(torch.int64)
            sv = valid if flag is None else (valid & (flag == 1))
            svalids.append(sv)
            lo = torch.minimum(lo, torch.where(sv, d, _I64.max).min())
            hi = torch.maximum(hi, torch.where(sv, d, _I64.min).max())
            any_v = any_v | sv.any()
        lo = torch.where(any_v, lo, 0)
        hi = torch.where(any_v, hi, 0)
        span_prod = span_prod * (hi.to(torch.float64)
                                 - lo.to(torch.float64) + 1.0)
        ok = ok & (span_prod < 2.0 ** 62)
        stride = hi - lo + 1
        has_flag = any(flag is not None for _, flag, _ in sides)
        if has_flag:
            span_prod = span_prod * 2.0
            ok = ok & (span_prod < 2.0 ** 62)
        for s, (d, flag, _) in enumerate(sides):
            d = d.to(torch.int64)
            dn = torch.where(svalids[s], d - lo, 0)
            k = keys[s] * stride + dn
            if has_flag:
                fl = (torch.ones_like(dn) if flag is None
                      else flag.to(torch.int64))
                k = k * 2 + fl
            keys[s] = k
    return keys, ok, span_prod


def _slot_at_round(h: torch.Tensor, k: int, size: int, direct
                   ) -> torch.Tensor:
    s = (_mix64(h + _i64((2 * k + 1) * _GOLDEN_U)) & (size - 1)
         ).to(torch.int32)
    if direct is not None and k == 0:
        raw, lo, fits = direct
        d = (raw - lo).clamp(0, size - 1).to(torch.int32)
        s = torch.where(fits, d, s)
    return s


_TBL_EMPTY = _I64.max
_TBL_ROW_MASK = (1 << 32) - 1


def _hash_table_insert(h: torch.Tensor, valid: torch.Tensor, size: int,
                       direct=None, rounds: int = _HASH_MAX_ROUNDS):
    """Resolve every valid row to one table slot per distinct hash in
    ``rounds`` claim rounds.

    Claims are ``(round+1) << 32 | row``, written with one scatter-min per
    round: earlier rounds beat later ones and the smallest row wins within
    a round, so claims are permanent and deterministic.  Returns (slot
    int32 per row, resident int32 per row: the hash group's first row, n
    where unresolved, resolved bool, table int64[size]: the claims,
    ``_TBL_EMPTY`` where free, unresolved: 0-dim bool, some valid row
    still unresolved after ``rounds``)."""
    n = h.shape[0]
    dev = h.device
    rows = torch.arange(n, dtype=torch.int64, device=dev)
    # the rows no longer active claim spare slots past ``size``
    table = torch.full((size + TRASH,), _TBL_EMPTY, dtype=torch.int64,
                       device=dev)
    slot = torch.zeros(n, dtype=torch.int32, device=dev)
    resident = torch.full((n,), n, dtype=torch.int32, device=dev)
    active = valid
    for k in range(rounds):
        s_k = _slot_at_round(h, k, size, direct).to(torch.int64)
        table.scatter_reduce_(0, _trash(active, s_k, size),
                              rows | ((k + 1) << 32), reduce="amin")
        tv = table[s_k]
        res = (tv & _TBL_ROW_MASK).to(torch.int32)
        ok = (active & (tv != _TBL_EMPTY)
              & (h[res.clamp(0, max(n - 1, 0)).to(torch.int64)] == h))
        slot = torch.where(ok, s_k.to(torch.int32), slot)
        resident = torch.where(ok, res, resident)
        active = active & ~ok
    return slot, resident, valid & ~active, table[:size], active.any()


def _group_hashed_codes(key_cols: List[Column],
                        row_valid: Optional[torch.Tensor], cap: int,
                        rounds: int = _HASH_MAX_ROUNDS):
    """Row-order dense group codes without a sort (the host strategy).

    Returns (codes int64 per row, trash slot ``cap`` for invalid rows,
    first_rows int64[cap], num_groups, collision, unresolved).
    ``num_groups`` is n+1 when the table could not resolve every key (the
    saturation sentinel the capacity escalation reads).  Group numbering
    is first-occurrence order."""
    n = len(key_cols[0])
    dev = key_cols[0].device
    parts = _key_parts(key_cols)
    h = _hash_group_parts(parts)
    valid = torch.ones(n, dtype=torch.bool, device=dev) \
        if row_valid is None else row_valid
    size = _hash_table_size(cap)
    single = _single_int_part(parts)
    direct = _direct_info(single, valid, size)
    combo_ok = None
    if single is None:
        combo = _combined_int_key([[(d, flag, valid)] for d, flag in parts])
        if combo is not None:
            (key,), combo_ok, span_prod = combo
            h = torch.where(combo_ok, _mix64(key), h)
            direct = (key, torch.zeros((), dtype=torch.int64, device=dev),
                      combo_ok & (span_prod <= float(size)))
    slot, resident, resolved, _, unresolved = _hash_table_insert(
        h, valid, size, direct, rounds)

    coll = torch.zeros((), dtype=torch.bool, device=dev)
    if single is None:
        rc = resident.clamp(0, n - 1).to(torch.int64)
        for d, flag in parts:
            coll = coll | (resolved & (d[rc] != d)).any()
            if flag is not None:
                coll = coll | (resolved & (flag[rc] != flag)).any()
        if combo_ok is not None:
            coll = coll & ~combo_ok

    # dense codes in first-occurrence order: rank the leader rows (a
    # group's resident is its first row) and read codes through residents
    ar = torch.arange(n, dtype=torch.int64, device=dev)
    leader = resolved & (resident.to(torch.int64) == ar)
    lrank = torch.cumsum(leader.to(torch.int64), 0) - 1
    real_groups = leader.to(torch.int64).sum()
    num_groups = torch.where((valid & ~resolved).any(), n + 1, real_groups)

    codes_raw = lrank[resident.clamp(0, n - 1).to(torch.int64)]
    codes = torch.where(resolved, codes_raw.clamp_max(cap), cap)
    # a group has one leader: a plain scatter places it (the JAX package's
    # scatter-min over the same unique slots)
    fr_idx = _trash(leader & (codes < cap), codes, cap)
    first_rows = torch.full((cap + TRASH,), n, dtype=torch.int64, device=dev)
    first_rows.scatter_(0, fr_idx, ar)
    first_rows = first_rows[:cap].clamp(0, max(n - 1, 0))
    return codes, first_rows, num_groups, coll, unresolved


def _compact_index(mask: torch.Tensor, count: int) -> torch.Tensor:
    """Positions of the first ``count`` True rows of ``mask``, in order, 0
    past the last True row (``jnp.nonzero(size=count, fill_value=0)``):
    the k-th True row is where the running count first reaches k, a binary
    search, with no host read (``count`` is static)."""
    running = torch.cumsum(mask.to(torch.int64), 0)
    pos = torch.searchsorted(running, torch.arange(
        1, count + 1, dtype=torch.int64, device=mask.device))
    return torch.where(pos < mask.shape[0], pos, 0)


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------

class _Tracer:
    is_tracer = True   # routes RexScalarSubquery into traced_scalar_subquery

    def __init__(self, context, scan_tables: Dict[tuple, tuple],
                 caps: Dict[str, int], tpu: bool = False):
        self.context = context
        self.device = context.device
        self.scan_tables = scan_tables
        self.caps = caps
        self.tpu = tpu
        self.fallback: List[torch.Tensor] = []   # device bools -> eager
        self.ngroups: List[torch.Tensor] = []    # device ints, walk order
        self.ngroup_caps: List[int] = []         # matching static caps
        self.agg_sites: List[Tuple[int, bool, str]] = []  # (rows, hashed, tag)
        self.unresolved: List[torch.Tensor] = []  # per hash-table site
        self.round_sites: List[Tuple[str, int]] = []      # (tag, rounds)
        self._agg_counter = 0
        self._cmp_counter = 0
        self._rnd_counter = 0
        self.compact_ok: set = set()
        # RexParam node id -> the program's 0-d input tensor for it
        # (``rex/evaluate._eval_param``); None outside a parameterized plan
        self.param_values: Optional[Dict[int, torch.Tensor]] = None

    def _rounds(self) -> Tuple[str, int]:
        tag = f"rnd{self._rnd_counter}"
        self._rnd_counter += 1
        return tag, int(self.caps.get(tag, DEFAULT_HASH_ROUNDS))

    def _note_rounds(self, tag: str, rounds: int, unresolved,
                     agg_tag: Optional[str] = None) -> None:
        """A hash-table site; ``agg_tag`` names the GROUP BY whose
        capacity sizes its table."""
        self.round_sites.append((tag, rounds, agg_tag))
        self.unresolved.append(unresolved)

    def traced_scalar_subquery(self, rex, outer_table: Table) -> Column:
        """Inline an uncorrelated scalar subquery whose plan is statically
        one row; the value broadcasts to the outer table's length and its
        NULL-ness rides the mask."""
        vt = self.run(rex.plan)
        if vt.valid is not None or vt.n != 1:
            raise Unsupported("scalar subquery with runtime row count")
        col = vt.table.columns[0]
        n = outer_table.num_rows
        d0 = col.data[0]
        data = d0.expand(n)
        valid0 = None if col.mask is None else col.mask[0]
        if col.data.dtype.is_floating_point:
            # the eager path makes a NaN subquery result NULL
            notnan = ~torch.isnan(d0)
            valid0 = notnan if valid0 is None else (valid0 & notnan)
        mask = None if valid0 is None else valid0.expand(n)
        return Column(data, col.stype, mask, col.dictionary)

    # -- dispatch ----------------------------------------------------------
    def run(self, rel: RelNode) -> _VT:
        m = getattr(self, "_" + type(rel).__name__, None)
        if m is None:
            raise Unsupported(type(rel).__name__)
        return m(rel)

    # -- nodes -------------------------------------------------------------
    def _LogicalTableScan(self, rel: LogicalTableScan) -> _VT:
        t, valid = self.scan_tables[(rel.schema_name, rel.table_name)]
        want = [f.name for f in rel.schema]
        if t.names != want:
            t = t.limit_to(want)
        return _VT(t, valid)

    def _LogicalProject(self, rel: LogicalProject) -> _VT:
        src = self.run(rel.input)
        cols: List[Column] = []
        for rex in rel.exprs:
            v = evaluate_rex(rex, src.table, self)
            if isinstance(v, Scalar):
                v = Column.from_scalar(v, src.n, self.device)
            cols.append(v)
        return _VT(Table([f.name for f in rel.schema], cols), src.valid,
                   weight=src.weight)

    def _LogicalFilter(self, rel: LogicalFilter) -> _VT:
        src = self.run(rel.input)
        mask = evaluate_predicate(rel.condition, src.table, self)
        if isinstance(mask, bool):
            if mask:
                return src
            return _VT(src.table, torch.zeros(src.n, dtype=torch.bool,
                                              device=self.device))
        valid = mask if src.valid is None else (mask & src.valid)
        out = _VT(src.table, valid, weight=src.weight)
        if id(rel) in self.compact_ok:
            out = self._maybe_compact(out)
        return out

    def _maybe_compact(self, vt: _VT) -> _VT:
        """Learned-capacity compaction after a selective filter (the tpu
        strategy): a power-of-2 capacity learned through the flags, as
        group caps are; a learned cap >= n/2 disables the site."""
        n = vt.n
        if n < (1 << 16):
            return vt
        tag = f"cmp{self._cmp_counter}"
        self._cmp_counter += 1
        default_cap = 1 << max(int((max(n // 4, 1) - 1)).bit_length(), 10)
        cap = min(self.caps.get(tag, default_cap), n)
        if cap * 2 >= n:
            return vt
        mask = vt.vmask(self.device)
        count = mask.to(torch.int64).sum()
        idx = _compact_index(mask, cap)
        row_valid = torch.arange(cap, device=self.device) < count
        cols = [c.take(idx) for c in vt.table.columns]
        self.ngroups.append(count)
        self.ngroup_caps.append(cap)
        self.agg_sites.append((n, False, tag))
        return _VT(Table(list(vt.table.names), cols), row_valid,
                   weight=vt.weight)

    def _LogicalValues(self, rel: LogicalValues) -> _VT:
        from .rel.executor import _values
        return _VT(_values(rel, self), None)

    def _LogicalAggregate(self, rel: LogicalAggregate) -> _VT:
        src = self.run(rel.input)
        n = src.n
        out_cols: List[Column] = []
        out_names = [f.name for f in rel.schema]

        if not rel.group_keys:
            for j, agg in enumerate(rel.aggs):
                f = rel.schema[j]
                col = src.table.columns[agg.args[0]] if agg.args else None
                fmask = self._agg_filter(agg, src)
                if agg.distinct and agg.op not in ("MIN", "MAX"):
                    keep = self._distinct_keep([], agg, src)
                    fmask = keep if fmask is None else (fmask & keep)
                out_cols.append(G.whole_table_aggregate(
                    agg.op, col, fmask, f.stype, n, self.device))
            return _VT(Table(out_names, out_cols), None)

        key_cols = [src.table.columns[i] for i in rel.group_keys]
        static = self._static_domain_aggregate(rel, src, key_cols)
        if static is not None:
            return static

        tag = f"agg{self._agg_counter}"
        self._agg_counter += 1
        cap = min(self.caps.get(tag, DEFAULT_GROUP_CAP), n)
        if not self.tpu:
            return self._hashed_aggregate(rel, src, key_cols, cap, tag)
        return self._sorted_aggregate(rel, src, key_cols, cap, tag)

    def _sorted_aggregate(self, rel, src: _VT, key_cols: List[Column],
                          cap: int, tag: str) -> _VT:
        """GROUP BY under the tpu strategy: one group sort, then every
        aggregate is a prefix-sum difference or a segmented scan over the
        sorted stream (``sorted_segment_aggregate``), no scatter."""
        n = src.n
        out_names = [f.name for f in rel.schema]
        need: List[int] = []
        for agg in rel.aggs:
            for idx in (list(agg.args[:1])
                        + ([agg.filter_arg] if agg.filter_arg is not None
                           else [])):
                if idx not in need:
                    need.append(idx)
        payload: List[torch.Tensor] = []
        pay_slots: Dict[int, Tuple[int, Optional[int]]] = {}
        for idx in need:
            col = src.table.columns[idx]
            di = len(payload)
            payload.append(col.data)
            mi = None
            if col.mask is not None:
                mi = len(payload)
                payload.append(col.mask)
            pay_slots[idx] = (di, mi)
        keep_slots: Dict[int, int] = {}
        for agg in rel.aggs:
            if agg.distinct and agg.op not in ("MIN", "MAX"):
                ai = agg.args[0]
                if ai not in keep_slots:
                    keep_slots[ai] = len(payload)
                    payload.append(self._distinct_keep(key_cols, agg, src))

        gs = _group_sorted_codes(key_cols, src.valid, cap, tuple(payload),
                                 tpu=True)
        self.fallback.append(gs.collision)
        self.ngroups.append(gs.num_groups)
        self.ngroup_caps.append(cap)
        self.agg_sites.append((n, False, tag))

        out_cols = [src.table.columns[ki].take(gs.first_rows)
                    for ki in rel.group_keys]

        def _sorted_col(idx: int) -> Column:
            di, mi = pay_slots[idx]
            col = src.table.columns[idx]
            mask = gs.payload_sorted[mi] if mi is not None else None
            return Column(gs.payload_sorted[di], col.stype, mask,
                          col.dictionary)

        for j, agg in enumerate(rel.aggs):
            f = rel.schema[len(rel.group_keys) + j]
            col_s = _sorted_col(agg.args[0]) if agg.args else None
            vmask = gs.valid_sorted
            if col_s is not None and col_s.mask is not None:
                vmask = vmask & col_s.mask
            if agg.filter_arg is not None:
                fc = _sorted_col(agg.filter_arg)
                vmask = vmask & fc.data.to(torch.bool) & fc.valid_mask()
            if agg.distinct and agg.op not in ("MIN", "MAX"):
                vmask = vmask & gs.payload_sorted[keep_slots[agg.args[0]]]
            out_cols.append(G.sorted_segment_aggregate(
                agg.op, col_s, vmask, gs.codes_sorted, gs.starts, gs.ends,
                f.stype))
        row_valid = torch.arange(cap, device=self.device) < gs.num_groups
        return _VT(Table(out_names, out_cols), row_valid)

    def _hashed_aggregate(self, rel, src: _VT, key_cols: List[Column],
                          cap: int, tag: str) -> _VT:
        """GROUP BY under the host strategy: hash-table codes in row order,
        then each aggregate is the eager path's segment reduction
        (``segment_aggregate``) over cap + TRASH segments, the spare ones
        the invalid rows', sliced off."""
        n = src.n
        out_names = [f.name for f in rel.schema]
        rtag, rounds = self._rounds()
        codes, first_rows, num_groups, coll, unres = _group_hashed_codes(
            key_cols, src.valid, cap, rounds)
        self._note_rounds(rtag, rounds, unres, tag)
        self.fallback.append(coll)
        self.ngroups.append(num_groups)
        self.ngroup_caps.append(cap)
        self.agg_sites.append((n, True, tag))

        out_cols = [src.table.columns[ki].take(first_rows)
                    for ki in rel.group_keys]
        codes = _trash(codes < cap, codes, cap)
        for j, agg in enumerate(rel.aggs):
            f = rel.schema[len(rel.group_keys) + j]
            col = src.table.columns[agg.args[0]] if agg.args else None
            fmask = self._agg_filter(agg, src)
            if agg.distinct and agg.op not in ("MIN", "MAX"):
                keep = self._distinct_keep(key_cols, agg, src)
                fmask = keep if fmask is None else (fmask & keep)
            c = G.segment_aggregate(agg.op, col, codes, cap + TRASH, f.stype,
                                    filter_mask=fmask, n_rows=n,
                                    device=self.device)
            out_cols.append(Column(c.data[:cap], c.stype,
                                   None if c.mask is None else c.mask[:cap],
                                   c.dictionary))
        row_valid = torch.arange(cap, device=self.device) < num_groups
        return _VT(Table(out_names, out_cols), row_valid)

    def _static_domain_aggregate(self, rel, src: _VT, key_cols
                                 ) -> Optional[_VT]:
        """GROUP BY over a statically enumerable key domain of at most 256
        slots (dictionary strings, booleans): codes straight from the
        dictionary ranks, every SUM/COUNT/AVG one row of a float64 stack
        summed exactly by ``segmented_sums_dispatch`` (kernel 1 on the
        card).  The TPC-H Q1 shape.  None when the shape does not fit."""
        from ..ops import gpu_kernels as gk
        static = _try_static_codes(key_cols)
        if static is None:
            return None
        codes, domain, key_meta = static
        if domain > 256:
            return None
        for agg in rel.aggs:
            col = src.table.columns[agg.args[0]] if agg.args else None
            if agg.op not in ("SUM", "$SUM0", "AVG", "COUNT") or agg.distinct:
                return None
            if col is not None and col.stype.is_string:
                return None
            if col is not None and col.data.dtype == torch.bool:
                return None

        n = src.n
        dev = self.device
        kmask = torch.ones(n, dtype=torch.bool, device=dev) \
            if src.valid is None else src.valid
        out_names = [f.name for f in rel.schema]
        out_cols: List[Column] = _decode_static_keys(key_cols, key_meta,
                                                     domain, dev)

        rows = [kmask.to(torch.float64)]   # row 0: occupancy counts
        row_classes = ["unit"]
        slots = []
        for j, agg in enumerate(rel.aggs):
            f = rel.schema[len(rel.group_keys) + j]
            col = src.table.columns[agg.args[0]] if agg.args else None
            fmask = self._agg_filter(agg, src)
            factor = 1.0
            if col is not None and agg.op in ("SUM", "$SUM0", "AVG"):
                ds = exact_decimal_scale(col.stype)
                if ds is not None:
                    factor = 10.0 ** ds
            if col is None:
                vmask = torch.ones(n, dtype=torch.bool, device=dev) \
                    if fmask is None else fmask
                vrow = crow = vmask.to(torch.float64)
                rc = "unit"
            elif agg.op == "COUNT":
                # only the 0/1 count row is read: no 2**53 guard
                vmask = col.valid_mask() if fmask is None \
                    else (col.valid_mask() & fmask)
                vrow = crow = vmask.to(torch.float64)
                rc = "unit"
            else:
                vmask = col.valid_mask() if fmask is None \
                    else (col.valid_mask() & fmask)
                data = col.data.to(torch.float64)
                if factor != 1.0:
                    data = torch.round(data * factor)
                vrow = torch.where(vmask, data, 0.0)
                crow = vmask.to(torch.float64)
                is_int = factor != 1.0 or not col.data.dtype.is_floating_point
                if is_int:
                    # the int grid is exact below 2**53 only
                    big = vrow.abs().amax() >= 2.0 ** 53 if n else \
                        torch.zeros((), dtype=torch.bool, device=dev)
                    self.fallback.append(big)
                rc = "int" if is_int else "float"
            slots.append((j, agg, f, len(rows), factor))
            rows.append(vrow)
            row_classes.append(rc)
            rows.append(crow)
            row_classes.append("unit")

        stack = torch.stack(rows)
        red = gk.segmented_sums_dispatch(stack, codes, kmask, domain,
                                         row_classes=row_classes)
        occupancy = red[0] > 0

        from ..ops.kernels import decimal_unscale
        results: List[Optional[Column]] = [None] * len(rel.aggs)
        for j, agg, f, row0, factor in slots:
            sums, counts = red[row0], red[row0 + 1]
            has = counts > 0
            if agg.op == "COUNT":
                results[j] = Column(counts.to(torch.int64), f.stype, None)
            elif agg.op in ("$SUM0", "SUM"):
                out = sums
                if factor != 1.0:
                    out = decimal_unscale(sums.to(torch.int64),
                                          int(round(math.log10(factor))))
                results[j] = Column(out.to(torch_dtype(f.stype)), f.stype,
                                    None if agg.op == "$SUM0" else has)
            else:  # AVG
                results[j] = Column(sums / (counts.clamp_min(1.0) * factor),
                                    f.stype, has)
        out_cols.extend(results)
        return _VT(Table(out_names, out_cols), occupancy)

    def _first_occurrence_keep(self, cols: List[Column],
                               row_valid: Optional[torch.Tensor]
                               ) -> torch.Tensor:
        """True on the first valid row of each distinct column tuple."""
        n = len(cols[0])
        rtag, rounds = self._rounds()
        codes, first, _, coll, unres = _traced_factorize(
            cols, row_valid, n, rounds, self.tpu)
        if unres is not None:
            self._note_rounds(rtag, rounds, unres)
        self.fallback.append(coll)
        return first.clamp(0, max(n - 1, 0))[codes.clamp_max(n - 1)] \
            == torch.arange(n, device=self.device)

    def _distinct_keep(self, key_cols: List[Column], agg, src: _VT
                       ) -> torch.Tensor:
        """First occurrence of each (group keys, argument value) combo."""
        return self._first_occurrence_keep(
            list(key_cols) + [src.table.columns[agg.args[0]]], src.valid)

    def _agg_filter(self, agg, src: _VT):
        """FILTER clause and row validity combined (None = all rows)."""
        fmask = src.valid
        if agg.filter_arg is not None:
            fc = src.table.columns[agg.filter_arg]
            fm = fc.data.to(torch.bool) & fc.valid_mask()
            fmask = fm if fmask is None else (fmask & fm)
        return fmask

    def _LogicalSort(self, rel: LogicalSort) -> _VT:
        src = self.run(rel.input)
        n = src.n
        valid = src.valid
        table = src.table
        need_compact = rel.offset is not None or rel.limit is not None
        if rel.collation or (need_compact and valid is not None):
            arrays = []
            for c in reversed(rel.collation):
                col = table.columns[c.index]
                raw = comparable_data(col)
                if raw.dtype.is_floating_point:
                    d = canon_f64(raw)
                    # NaN sorts last in both directions
                    nanflag = torch.isnan(raw).to(torch.int8)
                    if not c.ascending:
                        d = -d
                    arrays.append(d)
                    arrays.append(nanflag)
                else:
                    d = orderable_int64(raw)
                    if not c.ascending:
                        d = -torch.where(d == _INT64_MIN, _INT64_MIN + 1, d)
                    arrays.append(d)
                if col.mask is not None:
                    nullkey = (~col.mask).to(torch.int8)
                    if c.effective_nulls_first:
                        nullkey = -nullkey
                    arrays.append(nullkey)
            if valid is not None:
                arrays.append((~valid).to(torch.int8))  # valid rows first
            perm = _lexsort(arrays, n, self.device)
            table = table.take(perm)
            if valid is not None:
                count = valid.to(torch.int64).sum()
                valid = torch.arange(n, device=self.device) < count
        start = rel.offset or 0
        stop = n if rel.limit is None else min(start + rel.limit, n)
        if start == 0 and stop == n:
            return _VT(table, valid)
        table = table.slice(start, stop)
        if valid is not None:
            count = valid.to(torch.int64).sum()
            valid = torch.arange(stop - start, device=self.device) \
                < (count - start)
        return _VT(table, valid)

    def _LogicalWindow(self, rel) -> _VT:
        from ..ops import window as W
        src = self.run(rel.input)
        names = list(src.table.names)
        cols = list(src.table.columns)
        for call in rel.calls:
            order = [(c.index, c.ascending, c.effective_nulls_first)
                     for c in call.order]
            cols.append(W.compute_window(src.table, call.op, call.args,
                                         call.partition, order, call.frame,
                                         call.stype, row_valid=src.valid))
            names.append(call.name)
        return _VT(Table(names, cols), src.valid)

    def _LogicalUnion(self, rel: LogicalUnion) -> _VT:
        from ..ops.join import concat_columns
        from .rex.cast import cast_column
        parts = [self.run(i) for i in rel.inputs_]
        out_names = [f.name for f in rel.schema]
        cols: List[Column] = []
        for j, f in enumerate(rel.schema):
            pieces = []
            for p in parts:
                c = p.table.columns[j]
                if c.stype.name != f.stype.name:
                    c = cast_column(c, f.stype)
                pieces.append(c)
            cols.append(concat_columns(pieces))
        valid = (None if all(p.valid is None for p in parts)
                 else torch.cat([p.vmask(self.device) for p in parts]))
        out = _VT(Table(out_names, cols), valid)
        if rel.all:
            return out
        keep = self._first_occurrence_keep(list(out.table.columns),
                                           out.valid)
        return _VT(out.table, keep & out.vmask(self.device))

    def _LogicalJoin(self, rel: LogicalJoin) -> _VT:
        from ..plan.optimizer import split_join_condition
        from .rel.executor import _and_rex
        left = self.run(rel.left)
        right = self.run(rel.right)
        equi, residual = split_join_condition(rel)
        jt = rel.join_type
        if not equi:
            raise Unsupported("non-equi/cross join")

        lk = [k for k, _ in equi]
        rk = [k for _, k in equi]
        out_names = [f.name for f in rel.schema]

        if jt == "LEFT" or jt in ("SEMI", "ANTI"):
            probe, build, probe_is_left = left, right, True
        elif jt == "RIGHT":
            probe, build, probe_is_left = right, left, False
        else:  # INNER: probe the bigger side (by pre-compaction weight)
            probe_is_left = left.weight >= right.weight
            probe, build = (left, right) if probe_is_left else (right, left)
        if probe_is_left:
            pk_cols = [left.table.columns[i] for i in lk]
            bk_cols = [right.table.columns[i] for i in rk]
            pparts, bparts = _join_key_parts(pk_cols, bk_cols)
        else:
            pk_cols = [right.table.columns[i] for i in rk]
            bk_cols = [left.table.columns[i] for i in lk]
            bparts, pparts = _join_key_parts(bk_cols, pk_cols)
        if build.n == 0 or probe.n == 0:
            raise Unsupported("join of an empty input")

        exist_test = None
        if residual and jt in ("SEMI", "ANTI"):
            # build.x OP probe.y decides by per-key build count/min/max
            exist_test = self._residual_exist_test(rel, residual, probe,
                                                   build)
            if exist_test is None:
                raise Unsupported("semi/anti join with general residual")

        pvalid = _keys_valid(pk_cols, probe.valid)
        bvalid = _keys_valid(bk_cols, build.valid)

        join = self._join_merge if self.tpu else self._join_hash_table
        match, gathered = join(jt, probe, build, pparts, bparts, pvalid,
                               bvalid, exist_test)

        if jt == "SEMI":
            return _VT(probe.table.with_names(out_names),
                       probe.vmask(self.device) & match, weight=probe.weight)
        if jt == "ANTI":
            keep = ~match
            if getattr(rel, "null_aware", False):
                # NOT IN: a NULL build key empties the result; NULL probe
                # keys qualify only against an empty build
                build_rows = build.vmask(self.device)
                build_has_null = (build_rows & ~bvalid).any()
                build_nonempty = build_rows.any()
                keep = (keep & ~build_has_null
                        & (pvalid | ~build_nonempty))
            return _VT(probe.table.with_names(out_names),
                       probe.vmask(self.device) & keep, weight=probe.weight)

        def _pairs(build_cols: List[Column]) -> Table:
            if probe_is_left:
                return Table(out_names,
                             list(probe.table.columns) + build_cols)
            return Table(out_names, build_cols + list(probe.table.columns))

        if residual:
            # the ON residual over the candidate pair; where the equi key
            # failed, the AND with match drops the verdict
            pred = evaluate_predicate(_and_rex(residual), _pairs(gathered),
                                      self)
            if isinstance(pred, bool):
                pred = torch.full((probe.n,), pred, device=self.device)
            match = match & pred

        if jt == "INNER":
            return _VT(_pairs(gathered), probe.vmask(self.device) & match,
                       weight=probe.weight)
        # LEFT/RIGHT: every valid probe row stays; the build side is NULL
        # where the full ON condition failed
        gathered = [Column(c.data, c.stype, c.valid_mask() & match,
                           c.dictionary) for c in gathered]
        return _VT(_pairs(gathered), probe.valid, weight=probe.weight)

    def _residual_exist_test(self, rel, residual, probe: _VT, build: _VT):
        """(op, x build Column, y probe Column) for a residual of the form
        ``build.x OP probe.y`` with OP a comparison, normalized to "exists
        build x with x OP y"; None otherwise (floats excluded: NaN
        comparisons do not survive the min/max reduction)."""
        if len(residual) != 1:
            return None
        r = residual[0]
        if not (isinstance(r, RexCall) and r.op in ("<>", "<", "<=", ">", ">=")
                and len(r.operands) == 2
                and all(isinstance(o, RexInputRef) for o in r.operands)):
            return None
        nl = len(rel.left.schema)  # probe is the left side for SEMI/ANTI
        a, b = r.operands
        if a.index < nl <= b.index:      # y OP x -> exists x SWAP(OP) y
            y_col = probe.table.columns[a.index]
            x_col = build.table.columns[b.index - nl]
            op = {"<": ">", ">": "<", "<=": ">=", ">=": "<=", "<>": "<>"}[r.op]
        elif b.index < nl <= a.index:    # x OP y
            x_col = build.table.columns[a.index - nl]
            y_col = probe.table.columns[b.index]
            op = r.op
        else:
            return None
        if x_col.stype.is_string != y_col.stype.is_string:
            return None
        for c in (x_col, y_col):
            if not c.stype.is_string and c.data.dtype.is_floating_point:
                return None
        if not x_col.stype.is_string:
            # the reduction runs in int64: uint64 or a float promotion is
            # not order-safe
            dt = torch.promote_types(x_col.data.dtype, y_col.data.dtype)
            if dt == getattr(torch, "uint64", None) or dt.is_floating_point:
                return None
        return op, x_col, y_col

    def _append_join_flags(self, jt, adj: torch.Tensor, raw_diffs) -> None:
        """The merge joins' fallback policy: ``adj`` marks adjacent
        equal-hash build rows in hash order, ``raw_diffs`` their raw-key
        inequality.  INNER/LEFT/RIGHT need a unique build key; SEMI/ANTI
        tolerate duplicates, so only a genuine collision is fatal."""
        if jt in ("INNER", "LEFT", "RIGHT"):
            self.fallback.append(adj.any())
            return
        coll = torch.zeros((), dtype=torch.bool, device=self.device)
        for d in raw_diffs:
            coll = coll | (adj & d).any()
        self.fallback.append(coll)

    def _join_merge(self, jt, probe: _VT, build: _VT, pparts, bparts,
                    pvalid: torch.Tensor, bvalid: torch.Tensor,
                    exist_test=None):
        """Sorted-probe join (the tpu strategy): sort only the build side's
        hashes, find each probe hash by binary search, verify raw keys on
        the candidate row.  Hashes sort in unsigned order (sign bit
        flipped), as the JAX package's uint64 sort.  Returns (match over
        probe rows, gathered build columns or None)."""
        ph = _hash_parts(pparts, pvalid)
        bh = _hash_parts(bparts, bvalid)
        if exist_test is not None:
            return self._join_merge_payload(jt, probe, build, pparts, bparts,
                                            pvalid, ph, bh, exist_test)
        nb = build.n
        ub = bh ^ _INT64_MIN
        order = torch.sort(ub, stable=True).indices
        bh_sorted = bh[order]
        adj = (bh_sorted[1:] == bh_sorted[:-1]) & (bh_sorted[1:] != _U64_MAX)
        raws_sorted = [braw[order] for _, braw in bparts]
        self._append_join_flags(jt, adj,
                                [rs[1:] != rs[:-1] for rs in raws_sorted])
        pos = torch.searchsorted(ub[order], ph ^ _INT64_MIN, side="left")
        pos_c = pos.clamp_max(nb - 1)
        cand = order[pos_c]
        match = (pos < nb) & pvalid & (bh_sorted[pos_c] == ph)
        for (_, praw), (_, braw) in zip(pparts, bparts):
            match = match & (praw == braw[cand])
        if jt in ("SEMI", "ANTI"):
            return match, None
        return match, [c.take(cand) for c in build.table.columns]

    def _join_merge_payload(self, jt, probe: _VT, build: _VT, pparts,
                            bparts, pvalid: torch.Tensor, ph: torch.Tensor,
                            bh: torch.Tensor, exist_test):
        """The merge join of build and probe rows in one hash-sorted stream
        (the tpu strategy's SEMI/ANTI with a comparison residual): each
        probe row carries the last build row at or before it (the JAX
        package's associative carry scan: here the position of that build
        row, by a running count), and per-hash-run build count/min/max
        decide "exists build x OP y"."""
        from ..ops.window import segmented_scan
        nb, npr = build.n, probe.n
        m = nb + npr
        dev = self.device
        h_m = torch.cat([bh, ph])
        flag_b = torch.cat([torch.ones(nb, dtype=torch.bool, device=dev),
                            torch.zeros(npr, dtype=torch.bool, device=dev)])
        perm = torch.sort(h_m ^ _INT64_MIN, stable=True).indices
        hs, fbs = h_m[perm], flag_b[perm]
        raws = [torch.cat([braw, praw])[perm]
                for (_, braw), (_, praw) in zip(bparts, pparts)]
        adj = fbs[1:] & fbs[:-1] & (hs[1:] == hs[:-1]) & (hs[1:] != _U64_MAX)
        self._append_join_flags(jt, adj, [r[1:] != r[:-1] for r in raws])

        # the last build row at or before each position
        count = torch.cumsum(fbs.to(torch.int64), 0)
        bpos = _compact_index(fbs, nb)
        last = bpos[(count - 1).clamp_min(0)]
        match_s = (~fbs) & (count > 0)
        for r in raws:
            match_s = match_s & (r[last] == r)

        op_t, x_col, y_col = exist_test
        if x_col.stype.is_string:
            xd, yd = unify_string_codes([x_col, y_col])
        else:
            dt = torch.promote_types(x_col.data.dtype, y_col.data.dtype)
            xd, yd = x_col.data.to(dt), y_col.data.to(dt)
        xd, yd = xd.to(torch.int64), yd.to(torch.int64)
        zi = torch.zeros(npr, dtype=torch.int64, device=dev)
        zb = torch.zeros(npr, dtype=torch.bool, device=dev)
        xs = torch.cat([xd, zi])[perm]
        xvs = torch.cat([x_col.valid_mask(), zb])[perm]
        ys = torch.cat([torch.zeros(nb, dtype=torch.int64, device=dev),
                        yd])[perm]
        yvs = torch.cat([torch.zeros(nb, dtype=torch.bool, device=dev),
                         y_col.valid_mask()])[perm]
        # all build rows of a hash run precede its probe rows (stable
        # sort), so a probe's inclusive scan covers the whole run
        run_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                               hs[1:] != hs[:-1]])
        xv = xvs & fbs
        cnt = segmented_scan(xv.to(torch.int64), run_start, torch.add)
        mn = segmented_scan(torch.where(xv, xs, _I64.max), run_start,
                            torch.minimum)
        mx = segmented_scan(torch.where(xv, xs, _I64.min), run_start,
                            torch.maximum)
        if op_t == "<>":
            ex = (mn != ys) | (mx != ys)
        elif op_t == "<":
            ex = mn < ys
        elif op_t == "<=":
            ex = mn <= ys
        elif op_t == ">":
            ex = mx > ys
        else:
            ex = mx >= ys
        match_s = match_s & (cnt > 0) & ex & yvs
        match = torch.empty(m, dtype=torch.bool, device=dev)
        match[perm] = match_s
        return match[nb:] & pvalid, None

    def _join_hash_table(self, jt, probe: _VT, build: _VT, pparts, bparts,
                         pvalid: torch.Tensor, bvalid: torch.Tensor,
                         exist_test=None):
        """Open-addressing hash join (the host strategy): insert the build
        row ids into a power-of-2 table, probe with one gather chain per
        round.  Raw key parts verify every match, so lossy hashes only add
        collisions, which the flags send to eager.  SEMI/ANTI residual
        exist-tests aggregate (count, min, max) per build group.  Returns
        (match over probe rows, gathered build columns or None)."""
        nb, npr = build.n, probe.n
        dev = self.device
        size = _hash_table_size(nb)
        # one integer raw key: the _mix64 rehash is a bijection, so hash
        # equality is key equality, and raw values address directly (the
        # generic key hash is not needed: not computed)
        bij = len(bparts) == 1 and not bparts[0][1].dtype.is_floating_point
        direct_b = direct_p = None
        combo_ok = None
        if not bij:
            ph = _hash_parts(pparts, pvalid)
            bh = _hash_parts(bparts, bvalid)
        if bij:
            braw1 = bparts[0][1].to(torch.int64)
            praw1 = pparts[0][1].to(torch.int64)
            bh = _mix64(braw1)
            ph = _mix64(praw1)
            direct_b = _direct_info(braw1, bvalid, size)
            direct_p = (praw1, direct_b[1], direct_b[2])
        else:
            combo = _combined_int_key(
                [[(braw, None, bvalid), (praw, None, pvalid)]
                 for (_, braw), (_, praw) in zip(bparts, pparts)])
            if combo is not None:
                (bkey, pkey), combo_ok, span_prod = combo
                bh = torch.where(combo_ok, _mix64(bkey), bh)
                ph = torch.where(combo_ok, _mix64(pkey), ph)
                fits = combo_ok & (span_prod <= float(size))
                zero = torch.zeros((), dtype=torch.int64, device=dev)
                direct_b = (bkey, zero, fits)
                direct_p = (pkey, zero, fits)
        rtag, rounds = self._rounds()
        slot, resident, resolved, table, unres = _hash_table_insert(
            bh, bvalid, size, direct_b, rounds)
        self._note_rounds(rtag, rounds, unres)

        raw_mismatch = torch.zeros((), dtype=torch.bool, device=dev)
        if not bij:
            rc0 = resident.clamp(0, nb - 1).to(torch.int64)
            for _, braw in bparts:
                raw_mismatch = raw_mismatch | (resolved
                                               & (braw[rc0] != braw)).any()
            if combo_ok is not None:
                raw_mismatch = raw_mismatch & ~combo_ok
        unresolved = (bvalid & ~resolved).any()
        if jt in ("INNER", "LEFT", "RIGHT"):
            # a unique build key is required: a second row of a key
            # resolves to a foreign resident
            dup = (resolved & (resident.to(torch.int64)
                               != torch.arange(nb, device=dev))).any()
            self.fallback.append(raw_mismatch | dup | unresolved)
        else:
            self.fallback.append(raw_mismatch | unresolved)

        # probe: the same slot sequence; the first equal-hash resident
        # along it is the key's (a key resident at round k has its rounds
        # 0..k slots all occupied), so the rounds after the insert's last
        # change nothing
        cand = torch.full((npr,), nb, dtype=torch.int64, device=dev)
        for k in range(rounds):
            s_k = _slot_at_round(ph, k, size, direct_p).to(torch.int64)
            tv = table[s_k]
            r = tv & _TBL_ROW_MASK
            hit = (tv != _TBL_EMPTY) & (bh[r.clamp(0, nb - 1)] == ph)
            cand = torch.where((cand == nb) & hit, r, cand)
        found = cand < nb
        cc = cand.clamp(0, nb - 1)
        match = found & pvalid
        if not bij:
            raw_eq = torch.ones(npr, dtype=torch.bool, device=dev)
            for (_, praw), (_, braw) in zip(pparts, bparts):
                raw_eq = raw_eq & (praw == braw[cc])
            match = match & ((combo_ok | raw_eq) if combo_ok is not None
                             else raw_eq)

        if exist_test is not None:
            op_t, x_col, y_col = exist_test
            if x_col.stype.is_string:
                xd, yd = unify_string_codes([x_col, y_col])
            else:
                dt = torch.promote_types(x_col.data.dtype, y_col.data.dtype)
                xd, yd = x_col.data.to(dt), y_col.data.to(dt)
            xd, yd = xd.to(torch.int64), yd.to(torch.int64)
            # aggregates indexed by the group's resident row (dense in
            # [0, nb)); the probe's candidate is the resident
            xv = resolved & x_col.valid_mask()
            idx = _trash(xv, resident.to(torch.int64), nb)
            cnt = torch.zeros(nb + TRASH, dtype=torch.int64, device=dev)
            cnt.index_add_(0, idx, torch.ones(nb, dtype=torch.int64,
                                              device=dev))
            mn = torch.full((nb + TRASH,), _I64.max, dtype=torch.int64,
                            device=dev)
            mn.scatter_reduce_(0, idx, xd, reduce="amin")
            mx = torch.full((nb + TRASH,), _I64.min, dtype=torch.int64,
                            device=dev)
            mx.scatter_reduce_(0, idx, xd, reduce="amax")
            cntp, mnp, mxp = cnt[cc], mn[cc], mx[cc]
            if op_t == "<>":
                ex = (mnp != yd) | (mxp != yd)
            elif op_t == "<":
                ex = mnp < yd
            elif op_t == "<=":
                ex = mnp <= yd
            elif op_t == ">":
                ex = mxp > yd
            else:
                ex = mxp >= yd
            match = match & (cntp > 0) & ex & y_col.valid_mask()

        if jt in ("SEMI", "ANTI"):
            return match, None
        return match, [c.take(cc) for c in build.table.columns]


# ---------------------------------------------------------------------------
# compile + execute
# ---------------------------------------------------------------------------

class _Compiled:
    __slots__ = ("fn", "meta", "caps", "origin")

    def __init__(self, fn, meta, caps, origin=None):
        self.fn = fn            # a graphs.GraphProgram
        self.meta = meta        # filled during the first trace
        self.caps = caps
        self.origin = origin    # the root query's fingerprint that built it


_cache: "OrderedDict[tuple, object]" = OrderedDict()
# learned state per (plan, inputs) key: escalated caps and hash rounds,
# and runtime verdicts pinned to the exact tables
_learned_caps: "OrderedDict[tuple, Dict[str, int]]" = OrderedDict()
_runtime_eager: "OrderedDict[tuple, bool]" = OrderedDict()
# statistics-derived starting caps per (plan, inputs, tables): the walk
# over the plan's estimates runs once per set of tables
_hints_memo: "OrderedDict[tuple, Dict[str, int]]" = OrderedDict()
_LEARNED_LIMIT = 1024
_UNSUPPORTED = object()
_state_lock = threading.RLock()
# key -> Event: a second caller of a program being built waits for it
_inflight: Dict[tuple, threading.Event] = {}

# write-through persistence of learned caps (``DSQL_CAPS_FILE``) and a
# read-only seed (``DSQL_CAPS_SEED``): keys are digests of the program's
# base key, so a cap never applies to another query, layout or strategy
_caps_disk: Optional[Dict[str, Dict[str, int]]] = None
_caps_seed: Optional[Dict[str, Dict[str, int]]] = None


def _caps_disk_key(base_key) -> str:
    return _kv.digest_key(base_key)


def _caps_disk_read(path: str) -> Dict[str, Dict[str, int]]:
    return {k: {t: int(c) for t, c in v.items()}
            for k, v in _kv.read_json_dict(path).items()}


def _learned_caps_get(base_key) -> Dict[str, int]:
    global _caps_disk, _caps_seed
    caps = _learned_caps.get(base_key)
    if caps is not None:
        return dict(caps)
    key = None
    path = os.environ.get("DSQL_CAPS_FILE")
    if path:
        if _caps_disk is None:
            _caps_disk = _caps_disk_read(path)
        key = _caps_disk_key(base_key)
        hit = _caps_disk.get(key)
        if hit:
            return dict(hit)
    seed_path = os.environ.get("DSQL_CAPS_SEED")
    if seed_path:
        if _caps_seed is None:
            _caps_seed = _caps_disk_read(seed_path)
        return dict(_caps_seed.get(key or _caps_disk_key(base_key), {}))
    return {}


def _learned_caps_put(base_key, caps: Dict[str, int]) -> None:
    global _caps_disk
    _bounded_put(_learned_caps, base_key, dict(caps))
    path = os.environ.get("DSQL_CAPS_FILE")
    if not path:
        return
    # read-merge-replace: a lost race between writers costs one re-learn
    disk = _caps_disk_read(path)
    disk[_caps_disk_key(base_key)] = {k: int(v) for k, v in caps.items()}
    if _kv.atomic_write_json(path, disk):
        _caps_disk = disk


def _bounded_put(d: OrderedDict, key, value):
    while len(d) >= _LEARNED_LIMIT:
        d.popitem(last=False)
    d[key] = value


# ---------------------------------------------------------------------------
# compile-worker backoff: consecutive build failures halve the effective
# worker width (floor 1, DSQL_COMPILE_BACKOFF_AFTER failures per halving,
# counter ``compile_backoffs``); a successful build restores it
# ---------------------------------------------------------------------------

_compile_fail_streak = 0


def _backoff_after() -> int:
    try:
        return max(1, int(os.environ.get("DSQL_COMPILE_BACKOFF_AFTER", "2")))
    except ValueError:
        return 2


def _note_compile_result(ok: bool) -> None:
    global _compile_fail_streak
    after = _backoff_after()
    with _state_lock:
        if ok:
            _compile_fail_streak = 0
            return
        _compile_fail_streak += 1
        crossed = _compile_fail_streak % after == 0
    if crossed:
        _tel.inc("compile_backoffs")
        logger.warning(
            "%d consecutive compile failures; halving effective compile "
            "workers (now %d)", _compile_fail_streak, _compile_workers())


def _compile_workers(n_stages: Optional[int] = None) -> int:
    """The stage and background-compile width: ``DSQL_COMPILE_WORKERS``
    (default 4), halved once per ``DSQL_COMPILE_BACKOFF_AFTER``
    consecutive build failures, capped by the stage count."""
    try:
        w = int(os.environ.get("DSQL_COMPILE_WORKERS", "4"))
    except ValueError:
        w = 4
    with _state_lock:
        halvings = _compile_fail_streak // _backoff_after()
    if halvings:
        w = max(1, w >> min(halvings, 8))
    if n_stages is not None:
        w = min(w, n_stages)
    return max(1, w)


def _flatten_tables(scans) -> List[torch.Tensor]:
    flat: List[torch.Tensor] = []
    for _, tbl, row_valid in scans:
        for c in tbl.columns:
            flat.append(c.data)
            if c.mask is not None:
                flat.append(c.mask)
        if row_valid is not None:
            flat.append(row_valid)
    return flat


def _copied_positions(scans, n_params: int) -> List[int]:
    """Positions of the inputs that change on every call: the tensors of
    ``__split__`` scans (a stage's materialized boundary), of the
    out-of-core path's ``__stream__`` tables (``streaming.py``'s batch or
    window bucket and ``morsel.py``'s pair sides ``grace_l`` and
    ``grace_r``, each with its ``row_valid``, replaced per call; the
    temps a streamed query materializes, named afresh by every query) and
    the trailing parameters.  A CUDA graph copies them into its own
    buffers, so a streamed batch is one device copy and one replay, and a
    repeated streamed query replays the graphs of the last one."""
    from .streaming import STREAM_SCHEMA

    out: List[int] = []
    i = 0
    for skey, tbl, row_valid in scans:
        n = (sum(2 if c.mask is not None else 1 for c in tbl.columns)
             + (row_valid is not None))
        if skey[0] in (_SPLIT_SCHEMA, STREAM_SCHEMA):
            out.extend(range(i, i + n))
        i += n
    out.extend(range(i, i + n_params))
    return out


def _param_args(params, device) -> List[torch.Tensor]:
    """One 0-d tensor per hoisted literal, in fingerprint order (the
    ``P{i}`` positions of the key), of its declared SQL type's dtype, so
    that ``x > 5`` and ``x > 5000000000`` of one declared type share a
    program and different declared types never do.  On the card they are
    pinned host tensors, which the graph copies into its buffers without a
    synchronisation."""
    cuda = torch.device(device).type == "cuda"
    out = []
    for p in params:
        t = torch.tensor(p.value, dtype=torch_dtype(p.stype))
        out.append(t.pin_memory() if cuda else t)
    return out


def _maybe_parameterize(plan: RelNode, count: bool = True) -> RelNode:
    """Hoist literals into runtime arguments (``plan/parameterize.py``)
    unless ``DSQL_PARAM_PLANS=0``.  Idempotent: re-entries (the ladder,
    background compiles) hoist nothing; probes pass ``count=False``."""
    from ..plan.parameterize import param_plans_enabled, parameterize_plan
    if not param_plans_enabled():
        return plan
    new, hoisted = parameterize_plan(plan)
    if hoisted and count:
        _tel.inc("param_plans")
        _tel.inc("param_literals_hoisted", hoisted)
    return new


def _build(plan: RelNode, context, scans, caps: Dict[str, int],
           params=None, origin=None) -> _Compiled:
    """The program for this plan and input spec; ``params`` (the plan's
    RexParam nodes in fingerprint order) are its trailing inputs."""
    spec = []
    for skey, tbl, row_valid in scans:
        spec.append((skey, [(c.stype, c.mask is not None, c.dictionary)
                            for c in tbl.columns], tbl.names,
                     row_valid is not None))
    meta: dict = {}
    tpu = _strategy_on_tpu()
    dev = context.device
    params = list(params or ())

    def fn(*flat):
        i = 0
        tables: Dict[tuple, tuple] = {}
        for skey, colspec, names, has_valid in spec:
            cols = []
            for stype, has_mask, dictionary in colspec:
                data = flat[i]
                mask = flat[i + 1] if has_mask else None
                i += 2 if has_mask else 1
                cols.append(Column(data, stype, mask, dictionary))
            valid = None
            if has_valid:
                valid = flat[i]
                i += 1
            tables[skey] = (Table(names, cols), valid)
        tr = _Tracer(context, tables, caps, tpu=tpu)
        if params:
            tr.param_values = {id(p): flat[i + j]
                               for j, p in enumerate(params)}
        if tpu and os.environ.get("DSQL_COMPACT", "1") != "0":
            tr.compact_ok = _compact_eligible(plan)
        out = tr.run(plan)
        n = out.n
        if out.valid is None:
            count = torch.full((), n, dtype=torch.int64, device=dev)
        else:
            count = out.valid.to(torch.int64).sum()
        fb = torch.zeros((), dtype=torch.bool, device=dev)
        for f in tr.fallback:
            fb = fb | f
        flags = torch.stack([fb.to(torch.int64), count]
                            + [g.to(torch.int64) for g in tr.ngroups]
                            + [u.to(torch.int64) for u in tr.unresolved])
        meta["names"] = list(out.table.names)
        meta["cols"] = [(c.stype, c.mask is not None, c.dictionary)
                        for c in out.table.columns]
        meta["has_valid"] = out.valid is not None
        meta["ngroup_caps"] = list(tr.ngroup_caps)
        meta["agg_sites"] = list(tr.agg_sites)
        meta["round_sites"] = list(tr.round_sites)
        meta["n_out"] = n
        outs: List[torch.Tensor] = [flags]
        for c in out.table.columns:
            outs.append(c.data)
            if c.mask is not None:
                outs.append(c.mask)
        if out.valid is not None:
            outs.append(out.valid)
        return tuple(outs)

    program = GraphProgram(fn, dev,
                           copied=_copied_positions(scans, len(params)))
    return _Compiled(program, meta, dict(caps), origin)


class _NeedsRecompile(Exception):
    def __init__(self, caps):
        self.caps = caps


def _degrade_compile(plan: RelNode, context, base_key, key, exc: Exception,
                     err, split_limit: Optional[int]) -> Optional[Table]:
    """One rung down the ladder (``resilience.LADDER``) after a build
    failed past its in-rung retries.

    whole -> stages: a plan with more than one heavy node runs again as
    minimal stages (budget 1).  stages, or an unsplittable plan -> eager:
    ``None`` tells the caller to run the eager executor, or, with
    ``DSQL_EAGER_FALLBACK=0``, the typed error surfaces.  A fatal verdict
    also exiles the program in this process and marks it in the
    quarantine store for the others; a transient one leaves the cache slot
    empty, so the next call tries again."""
    _tel.inc("degradations")
    if split_limit is None and heavy_count(plan) > 1:
        _tel.inc("split_hints")
        _tel.annotate(degraded_to="stages")
        logger.warning("program build failed (%s); degrading to bounded "
                       "stages", type(exc).__name__)
        return try_execute_compiled(plan, context, _split_limit=1)
    _tel.annotate(degraded_to="eager")
    if not isinstance(err, _res.TransientError):
        with _state_lock:
            _cache[key] = _UNSUPPORTED
        _tel.inc("exiled")
        _quar.get_store().mark(_quar.program_key(base_key), "fatal",
                               reason=str(err)[:200])
    if os.environ.get("DSQL_EAGER_FALLBACK", "1") == "0":
        raise err if err is exc else err from exc
    logger.warning("compiled path failed for this plan (%s); using the "
                   "eager executor", str(err)[:200])
    return None


def _compact_eligible(plan: RelNode) -> set:
    """ids of the LogicalFilter nodes worth compacting (the tpu strategy):
    the topmost filter of each chain with a join, window, sort or grouped
    aggregate above it."""
    out: set = set()

    def walk(rel: RelNode, sorty_above: bool, parent_is_filter: bool):
        is_filter = isinstance(rel, LogicalFilter)
        if is_filter and sorty_above and not parent_is_filter:
            out.add(id(rel))
        sorty = sorty_above \
            or isinstance(rel, (LogicalJoin, LogicalWindow, LogicalSort)) \
            or (isinstance(rel, LogicalAggregate)
                and (rel.group_keys
                     or any(a.distinct and a.op not in ("MIN", "MAX")
                            for a in rel.aggs)))
        for i in rel.inputs:
            walk(i, sorty, is_filter)

    walk(plan, False, False)
    return out


def _check_rounds(entry: _Compiled, flags) -> None:
    """A hash-table site left rows unresolved after fewer than 64 rounds:
    recompile with twice its rounds (read before every other flag, which
    such a site may have set).  A GROUP BY whose groups overflowed its
    capacity is left to the capacity's escalation, which enlarges its
    table."""
    meta = entry.meta
    sites = meta["round_sites"]
    if not sites:
        return
    unres = flags[len(flags) - len(sites):]
    ngroups = flags[2:2 + len(meta["ngroup_caps"])]
    # a GROUP BY over a capacity that can still grow: its groups (or the
    # saturation sentinel n+1) grow the capacity, and with it the table,
    # first; rounds cost every replay, a larger table only its fill
    overflowed = {site[2] for site, ng, cap in zip(
        meta["agg_sites"], ngroups, meta["ngroup_caps"])
        if ng > cap and cap < site[0]}
    new_caps = dict(entry.caps)
    grew = False
    for (tag, rounds, agg_tag), u in zip(sites, unres):
        if u and rounds < _HASH_MAX_ROUNDS and agg_tag not in overflowed:
            new_caps[tag] = min(rounds * 2, _HASH_MAX_ROUNDS)
            grew = True
    if grew:
        raise _NeedsRecompile(new_caps)


def _check_flags(entry: _Compiled, flags) -> None:
    """Raise _NeedsRecompile on group-cap overflow; compaction sites (tpu
    strategy) also shrink once to a tight capacity."""
    meta = entry.meta
    ngroups = flags[2:2 + len(meta["ngroup_caps"])]
    new_caps = dict(entry.caps)
    grew = False
    for i, (ng, cap) in enumerate(zip(ngroups, meta["ngroup_caps"])):
        n_rows, hashed, tag = meta["agg_sites"][i]
        if ng > cap:
            if hashed and int(ng) > n_rows:
                # n+1: the hash table saturated, the true count is unknown:
                # jump x16 (bounded by the input rows)
                need = min(1 << (int(n_rows) - 1).bit_length(), cap * 16)
            else:
                need = 1 << (int(ng) - 1).bit_length()
            new_caps[tag] = max(need, cap * 2)
            grew = True
        elif tag.startswith("cmp"):
            tight = 1 << max(int(max(int(ng), 1) - 1).bit_length(), 10)
            if tight * 8 <= cap:
                new_caps[tag] = max(tight * 2, 1024)
                grew = True
    if grew:
        raise _NeedsRecompile(new_caps)


SMALL_FETCH_BYTES = 8 << 20


def _materialize(entry: _Compiled, outs) -> Optional[Table]:
    """The result table from a run's outputs, copied out of the program's
    memory (the next replay overwrites it).  A small result (at most
    ``SMALL_FETCH_BYTES``) comes to the host in one transfer with the flags
    and keeps host copies; a large one reads only the flags.  Valid rows
    are compacted on the device (``count`` is known)."""
    _faults.maybe_fail("materialize")
    meta = entry.meta
    total = sum(o.numel() * o.element_size() for o in outs)
    # one device-to-host transfer of every output (``tensors_to_host``)
    host = tensors_to_host(outs) if total <= SMALL_FETCH_BYTES else None
    flags = host[0] if host is not None else outs[0].cpu().numpy()
    _check_rounds(entry, flags)
    if flags[0]:
        _tel.inc("fallbacks")
        return None
    _check_flags(entry, flags)
    count = int(flags[1])
    idx = sel = None
    if meta["has_valid"] and count < meta["n_out"]:
        idx = _compact_index(outs[-1], count)
        if host is not None:
            sel = np.nonzero(host[-1])[0]
    copy = outs[0].is_cuda
    cols: List[Column] = []
    i = 1
    for stype, has_mask, dictionary in meta["cols"]:
        parts = []
        for _ in range(2 if has_mask else 1):
            t = outs[i]
            t = t.index_select(0, idx) if idx is not None \
                else (t.clone() if copy else t)
            h = None
            if host is not None:
                h = host[i][sel] if sel is not None else host[i]
            parts.append((t, h))
            i += 1
        (data, dh), (mask, mh) = parts[0], (parts[1] if has_mask
                                            else (None, None))
        cols.append(Column(data, stype, mask, dictionary,
                           host=None if host is None else (dh, mh)))
    return Table(meta["names"], cols)


def _host_sort_indices(table: Table, keys) -> np.ndarray:
    """``ops/sort.sort_indices`` on the columns' host copies."""
    arrays = []
    for idx, ascending, nulls_first in reversed(keys):
        col = table.columns[idx]
        data, mask = col.host
        if col.stype.is_string:
            order = dict_sort_order(col.dictionary)
            ranks = np.empty(len(order), dtype=np.int64)
            ranks[order] = np.arange(len(order))
            data = ranks[np.clip(data, 0, len(ranks) - 1)]
        elif data.dtype == np.bool_:
            data = data.astype(np.int64)
        elif data.dtype.kind != "f":
            data = data.astype(np.int64)
        if not ascending:
            data = -data
        arrays.append(data)
        if mask is not None:
            nullkey = (~mask).astype(np.int64)
            arrays.append(-nullkey if nulls_first else nullkey)
    perm = np.arange(table.num_rows)
    for a in arrays:
        perm = perm[np.argsort(a[perm], kind="stable")]
    return perm


def _upload(arr: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device`` without a synchronisation: on the card a
    pinned, non-blocking copy, ordered on the current stream."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _device_sort_indices(table: Table, keys) -> torch.Tensor:
    """``ops/sort.sort_indices`` with each string key replaced by its sort
    ranks, uploaded without a synchronisation (a result too large for host
    copies)."""
    from ..ops import sort as S
    from ..types import BIGINT
    cols = list(table.columns)
    for idx, _, _ in keys:
        col = cols[idx]
        if col.stype.is_string:
            order = dict_sort_order(col.dictionary)
            ranks = np.empty(len(order), dtype=np.int64)
            ranks[order] = np.arange(len(order))
            data = _upload(ranks, col.device)[
                col.data.clamp(0, len(ranks) - 1).to(torch.int64)]
            cols[idx] = Column(data, BIGINT, col.mask)
    return S.sort_indices(Table(table.names, cols), keys)


def _apply_host_sort(result: Table, sort: LogicalSort) -> Table:
    """The peeled terminal ORDER BY / OFFSET / LIMIT.  With host copies the
    order is found on the host and the device columns gathered by one
    non-blocking upload of the permutation; otherwise the sort runs on the
    device.  Neither synchronises."""
    keys = [(c.index, c.ascending, c.effective_nulls_first)
            for c in sort.collation]
    n = result.num_rows
    start = sort.offset or 0
    stop = n if sort.limit is None else min(start + sort.limit, n)
    if not keys and start == 0 and stop == n:
        return result
    host = bool(result.columns) and result.columns[0].host is not None
    if host:
        perm = _host_sort_indices(result, keys) if keys and n > 1 \
            else np.arange(n)
        perm = perm[start:stop]
        pt = _upload(perm.astype(np.int64), result.columns[0].device)
    else:
        pt = (_device_sort_indices(result, keys) if keys and n > 1
              else torch.arange(n, device=result.columns[0].device))
        pt = pt[start:stop]
    cols = []
    for c in result.columns:
        h = None
        if host:
            dh, mh = c.host
            h = (dh[perm], None if mh is None else mh[perm])
        cols.append(Column(c.data.index_select(0, pt), c.stype,
                           None if c.mask is None
                           else c.mask.index_select(0, pt), c.dictionary,
                           host=h))
    return Table(result.names, cols)




# ---------------------------------------------------------------------------
# stage graphs: a plan above the heavy-node budget (physical/stages.py) runs
# as a DAG of bounded programs.  Each stage's output is materialized into a
# padded power-of-2 capacity-class table under the ``__split__`` schema, so
# that the consumer's program key is stable across runs; its graph copies
# the boundary into its own buffers on every call.  Stages keep the ordinary
# (plan fingerprint, input layout) cache key: a pipeline shared by two
# queries builds once (``cross_query_hits``).  Independent stages run
# concurrently on a small pool of threads.
# ---------------------------------------------------------------------------

_SPLIT_SCHEMA = "__split__"

_split_lock = threading.Lock()
_split_refs: Dict[tuple, int] = {}


def _rex_scan_uids(rex, context) -> list:
    if isinstance(rex, RexScalarSubquery):
        return _scan_uids(rex.plan, context)
    if isinstance(rex, RexCall):
        return [u for o in rex.operands for u in _rex_scan_uids(o, context)]
    return []


def _scan_uids(rel: RelNode, context) -> list:
    """uids of every table a subtree scans, scalar-subquery plans
    included; a boundary scan contributes its name (already a content
    digest of its producing subtree)."""
    if isinstance(rel, LogicalTableScan):
        if rel.schema_name == _SPLIT_SCHEMA:
            return [rel.table_name]
        entry = context.schema.get(rel.schema_name)
        tbl = (entry.tables[rel.table_name].table
               if entry is not None and rel.table_name in entry.tables
               else None)
        return [str(getattr(tbl, "uid", "?"))]
    out = [u for i in rel.inputs for u in _scan_uids(i, context)]
    if isinstance(rel, LogicalProject):
        for e in rel.exprs:
            out.extend(_rex_scan_uids(e, context))
    elif isinstance(rel, LogicalFilter):
        out.extend(_rex_scan_uids(rel.condition, context))
    elif isinstance(rel, LogicalJoin) and rel.condition is not None:
        out.extend(_rex_scan_uids(rel.condition, context))
    return out


def _stage_table_name(node: RelNode, context) -> str:
    """A deterministic boundary name: a digest of the subtree's canonical
    text (``result_cache.canonical_plan``: values included, so two literal
    variants never share a boundary), its output types and the scanned
    tables' uids.  The name feeds the consumer's fingerprint, so it must
    not change between runs of one query; equal names mean equal data, so
    two concurrent queries may share one."""
    shape, _, _ = _rcache.canonical_plan(node, context)
    digest = hashlib.blake2s(
        (shape + "|"
         + ",".join(f.stype.name for f in node.schema) + "|"
         + ",".join(_scan_uids(node, context))).encode()
    ).hexdigest()[:16]
    return f"t{digest}"


def _make_boundary_scan(node: RelNode, context) -> LogicalTableScan:
    from ..plan.nodes import Field
    return LogicalTableScan(
        schema_name=_SPLIT_SCHEMA,
        table_name=_stage_table_name(node, context),
        schema=[Field(f"c{i}", f.stype)
                for i, f in enumerate(node.schema)])


def _partition_plan(plan: RelNode, budget: int, context) -> StageGraph:
    graph = _partition(plan, budget,
                       lambda sub: _make_boundary_scan(sub, context))
    _annotate_stage_stats(graph, context)
    return graph


def _capacity_class(n: int) -> int:
    """The padded row count of a stage output of ``n`` rows: a power of 2,
    at least 64."""
    return 1 << max((max(n, 1) - 1).bit_length(), 6)


def _pad_capacity(table: Table):
    """(padded table, row_valid): a stage output padded to its capacity
    class with row validity, so that its consumer's key, which holds input
    shapes, is stable across runs."""
    n = table.num_rows
    cap = _capacity_class(n)
    cols = list(table.columns)
    dev = cols[0].device if cols else torch.device("cpu")
    if cap != n:
        pad = cap - n
        padded = []
        for c in cols:
            data = torch.cat([c.data, torch.zeros(
                (pad,) + tuple(c.data.shape[1:]), dtype=c.data.dtype,
                device=c.data.device)])
            mask = (None if c.mask is None else torch.cat(
                [c.mask, torch.zeros(pad, dtype=torch.bool,
                                     device=c.mask.device)]))
            padded.append(Column(data, c.stype, mask, c.dictionary))
        cols = padded
    names = [f"c{i}" for i in range(len(cols))]
    return Table(names, cols), torch.arange(cap, device=dev) < n


def _register_stage_table(context, name: str, table: Table) -> None:
    """Publish a stage output under ``__split__`` (reference-counted:
    concurrent queries on one context may share a boundary name, whose
    digest guarantees equal content)."""
    from ..datacontainer import TableEntry
    padded, row_valid = _pad_capacity(table)
    ref_key = (id(context), name)
    with _split_lock:
        if _SPLIT_SCHEMA not in context.schema:
            context.create_schema(_SPLIT_SCHEMA)
        context.schema[_SPLIT_SCHEMA].tables[name] = TableEntry(
            table=padded, row_valid=row_valid)
        _split_refs[ref_key] = _split_refs.get(ref_key, 0) + 1


def _unregister_stage_table(context, name: str) -> None:
    ref_key = (id(context), name)
    with _split_lock:
        refs = _split_refs.get(ref_key, 0) - 1
        if refs > 0:
            _split_refs[ref_key] = refs
            return
        _split_refs.pop(ref_key, None)
        sch = context.schema.get(_SPLIT_SCHEMA)
        if sch is not None:
            sch.tables.pop(name, None)


def _record_stage_stats(st, out: Table, query_fp: str,
                        wall_ms: float) -> None:
    """The stage's span annotations: its digest (the boundary name, or the
    query's fingerprint for the root), output rows against the padded
    capacity it will be materialized at, bytes and wall."""
    rows_out = int(out.num_rows)
    nbytes = 0
    for c in out.columns:
        nbytes += c.data.numel() * c.data.element_size()
        if c.mask is not None:
            nbytes += c.mask.numel()
    digest = (st.scan.table_name if st.scan is not None
              else f"root:{query_fp[:48]}")
    _tel.annotate(stage_digest=digest, stage_rows_out=rows_out,
                  stage_capacity=_capacity_class(rows_out),
                  stage_bytes=nbytes, stage_wall_ms=round(wall_ms, 3))


def _execute_stage_graph(graph: StageGraph, context, query_fp: str,
                         split_limit: Optional[int]) -> Optional[Table]:
    """Run a stage DAG: dependencies first, independent stages
    concurrently.  A stage that cannot run compiled (unsupported, runtime
    flag) sends the whole query to eager; boundary tables are unregistered
    on every path."""
    with _tel.span("stage_graph", stages=len(graph.stages)):
        return _execute_stage_graph_inner(graph, context, query_fp,
                                          split_limit)


def _execute_stage_graph_inner(graph: StageGraph, context, query_fp: str,
                               split_limit: Optional[int]
                               ) -> Optional[Table]:
    _tel.inc("stage_graphs")
    stages = graph.stages
    nst = len(stages)
    root_idx = nst - 1
    registered: List[str] = []
    rt = _res.current()
    tel_trace = _tel.current_trace()
    tel_parent = _tel.current_span()

    def run_stage_once(idx: int, attempt: int) -> Optional[Table]:
        _tel.inc("stage_execs")
        if attempt > 0:
            # the replay path is its own site, checked first, so that
            # arming both sabotages the replay itself
            _faults.maybe_fail("stage_replay")
        _faults.maybe_fail("stage_exec")
        st = stages[idx]
        # the subplan cache: a non-root stage's boundary name digests its
        # subtree (the scanned tables' uids included), so a query sharing
        # the subplan replays its stored output and skips the device
        skey = None
        cache = _rcache.get_cache()
        if st.scan is not None and cache.enabled():
            skey = _rcache.stage_key(st.scan.table_name)
            hit = cache.get(skey)
            if hit is not None:
                _tel.inc("result_cache_subplan_hits")
                _tel.annotate(subplan_cache="hit",
                              result_cache_tier=hit[1])
                return hit[0]
        out = _execute_single(st.plan, context, query_fp, split_limit,
                              in_stage=True)
        if skey is not None and out is not None:
            cache.put(skey, out)
        return out

    def run_stage(idx: int) -> Optional[Table]:
        # a worker thread re-enters the query's deadline scope and trace;
        # a transient failure replays this stage alone: its dependencies'
        # outputs are registered boundary tables, rescanned, not recomputed
        with _res.scoped(rt), _tel.scoped(tel_trace, tel_parent), \
                _tel.span("stage", index=idx):
            if stages[idx].est_rows is not None:
                _tel.annotate(stage_est_rows=stages[idx].est_rows)
            attempt = 0
            while True:
                _res.check("stage_exec")
                try:
                    t0 = time.perf_counter()
                    out = run_stage_once(idx, attempt)
                    if out is not None:
                        _record_stage_stats(stages[idx], out, query_fp,
                                            (time.perf_counter() - t0) * 1e3)
                    return out
                except (KeyboardInterrupt, SystemExit):
                    raise
                except Exception as e:
                    err = _res.classify(e)
                    if err is None:
                        raise
                    if not isinstance(err, _res.TransientError):
                        raise err if err is e else err from e
                    attempt += 1
                    if attempt > _res.retry_max():
                        raise err if err is e else err from e
                    saved = len(registered)
                    _tel.inc("retries")
                    _tel.inc("stage_replays")
                    _tel.inc("stage_replay_saved_stages", saved)
                    _tel.annotate(stage_replays=attempt,
                                  stage_replay_saved=saved)
                    logger.warning(
                        "stage %d failed transiently (%s); replaying it from "
                        "%d materialized boundary stage(s), retry %d/%d",
                        idx, str(err)[:200], saved, attempt, _res.retry_max())
                    _res.backoff(attempt, "stage_exec")

    def stage_error(e: Exception) -> Optional[BaseException]:
        """None: degrade the whole graph to eager; else raise this.  Only a
        transient failure degrades: each stage's own ladder already
        resolved what it could, so anything else surfaces typed."""
        err = _res.classify(e)
        if err is None or not isinstance(err, _res.TransientError):
            return err if err is not None else e
        if os.environ.get("DSQL_EAGER_FALLBACK", "1") == "0":
            return err
        _tel.inc("degradations")
        _tel.annotate(degraded_to="eager")
        logger.warning("stage failed (%s); degrading the graph to eager",
                       str(err)[:200])
        return None

    try:
        workers = _compile_workers(nst)
        if workers == 1:
            for idx, st in enumerate(stages):   # already topological
                _res.check("stage_graph")
                try:
                    out = run_stage(idx)
                except (KeyboardInterrupt, SystemExit):
                    raise
                except (_res.DeadlineExceeded, _res.QueryCancelled):
                    raise
                except Exception as e:
                    raised = stage_error(e)
                    if raised is not None:
                        raise raised from (None if raised is e else e)
                    return None
                if out is None:
                    return None
                if idx == root_idx:
                    return out
                _register_stage_table(context, st.scan.table_name, out)
                registered.append(st.scan.table_name)
            return None   # unreachable: the root returns above

        from concurrent.futures import (FIRST_COMPLETED, ThreadPoolExecutor,
                                        wait as _fwait)
        pending = set(range(nst))
        done: set = set()
        futs: Dict[object, int] = {}
        failed = False
        aborted = False
        result: Optional[Table] = None
        pool = ThreadPoolExecutor(workers, thread_name_prefix="dsql-stage")
        try:
            while (pending or futs) and not failed:
                # a deadline cuts the graph: queued stages are abandoned,
                # running ones finish in the background
                _res.check("stage_graph")
                for i in sorted(pending):
                    if all(d in done for d in stages[i].deps):
                        pending.discard(i)
                        futs[pool.submit(run_stage, i)] = i
                if not futs:
                    break
                finished, _ = _fwait(list(futs), timeout=0.1,
                                     return_when=FIRST_COMPLETED)
                for f in finished:
                    i = futs.pop(f)
                    try:
                        out = f.result()
                    except (KeyboardInterrupt, SystemExit):
                        raise
                    except Exception as e:
                        raised = stage_error(e)
                        if raised is not None:
                            raise raised from (None if raised is e else e)
                        failed = True
                        continue
                    if out is None:
                        failed = True
                        continue
                    if i == root_idx:
                        result = out
                    else:
                        _register_stage_table(
                            context, stages[i].scan.table_name, out)
                        registered.append(stages[i].scan.table_name)
                    done.add(i)
        except BaseException:
            aborted = True
            raise
        finally:
            pool.shutdown(wait=not aborted, cancel_futures=aborted)
        return None if failed else result
    finally:
        for name in registered:
            _unregister_stage_table(context, name)


# ---------------------------------------------------------------------------
# tiered execution: the first arrival of a cold plan is answered on the
# eager tier while its programs build on a daemon thread (bounded by the
# DSQL_COMPILE_WORKERS width and its failure backoff); the next arrival runs
# compiled.  A plan with a standing verdict (exile, runtime flag,
# quarantine) is decided and takes the normal path.  DSQL_EAGER_FALLBACK=0
# leaves no eager tier to serve from, so builds stay synchronous.
# DSQL_TIERED=0 turns it off (the tests pin it off; on by default).
# ---------------------------------------------------------------------------

_tier_lock = threading.Lock()
_tier_done: "OrderedDict[tuple, bool]" = OrderedDict()   # attempted keys
_tier_inflight: set = set()
_tier_local = threading.local()          # .bg: on a background thread
_bg_sem: Optional[threading.Semaphore] = None


def _tiering_enabled() -> bool:
    if os.environ.get("DSQL_TIERED", "1") == "0":
        return False
    return os.environ.get("DSQL_EAGER_FALLBACK", "1") != "0"


def _initial_caps(plan: RelNode, context, base_key, runtime_key,
                  count: bool = True) -> Dict[str, int]:
    """The capacities a program starts from: the learned ones, then the
    statistics' hints for the sites not learned yet (memoized per set of
    tables).  Execution and the readiness probe key with the same caps."""
    caps: Dict[str, int] = _learned_caps_get(base_key)
    hints = _hints_memo.get(runtime_key)
    if hints is None:
        from ..runtime import statistics as _stats
        hints = _stats.compiled_cap_hints(plan, context)
        with _state_lock:
            _bounded_put(_hints_memo, runtime_key, hints)
    for tag, cap in hints.items():
        if tag not in caps:
            caps[tag] = cap
            if count:
                _tel.inc("stats_cap_hints")
                _tel.annotate(cap_hint=f"{tag}={cap}")
    return caps


def _program_decided(plan: RelNode, context, base_key, scans) -> bool:
    """True when the normal path needs no fresh build for this program: an
    entry (or an unsupported verdict) in the cache, a runtime exile, or a
    standing quarantine verdict."""
    runtime_key = (base_key, tuple(t.uid for _, t, _ in scans))
    caps = _initial_caps(plan, context, base_key, runtime_key, count=False)
    key = (base_key, tuple(sorted(caps.items())))
    with _state_lock:
        if key in _cache or runtime_key in _runtime_eager:
            return True
    qstore = _quar.get_store()
    return qstore.enabled() and _quar.program_key(base_key) in qstore.entries()


def _probe_single(plan: RelNode, context, tpu: bool) -> bool:
    """Readiness of ONE program, keyed as ``_execute_single`` keys it
    (the terminal ORDER BY peeled under the host strategy)."""
    if not tpu and isinstance(plan, LogicalSort):
        plan = plan.input
    scans: list = []
    try:
        fp = _fp_plan(plan, context, scans)
    except Unsupported:
        return True   # needs no build; the normal path serves it eager
    base_key = (fp, _fp_inputs(scans), tpu, _mesh_signature(context))
    return _program_decided(plan, context, base_key, scans)


def _programs_ready(plan: RelNode, context, base_key, budget: int) -> bool:
    """Would the compiled path answer without a fresh build?  A whole
    program is probed exactly; a stage graph at its leaf stages (deeper
    stages scan boundary tables that do not exist before execution)."""
    tpu = base_key[2]
    if heavy_count(plan) <= budget:
        return _probe_single(plan, context, tpu)
    graph = _partition_plan(plan, budget, context)
    if len(graph.stages) <= 1:
        return _probe_single(plan, context, tpu)
    return all(_probe_single(st.plan, context, tpu)
               for st in graph.stages if not st.deps)


def _background_compile(plan: RelNode, context, base_key) -> None:
    """Build (and run once) this plan's programs off the query path: a
    daemon thread with fresh thread-locals (no deadline) and a background
    trace of its own, through the normal pipeline, so that learned caps,
    the program cache and quarantine fill as a foreground build would."""
    _tier_local.bg = True
    trace = None
    try:
        with _bg_sem:
            trace = _tel.QueryTrace(
                f"<background-compile:{base_key[0][:48]}>")
            trace.root.name = "background_compile"
            try:
                with _tel.scoped(trace, trace.root):
                    try_execute_compiled(plan, context)
                _tel.inc("background_compiles_done")
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as e:
                trace.root.attrs["error"] = type(e).__name__
                _tel.inc("background_compile_errors")
                logger.warning("background compile failed (%s: %s)",
                               type(e).__name__, str(e)[:200])
    finally:
        if trace is not None:
            _tel.close_background_trace(trace)
        _tier_local.bg = False
        with _tier_lock:
            _tier_inflight.discard(base_key)
            _bounded_put(_tier_done, base_key, True)


def _tier_serve_eager(plan: RelNode, context, base_key, budget: int,
                      split_limit: Optional[int]) -> bool:
    """The tier decision: True => answer this arrival on the eager tier
    (the caller returns None) while the programs build in the
    background."""
    global _bg_sem
    if split_limit is not None or not _tiering_enabled() \
            or getattr(_tier_local, "bg", False):
        return False
    with _tier_lock:
        if base_key in _tier_done:
            return False   # the background attempt finished
        if base_key in _tier_inflight:
            return True    # still building
    if _programs_ready(plan, context, base_key, budget):
        return False
    with _tier_lock:
        if base_key in _tier_done or base_key in _tier_inflight:
            return True
        _tier_inflight.add(base_key)
        if _bg_sem is None:
            _bg_sem = threading.Semaphore(_compile_workers())
    # a daemon thread, not a pool: process exit never waits for a build
    threading.Thread(target=_background_compile,
                     args=(plan, context, base_key),
                     name="dsql-bg-compile", daemon=True).start()
    return True


def inflight_background_compiles() -> list:
    """Plan fingerprints building in background threads now."""
    with _tier_lock:
        return [k[0] for k in _tier_inflight]


def tier_probe(plan: RelNode, context) -> str:
    """Which tier would answer this plan now, without running it:
    ``eager`` (not compilable, or ``DSQL_COMPILE=0``), ``compiled`` (its
    programs are built), ``eager-compiling`` (cold: tiering answers eager
    while building) or ``compiled-cold`` (tiering off: the arrival pays
    the build)."""
    if os.environ.get("DSQL_COMPILE", "1") == "0":
        return "eager"
    plan = _maybe_parameterize(plan, count=False)
    scans: list = []
    try:
        plan_fp = _fp_plan(plan, context, scans)
    except Unsupported:
        return "eager"
    base_key = (plan_fp, _fp_inputs(scans), _strategy_on_tpu(),
                _mesh_signature(context))
    try:
        if _programs_ready(plan, context, base_key, stage_budget()):
            return "compiled"
    except Exception:   # a probe never fails a query
        logger.debug("tier probe failed", exc_info=True)
        return "eager"
    with _tier_lock:
        inflight = base_key in _tier_inflight
    if inflight or _tiering_enabled():
        return "eager-compiling"
    return "compiled-cold"


def try_execute_compiled(plan: RelNode, context,
                         _split_limit: Optional[int] = None
                         ) -> Optional[Table]:
    """Execute through the compiled tier; None => the caller runs eager.

    A plan within the heavy-node budget is one program; a larger one runs
    as a stage graph.  ``_split_limit`` overrides the budget (the ladder's
    whole -> stages rung; keys equal a ``DSQL_STAGE_HEAVY`` run at that
    value)."""
    if os.environ.get("DSQL_COMPILE", "1") == "0":
        return None
    # the JAX package's persistent program store (not ported)
    refuse("DSQL_PROGRAM_STORE")
    _res.check("compile_entry")
    # literals hoist here, at the one entry of the tier, so every key
    # below (whole plan, stages) sees the shape; the eager executor never
    # sees this plan
    plan = _maybe_parameterize(plan)
    scans: list = []
    try:
        plan_fp = _fp_plan(plan, context, scans)
    except Unsupported as e:
        return _unsupported(e)
    base_key = (plan_fp, _fp_inputs(scans), _strategy_on_tpu(),
                _mesh_signature(context))
    budget = stage_budget(_split_limit)
    if _tier_serve_eager(plan, context, base_key, budget, _split_limit):
        _tel.inc("served_eager_while_compiling")
        _tel.annotate(tier="eager-compiling")
        return None
    if heavy_count(plan) > budget:
        graph = _partition_plan(plan, budget, context)
        if len(graph.stages) > 1:
            return _execute_stage_graph(graph, context, plan_fp,
                                        _split_limit)
        # nothing to cut (one oversized node): run it whole
    return _execute_single(plan, context, plan_fp, _split_limit)


def _unsupported(e: Exception) -> None:
    logger.debug("not compilable: %s", e)
    _tel.inc("unsupported")
    _tel.annotate(compiled_unsupported=str(e)[:200])
    return None


def _execute_single(plan: RelNode, context, query_fp: str,
                    split_limit: Optional[int] = None,
                    in_stage: bool = False) -> Optional[Table]:
    """Build, capture and run ONE program (a whole plan or one stage);
    None => eager.  Under the host strategy a terminal ORDER BY / LIMIT
    runs after the fetch: the rows are compacted to their true count there,
    so the sort costs the result size, not the padded one; it applies to
    whatever rung answers."""
    host_sort = None
    if not _strategy_on_tpu() and isinstance(plan, LogicalSort):
        host_sort = plan
        plan = plan.input
    result = _execute_program(plan, context, query_fp, split_limit, in_stage)
    if result is not None and host_sort is not None:
        result = _apply_host_sort(result, host_sort)
    return result


def _build_and_run(plan: RelNode, context, scans, params, caps, key,
                   base_key, plan_fp: str, query_fp: str, flat,
                   split_limit: Optional[int], in_stage: bool):
    """The build of a program absent from the cache, on the ladder:
    (entry, the first run's outputs), or ("answer", result) when a rung
    below whole answered (None: eager)."""
    degrade = None
    qstore = _quar.get_store()
    qkey = _quar.program_key(base_key)
    with _tel.span("compile"):
        verdict = qstore.check(qkey) if qstore.enabled() else None
        if verdict == "quarantined":
            # a standing cross-process verdict: no build, eager
            _tel.inc("quarantine_skips")
            _tel.annotate(quarantined=True)
            logger.warning("program is quarantined (a crash or hang in an "
                           "earlier process); skipping its build, serving "
                           "eager")
            return "answer", None
        if verdict == "probe":
            # half-open: this caller tries the build; success lifts the
            # verdict, failure re-arms it
            _tel.inc("quarantine_probes")
            _tel.annotate(quarantine_probe=True)
        attempt = 0
        while True:   # in-rung transient retries
            try:
                # the watchdog observes the build from outside: an
                # injected compile fault (stall included) sits inside it
                with _quar.get_watchdog().watch(qkey, label=plan_fp[:60]):
                    _faults.maybe_fail("compile")
                    entry = _build(plan, context, scans, caps,
                                   params=params, origin=query_fp)
                    with entry.fn.lock:
                        outs = entry.fn(*flat)
                break
            except (Unsupported, HostRead) as e:
                with _state_lock:
                    _cache[key] = _UNSUPPORTED
                return "answer", _unsupported(e)
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:
                err = _res.classify(e)
                if err is None:
                    raise
                if isinstance(err, (_res.DeadlineExceeded,
                                    _res.QueryCancelled, _res.DeviceLost)):
                    raise err if err is e else err from e
                _tel.inc("compile_errors")
                _note_compile_result(False)
                attempt += 1
                _tel.annotate(attempts=attempt)
                if (isinstance(err, _res.TransientError)
                        and attempt <= _res.retry_max()):
                    _tel.inc("retries")
                    logger.warning("transient compile failure (%s); retry "
                                   "%d/%d", str(err)[:200], attempt,
                                   _res.retry_max())
                    _res.backoff(attempt, "compile")
                    continue
                degrade = (e, err)
                break
    if degrade is not None:
        return "degrade", degrade
    _tel.inc("compiles")
    _note_compile_result(True)
    if params:
        _tel.inc("param_plan_misses")
    if in_stage:
        _tel.inc("stage_compiles")
    if qstore.enabled():
        # a build that succeeded lifts any verdict left on it
        qstore.clear(qkey)
    with _state_lock:
        while len(_cache) >= _CACHE_LIMIT:
            _, old = _cache.popitem(last=False)
            if isinstance(old, _Compiled):
                old.fn.release()
        _cache[key] = entry
    return entry, outs


def _execute_program(plan: RelNode, context, query_fp: str,
                     split_limit: Optional[int], in_stage: bool
                     ) -> Optional[Table]:
    scans: list = []
    params: list = []
    try:
        plan_fp = _fp_plan(plan, context, scans, params)
    except Unsupported as e:
        return _unsupported(e)
    base_key = (plan_fp, _fp_inputs(scans), _strategy_on_tpu(),
                _mesh_signature(context))
    # runtime verdicts depend on values the layout cannot see: pinned to
    # the exact tables, so reloaded (corrected) data gets a fresh chance
    runtime_key = (base_key, tuple(t.uid for _, t, _ in scans))
    with _state_lock:
        exiled = runtime_key in _runtime_eager
    if exiled:
        _tel.inc("fallbacks")
        _tel.annotate(compiled_fallback="runtime verdict of these tables")
        return None
    caps = _initial_caps(plan, context, base_key, runtime_key)
    # escalation bound: the JAX package's 8 for capacities, and the five
    # doublings of a hash site's rounds (2 -> 64)
    for _ in range(16):
        _res.check("execute")
        key = (base_key, tuple(sorted(caps.items())))
        my_event = None
        with _state_lock:
            entry = _cache.get(key)
            if entry is None:
                other = _inflight.get(key)
                if other is None:
                    my_event = threading.Event()
                    _inflight[key] = my_event
        if entry is None and my_event is None:
            # another thread builds this exact program: wait for it, never
            # past this query's deadline
            rt = _res.current()
            rem = None if rt is None else rt.remaining()
            other.wait(1800 if rem is None else max(min(rem, 1800), 1e-3))
            _res.check("compile_wait")
            with _state_lock:
                entry = _cache.get(key)
                if entry is None:   # its builder failed: take over
                    my_event = threading.Event()
                    _inflight[key] = my_event
        try:
            if entry is _UNSUPPORTED:
                _tel.inc("unsupported")
                return None
            flat = _flatten_tables(scans)
            if params:
                flat = flat + _param_args(params, context.device)
            if entry is None:
                got = _build_and_run(plan, context, scans, params, caps,
                                     key, base_key, plan_fp, query_fp, flat,
                                     split_limit, in_stage)
            else:
                got = None
        finally:
            if my_event is not None:
                with _state_lock:
                    _inflight.pop(key, None)
                my_event.set()
        if got is not None and got[0] == "answer":
            return got[1]
        if got is not None and got[0] == "degrade":
            exc, err = got[1]
            return _degrade_compile(plan, context, base_key, key, exc, err,
                                    split_limit)
        try:
            if got is not None:
                entry, outs = got
                with _tel.span("materialize"):
                    result = _res.retry_transient(
                        lambda: _materialize(entry, outs),
                        site="materialize", passthrough=(_NeedsRecompile,))
            else:
                result = _run_cached(entry, flat, params, in_stage, query_fp,
                                     key)
        except _NeedsRecompile as r:
            _tel.inc("recompiles")
            caps = r.caps
            _learned_caps_put(base_key, caps)
            continue
        except _res.TransientError as e:
            # the host decode failed past its retries: one rung down, the
            # eager executor recomputes from the source tables
            _tel.inc("degradations")
            _tel.annotate(degraded_to="eager")
            if os.environ.get("DSQL_EAGER_FALLBACK", "1") == "0":
                raise
            logger.warning("materialize failed (%s); using the eager "
                           "executor", str(e)[:200])
            return None
        if result is None:
            # a runtime invariant failed (non-unique build, collision,
            # 2**53): stable for these tables, eager from now on
            _tel.annotate(compiled_fallback="runtime flag")
            with _state_lock:
                _bounded_put(_runtime_eager, runtime_key, True)
        return result
    # the flags kept asking for larger capacities or more rounds: a
    # runtime verdict, counted as one
    _tel.inc("fallbacks")
    _tel.annotate(compiled_fallback="runtime escalation bound")
    return None


def _run_cached(entry: _Compiled, flat, params, in_stage: bool,
                query_fp: str, key) -> Optional[Table]:
    """A cache hit: replay (or, for new table inputs, warm up and capture
    once more) and materialize, under the program's lock: the next replay
    overwrites the outputs."""
    _tel.inc("hits")
    _tel.annotate(cache_hit=True)
    if params:
        _tel.inc("param_plan_hits")
    if in_stage:
        _tel.inc("stage_hits")
    if entry.origin is not None and entry.origin != query_fp:
        _tel.inc("cross_query_hits")
    with _state_lock:
        if key in _cache:
            _cache.move_to_end(key)
    with entry.fn.lock:
        t0 = time.perf_counter()
        with _tel.span("run"):
            outs = entry.fn(*flat)
        if os.environ.get("DSQL_TIME_DEVICE"):
            # opt-in split of the run into device and materialize time
            # (one extra synchronisation)
            if outs[0].is_cuda:
                torch.cuda.synchronize(outs[0].device)
            prof = _tel.exec_profile()
            prof["device_ms"] = (time.perf_counter() - t0) * 1e3
            _tel.annotate(device_ms=prof["device_ms"])
        with _tel.span("materialize"):
            return _res.retry_transient(
                lambda: _materialize(entry, outs), site="materialize",
                passthrough=(_NeedsRecompile,))
