"""The result and subplan cache, under catalog epochs and two budgets.

The counterpart of ``dask_sql_tpu/runtime/result_cache.py``.  It memoizes
query results and materialized stage outputs, keyed by a canonical text of
the optimized plan (``canonical_plan``: a total serialization that never
raises, covers every node type and includes VALUES rows and
scalar-subquery bodies, so two different subplans never share a text)
folded with the catalog epoch and the table uid of every table it scans.

- **Epochs.**  ``Context`` bumps a table's epoch on every mutating path
  (create, drop, alter, CTAS, schema operations); the epoch joins the key
  and the bump drops every entry that scans the table.  Uids are never
  reused, so replacing a table misses even without a bump.
- **Volatility.**  RAND, the current-time functions, Python UDFs, an
  unseeded TABLESAMPLE, PREDICT and ``system.*`` scans make ``plan_key``
  answer None: never cached.  A stage boundary's key is its name
  (``stage_key``), a digest of the subtree with the uids of its scans.
- **Budgets.**  Entries live on the device under ``DSQL_RESULT_CACHE_MB``
  (default 256; ``0`` turns the cache off and releases what it holds);
  the device tier's LRU entry spills to the host under
  ``DSQL_RESULT_CACHE_HOST_MB`` (default 1024) in one transfer
  (``table.tensors_to_host``); the host tier's LRU entry is dropped.  A
  host hit uploads the entry again with non-blocking pinned copies, the
  host copies kept in ``Column.host``.  With the workload manager on, the
  cache is a tenant of its device-bytes ledger: the device budget shrinks
  to the ledger's free room and an admitted query's reservation spills
  the device tier (``shrink_device_to``).
- **Faults.**  A store passes the ``cache_populate`` site: an injected or
  transient failure skips the store, never the query; a failed execution
  never reaches ``put``.

Gauges ``result_cache_bytes`` / ``result_cache_host_bytes`` and the
``result_cache_*`` counters keep the JAX package's names.  The compiled
tier's stage boundary names are digests of ``canonical_plan``
(``physical/compiled.py`` ``_stage_table_name``); ``shape=True`` writes a
hoisted parameter by slot and type only, the default keeps its value.
"""
from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Set, Tuple

from . import faults as _faults, resilience as _res, telemetry as _tel

# non-deterministic / environment-dependent operators: results must never be
# replayed from cache (the seeded RAND variants still read per-row state)
VOLATILE_OPS = frozenset({
    "RAND", "RANDOM", "RAND_INTEGER",
    "CURRENT_DATE", "CURRENT_TIMESTAMP", "NOW", "LOCALTIMESTAMP",
    "CURRENT_TIME", "LOCALTIME",
})

_SPLIT_SCHEMA = "__split__"

DEFAULT_DEVICE_MB = 256.0
DEFAULT_HOST_MB = 1024.0


def _env_mb(name: str, default: float) -> float:
    import os

    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        return max(float(raw), 0.0)
    except ValueError:
        return default


class _Canon:
    """Accumulator for one canonicalization walk.

    ``shape=True`` serializes hoisted parameters (RexParam) by slot and
    type only — the SHAPE identity the flight recorder's EWMA history
    keys on, so cost estimates transfer across literal variants.  The
    default stays value-bearing: result-cache keys, stage boundary names
    and SPMD digests must distinguish literals, or two variants of a
    shape would replay each other's ANSWERS."""

    __slots__ = ("parts", "scans", "volatile", "shape")

    def __init__(self, shape: bool = False):
        self.parts: List[str] = []
        self.scans: List[Tuple[str, str]] = []
        self.volatile = False
        self.shape = shape


def _canon_rex(rex, acc: _Canon) -> None:
    from ..plan.nodes import (RexCall, RexInputRef, RexLiteral, RexOuterRef,
                              RexParam, RexScalarSubquery, RexUdf)

    if isinstance(rex, RexInputRef):
        acc.parts.append(f"${rex.index}")
    elif isinstance(rex, RexParam):
        if acc.shape:
            acc.parts.append(f"P{rex.slot}:{rex.stype.name}")
        else:
            acc.parts.append(f"P{rex.slot}:{rex.stype.name}={rex.value!r}")
    elif isinstance(rex, RexLiteral):
        acc.parts.append(f"L{rex.stype.name}:{rex.value!r}")
    elif isinstance(rex, RexCall):
        if rex.op in VOLATILE_OPS:
            acc.volatile = True
        info = getattr(rex, "info", None)
        extra = f"!{getattr(info, 'name', info)}" if info is not None else ""
        acc.parts.append(f"C{rex.op}{extra}[")
        for o in rex.operands:
            _canon_rex(o, acc)
        acc.parts.append(f"]:{rex.stype.name}")
    elif isinstance(rex, RexScalarSubquery):
        acc.parts.append("S[")
        _canon_rel(rex.plan, acc)
        acc.parts.append("]")
    elif isinstance(rex, RexOuterRef):
        acc.parts.append(f"$outer{rex.index}")
    elif isinstance(rex, RexUdf):
        # python callables: identity is not content-addressable and the
        # function may be stateful — never replay from cache
        acc.volatile = True
        acc.parts.append(f"udf:{rex.name}")
        for o in rex.operands:
            _canon_rex(o, acc)
    else:
        acc.volatile = True
        acc.parts.append(f"?rex:{type(rex).__name__}")


def _canon_collation(collation, acc: _Canon) -> None:
    acc.parts.append(",".join(
        f"{c.index}{'a' if c.ascending else 'd'}"
        f"{'nf' if c.effective_nulls_first else 'nl'}" for c in collation))


def _canon_rel(rel, acc: _Canon) -> None:
    """Total canonical serialization: unlike ``compiled._fp_plan`` it never
    raises and covers every node type (unknown constructs serialize by type
    name and mark the plan volatile), and unlike ``RelNode.explain`` it
    includes the contents of VALUES rows and scalar-subquery plans — two
    different subplans can never share a fingerprint."""
    from ..plan.nodes import (LogicalAggregate, LogicalExcept, LogicalFilter,
                              LogicalIntersect, LogicalJoin, LogicalProject,
                              LogicalSample, LogicalSort, LogicalTableScan,
                              LogicalUnion, LogicalValues, LogicalWindow)
    from ..plan.predict import LogicalPredict

    t = type(rel).__name__
    schema = ";".join(f"{f.name}:{f.stype.name}" for f in rel.schema)
    if isinstance(rel, LogicalTableScan):
        if rel.schema_name == "system":
            # system tables are views over live engine state (and the
            # flight-recorder file): never cacheable, and they must not
            # occupy result-cache budget or bump catalog epochs.  A user
            # schema literally named "system" shadows the builtin in
            # resolution but still pays this exemption — acceptable cost
            # for a reserved name.
            acc.volatile = True
        if rel.schema_name != _SPLIT_SCHEMA:
            acc.scans.append((rel.schema_name, rel.table_name))
        # a __split__ boundary name is already a content digest of its
        # producing subtree (physical/compiled._stage_table_name)
        acc.parts.append(f"Scan({rel.schema_name}.{rel.table_name})[{schema}]")
        return
    acc.parts.append(f"{t}(")
    if isinstance(rel, LogicalProject):
        for e in rel.exprs:
            _canon_rex(e, acc)
            acc.parts.append(",")
    elif isinstance(rel, LogicalFilter):
        _canon_rex(rel.condition, acc)
    elif isinstance(rel, LogicalAggregate):
        acc.parts.append(f"g={rel.group_keys}|")
        for a in rel.aggs:
            if a.udaf is not None:
                acc.volatile = True  # python callable, like a UDF
            acc.parts.append(
                f"{a.op}{'d' if a.distinct else ''}({a.args})f{a.filter_arg};")
    elif isinstance(rel, LogicalJoin):
        na = "N" if getattr(rel, "null_aware", False) else ""
        acc.parts.append(f"{rel.join_type}{na}|")
        if rel.condition is not None:
            _canon_rex(rel.condition, acc)
    elif isinstance(rel, LogicalSort):
        _canon_collation(rel.collation, acc)
        acc.parts.append(f"|o={rel.offset}|l={rel.limit}")
    elif isinstance(rel, LogicalWindow):
        for call in rel.calls:
            acc.parts.append(f"{call.op}({call.args})p{call.partition}o")
            _canon_collation(call.order, acc)
            acc.parts.append(f"f{call.frame!r};")
    elif isinstance(rel, (LogicalUnion, LogicalIntersect, LogicalExcept)):
        acc.parts.append(f"all={rel.all}")
    elif isinstance(rel, LogicalValues):
        acc.parts.append(repr([[f"{l.stype.name}:{l.value!r}" for l in row]
                               for row in rel.rows]))
    elif isinstance(rel, LogicalSample):
        if rel.seed is None:
            acc.volatile = True
        acc.parts.append(f"{rel.method}|{rel.percentage}|{rel.seed}")
    elif isinstance(rel, LogicalPredict):
        # the model registry is mutable and carries no versioning the key
        # could fold in — never replay PREDICT results
        acc.volatile = True
        acc.parts.append(".".join(rel.model_name))
    else:
        acc.volatile = True
    acc.parts.append(f")[{schema}]<")
    for i in rel.inputs:
        _canon_rel(i, acc)
    acc.parts.append(">")


def canonical_plan(rel, context=None, shape: bool = False) -> Tuple[
        str, bool, List[Tuple[str, str]]]:
    """(canonical text, volatile, referenced (schema, table) pairs).

    ``shape=True`` collapses hoisted literals (RexParam) to slot+type so
    the text names the query SHAPE — see ``_Canon``."""
    acc = _Canon(shape=shape)
    _canon_rel(rel, acc)
    return "".join(acc.parts), acc.volatile, acc.scans


class CacheKey:
    """A fully-resolved cache key: plan digest folded with every referenced
    table's catalog epoch AND table uid at key-build time."""

    __slots__ = ("digest", "tables")

    def __init__(self, digest: str, tables: Tuple[Tuple[str, str], ...]):
        self.digest = digest
        self.tables = tables


def plan_key(plan, context) -> Optional[CacheKey]:
    """Cache key for an optimized query plan, or None when the plan is
    uncacheable (volatile constructs, unresolvable/chunked scans)."""
    text, volatile, scans = canonical_plan(plan, context)
    if volatile:
        return None
    h = hashlib.blake2b(text.encode(), digest_size=16)
    tables: List[Tuple[str, str]] = []
    for schema_name, table_name in scans:
        # the executors' read: a pinned query keys on its pinned entry
        # and epoch together (runtime/ingest.py)
        try:
            entry = context.catalog_entry(schema_name, table_name)
        except KeyError:
            entry = None
        if entry is None or entry.table is None or entry.chunked is not None:
            # views resolve through the binder before this point; a chunked
            # source has no stable content identity to key on
            return None
        epoch = context.table_epoch(schema_name, table_name)
        h.update(f"|{schema_name}.{table_name}:e{epoch}"
                 f":u{entry.table.uid}".encode())
        tables.append((schema_name, table_name))
    return CacheKey(h.hexdigest(), tuple(dict.fromkeys(tables)))


def stage_key(name: str) -> CacheKey:
    """Key for a stage-boundary subplan output.  ``name`` is the boundary
    temp-table digest (physical/compiled._stage_table_name), which already
    content-addresses the subtree INCLUDING the uids of every scanned table
    — a catalog mutation changes the uids and therefore the name."""
    return CacheKey(f"stage:{name}", ())


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------

class _Entry:
    __slots__ = ("key", "tier", "table", "host", "nbytes", "tables", "hits",
                 "device")

    def __init__(self, key: str, table, nbytes: int,
                 tables: Tuple[Tuple[str, str], ...]):
        self.key = key
        self.tier = "device"
        self.table = table          # device Table (tier == "device")
        self.host = None            # (names, [(data, mask, stype, dict)])
        self.nbytes = nbytes
        self.tables = tables
        self.hits = 0
        # where a host-tier hit uploads the entry again
        self.device = (table.columns[0].data.device if table.columns
                       else "cpu")


def _table_nbytes(table) -> int:
    total = 0
    for c in table.columns:
        total += int(getattr(c.data, "nbytes", 0))
        if c.mask is not None:
            total += int(getattr(c.mask, "nbytes", 0))
    return total


def _snapshot(table):
    """Shallow copy: shared immutable columns, private names/columns lists
    and a fresh uid — callers can never corrupt the cached copy (or each
    other's) through list surgery on a shared Table object."""
    from ..table import Table

    return Table(list(table.names), list(table.columns))


class ResultCache:
    """Byte-accounted two-tier LRU over query results and stage outputs."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()
        self._by_table: Dict[Tuple[str, str], Set[str]] = {}
        self.device_bytes = 0
        self.host_bytes = 0

    # -- config ------------------------------------------------------------
    def _base_device_budget(self) -> int:
        return int(_env_mb("DSQL_RESULT_CACHE_MB", DEFAULT_DEVICE_MB) * 2**20)

    def device_budget(self) -> int:
        """Effective device budget: the configured ceiling, shrunk to the
        workload manager's ledger headroom when that subsystem is active —
        the cache is a TENANT of the shared device-bytes ledger
        (runtime/scheduler.py), so admitted queries' reservations squeeze
        the cache before they squeeze each other.  The allowance read is
        lock-free on the scheduler side, so calling this under the cache
        lock cannot invert the ledger->cache lock order."""
        base = self._base_device_budget()
        if base <= 0:
            return 0
        from . import scheduler as _sched
        allowance = _sched.get_manager().cache_allowance()
        return base if allowance is None else min(base, allowance)

    def host_budget(self) -> int:
        return int(_env_mb("DSQL_RESULT_CACHE_HOST_MB",
                           DEFAULT_HOST_MB) * 2**20)

    def enabled(self) -> bool:
        # the BASE budget decides liveness: ledger pressure (allowance 0)
        # must shrink the device tier, not clear the whole cache
        if self._base_device_budget() > 0:
            return True
        if self._entries:
            self.clear()  # flipping the env off releases held memory
        return False

    # -- gauges ------------------------------------------------------------
    def _publish_gauges(self) -> None:
        _tel.REGISTRY.set_gauge("result_cache_bytes", self.device_bytes)
        _tel.REGISTRY.set_gauge("result_cache_host_bytes", self.host_bytes)

    # -- core --------------------------------------------------------------
    def probe(self, key: Optional[CacheKey]) -> Optional[str]:
        """Tier of the live entry for ``key`` (no LRU touch), else None."""
        if key is None:
            return None
        with self._lock:
            e = self._entries.get(key.digest)
            return e.tier if e is not None else None

    def get(self, key: Optional[CacheKey]):
        """(Table, tier) on a hit — the tier the entry was found in — or
        None.  Host entries re-upload and re-promote to the device tier."""
        if key is None or not self.enabled():
            return None
        with self._lock:
            e = self._entries.get(key.digest)
            if e is None:
                return None
            self._entries.move_to_end(key.digest)
            e.hits += 1
            found_tier = e.tier
            if e.tier == "host":
                self._promote(e)
            table = e.table
            # re-balance AFTER capturing the table: if the budget shrank
            # since the store, the promotion may immediately spill again
            self._evict_to_budget()
            self._publish_gauges()
        return _snapshot(table), found_tier

    def put(self, key: Optional[CacheKey], table) -> bool:
        """Store a successfully-materialized result.  Returns True when the
        entry landed.  Runs through the ``cache_populate`` fault site: an
        injected/transient failure skips the store, never the query."""
        if key is None or not self.enabled():
            return False
        try:
            _faults.maybe_fail("cache_populate")
        except _res.TransientError:
            return False  # population is best-effort by contract
        nbytes = _table_nbytes(table)
        budget = self.device_budget()
        if nbytes > budget:
            return False  # larger than the whole tier: not worth churning
        snap = _snapshot(table)
        with self._lock:
            old = self._entries.pop(key.digest, None)
            if old is not None:
                self._unaccount(old)
            e = _Entry(key.digest, snap, nbytes, key.tables)
            self._entries[key.digest] = e
            self.device_bytes += nbytes
            for t in key.tables:
                self._by_table.setdefault(t, set()).add(key.digest)
            self._evict_to_budget()
            self._publish_gauges()
        _tel.inc("result_cache_stores")
        return True

    # -- invalidation ------------------------------------------------------
    def invalidate_table(self, schema_name: str, table_name: str) -> int:
        """Drop every entry referencing (schema, table); returns the count.
        Called on every catalog-epoch bump — stale entries are released
        immediately instead of lingering until LRU pressure."""
        dropped = 0
        with self._lock:
            keys = self._by_table.pop((schema_name, table_name.lower()), ())
            for k in list(keys):
                e = self._entries.pop(k, None)
                if e is not None:
                    self._unaccount(e)
                    dropped += 1
            if dropped:
                self._publish_gauges()
        if dropped:
            _tel.inc("result_cache_invalidations", dropped)
        return dropped

    def shrink_device_to(self, target_bytes: int) -> int:
        """Pressure-driven eviction callback for the workload manager's
        memory broker: spill (or drop) device-tier LRU entries until the
        device tier fits ``target_bytes``.  Returns the bytes freed.  The
        entries keep their value when the host tier can hold them — a
        large admitted query transiently displaces the cache to host
        instead of destroying it (or OOMing the device)."""
        target = max(int(target_bytes), 0)
        host_budget = self.host_budget()
        freed = 0
        with self._lock:
            before = self.device_bytes
            while self.device_bytes > target:
                victim = self._lru_of_tier("device")
                if victim is None:  # pragma: no cover - accounting invariant
                    break
                if host_budget > 0 and victim.nbytes <= host_budget:
                    self._spill(victim)
                else:
                    self._drop(victim)
            # spills may now overflow the host tier; run the normal ladder
            while self.host_bytes > host_budget:
                victim = self._lru_of_tier("host")
                if victim is None:  # pragma: no cover - accounting invariant
                    break
                self._drop(victim)
            freed = before - self.device_bytes
            if freed:
                self._publish_gauges()
        return freed

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._by_table.clear()
            self.device_bytes = 0
            self.host_bytes = 0
            self._publish_gauges()

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "device_bytes": self.device_bytes,
                "host_bytes": self.host_bytes,
                "device_budget": self.device_budget(),
                "host_budget": self.host_budget(),
            }

    def entries_snapshot(self) -> List[dict]:
        """Per-entry view for ``system.cache`` (LRU order, oldest first)."""
        with self._lock:
            return [{"key": e.key, "tier": e.tier, "nbytes": int(e.nbytes),
                     "hits": int(e.hits),
                     "tables": ",".join(f"{s}.{t}" for s, t in e.tables)}
                    for e in self._entries.values()]

    # -- internals (lock held) ---------------------------------------------
    def _unaccount(self, e: _Entry) -> None:
        if e.tier == "device":
            self.device_bytes -= e.nbytes
        else:
            self.host_bytes -= e.nbytes
        for t in e.tables:
            keys = self._by_table.get(t)
            if keys is not None:
                keys.discard(e.key)
                if not keys:
                    self._by_table.pop(t, None)

    def _drop(self, e: _Entry) -> None:
        self._entries.pop(e.key, None)
        self._unaccount(e)
        _tel.inc("result_cache_evictions")

    def _lru_of_tier(self, tier: str) -> Optional[_Entry]:
        for e in self._entries.values():  # insertion order == LRU order
            if e.tier == tier:
                return e
        return None

    def _evict_to_budget(self) -> None:
        """The eviction ladder: device LRU spills to host; host LRU drops."""
        budget = self.device_budget()
        host_budget = self.host_budget()
        while self.device_bytes > budget:
            victim = self._lru_of_tier("device")
            if victim is None:  # pragma: no cover - accounting invariant
                break
            if host_budget > 0 and victim.nbytes <= host_budget:
                self._spill(victim)
            else:
                self._drop(victim)
        while self.host_bytes > host_budget:
            victim = self._lru_of_tier("host")
            if victim is None:  # pragma: no cover - accounting invariant
                break
            self._drop(victim)

    def _spill(self, e: _Entry) -> None:
        """device -> host: one bulk transfer, numpy thereafter."""
        from ..table import tensors_to_host

        table = e.table
        bufs = []
        for c in table.columns:
            bufs.append(c.data)
            if c.mask is not None:
                bufs.append(c.mask)
        fetched = iter(tensors_to_host(bufs))
        cols = []
        for c in table.columns:
            data = next(fetched)
            mask = next(fetched) if c.mask is not None else None
            cols.append((data, mask, c.stype, c.dictionary))
        e.host = (list(table.names), cols)
        e.table = None
        e.tier = "host"
        self.device_bytes -= e.nbytes
        self.host_bytes += e.nbytes
        _tel.inc("result_cache_spills")

    def _promote(self, e: _Entry) -> None:
        """host -> device on a host-tier hit: non-blocking pinned uploads,
        the host copies kept in ``Column.host`` for the next read."""
        from ..table import Column, Table, array_to_device

        names, host_cols = e.host
        cols = [Column(array_to_device(data, e.device), stype,
                       None if mask is None
                       else array_to_device(mask, e.device),
                       dictionary, host=(data, mask))
                for data, mask, stype, dictionary in host_cols]
        e.table = Table(names, cols)
        e.host = None
        e.tier = "device"
        self.host_bytes -= e.nbytes
        self.device_bytes += e.nbytes


_CACHE = ResultCache()


def get_cache() -> ResultCache:
    """The process-global cache (keys fold table uids, so entries from
    different Contexts/tests can never collide)."""
    return _CACHE
