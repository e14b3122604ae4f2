"""Canonical plan text: the part of the result cache that stage graphs need.

The counterpart of ``dask_sql_tpu/runtime/result_cache.py``, cut to
``canonical_plan``: a total serialization of a plan that never raises,
covers every node type (unknown constructs serialize by type name and
mark the plan volatile) and includes VALUES rows and scalar-subquery
bodies, so two different subplans never share a text.  The compiled
tier's stage boundary names are digests of it
(``physical/compiled.py`` ``_stage_table_name``).  ``shape=True`` writes a
hoisted parameter by slot and type only; the default keeps its value.

The cache itself (``ResultCache``: memoized query results and stage
outputs under catalog epochs, a device and a host budget) is not ported
yet: on by default in the JAX package, it would turn every warm timing of
the port into a cache hit, so it comes with the runtime services.
"""
from __future__ import annotations

from typing import List, Tuple

# non-deterministic / environment-dependent operators: results must never be
# replayed from cache (the seeded RAND variants still read per-row state)
VOLATILE_OPS = frozenset({
    "RAND", "RANDOM", "RAND_INTEGER",
    "CURRENT_DATE", "CURRENT_TIMESTAMP", "NOW", "LOCALTIMESTAMP",
    "CURRENT_TIME", "LOCALTIME",
})

_SPLIT_SCHEMA = "__split__"


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
