"""Bridge to the native (C++) plan optimizer.

The counterpart of ``dask_sql_tpu/plan/native_planner.py``: the bound plan
serializes to JSON, ``native/optimizer.cpp`` (a lockstep port of
``plan/optimizer.py``) applies the PASSES pipeline, the subplan
optimization and the column pruning, and the result deserializes back.

The Python optimizer takes the plans the wire format cannot express:
scalar UDF calls (RexUdf), custom aggregations (AggCall.udaf), plan nodes
outside the core vocabulary (LogicalPredict), and non-finite float or
out-of-int64 literals.  ``serialize_plan`` returns None for those, as in the
JAX package.  A serializable plan the native optimizer fails on raises:
that would be a lockstep bug, and the Python pipeline does not hide it.
"""
from __future__ import annotations

import json
import logging
from typing import Any, List, Optional

from ..types import SqlType
from .nodes import (
    AggCall, Field, LogicalAggregate, LogicalExcept, LogicalFilter,
    LogicalIntersect, LogicalJoin, LogicalProject, LogicalSample, LogicalSort,
    LogicalTableScan, LogicalUnion, LogicalValues, LogicalWindow, RelNode,
    RexCall, RexInputRef, RexLiteral, RexNode, RexScalarSubquery,
    SortCollation, WindowCall,
)

logger = logging.getLogger(__name__)

_INT64_MIN = -(1 << 63)
_INT64_MAX = (1 << 63) - 1


class _Unserializable(Exception):
    """Plan carries a payload the native wire format cannot express."""


# --------------------------------------------------------------- serialize

def _type_to_json(t: SqlType) -> list:
    return [t.name, t.precision, t.scale, t.nullable]


def _type_from_json(v: list) -> SqlType:
    return SqlType(v[0], v[1], v[2], v[3])


def _field_to_json(f: Field) -> list:
    return [f.name, _type_to_json(f.stype)]


def _schema_to_json(schema: List[Field]) -> list:
    return [_field_to_json(f) for f in schema]


def _schema_from_json(v: list) -> List[Field]:
    return [Field(name, _type_from_json(t)) for name, t in v]


def _rex_to_json(r: RexNode) -> list:
    if isinstance(r, RexInputRef):
        return ["in", r.index, _type_to_json(r.stype)]
    if isinstance(r, RexLiteral):
        v = r.value
        if v is None:
            return ["lit", "n", None, _type_to_json(r.stype)]
        if isinstance(v, bool):
            return ["lit", "b", v, _type_to_json(r.stype)]
        if isinstance(v, int):
            if not (_INT64_MIN <= v <= _INT64_MAX):
                raise _Unserializable("int literal outside int64")
            return ["lit", "i", v, _type_to_json(r.stype)]
        if isinstance(v, float):
            if v != v or v in (float("inf"), float("-inf")):
                raise _Unserializable("non-finite float literal")
            return ["lit", "f", v, _type_to_json(r.stype)]
        if isinstance(v, str):
            return ["lit", "s", v, _type_to_json(r.stype)]
        raise _Unserializable(f"literal of type {type(v).__name__}")
    if isinstance(r, RexScalarSubquery):
        return ["subq", _rel_to_json(r.plan), _type_to_json(r.stype)]
    if isinstance(r, RexCall):
        if r.info is not None and not isinstance(r.info, SqlType):
            raise _Unserializable("non-type call info")
        return ["call", r.op, [_rex_to_json(o) for o in r.operands],
                _type_to_json(r.stype),
                None if r.info is None else _type_to_json(r.info)]
    # RexUdf, RexOuterRef, anything unknown
    raise _Unserializable(f"rex {type(r).__name__}")


def _agg_to_json(a: AggCall) -> list:
    if a.udaf is not None:
        raise _Unserializable("custom aggregation (udaf)")
    return [a.op, list(a.args), a.distinct, _type_to_json(a.stype), a.name,
            a.filter_arg]


def _coll_to_json(c: SortCollation) -> list:
    return [c.index, c.ascending, c.nulls_first]


def _frame_to_json(frame) -> Any:
    # opaque round-trip: (kind, (bound, n|None), (bound, n|None)) or None
    if frame is None:
        return None
    kind, lo, hi = frame
    return [kind, list(lo), list(hi)]


def _rel_to_json(rel: RelNode) -> dict:
    if isinstance(rel, LogicalTableScan):
        out = {"k": "scan", "sn": rel.schema_name, "tn": rel.table_name}
    elif isinstance(rel, LogicalProject):
        out = {"k": "proj", "in": _rel_to_json(rel.input),
               "exprs": [_rex_to_json(e) for e in rel.exprs]}
    elif isinstance(rel, LogicalFilter):
        out = {"k": "filt", "in": _rel_to_json(rel.input),
               "cond": _rex_to_json(rel.condition)}
    elif isinstance(rel, LogicalAggregate):
        out = {"k": "agg", "in": _rel_to_json(rel.input),
               "gk": list(rel.group_keys),
               "aggs": [_agg_to_json(a) for a in rel.aggs]}
    elif isinstance(rel, LogicalJoin):
        out = {"k": "join", "l": _rel_to_json(rel.left),
               "r": _rel_to_json(rel.right), "jt": rel.join_type,
               "cond": (None if rel.condition is None
                        else _rex_to_json(rel.condition)),
               "na": bool(getattr(rel, "null_aware", False))}
    elif isinstance(rel, LogicalSort):
        out = {"k": "sort", "in": _rel_to_json(rel.input),
               "coll": [_coll_to_json(c) for c in rel.collation],
               "limit": rel.limit, "offset": rel.offset}
    elif isinstance(rel, (LogicalUnion, LogicalIntersect, LogicalExcept)):
        kinds = {LogicalUnion: "union", LogicalIntersect: "intersect",
                 LogicalExcept: "except"}
        out = {"k": kinds[type(rel)],
               "ins": [_rel_to_json(i) for i in rel.inputs_],
               "all": rel.all}
    elif isinstance(rel, LogicalValues):
        out = {"k": "values",
               "rows": [[_rex_to_json(e) for e in row] for row in rel.rows]}
    elif isinstance(rel, LogicalWindow):
        out = {"k": "window", "in": _rel_to_json(rel.input),
               "calls": [[c.op, list(c.args), list(c.partition),
                          [_coll_to_json(k) for k in c.order],
                          _frame_to_json(c.frame), _type_to_json(c.stype),
                          c.name] for c in rel.calls]}
    elif isinstance(rel, LogicalSample):
        out = {"k": "sample", "in": _rel_to_json(rel.input),
               "method": rel.method, "pct": float(rel.percentage),
               "seed": rel.seed}
    else:
        # LogicalPredict and any future node type: Python pipeline only
        raise _Unserializable(f"rel {type(rel).__name__}")
    out["schema"] = _schema_to_json(rel.schema)
    return out


# ------------------------------------------------------------- deserialize

def _rex_from_json(v: list) -> RexNode:
    tag = v[0]
    if tag == "in":
        return RexInputRef(v[1], _type_from_json(v[2]))
    if tag == "lit":
        lt, val = v[1], v[2]
        stype = _type_from_json(v[3])
        if lt == "n":
            return RexLiteral(None, stype)
        if lt == "b":
            return RexLiteral(bool(val), stype)
        if lt == "i":
            return RexLiteral(int(val), stype)
        if lt == "f":
            return RexLiteral(float(val), stype)
        return RexLiteral(val, stype)
    if tag == "call":
        return RexCall(v[1], [_rex_from_json(o) for o in v[2]],
                       _type_from_json(v[3]),
                       None if v[4] is None else _type_from_json(v[4]))
    if tag == "subq":
        return RexScalarSubquery(_rel_from_json(v[1]), _type_from_json(v[2]))
    raise ValueError(f"unknown rex tag {tag!r}")


def _coll_from_json(v: list) -> SortCollation:
    return SortCollation(v[0], v[1], v[2])


def _frame_from_json(v) -> Any:
    if v is None:
        return None
    kind, lo, hi = v
    return (kind, (lo[0], lo[1]), (hi[0], hi[1]))


def _rel_from_json(v: dict) -> RelNode:
    k = v["k"]
    schema = _schema_from_json(v["schema"])
    if k == "scan":
        return LogicalTableScan(v["sn"], v["tn"], schema)
    if k == "proj":
        return LogicalProject(_rel_from_json(v["in"]),
                              [_rex_from_json(e) for e in v["exprs"]], schema)
    if k == "filt":
        return LogicalFilter(_rel_from_json(v["in"]),
                             _rex_from_json(v["cond"]), schema)
    if k == "agg":
        aggs = [AggCall(a[0], list(a[1]), a[2], _type_from_json(a[3]), a[4],
                        a[5], None) for a in v["aggs"]]
        return LogicalAggregate(_rel_from_json(v["in"]), list(v["gk"]), aggs,
                                schema)
    if k == "join":
        out = LogicalJoin(_rel_from_json(v["l"]), _rel_from_json(v["r"]),
                          v["jt"],
                          None if v["cond"] is None
                          else _rex_from_json(v["cond"]), schema)
        if v["na"]:
            out.null_aware = True  # type: ignore[attr-defined]
        return out
    if k == "sort":
        return LogicalSort(_rel_from_json(v["in"]),
                           [_coll_from_json(c) for c in v["coll"]],
                           v["limit"], v["offset"], schema)
    if k in ("union", "intersect", "except"):
        cls = {"union": LogicalUnion, "intersect": LogicalIntersect,
               "except": LogicalExcept}[k]
        return cls([_rel_from_json(i) for i in v["ins"]], v["all"], schema)
    if k == "values":
        return LogicalValues([[_rex_from_json(e) for e in row]
                              for row in v["rows"]], schema)
    if k == "window":
        calls = [WindowCall(c[0], list(c[1]), list(c[2]),
                            [_coll_from_json(x) for x in c[3]],
                            _frame_from_json(c[4]), _type_from_json(c[5]),
                            c[6]) for c in v["calls"]]
        return LogicalWindow(_rel_from_json(v["in"]), calls, schema)
    if k == "sample":
        return LogicalSample(_rel_from_json(v["in"]), v["method"], v["pct"],
                             v["seed"], schema)
    raise ValueError(f"unknown rel kind {k!r}")


# ------------------------------------------------------------------ public

def serialize_plan(plan: RelNode) -> Optional[str]:
    """Plan -> wire JSON, or None when the plan carries Python-only
    payloads (UDF/UDAF/unknown nodes) the native optimizer must not see."""
    try:
        return json.dumps(_rel_to_json(plan), ensure_ascii=False,
                          separators=(",", ":"))
    except _Unserializable as e:
        logger.debug("native optimizer skipped: %s", e)
        return None


def deserialize_plan(text: str) -> RelNode:
    return _rel_from_json(json.loads(text))


def optimize_native(plan: RelNode,
                    enable_pruning: bool = True) -> Optional[RelNode]:
    """The native optimizer's plan, or None when ``DSQL_NATIVE=0`` or
    ``serialize_plan`` refuses the plan (the caller runs the Python
    pipeline)."""
    from .. import native as _native

    if not _native.available():
        return None
    wire = serialize_plan(plan)
    if wire is None:
        return None
    envelope = _native.optimize_to_json(wire, enable_pruning)
    if "error" in envelope:
        raise RuntimeError(
            f"native optimizer: {envelope['error'].get('msg')}")
    return _rel_from_json(envelope["ok"])
