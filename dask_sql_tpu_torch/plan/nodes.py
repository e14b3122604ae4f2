"""Logical relational algebra: the plan-node vocabulary the physical layer lowers.

Same node vocabulary as the reference's Calcite plans (SURVEY §2.2): TableScan,
Project, Filter, Aggregate, Join, Sort(+limit/offset), Union/Intersect/Except,
Values, Window, Sample — produced by our native binder instead of
Calcite's SqlToRelConverter.  Expressions are *bound* REX trees: input
references by ordinal, typed literals in physical representation, and calls
with inferred result types (reference's RexInputRef/RexLiteral/RexCall
handled in upstream dask_sql/physical/rex/core/).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

from ..types import SqlType


@dataclass(frozen=True)
class Field:
    name: str
    stype: SqlType


# ===========================================================================
# REX: bound expressions
# ===========================================================================

class RexNode:
    stype: SqlType


@dataclass
class RexInputRef(RexNode):
    index: int
    stype: SqlType

    def __repr__(self):
        return f"${self.index}"


@dataclass
class RexLiteral(RexNode):
    value: Any              # physical representation (or None for NULL)
    stype: SqlType

    def __repr__(self):
        return repr(self.value)


@dataclass
class RexParam(RexNode):
    """A literal hoisted into a runtime argument (plan/parameterize.py).

    Deliberately NOT a ``RexLiteral`` subclass: every site that bakes a
    literal's VALUE into a compiled trace or a shape-level fingerprint
    dispatches on ``isinstance(rex, RexLiteral)``, and a param must never
    take those branches — unknown rex kinds fail safe everywhere
    (``compiled._fp_rex`` raises Unsupported, ``result_cache._canon_rex``
    marks the plan volatile) until a site opts in explicitly.

    The node carries its CURRENT value, so any (sub)plan containing params
    can self-supply its bound-argument vector: the compiled path collects
    params in fingerprint-traversal order and passes the values as trailing
    scalar jit arguments, while the eager/SPMD paths (which key on values)
    simply read ``value`` like a literal.  ``slot`` is the hoisting pass's
    deterministic numbering over the whole plan — stable per shape."""
    slot: int
    value: Any
    stype: SqlType

    def __repr__(self):
        return f"?p{self.slot}={self.value!r}"


@dataclass
class RexCall(RexNode):
    op: str                 # canonical operator name, e.g. "+", "AND", "SUBSTRING"
    operands: List[RexNode]
    stype: SqlType
    # extra payload for special ops (EXTRACT field symbols, cast targets...)
    info: Any = None

    def __repr__(self):
        return f"{self.op}({', '.join(map(repr, self.operands))})"


@dataclass
class RexScalarSubquery(RexNode):
    plan: "RelNode"
    stype: SqlType

    def __repr__(self):
        return "$scalar_subquery"


@dataclass
class RexOuterRef(RexNode):
    """Column of the enclosing query inside a correlated subquery.

    Exists only transiently during binding: the binder's decorrelation
    rewrites (EXISTS -> SEMI/ANTI join condition, scalar aggregate
    comparison -> grouped-aggregate join) eliminate every occurrence; a
    surviving one is a binder bug and has no executor."""
    index: int = 0
    stype: SqlType = None

    def __repr__(self):
        return f"$outer{self.index}"


@dataclass
class RexUdf(RexNode):
    """A registered python scalar UDF call (Context.register_function)."""
    name: str
    func: Any
    operands: List[RexNode]
    stype: SqlType
    row_udf: bool = False

    def __repr__(self):
        return f"udf:{self.name}({', '.join(map(repr, self.operands))})"


# ===========================================================================
# Aggregate / window call descriptors
# ===========================================================================

@dataclass
class AggCall:
    op: str                     # SUM, COUNT, AVG, MIN, MAX, ...
    args: List[int]             # input column ordinals
    distinct: bool
    stype: SqlType
    name: str
    filter_arg: Optional[int] = None   # ordinal of a BOOLEAN filter column
    udaf: Any = None                   # registered custom aggregation


@dataclass
class SortCollation:
    index: int
    ascending: bool = True
    nulls_first: Optional[bool] = None  # None = postgres default

    @property
    def effective_nulls_first(self) -> bool:
        # Postgres: NULLS LAST for ASC, NULLS FIRST for DESC
        if self.nulls_first is None:
            return not self.ascending
        return self.nulls_first


@dataclass
class WindowCall:
    op: str                     # ROW_NUMBER, SUM, COUNT, MAX, MIN, FIRST_VALUE...
    args: List[int]
    partition: List[int]
    order: List[SortCollation]
    frame: Optional[Tuple[str, Tuple[str, Optional[int]], Tuple[str, Optional[int]]]]
    stype: SqlType
    name: str


# ===========================================================================
# REL: plan nodes
# ===========================================================================

class RelNode:
    schema: List[Field]

    @property
    def inputs(self) -> List["RelNode"]:
        return []

    def with_inputs(self, inputs: List["RelNode"]) -> "RelNode":
        raise NotImplementedError

    def node_name(self) -> str:
        return type(self).__name__

    def explain(self, indent: int = 0, annotate=None) -> str:
        """Indented plan tree.  ``annotate``, when given, is a callback
        ``node -> str`` whose non-empty return is appended to that node's
        line — EXPLAIN ANALYZE uses it to attach measured wall-time and
        row counts without the tree renderer knowing about telemetry."""
        line = ("  " * indent) + self._explain_line()
        if annotate is not None:
            suffix = annotate(self)
            if suffix:
                line += " " + suffix
        lines = [line]
        for child in self.inputs:
            lines.append(child.explain(indent + 1, annotate))
        return "\n".join(lines)

    def _explain_line(self) -> str:
        return self.node_name()


@dataclass
class LogicalTableScan(RelNode):
    schema_name: str
    table_name: str
    schema: List[Field] = field(default_factory=list)

    def _explain_line(self):
        return f"LogicalTableScan(table=[[{self.schema_name}, {self.table_name}]])"


@dataclass
class LogicalProject(RelNode):
    input: RelNode = None
    exprs: List[RexNode] = field(default_factory=list)
    schema: List[Field] = field(default_factory=list)

    @property
    def inputs(self):
        return [self.input]

    def with_inputs(self, inputs):
        return LogicalProject(inputs[0], self.exprs, self.schema)

    def _explain_line(self):
        cols = ", ".join(f"{f.name}=[{e!r}]" for f, e in zip(self.schema, self.exprs))
        return f"LogicalProject({cols})"


@dataclass
class LogicalFilter(RelNode):
    input: RelNode = None
    condition: RexNode = None
    schema: List[Field] = field(default_factory=list)

    @property
    def inputs(self):
        return [self.input]

    def with_inputs(self, inputs):
        return LogicalFilter(inputs[0], self.condition, self.schema)

    def _explain_line(self):
        return f"LogicalFilter(condition=[{self.condition!r}])"


@dataclass
class LogicalAggregate(RelNode):
    input: RelNode = None
    group_keys: List[int] = field(default_factory=list)
    aggs: List[AggCall] = field(default_factory=list)
    schema: List[Field] = field(default_factory=list)

    @property
    def inputs(self):
        return [self.input]

    def with_inputs(self, inputs):
        return LogicalAggregate(inputs[0], self.group_keys, self.aggs, self.schema)

    def _explain_line(self):
        aggs = ", ".join(
            f"{a.name}=[{a.op}({'DISTINCT ' if a.distinct else ''}{', '.join('$%d' % i for i in a.args)})]"
            for a in self.aggs
        )
        return f"LogicalAggregate(group=[{self.group_keys}], {aggs})"


@dataclass
class LogicalJoin(RelNode):
    left: RelNode = None
    right: RelNode = None
    join_type: str = "INNER"       # INNER | LEFT | RIGHT | FULL | CROSS | SEMI | ANTI
    condition: Optional[RexNode] = None   # over [left fields..., right fields...]
    schema: List[Field] = field(default_factory=list)

    @property
    def inputs(self):
        return [self.left, self.right]

    def with_inputs(self, inputs):
        out = LogicalJoin(inputs[0], inputs[1], self.join_type,
                          self.condition, self.schema)
        if hasattr(self, "null_aware"):
            out.null_aware = self.null_aware  # type: ignore[attr-defined]
        return out

    def _explain_line(self):
        return f"LogicalJoin(condition=[{self.condition!r}], joinType=[{self.join_type.lower()}])"


@dataclass
class LogicalSort(RelNode):
    """ORDER BY + LIMIT/OFFSET (Calcite folds fetch into Sort too)."""
    input: RelNode = None
    collation: List[SortCollation] = field(default_factory=list)
    limit: Optional[int] = None
    offset: Optional[int] = None
    schema: List[Field] = field(default_factory=list)

    @property
    def inputs(self):
        return [self.input]

    def with_inputs(self, inputs):
        return LogicalSort(inputs[0], self.collation, self.limit, self.offset, self.schema)

    def _explain_line(self):
        parts = []
        for c in self.collation:
            parts.append(f"sort0=[${c.index} {'ASC' if c.ascending else 'DESC'}]")
        if self.limit is not None:
            parts.append(f"fetch=[{self.limit}]")
        if self.offset is not None:
            parts.append(f"offset=[{self.offset}]")
        return f"LogicalSort({', '.join(parts)})"


@dataclass
class LogicalUnion(RelNode):
    inputs_: List[RelNode] = field(default_factory=list)
    all: bool = False
    schema: List[Field] = field(default_factory=list)

    @property
    def inputs(self):
        return list(self.inputs_)

    def with_inputs(self, inputs):
        return LogicalUnion(list(inputs), self.all, self.schema)

    def _explain_line(self):
        return f"LogicalUnion(all=[{self.all}])"


@dataclass
class LogicalIntersect(RelNode):
    inputs_: List[RelNode] = field(default_factory=list)
    all: bool = False
    schema: List[Field] = field(default_factory=list)

    @property
    def inputs(self):
        return list(self.inputs_)

    def with_inputs(self, inputs):
        return LogicalIntersect(list(inputs), self.all, self.schema)


@dataclass
class LogicalExcept(RelNode):
    inputs_: List[RelNode] = field(default_factory=list)
    all: bool = False
    schema: List[Field] = field(default_factory=list)

    @property
    def inputs(self):
        return list(self.inputs_)

    def with_inputs(self, inputs):
        return LogicalExcept(list(inputs), self.all, self.schema)


@dataclass
class LogicalValues(RelNode):
    rows: List[List[RexLiteral]] = field(default_factory=list)
    schema: List[Field] = field(default_factory=list)

    def _explain_line(self):
        return f"LogicalValues(tuples=[{len(self.rows)} rows])"


@dataclass
class LogicalWindow(RelNode):
    """Adds window-function result columns to the input schema."""
    input: RelNode = None
    calls: List[WindowCall] = field(default_factory=list)
    schema: List[Field] = field(default_factory=list)

    @property
    def inputs(self):
        return [self.input]

    def with_inputs(self, inputs):
        return LogicalWindow(inputs[0], self.calls, self.schema)

    def _explain_line(self):
        return f"LogicalWindow({', '.join(c.op for c in self.calls)})"


@dataclass
class LogicalSample(RelNode):
    input: RelNode = None
    method: str = "BERNOULLI"      # SYSTEM | BERNOULLI
    percentage: float = 100.0
    seed: Optional[int] = None
    schema: List[Field] = field(default_factory=list)

    @property
    def inputs(self):
        return [self.input]

    def with_inputs(self, inputs):
        return LogicalSample(inputs[0], self.method, self.percentage, self.seed, self.schema)

    def _explain_line(self):
        return f"LogicalSample(mode=[{self.method.lower()}], rate=[{self.percentage}])"


# ---------------------------------------------------------------------------
# rex utilities
# ---------------------------------------------------------------------------

def rex_inputs(rex: RexNode) -> List[int]:
    """All input ordinals referenced by a rex tree."""
    out: List[int] = []

    def walk(r: RexNode):
        if isinstance(r, RexInputRef):
            out.append(r.index)
        elif isinstance(r, (RexCall, RexUdf)):
            for o in r.operands:
                walk(o)

    walk(rex)
    return out


def shift_rex(rex: RexNode, delta: int, start: int = 0) -> RexNode:
    """Shift input refs >= start by delta (used when splicing plans)."""
    if isinstance(rex, RexInputRef):
        if rex.index >= start:
            return RexInputRef(rex.index + delta, rex.stype)
        return rex
    if isinstance(rex, RexCall):
        return RexCall(rex.op, [shift_rex(o, delta, start) for o in rex.operands],
                       rex.stype, rex.info)
    if isinstance(rex, RexUdf):
        return RexUdf(rex.name, rex.func, [shift_rex(o, delta, start) for o in rex.operands],
                      rex.stype, rex.row_udf)
    return rex


def remap_rex(rex: RexNode, mapping: dict) -> RexNode:
    """Rewrite input refs through an old->new ordinal mapping."""
    if isinstance(rex, RexInputRef):
        return RexInputRef(mapping[rex.index], rex.stype)
    if isinstance(rex, RexCall):
        return RexCall(rex.op, [remap_rex(o, mapping) for o in rex.operands],
                       rex.stype, rex.info)
    if isinstance(rex, RexUdf):
        return RexUdf(rex.name, rex.func, [remap_rex(o, mapping) for o in rex.operands],
                      rex.stype, rex.row_udf)
    return rex
