"""AST for the Postgres-ish SQL dialect plus the custom statement extensions.

Statement vocabulary mirrors the reference's grammar
(upstream planner/src/main/codegen/: create.ftl, model.ftl, show.ftl,
utils.ftl and the core Calcite grammar it extends): SELECT with joins /
group-by / having / window functions / order / limit / union, VALUES, plus the
17 custom statements (CREATE TABLE|VIEW [WITH|AS], CREATE|DROP|USE SCHEMA,
DROP TABLE, ANALYZE TABLE, SHOW SCHEMAS|TABLES|COLUMNS|MODELS, DESCRIBE MODEL,
CREATE MODEL, DROP MODEL, PREDICT, CREATE EXPERIMENT, EXPORT MODEL) and the
``key = value`` kwargs-dict syntax (ARRAY/MAP nesting, utils.ftl:1-136).

Every node keeps ``pos`` = (line, col) for caret-marked error messages.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple, Union


class Node:
    pos: Tuple[int, int] = (0, 0)


# ===========================================================================
# Expressions
# ===========================================================================

@dataclass
class Expr(Node):
    pass


@dataclass
class Literal(Expr):
    value: Any            # python value (int/float/str/bool/None/date...)
    type_name: str        # "INTEGER" | "DOUBLE" | "VARCHAR" | "BOOLEAN" | "NULL" | ...
    pos: Tuple[int, int] = (0, 0)


@dataclass
class IntervalLiteral(Expr):
    value: Any            # numeric magnitude or string like '1-2'
    unit: str             # DAY/HOUR/MINUTE/SECOND/MONTH/YEAR/WEEK...
    to_unit: Optional[str] = None
    pos: Tuple[int, int] = (0, 0)


@dataclass
class ColumnRef(Expr):
    parts: List[str]      # ["tbl", "col"] or ["col"]
    pos: Tuple[int, int] = (0, 0)

    @property
    def name(self) -> str:
        return self.parts[-1]


@dataclass
class Star(Expr):
    table: Optional[str] = None
    pos: Tuple[int, int] = (0, 0)


@dataclass
class Param(Expr):
    """Positional parameter: ``?`` (indexed left-to-right in statement
    order) or ``$n`` (1-based explicit index, stored 0-based)."""
    index: int = 0
    pos: Tuple[int, int] = (0, 0)


@dataclass
class WindowSpec(Node):
    partition_by: List[Expr] = field(default_factory=list)
    order_by: List["SortKey"] = field(default_factory=list)
    # frame: (kind, lo, hi) — kind in {"ROWS","RANGE"}; bounds are
    # ("UNBOUNDED_PRECEDING"|"PRECEDING"|"CURRENT"|"FOLLOWING"|"UNBOUNDED_FOLLOWING", n|None)
    frame: Optional[Tuple[str, Tuple[str, Optional[int]], Tuple[str, Optional[int]]]] = None


@dataclass
class Call(Expr):
    op: str               # canonical upper-case operator/function name
    args: List[Expr] = field(default_factory=list)
    distinct: bool = False
    filter: Optional[Expr] = None          # FILTER (WHERE ...)
    over: Optional[WindowSpec] = None      # OVER (...)
    pos: Tuple[int, int] = (0, 0)


@dataclass
class Case(Expr):
    operand: Optional[Expr]
    whens: List[Tuple[Expr, Expr]] = field(default_factory=list)
    else_: Optional[Expr] = None
    pos: Tuple[int, int] = (0, 0)


@dataclass
class Cast(Expr):
    expr: Expr = None
    type_name: str = ""
    precision: Optional[int] = None
    scale: Optional[int] = None
    pos: Tuple[int, int] = (0, 0)


@dataclass
class InList(Expr):
    expr: Expr = None
    values: List[Expr] = field(default_factory=list)
    negated: bool = False
    pos: Tuple[int, int] = (0, 0)


@dataclass
class Between(Expr):
    expr: Expr = None
    low: Expr = None
    high: Expr = None
    negated: bool = False
    symmetric: bool = False
    pos: Tuple[int, int] = (0, 0)


@dataclass
class Like(Expr):
    expr: Expr = None
    pattern: Expr = None
    escape: Optional[Expr] = None
    negated: bool = False
    kind: str = "LIKE"    # LIKE | ILIKE | SIMILAR
    pos: Tuple[int, int] = (0, 0)


@dataclass
class IsNull(Expr):
    expr: Expr = None
    negated: bool = False
    pos: Tuple[int, int] = (0, 0)


@dataclass
class IsBool(Expr):
    expr: Expr = None
    value: bool = True    # IS TRUE / IS FALSE
    negated: bool = False
    pos: Tuple[int, int] = (0, 0)


@dataclass
class IsDistinctFrom(Expr):
    left: Expr = None
    right: Expr = None
    negated: bool = False  # negated => IS NOT DISTINCT FROM
    pos: Tuple[int, int] = (0, 0)


@dataclass
class Subquery(Expr):
    query: "SelectLike" = None
    kind: str = "scalar"  # scalar | exists | in | any | all
    outer: Optional[Expr] = None   # for IN / quantified comparisons
    op: Optional[str] = None       # comparison op for ANY/ALL
    negated: bool = False
    pos: Tuple[int, int] = (0, 0)


# ===========================================================================
# Relations (FROM clause)
# ===========================================================================

@dataclass
class Relation(Node):
    pass


@dataclass
class TableRef(Relation):
    parts: List[str] = field(default_factory=list)  # [schema, table] or [table]
    alias: Optional[str] = None
    column_aliases: Optional[List[str]] = None
    sample: Optional[Tuple[str, float, Optional[int]]] = None  # (SYSTEM|BERNOULLI, pct, seed)
    pos: Tuple[int, int] = (0, 0)


@dataclass
class SubqueryRelation(Relation):
    query: "SelectLike" = None
    alias: Optional[str] = None
    column_aliases: Optional[List[str]] = None
    pos: Tuple[int, int] = (0, 0)


@dataclass
class JoinRelation(Relation):
    left: Relation = None
    right: Relation = None
    join_type: str = "INNER"   # INNER|LEFT|RIGHT|FULL|CROSS
    condition: Optional[Expr] = None
    using: Optional[List[str]] = None
    pos: Tuple[int, int] = (0, 0)


@dataclass
class PredictRelation(Relation):
    """``FROM PREDICT(MODEL name, <select>)`` — reference model.ftl:1-60."""
    model: List[str] = field(default_factory=list)
    query: "SelectLike" = None
    alias: Optional[str] = None
    pos: Tuple[int, int] = (0, 0)


# ===========================================================================
# Query statements
# ===========================================================================

@dataclass
class SortKey(Node):
    expr: Expr = None
    ascending: bool = True
    nulls_first: Optional[bool] = None   # None = dialect default (= NULLS LAST asc, FIRST desc like postgres)


@dataclass
class SelectLike(Node):
    """Base for things usable as a query body (Select, SetOp, ValuesQuery)."""


@dataclass
class Select(SelectLike):
    projections: List[Tuple[Expr, Optional[str]]] = field(default_factory=list)
    distinct: bool = False
    from_: Optional[Relation] = None
    where: Optional[Expr] = None
    group_by: Optional[List[Expr]] = None   # None = no GROUP BY clause
    having: Optional[Expr] = None
    order_by: List[SortKey] = field(default_factory=list)
    limit: Optional[Expr] = None
    offset: Optional[Expr] = None
    ctes: List[Tuple[str, "SelectLike"]] = field(default_factory=list)
    pos: Tuple[int, int] = (0, 0)


@dataclass
class SetOp(SelectLike):
    op: str = "UNION"     # UNION | INTERSECT | EXCEPT
    all: bool = False
    left: SelectLike = None
    right: SelectLike = None
    order_by: List[SortKey] = field(default_factory=list)
    limit: Optional[Expr] = None
    offset: Optional[Expr] = None
    pos: Tuple[int, int] = (0, 0)


@dataclass
class ValuesQuery(SelectLike):
    rows: List[List[Expr]] = field(default_factory=list)
    pos: Tuple[int, int] = (0, 0)


# ===========================================================================
# Custom / DDL statements  (reference: planner/src/main/java/com/dask/sql/parser/)
# ===========================================================================

@dataclass
class Statement(Node):
    pass


@dataclass
class QueryStatement(Statement):
    query: SelectLike = None


@dataclass
class PrepareStatement(Statement):
    """PREPARE name AS <query> — the query text is stored verbatim (and
    the parsed AST alongside) in the per-context registry; binding is
    deferred to EXECUTE so each execution binds fresh parameter values."""
    name: str = ""
    query: SelectLike = None
    sql: str = ""                 # original statement text (for system.prepared)
    num_params: int = 0
    pos: Tuple[int, int] = (0, 0)


@dataclass
class ExecuteStatement(Statement):
    """EXECUTE name [(expr, ...)] — args must be literals (possibly signed)."""
    name: str = ""
    params: List[Any] = field(default_factory=list)   # python values
    pos: Tuple[int, int] = (0, 0)


@dataclass
class DeallocateStatement(Statement):
    """DEALLOCATE [PREPARE] name | ALL"""
    name: Optional[str] = None    # None == ALL
    pos: Tuple[int, int] = (0, 0)


@dataclass
class CreateTable(Statement):
    """CREATE [OR REPLACE] TABLE [IF NOT EXISTS] name WITH (k = v, ...)"""
    name: List[str] = field(default_factory=list)
    kwargs: dict = field(default_factory=dict)
    if_not_exists: bool = False
    or_replace: bool = False
    pos: Tuple[int, int] = (0, 0)


@dataclass
class CreateTableAs(Statement):
    """CREATE [OR REPLACE] TABLE|VIEW [IF NOT EXISTS] name AS (query)"""
    name: List[str] = field(default_factory=list)
    query: SelectLike = None
    if_not_exists: bool = False
    or_replace: bool = False
    view: bool = False
    pos: Tuple[int, int] = (0, 0)


@dataclass
class DropTable(Statement):
    name: List[str] = field(default_factory=list)
    if_exists: bool = False
    pos: Tuple[int, int] = (0, 0)


@dataclass
class CreateMaterializedView(Statement):
    """CREATE [OR REPLACE] MATERIALIZED VIEW [IF NOT EXISTS] name AS (query)

    Unlike the lazy CREATE VIEW, the result is materialized eagerly and kept
    incrementally fresh against base-table appends (runtime/matview.py)."""
    name: List[str] = field(default_factory=list)
    query: SelectLike = None
    if_not_exists: bool = False
    or_replace: bool = False
    pos: Tuple[int, int] = (0, 0)


@dataclass
class DropMaterializedView(Statement):
    name: List[str] = field(default_factory=list)
    if_exists: bool = False
    pos: Tuple[int, int] = (0, 0)


@dataclass
class RefreshMaterializedView(Statement):
    name: List[str] = field(default_factory=list)
    pos: Tuple[int, int] = (0, 0)


@dataclass
class InsertInto(Statement):
    """INSERT INTO t [(col, ...)] VALUES (...) | <query> — the append path:
    rows land as a delta record on the table's epoch, not a bare tombstone."""
    table: List[str] = field(default_factory=list)
    columns: Optional[List[str]] = None
    query: SelectLike = None
    pos: Tuple[int, int] = (0, 0)


@dataclass
class CreateSchema(Statement):
    name: str = ""
    if_not_exists: bool = False
    or_replace: bool = False
    pos: Tuple[int, int] = (0, 0)


@dataclass
class DropSchema(Statement):
    name: str = ""
    if_exists: bool = False
    pos: Tuple[int, int] = (0, 0)


@dataclass
class UseSchema(Statement):
    name: str = ""
    pos: Tuple[int, int] = (0, 0)


@dataclass
class ShowSchemas(Statement):
    like: Optional[str] = None
    pos: Tuple[int, int] = (0, 0)


@dataclass
class ShowTables(Statement):
    schema: Optional[str] = None
    pos: Tuple[int, int] = (0, 0)


@dataclass
class ShowColumns(Statement):
    table: List[str] = field(default_factory=list)
    pos: Tuple[int, int] = (0, 0)


@dataclass
class ShowModels(Statement):
    pos: Tuple[int, int] = (0, 0)


@dataclass
class DescribeModel(Statement):
    name: List[str] = field(default_factory=list)
    pos: Tuple[int, int] = (0, 0)


@dataclass
class AnalyzeTable(Statement):
    table: List[str] = field(default_factory=list)
    columns: Optional[List[str]] = None
    pos: Tuple[int, int] = (0, 0)


@dataclass
class CreateModel(Statement):
    name: List[str] = field(default_factory=list)
    kwargs: dict = field(default_factory=dict)
    query: SelectLike = None
    if_not_exists: bool = False
    or_replace: bool = False
    pos: Tuple[int, int] = (0, 0)


@dataclass
class DropModel(Statement):
    name: List[str] = field(default_factory=list)
    if_exists: bool = False
    pos: Tuple[int, int] = (0, 0)


@dataclass
class CreateExperiment(Statement):
    name: List[str] = field(default_factory=list)
    kwargs: dict = field(default_factory=dict)
    query: SelectLike = None
    if_not_exists: bool = False
    or_replace: bool = False
    pos: Tuple[int, int] = (0, 0)


@dataclass
class ExportModel(Statement):
    name: List[str] = field(default_factory=list)
    kwargs: dict = field(default_factory=dict)
    pos: Tuple[int, int] = (0, 0)


@dataclass
class DescribeTable(Statement):
    table: List[str] = field(default_factory=list)
    pos: Tuple[int, int] = (0, 0)


@dataclass
class ExplainStatement(Statement):
    query: SelectLike = None
    # EXPLAIN ANALYZE: execute the query (instrumented per plan node) and
    # annotate the rendered tree with measured wall-time + row counts
    analyze: bool = False
    # EXPLAIN PROFILE: execute the query through the NORMAL engine path
    # and render the device-level profile (per-stage flops/bytes/ms,
    # per-device HBM, shard skew, collective bytes) captured on its spans
    profile: bool = False
    pos: Tuple[int, int] = (0, 0)
