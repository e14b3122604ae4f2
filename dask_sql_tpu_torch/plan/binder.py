"""Binder/validator: AST -> typed logical plan.

Replaces the reference's Calcite validate + SqlToRelConverter step
(upstream planner/.../RelationalAlgebraGenerator.java:97-115) with a
native implementation: name resolution against the Context catalog, result
type inference, aggregate/window extraction, star expansion, subquery
de-correlation (uncorrelated IN/EXISTS -> SEMI/ANTI joins, scalar subqueries ->
eagerly-evaluated scalars), and ordinal/alias resolution in GROUP BY/ORDER BY.
"""
from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from ..types import (
    BIGINT, BOOLEAN, DATE, DOUBLE, INTEGER, INTERVAL_DAY_TIME,
    INTERVAL_YEAR_MONTH, NULLTYPE, SqlType, TIMESTAMP, TIME, VARCHAR,
    parse_type_name, promote, python_value_to_physical,
)
from ..utils import ValidationException
from ..sql import ast as A
from . import functions as F
from .nodes import (
    AggCall, Field, LogicalAggregate, LogicalExcept, LogicalFilter,
    LogicalIntersect, LogicalJoin, LogicalProject, LogicalSample, LogicalSort,
    LogicalTableScan, LogicalUnion, LogicalValues, LogicalWindow, RelNode,
    RexCall, RexInputRef, RexLiteral, RexNode, RexOuterRef,
    RexScalarSubquery, RexUdf,
    SortCollation, WindowCall, rex_inputs, shift_rex,
)


# ---------------------------------------------------------------------------
# Scope
# ---------------------------------------------------------------------------

@dataclass
class ScopeEntry:
    qualifier: Optional[str]
    name: str
    stype: SqlType
    hidden: bool = False   # e.g. right-side duplicate of a USING column


class Scope:
    def __init__(self, entries: List[ScopeEntry]):
        self.entries = entries

    @staticmethod
    def from_fields(fields: List[Field], qualifier: Optional[str]) -> "Scope":
        return Scope([ScopeEntry(qualifier, f.name, f.stype) for f in fields])

    def concat(self, other: "Scope") -> "Scope":
        return Scope(self.entries + other.entries)

    def resolve(self, parts: List[str]) -> Optional[int]:
        """Return ordinal for a (possibly qualified) column name, None if absent."""
        if len(parts) == 1:
            name = parts[0]
            hits = [i for i, e in enumerate(self.entries) if e.name == name and not e.hidden]
            if not hits:
                hits = [i for i, e in enumerate(self.entries)
                        if e.name.lower() == name.lower() and not e.hidden]
            if len(hits) > 1:
                # identical duplicated names: ambiguous
                raise ValidationException("", f"Column '{name}' is ambiguous")
            return hits[0] if hits else None
        qual, name = parts[-2], parts[-1]
        hits = [
            i for i, e in enumerate(self.entries)
            if e.qualifier is not None
            and e.qualifier.lower() == qual.lower()
            and (e.name == name or e.name.lower() == name.lower())
        ]
        if len(hits) > 1:
            exact = [i for i in hits if self.entries[i].name == name]
            if len(exact) == 1:
                return exact[0]
            raise ValidationException("", f"Column '{qual}.{name}' is ambiguous")
        return hits[0] if hits else None


# ---------------------------------------------------------------------------
# internal placeholder rex for aggregate / window calls found while binding
# ---------------------------------------------------------------------------

@dataclass
class RexAggPlaceholder(RexNode):
    op: str
    operands: List[RexNode]
    distinct: bool
    filter: Optional[RexNode]
    stype: SqlType
    udaf: Any = None


@dataclass
class RexWindowPlaceholder(RexNode):
    op: str
    operands: List[RexNode]
    partition: List[RexNode]
    order: List[Tuple[RexNode, bool, Optional[bool]]]
    frame: Optional[tuple]
    stype: SqlType


def _rex_equal(a: RexNode, b: RexNode) -> bool:
    if type(a) is not type(b):
        return False
    if isinstance(a, RexInputRef):
        return a.index == b.index
    if isinstance(a, RexLiteral):
        return a.value == b.value and a.stype.name == b.stype.name
    if isinstance(a, RexCall):
        return (a.op == b.op and a.info == b.info and len(a.operands) == len(b.operands)
                and all(_rex_equal(x, y) for x, y in zip(a.operands, b.operands)))
    return a is b


def _contains_placeholder(rex: RexNode, cls) -> bool:
    if isinstance(rex, cls):
        return True
    if isinstance(rex, (RexCall, RexUdf)):
        return any(_contains_placeholder(o, cls) for o in rex.operands)
    if isinstance(rex, RexAggPlaceholder):
        return any(_contains_placeholder(o, cls) for o in rex.operands)
    return False


# ---------------------------------------------------------------------------
# AST helpers
# ---------------------------------------------------------------------------

def _ast_contains_agg(e: A.Expr, catalog) -> bool:
    if isinstance(e, A.Call):
        if e.over is None:
            name = e.op
            if F.is_aggregate(name):
                return True
            fd = catalog.get_function(getattr(e, "original_name", name))
            if fd is not None and fd.aggregation:
                return True
        return any(_ast_contains_agg(a, catalog) for a in e.args) or (
            e.filter is not None and _ast_contains_agg(e.filter, catalog)
        )
    for child in _ast_children(e):
        if _ast_contains_agg(child, catalog):
            return True
    return False


def _ast_children(e: A.Expr) -> List[A.Expr]:
    if isinstance(e, A.Call):
        return list(e.args)
    if isinstance(e, A.Case):
        out = []
        if e.operand:
            out.append(e.operand)
        for c, v in e.whens:
            out += [c, v]
        if e.else_:
            out.append(e.else_)
        return out
    if isinstance(e, A.Cast):
        return [e.expr]
    if isinstance(e, A.InList):
        return [e.expr] + list(e.values)
    if isinstance(e, A.Between):
        return [e.expr, e.low, e.high]
    if isinstance(e, A.Like):
        return [e.expr, e.pattern] + ([e.escape] if e.escape else [])
    if isinstance(e, A.IsNull):
        return [e.expr]
    if isinstance(e, A.IsBool):
        return [e.expr]
    if isinstance(e, A.IsDistinctFrom):
        return [e.left, e.right]
    if isinstance(e, A.Subquery):
        return [e.outer] if e.outer is not None else []
    return []


_INTERVAL_UNIT_MS = {
    "SECOND": 1000,
    "MINUTE": 60_000,
    "HOUR": 3_600_000,
    "DAY": 86_400_000,
    "WEEK": 7 * 86_400_000,
    "MILLISECOND": 1,
}


# ===========================================================================
# Binder
# ===========================================================================

class Binder:
    """Binds one statement. ``catalog`` is a Context-like object exposing
    resolve_table(parts) and get_function(name)."""

    def __init__(self, catalog, sql: str = "", outer_scope: Optional[Scope] = None,
                 params: Optional[list] = None):
        self.catalog = catalog
        self.sql = sql
        # positional parameter values for ?/$n markers (Context.sql(params=...)
        # and EXECUTE); None means "no parameters were supplied" — a marker
        # then stays a binding error exactly as before
        self.params = params
        self.cte_stack: List[Dict[str, RelNode]] = [{}]
        # enclosing query's scope for correlated subqueries: unresolved
        # columns become RexOuterRef and are eliminated by decorrelation
        self.outer_scope = outer_scope
        # SELECT-list correlated scalar subqueries decorrelated ahead of
        # expression binding: AST node id -> replacement rex
        self._select_sq_rex: Dict[int, RexNode] = {}

    def error(self, msg: str, node: Optional[A.Node] = None):
        pos = getattr(node, "pos", (0, 0)) if node is not None else (0, 0)
        line, col = pos if pos != (0, 0) else (None, None)
        raise ValidationException(self.sql, msg, line, col)

    # ------------------------------------------------------------ entry point
    def bind(self, query: A.SelectLike) -> RelNode:
        return self.bind_query(query)

    def bind_query(self, q: A.SelectLike) -> RelNode:
        if isinstance(q, A.Select):
            return self.bind_select(q)
        if isinstance(q, A.SetOp):
            return self.bind_setop(q)
        if isinstance(q, A.ValuesQuery):
            return self.bind_values(q)
        self.error(f"Unsupported query node {type(q).__name__}", q)

    # ---------------------------------------------------------------- values
    def bind_values(self, q: A.ValuesQuery) -> RelNode:
        rows = []
        ncols = len(q.rows[0])
        col_types: List[SqlType] = [NULLTYPE] * ncols
        for row in q.rows:
            if len(row) != ncols:
                self.error("VALUES rows must have equal arity", q)
            bound_row = []
            for j, e in enumerate(row):
                rex = self.bind_expr(e, Scope([]))
                if not isinstance(rex, RexLiteral):
                    rex = _fold_to_literal(rex)
                    if rex is None:
                        self.error("VALUES must contain literals", e)
                bound_row.append(rex)
                col_types[j] = promote(col_types[j], rex.stype) if col_types[j].name != "NULL" or rex.stype.name != "NULL" else NULLTYPE
            rows.append(bound_row)
        fields = [Field(f"EXPR${j}", col_types[j] if col_types[j].name != "NULL" else INTEGER)
                  for j in range(ncols)]
        return LogicalValues(rows=rows, schema=fields)

    # ---------------------------------------------------------------- set ops
    def bind_setop(self, q: A.SetOp) -> RelNode:
        left = self.bind_query(q.left)
        right = self.bind_query(q.right)
        if len(left.schema) != len(right.schema):
            self.error(f"{q.op} inputs must have the same number of columns", q)
        fields = []
        for lf, rf in zip(left.schema, right.schema):
            fields.append(Field(lf.name, promote(lf.stype, rf.stype)))
        cls = {"UNION": LogicalUnion, "INTERSECT": LogicalIntersect,
               "EXCEPT": LogicalExcept}[q.op]
        plan: RelNode = cls(inputs_=[left, right], all=q.all, schema=fields)
        if q.order_by or q.limit is not None or q.offset is not None:
            scope = Scope.from_fields(fields, None)
            plan = self._apply_order_limit(plan, scope, q.order_by, q.limit,
                                           q.offset, output_fields=fields)
        return plan

    # ---------------------------------------------------------------- select
    def bind_select(self, q: A.Select) -> RelNode:
        # CTEs: later CTEs may reference earlier ones (frame mutated in order)
        if q.ctes:
            frame = dict(self.cte_stack[-1])
            self.cte_stack.append(frame)
            for name, cte_q in q.ctes:
                frame[name.lower()] = self.bind_query(cte_q)
        try:
            return self._bind_select_body(q)
        finally:
            if q.ctes:
                self.cte_stack.pop()

    def _bind_select_body(self, q: A.Select) -> RelNode:
        # ---- FROM
        if q.from_ is not None:
            plan, scope = self.bind_relation(q.from_)
        else:
            plan = LogicalValues(rows=[[RexLiteral(0, INTEGER)]],
                                 schema=[Field("__dummy__", INTEGER)])
            scope = Scope([ScopeEntry(None, "__dummy__", INTEGER, hidden=True)])

        # ---- WHERE (with subquery conjunct handling)
        if q.where is not None:
            plan, scope = self._apply_filter_with_subqueries(plan, scope, q.where)

        # ---- expand stars
        proj_items: List[Tuple[A.Expr, Optional[str]]] = []
        for e, alias in q.projections:
            if isinstance(e, A.Star):
                for i, entry in enumerate(scope.entries):
                    if entry.hidden:
                        continue
                    if e.table is not None and (entry.qualifier or "").lower() != e.table.lower():
                        continue
                    proj_items.append((A.ColumnRef(parts=_entry_parts(entry)), entry.name))
                if not proj_items and e.table is not None:
                    self.error(f"Unknown table alias '{e.table}' in star", e)
            else:
                proj_items.append((e, alias))

        # ---- aggregate or plain
        has_agg = q.group_by is not None or any(
            _ast_contains_agg(e, self.catalog) for e, _ in proj_items
        ) or (q.having is not None and _ast_contains_agg(q.having, self.catalog))

        if has_agg:
            plan, out_fields, hidden_sort = self._bind_aggregate_query(plan, scope, q, proj_items)
        else:
            plan, out_fields, hidden_sort = self._bind_plain_query(plan, scope, q, proj_items)

        # ---- DISTINCT
        if q.distinct:
            n = len(out_fields)
            if hidden_sort:
                # distinct over visible columns only; hidden sort cols would
                # change semantics -> rebind without hidden (rare: DISTINCT +
                # ORDER BY non-output expr is invalid SQL anyway)
                self.error("SELECT DISTINCT with ORDER BY on non-output expression")
            plan = LogicalAggregate(input=plan, group_keys=list(range(n)), aggs=[],
                                    schema=list(plan.schema))

        # ---- ORDER BY / LIMIT / OFFSET
        plan = self._apply_order_limit(plan, Scope.from_fields(plan.schema, None),
                                       q.order_by, q.limit, q.offset,
                                       output_fields=out_fields,
                                       hidden_sort=hidden_sort,
                                       proj_items=proj_items)
        return plan

    # ------------------------------------------------------------- relations
    def bind_relation(self, rel: A.Relation) -> Tuple[RelNode, Scope]:
        if isinstance(rel, A.TableRef):
            return self._bind_table_ref(rel)
        if isinstance(rel, A.SubqueryRelation):
            plan = self.bind_query(rel.query)
            names = rel.column_aliases or [f.name for f in plan.schema]
            if rel.column_aliases:
                if len(names) != len(plan.schema):
                    self.error("Column alias count mismatch", rel)
                plan = LogicalProject(
                    input=plan,
                    exprs=[RexInputRef(i, f.stype) for i, f in enumerate(plan.schema)],
                    schema=[Field(n, f.stype) for n, f in zip(names, plan.schema)],
                )
            scope = Scope([ScopeEntry(rel.alias, n, f.stype)
                           for n, f in zip(names, plan.schema)])
            return plan, scope
        if isinstance(rel, A.JoinRelation):
            return self._bind_join(rel)
        if isinstance(rel, A.PredictRelation):
            return self._bind_predict(rel)
        self.error(f"Unsupported relation {type(rel).__name__}", rel)

    def _bind_table_ref(self, rel: A.TableRef) -> Tuple[RelNode, Scope]:
        # CTE?
        if len(rel.parts) == 1:
            cte = self.cte_stack[-1].get(rel.parts[0].lower())
            if cte is not None:
                alias = rel.alias or rel.parts[0]
                plan = cte
                scope = Scope.from_fields(plan.schema, alias)
                if rel.sample:
                    plan, scope = self._apply_sample(plan, scope, rel.sample)
                return plan, scope
        resolved = self.catalog.resolve_table(rel.parts)
        if resolved is None:
            self.error(f"Table '{'.'.join(rel.parts)}' not found", rel)
        schema_name, table_name, fields, view_plan = resolved
        if view_plan is not None:
            plan: RelNode = view_plan
        else:
            plan = LogicalTableScan(schema_name=schema_name, table_name=table_name,
                                    schema=fields)
        alias = rel.alias or rel.parts[-1]
        names = rel.column_aliases or [f.name for f in fields]
        scope = Scope([ScopeEntry(alias, n, f.stype) for n, f in zip(names, fields)])
        if rel.sample:
            plan, scope = self._apply_sample(plan, scope, rel.sample)
        return plan, scope

    def _apply_sample(self, plan, scope, sample):
        method, pct, seed = sample
        plan = LogicalSample(input=plan, method=method, percentage=pct, seed=seed,
                             schema=list(plan.schema))
        return plan, scope

    def _bind_predict(self, rel: A.PredictRelation) -> Tuple[RelNode, Scope]:
        from .nodes import RelNode as _R  # local import for type only
        inner = self.bind_query(rel.query)
        model_info = self.catalog.resolve_model(rel.model)
        if model_info is None:
            self.error(f"Model '{'.'.join(rel.model)}' not found", rel)
        # schema = inner schema + "target" prediction column
        from .predict import LogicalPredict  # deferred to avoid cycle
        fields = list(inner.schema) + [Field("target", DOUBLE)]
        plan = LogicalPredict(input=inner, model_name=rel.model, schema=fields)
        alias = rel.alias or "PREDICT"
        return plan, Scope.from_fields(fields, alias)

    def _bind_join(self, rel: A.JoinRelation) -> Tuple[RelNode, Scope]:
        left_plan, left_scope = self.bind_relation(rel.left)
        right_plan, right_scope = self.bind_relation(rel.right)
        combined = left_scope.concat(right_scope)
        nl = len(left_scope.entries)

        using_cols: Optional[List[str]] = None
        if rel.using == "NATURAL":
            lnames = [e.name for e in left_scope.entries if not e.hidden]
            rnames = {e.name for e in right_scope.entries if not e.hidden}
            using_cols = [n for n in lnames if n in rnames]
        elif rel.using:
            using_cols = list(rel.using)

        condition: Optional[RexNode] = None
        if using_cols is not None:
            conds = []
            for c in using_cols:
                li = left_scope.resolve([c])
                ri = right_scope.resolve([c])
                if li is None or ri is None:
                    self.error(f"USING column '{c}' missing from join input", rel)
                lt = left_scope.entries[li].stype
                rt = right_scope.entries[ri].stype
                conds.append(RexCall("=", [RexInputRef(li, lt),
                                           RexInputRef(nl + ri, rt)], BOOLEAN))
                # hide the right-side duplicate from star expansion
                right_scope.entries[ri].hidden = True
            condition = _and_all(conds)
        elif rel.condition is not None:
            condition = self.bind_expr(rel.condition, combined)
            if _contains_placeholder(condition, RexAggPlaceholder):
                self.error("Aggregate functions not allowed in JOIN condition", rel)

        fields = [Field(e.name, e.stype) for e in combined.entries]
        # outer joins make the other side nullable
        jt = rel.join_type
        schema_fields = []
        for i, f in enumerate(fields):
            nullable = f.stype.nullable
            if jt in ("LEFT", "FULL") and i >= nl:
                nullable = True
            if jt in ("RIGHT", "FULL") and i < nl:
                nullable = True
            schema_fields.append(Field(f.name, f.stype.with_nullable(nullable)))
        plan = LogicalJoin(left=left_plan, right=right_plan, join_type=jt,
                           condition=condition, schema=schema_fields)
        return plan, combined

    # ------------------------------------------------------- filter/subquery
    def _apply_filter_with_subqueries(self, plan: RelNode, scope: Scope,
                                      where: A.Expr) -> Tuple[RelNode, Scope]:
        conjuncts = _split_conjuncts(where)
        plain: List[A.Expr] = []
        for c in conjuncts:
            handled, plan = self._try_bind_subquery_conjunct(plan, scope, c)
            if not handled:
                plain.append(c)
        if plain:
            cond = self.bind_expr(_and_ast(plain), scope)
            if _contains_placeholder(cond, RexAggPlaceholder):
                self.error("Aggregate functions not allowed in WHERE", where)
            plan = LogicalFilter(input=plan, condition=cond, schema=list(plan.schema))
        return plan, scope

    # --------------------------------------------------- correlated scalar
    def _bind_correlated_scalar_cmp(self, plan: RelNode, scope: Scope,
                                    op: str, other_ast: A.Expr,
                                    sq: A.Subquery) -> Tuple[bool, RelNode]:
        """Decorrelate ``expr <op> (SELECT agg(..) FROM .. WHERE k = outer.k)``
        into an INNER join against the subquery aggregated BY the correlation
        keys, plus a comparison filter (the classic rewrite; the reference
        gets it from Calcite's SubQueryRemoveRule). Empty groups vanish from
        the grouped aggregate, which matches NULL-compares-false semantics
        for a WHERE conjunct."""
        sub = Binder(self.catalog, self.sql, outer_scope=scope,
                             params=self.params)
        sub.cte_stack = self.cte_stack[:]
        sub_plan = sub.bind_query(sq.query)
        if len(sub_plan.schema) != 1:
            self.error("Scalar subquery must return one column", sq)
        if not _plan_has_outer(sub_plan):
            # uncorrelated: reuse this bind instead of discarding it (the
            # generic path would re-bind the whole subquery from scratch)
            lhs = self.bind_expr(other_ast, scope)
            t = sub_plan.schema[0].stype.with_nullable(True)
            cmp = RexCall(op, [lhs, RexScalarSubquery(sub_plan, t)], BOOLEAN)
            return True, LogicalFilter(input=plan, condition=cmp,
                                       schema=list(plan.schema))

        sub2, pairs, needed, count_like = self._decorrelate_scalar_agg(
            sub_plan, sq)
        nk = len(needed)

        nl = len(plan.schema)
        inner_of = {ii: pos for pos, ii in enumerate(needed)}
        cond: Optional[RexNode] = None
        for oi, ii, styp in pairs:
            eq = RexCall("=", [
                RexInputRef(oi, scope.entries[oi].stype),
                RexInputRef(nl + inner_of[ii], styp)], BOOLEAN)
            cond = eq if cond is None else RexCall("AND", [cond, eq], BOOLEAN)
        joined = LogicalJoin(left=plan, right=sub2,
                             join_type="LEFT" if count_like else "INNER",
                             condition=cond,
                             schema=list(plan.schema) + list(sub2.schema))
        lhs = self.bind_expr(other_ast, scope)  # left columns keep positions
        val: RexNode = RexInputRef(nl + nk, sub2.schema[-1].stype)
        if count_like:
            val = RexCall("COALESCE", [val, RexLiteral(0, val.stype)],
                          val.stype)
        cmp = RexCall(op, [lhs, val], BOOLEAN)
        filt = LogicalFilter(input=joined, condition=cmp,
                             schema=list(joined.schema))
        out = LogicalProject(
            input=filt,
            exprs=[RexInputRef(i, f.stype) for i, f in enumerate(plan.schema)],
            schema=list(plan.schema))
        return True, out

    def _decorrelate_scalar_agg(self, sub_plan: RelNode, sq: A.Subquery):
        """Shared core of the correlated scalar-aggregate rewrite: turn a
        whole-table-aggregate subquery correlated by equality predicates
        into a grouped aggregate keyed by the correlation columns.
        Returns ``(sub2, pairs, needed, count_like)``: the grouped subplan
        (schema = correlation keys + original outputs), the (outer idx,
        inner idx, type) equality pairs, the distinct inner key ordinals,
        and whether the aggregate is COUNT-shaped (0, not NULL, over an
        empty group — callers must LEFT-join + COALESCE)."""
        # peel output projections above the aggregate (e.g. 0.2 * AVG(x))
        projects: List[LogicalProject] = []
        core = sub_plan
        while isinstance(core, LogicalProject):
            if any(_rex_has_outer(e) for e in core.exprs):
                self.error("Unsupported correlated subquery "
                           "(correlation outside WHERE)", sq)
            projects.append(core)
            core = core.input
        if not isinstance(core, LogicalAggregate) or core.group_keys:
            self.error("Unsupported correlated scalar subquery "
                       "(expected a whole-table aggregate)", sq)

        # walk through the agg-argument projection chain to the filter
        chain: List[LogicalProject] = []
        node = core.input
        while isinstance(node, LogicalProject):
            if any(_rex_has_outer(e) for e in node.exprs):
                self.error("Unsupported correlated subquery "
                           "(correlation outside WHERE)", sq)
            chain.append(node)
            node = node.input
        node2, corr = _extract_correlated(node, self, sq)

        pairs: List[Tuple[int, int, SqlType]] = []  # (outer idx, inner idx)
        for cj in corr:
            o = i = None
            if (isinstance(cj, RexCall) and cj.op == "="
                    and len(cj.operands) == 2):
                a, b = cj.operands
                if isinstance(a, RexInputRef) and isinstance(b, RexOuterRef):
                    o, i = b, a
                elif isinstance(a, RexOuterRef) and isinstance(b, RexInputRef):
                    o, i = a, b
            if o is None:
                self.error("Unsupported correlated subquery predicate "
                           "(only equality correlation)", sq)
            pairs.append((o.index, i.index, i.stype))
        if not pairs:
            self.error("Unsupported correlated subquery", sq)
        needed: List[int] = []
        for _, ii, _t in pairs:
            if ii not in needed:
                needed.append(ii)

        # thread the correlation keys up through the projection chain
        cur: RelNode = node2
        key_pos = list(needed)
        for P in reversed(chain):
            exprs = list(P.exprs) + [
                RexInputRef(k, cur.schema[k].stype) for k in key_pos]
            fields = list(P.schema) + [
                Field(cur.schema[k].name, cur.schema[k].stype)
                for k in key_pos]
            base = len(P.exprs)
            cur = LogicalProject(input=cur, exprs=exprs, schema=fields)
            key_pos = [base + j for j in range(len(needed))]

        key_fields = [Field(cur.schema[k].name, cur.schema[k].stype)
                      for k in key_pos]
        agg2 = LogicalAggregate(input=cur, group_keys=list(key_pos),
                                aggs=core.aggs,
                                schema=key_fields + list(core.schema))
        sub2: RelNode = agg2
        nk = len(key_pos)
        for P in reversed(projects):
            exprs = ([RexInputRef(j, f.stype)
                      for j, f in enumerate(key_fields)]
                     + [shift_rex(e, nk) for e in P.exprs])
            sub2 = LogicalProject(input=sub2, exprs=exprs,
                                  schema=key_fields + list(P.schema))

        # COUNT-style aggregates are 0 over an empty set, not NULL: the
        # INNER-join rewrite would silently drop the no-match groups, so
        # those use a LEFT join + COALESCE(count, 0) — only sound when the
        # count is the subquery's direct output
        count_like = any(a.op in ("COUNT", "REGR_COUNT", "$SUM0")
                         for a in core.aggs)
        trivial_projects = all(
            len(P.exprs) == 1 and isinstance(P.exprs[0], RexInputRef)
            for P in projects)
        if count_like and (not trivial_projects or len(core.aggs) != 1):
            self.error("Unsupported correlated COUNT subquery shape", sq)
        return sub2, pairs, needed, count_like

    def _decorrelate_select_subqueries(self, plan: RelNode, scope: Scope,
                                       proj_items) -> RelNode:
        """Correlated scalar-aggregate subqueries in the SELECT list:
        LEFT-join the grouped subplan on the correlation keys and remember
        the value column for bind_expr (postgres-class parity; the
        reference gets this from Calcite's SubQueryRemoveRule).  A missing
        group yields NULL (or 0 for COUNT via COALESCE) — exactly the
        scalar subquery's empty-result semantics."""
        for e, _alias in proj_items:
            for sq in _walk_scalar_subqueries(e):
                sub = Binder(self.catalog, self.sql, outer_scope=scope,
                             params=self.params)
                sub.cte_stack = self.cte_stack[:]
                sub_plan = sub.bind_query(sq.query)
                if not _plan_has_outer(sub_plan):
                    continue  # uncorrelated: the ordinary rex path handles it
                if len(sub_plan.schema) != 1:
                    self.error("Scalar subquery must return one column", sq)
                sub2, pairs, needed, count_like = \
                    self._decorrelate_scalar_agg(sub_plan, sq)
                nl = len(plan.schema)
                inner_of = {ii: pos for pos, ii in enumerate(needed)}
                cond: Optional[RexNode] = None
                for oi, ii, styp in pairs:
                    eq = RexCall("=", [
                        RexInputRef(oi, scope.entries[oi].stype),
                        RexInputRef(nl + inner_of[ii], styp)], BOOLEAN)
                    cond = (eq if cond is None
                            else RexCall("AND", [cond, eq], BOOLEAN))
                plan = LogicalJoin(
                    left=plan, right=sub2, join_type="LEFT", condition=cond,
                    schema=list(plan.schema) + list(sub2.schema))
                t = sub2.schema[-1].stype.with_nullable(True)
                val: RexNode = RexInputRef(nl + len(needed), t)
                if count_like:
                    val = RexCall("COALESCE",
                                  [val, RexLiteral(0, val.stype)], val.stype)
                self._select_sq_rex[id(sq)] = val
        return plan

    def _try_bind_subquery_conjunct(self, plan: RelNode, scope: Scope,
                                    c: A.Expr) -> Tuple[bool, RelNode]:
        negated = False
        inner = c
        if isinstance(inner, A.Call) and inner.op == "NOT" and len(inner.args) == 1:
            if isinstance(inner.args[0], A.Subquery):
                negated = True
                inner = inner.args[0]
        if not isinstance(inner, A.Subquery):
            # comparison against a correlated scalar-aggregate subquery:
            # expr <op> (SELECT agg(...) WHERE inner_col = outer_col ...)
            if (isinstance(inner, A.Call)
                    and inner.op in ("=", "<", ">", "<=", ">=", "<>")
                    and len(inner.args) == 2):
                for side, other in ((0, 1), (1, 0)):
                    sq = inner.args[side]
                    if isinstance(sq, A.Subquery) and sq.kind == "scalar":
                        handled, out = self._bind_correlated_scalar_cmp(
                            plan, scope, inner.op if side == 1 else
                            _flip_cmp(inner.op), inner.args[other], sq)
                        if handled:
                            return True, out
            return False, plan
        kind = inner.kind
        neg = negated != inner.negated
        if kind == "exists":
            sub = Binder(self.catalog, self.sql, outer_scope=scope,
                             params=self.params)
            sub.cte_stack = self.cte_stack[:]
            sub_plan = sub.bind_query(inner.query)
            jt = "ANTI" if neg else "SEMI"
            if _plan_has_outer(sub_plan):
                # correlated EXISTS: the correlated conjuncts of the
                # subquery's top filter become the SEMI/ANTI join condition
                core, corr = _extract_correlated(sub_plan, self, inner)
                nl = len(plan.schema)
                cond = _corr_join_condition(corr, nl)
                out = LogicalJoin(left=plan, right=core, join_type=jt,
                                  condition=cond, schema=list(plan.schema))
                return True, out
            out = LogicalJoin(left=plan, right=sub_plan, join_type=jt,
                              condition=RexLiteral(True, BOOLEAN),
                              schema=list(plan.schema))
            return True, out
        if kind in ("in", "any", "all"):
            sub = Binder(self.catalog, self.sql, params=self.params)
            sub.cte_stack = self.cte_stack[:]
            sub_plan = sub.bind_query(inner.query)
            if len(sub_plan.schema) != 1:
                self.error("Subquery in IN must return one column", inner)
            key = self.bind_expr(inner.outer, scope)
            if kind == "all":
                # x <op> ALL(sub) === NOT (x <inv-op> ANY(sub)) — rewrite via
                # min/max for orderable ops
                return self._bind_quantified_all(plan, scope, key, inner, sub_plan)
            if kind == "any" and inner.op not in ("=", None):
                return self._bind_quantified_any(plan, scope, key, inner, sub_plan)
            # IN / = ANY: semi/anti join on key equality
            nl = len(plan.schema)
            # key must be a column: append as hidden projection if not
            plan2, key_idx = self._ensure_column(plan, key)
            sub_t = sub_plan.schema[0].stype
            cond = RexCall("=", [RexInputRef(key_idx, key.stype),
                                 RexInputRef(len(plan2.schema), sub_t)], BOOLEAN)
            jt = "ANTI" if neg else "SEMI"
            out = LogicalJoin(left=plan2, right=sub_plan, join_type=jt,
                              condition=cond, schema=list(plan2.schema))
            # NOT IN null semantics are handled by the ANTI-join kernel
            # (null-aware flag lives on the plan node)
            out.null_aware = neg  # type: ignore[attr-defined]
            if len(plan2.schema) != len(plan.schema):
                out = LogicalProject(
                    input=out,
                    exprs=[RexInputRef(i, f.stype) for i, f in enumerate(plan.schema)],
                    schema=list(plan.schema),
                )
            return True, out
        return False, plan

    def _bind_quantified_all(self, plan, scope, key, inner, sub_plan):
        # x < ALL(sub) -> x < MIN(sub); x > ALL(sub) -> x > MAX(sub);
        # x <> ALL(sub) -> NOT IN
        op = inner.op
        if op == "<>":
            new = A.Subquery(query=inner.query, kind="in", outer=inner.outer, negated=True)
            return self._try_bind_subquery_conjunct(plan, scope, new)
        agg = {"<": "MIN", "<=": "MIN", ">": "MAX", ">=": "MAX", "=": None}.get(op)
        if agg is None:
            self.error(f"Unsupported ALL comparison {op}", inner)
        sub_t = sub_plan.schema[0].stype
        agg_plan = LogicalAggregate(
            input=sub_plan, group_keys=[],
            aggs=[AggCall(agg, [0], False, sub_t, "m")],
            schema=[Field("m", sub_t)],
        )
        rex = RexCall(op, [key, RexScalarSubquery(agg_plan, sub_t)], BOOLEAN)
        out = LogicalFilter(input=plan, condition=rex, schema=list(plan.schema))
        return True, out

    def _bind_quantified_any(self, plan, scope, key, inner, sub_plan):
        op = inner.op
        agg = {"<": "MAX", "<=": "MAX", ">": "MIN", ">=": "MIN"}.get(op)
        if agg is None:
            self.error(f"Unsupported ANY comparison {op}", inner)
        sub_t = sub_plan.schema[0].stype
        agg_plan = LogicalAggregate(
            input=sub_plan, group_keys=[],
            aggs=[AggCall(agg, [0], False, sub_t, "m")],
            schema=[Field("m", sub_t)],
        )
        rex = RexCall(op, [key, RexScalarSubquery(agg_plan, sub_t)], BOOLEAN)
        out = LogicalFilter(input=plan, condition=rex, schema=list(plan.schema))
        return True, out

    def _ensure_column(self, plan: RelNode, rex: RexNode) -> Tuple[RelNode, int]:
        if isinstance(rex, RexInputRef):
            return plan, rex.index
        exprs = [RexInputRef(i, f.stype) for i, f in enumerate(plan.schema)] + [rex]
        fields = list(plan.schema) + [Field("__key__", rex.stype)]
        return LogicalProject(input=plan, exprs=exprs, schema=fields), len(fields) - 1

    # ----------------------------------------------------------- plain select
    def _bind_plain_query(self, plan: RelNode, scope: Scope, q: A.Select,
                          proj_items) -> Tuple[RelNode, List[Field], int]:
        # correlated scalar subqueries in the SELECT list join their
        # grouped subplans onto `plan` first (scope positions are left-side
        # and stay valid; the final project drops the joined columns)
        plan = self._decorrelate_select_subqueries(plan, scope, proj_items)
        bound = []
        names = []
        for e, alias in proj_items:
            rex = self.bind_expr(e, scope)
            bound.append(rex)
            names.append(alias or _default_name(e, len(names)))
        # ORDER BY exprs that aren't plain outputs -> hidden extra projections
        hidden_exprs, hidden_names = self._hidden_sort_exprs(q.order_by, proj_items,
                                                            names, scope)
        all_exprs = bound + hidden_exprs
        # window extraction
        if any(_contains_placeholder(r, RexWindowPlaceholder) for r in all_exprs):
            plan, all_exprs = self._lower_windows(plan, all_exprs)
        fields = [Field(n, r.stype) for n, r in zip(names + hidden_names, all_exprs)]
        out = LogicalProject(input=plan, exprs=all_exprs, schema=fields)
        visible = [Field(n, r.stype) for n, r in zip(names, all_exprs[: len(names)])]
        return out, visible, len(hidden_exprs)

    def _hidden_sort_exprs(self, order_by, proj_items, out_names, scope):
        hidden_exprs, hidden_names = [], []
        for k in order_by:
            resolved = self._resolve_orderby_item(k.expr, proj_items, out_names)
            if resolved is not None:
                continue
            rex = self.bind_expr(k.expr, scope)
            hidden_exprs.append(rex)
            hidden_names.append(f"__sort_{len(hidden_names)}")
        return hidden_exprs, hidden_names

    def _resolve_orderby_item(self, e: A.Expr, proj_items, out_names) -> Optional[int]:
        """Ordinal into output fields if the ORDER BY item is an output column."""
        if isinstance(e, A.Literal) and isinstance(e.value, int):
            idx = e.value - 1
            if not (0 <= idx < len(out_names)):
                self.error(f"ORDER BY position {e.value} out of range", e)
            return idx
        if isinstance(e, A.ColumnRef) and len(e.parts) == 1:
            name = e.parts[0]
            if name in out_names:
                return out_names.index(name)
            low = [n.lower() for n in out_names]
            if name.lower() in low:
                return low.index(name.lower())
        # structural match with a projection expr
        for i, (pe, _) in enumerate(proj_items):
            if _ast_equal(e, pe):
                return i
        return None

    # ------------------------------------------------------------- aggregate
    def _bind_aggregate_query(self, plan: RelNode, scope: Scope, q: A.Select,
                              proj_items) -> Tuple[RelNode, List[Field], int]:
        out_names = [alias or _default_name(e, i) for i, (e, alias) in enumerate(proj_items)]

        # resolve GROUP BY items (ordinals, output aliases, expressions)
        group_ast: List[A.Expr] = []
        for g in (q.group_by or []):
            if isinstance(g, A.Literal) and isinstance(g.value, int):
                idx = g.value - 1
                if not (0 <= idx < len(proj_items)):
                    self.error(f"GROUP BY position {g.value} out of range", g)
                group_ast.append(proj_items[idx][0])
                continue
            if isinstance(g, A.ColumnRef) and len(g.parts) == 1 and scope.resolve(g.parts) is None:
                name = g.parts[0]
                cand = [i for i, n in enumerate(out_names) if n == name or n.lower() == name.lower()]
                if cand:
                    group_ast.append(proj_items[cand[0]][0])
                    continue
            group_ast.append(g)

        group_rex = [self.bind_expr(g, scope) for g in group_ast]

        # bind projections/having/order with agg placeholders
        bound_proj = [self.bind_expr(e, scope) for e, _ in proj_items]
        bound_having = self.bind_expr(q.having, scope) if q.having is not None else None
        hidden_rex: List[RexNode] = []
        for k in q.order_by:
            if self._resolve_orderby_item(k.expr, proj_items, out_names) is None:
                hidden_rex.append(self.bind_expr(k.expr, scope))

        # collect agg placeholders
        collector = _AggCollector(group_rex)
        post_proj = [collector.rewrite(r) for r in bound_proj]
        post_having = collector.rewrite(bound_having) if bound_having is not None else None
        post_hidden = [collector.rewrite(r) for r in hidden_rex]

        # validate: post exprs only reference agg-output ordinals
        # build pre-projection
        pre_exprs = collector.pre_exprs
        if not pre_exprs and plan.schema:
            # COUNT(*) with no group keys references no columns at all; keep
            # one input ref so the pre-projection still carries the row count
            # (a zero-column table has no length)
            pre_exprs = [RexInputRef(0, plan.schema[0].stype)]
        pre_fields = [Field(f"$f{i}", r.stype) for i, r in enumerate(pre_exprs)]
        pre = LogicalProject(input=plan, exprs=pre_exprs, schema=pre_fields)

        n_groups = len(collector.group_slots)
        agg_fields = [Field(f"$g{i}", pre_exprs[s].stype)
                      for i, s in enumerate(collector.group_slots)]
        agg_calls: List[AggCall] = []
        for i, ph in enumerate(collector.agg_calls):
            agg_calls.append(AggCall(
                op=ph.op, args=ph.arg_slots, distinct=ph.distinct, stype=ph.stype,
                name=f"$a{i}", filter_arg=ph.filter_slot, udaf=ph.udaf,
            ))
            agg_fields.append(Field(f"$a{i}", ph.stype))
        agg = LogicalAggregate(input=pre, group_keys=list(collector.group_slots),
                               aggs=agg_calls, schema=agg_fields)

        plan2: RelNode = agg
        if post_having is not None:
            plan2 = LogicalFilter(input=plan2, condition=post_having,
                                  schema=list(plan2.schema))

        all_post = post_proj + post_hidden
        if any(_contains_placeholder(r, RexWindowPlaceholder) for r in all_post):
            plan2, all_post = self._lower_windows(plan2, all_post)
        hidden_names = [f"__sort_{i}" for i in range(len(post_hidden))]
        fields = [Field(n, r.stype) for n, r in zip(out_names + hidden_names, all_post)]
        out = LogicalProject(input=plan2, exprs=all_post, schema=fields)
        visible = fields[: len(out_names)]
        return out, visible, len(post_hidden)

    # --------------------------------------------------------------- windows
    def _lower_windows(self, plan: RelNode, exprs: List[RexNode]):
        """Extract RexWindowPlaceholders: plan -> LogicalWindow, rewrite refs."""
        calls: List[WindowCall] = []
        extra_exprs: List[RexNode] = []   # computed inputs the window needs
        base_n = len(plan.schema)

        def slot_for(rex: RexNode) -> int:
            if isinstance(rex, RexInputRef):
                return rex.index
            for i, e in enumerate(extra_exprs):
                if _rex_equal(e, rex):
                    return base_n + i
            extra_exprs.append(rex)
            return base_n + len(extra_exprs) - 1

        win_slot_of: List[int] = []
        placeholders: List[RexWindowPlaceholder] = []

        def collect(r: RexNode):
            if isinstance(r, RexWindowPlaceholder):
                for o in r.operands:
                    collect(o)
                for p in r.partition:
                    collect(p)
                for o, _, _ in r.order:
                    collect(o)
                placeholders.append(r)
                return
            if isinstance(r, (RexCall, RexUdf)):
                for o in r.operands:
                    collect(o)

        for r in exprs:
            collect(r)

        # build input projection with extra computed columns
        for ph in placeholders:
            pass
        # ensure slots for everything (operands/partitions/orders)
        for ph in placeholders:
            arg_slots = [slot_for(o) for o in ph.operands]
            part_slots = [slot_for(p) for p in ph.partition]
            order_cols = [SortCollation(slot_for(o), asc, nf) for o, asc, nf in ph.order]
            calls.append(WindowCall(op=ph.op, args=arg_slots, partition=part_slots,
                                    order=order_cols, frame=ph.frame, stype=ph.stype,
                                    name=f"$w{len(calls)}"))
            win_slot_of.append(base_n + len(extra_exprs) + len(win_slot_of))

        if extra_exprs:
            proj_exprs = [RexInputRef(i, f.stype) for i, f in enumerate(plan.schema)] + extra_exprs
            proj_fields = list(plan.schema) + [Field(f"$we{i}", e.stype)
                                               for i, e in enumerate(extra_exprs)]
            plan = LogicalProject(input=plan, exprs=proj_exprs, schema=proj_fields)

        win_fields = list(plan.schema) + [Field(c.name, c.stype) for c in calls]
        plan = LogicalWindow(input=plan, calls=calls, schema=win_fields)

        # rewrite placeholders to refs
        ph_map = {}
        for i, ph in enumerate(placeholders):
            ph_map[id(ph)] = RexInputRef(len(plan.schema) - len(calls) + i, ph.stype)

        def rewrite(r: RexNode) -> RexNode:
            if isinstance(r, RexWindowPlaceholder):
                return ph_map[id(r)]
            if isinstance(r, RexCall):
                return RexCall(r.op, [rewrite(o) for o in r.operands], r.stype, r.info)
            if isinstance(r, RexUdf):
                return RexUdf(r.name, r.func, [rewrite(o) for o in r.operands],
                              r.stype, r.row_udf)
            return r

        return plan, [rewrite(r) for r in exprs]

    # ---------------------------------------------------------- order / limit
    def _apply_order_limit(self, plan: RelNode, scope: Scope, order_by,
                           limit_e, offset_e, output_fields: List[Field],
                           hidden_sort: int = 0, proj_items=None) -> RelNode:
        collation: List[SortCollation] = []
        n_visible = len(output_fields)
        hidden_used = 0
        out_names = [f.name for f in output_fields]
        for k in order_by:
            # MUST mirror the resolution the binder used when deciding which
            # keys get hidden sort columns (_hidden_sort_exprs), or the
            # hidden-column accounting below goes out of sync
            idx = self._resolve_orderby_item(k.expr, proj_items or [],
                                             out_names)
            if idx is None:
                # hidden sort columns were appended in order of unresolved keys
                idx = n_visible + hidden_used
                hidden_used += 1
                if idx >= len(plan.schema):
                    self.error("Cannot resolve ORDER BY expression", k.expr)
            collation.append(SortCollation(idx, k.ascending, k.nulls_first))

        limit = _const_int(limit_e) if limit_e is not None else None
        offset = _const_int(offset_e) if offset_e is not None else None

        if collation or limit is not None or offset is not None:
            plan = LogicalSort(input=plan, collation=collation, limit=limit,
                               offset=offset, schema=list(plan.schema))
        if hidden_sort:
            exprs = [RexInputRef(i, f.stype) for i, f in enumerate(plan.schema[:n_visible])]
            plan = LogicalProject(input=plan, exprs=exprs, schema=list(output_fields))
        return plan

    # ============================================================ expressions
    def bind_expr(self, e: A.Expr, scope: Scope) -> RexNode:
        if isinstance(e, A.Literal):
            return self._bind_literal(e)
        if isinstance(e, A.IntervalLiteral):
            return self._bind_interval(e)
        if isinstance(e, A.ColumnRef):
            idx = scope.resolve(e.parts)
            if idx is None:
                if self.outer_scope is not None:
                    oidx = self.outer_scope.resolve(e.parts)
                    if oidx is not None:
                        return RexOuterRef(oidx,
                                           self.outer_scope.entries[oidx].stype)
                self.error(f"Column '{'.'.join(e.parts)}' not found", e)
            return RexInputRef(idx, scope.entries[idx].stype)
        if isinstance(e, A.Star):
            self.error("* not allowed here", e)
        if isinstance(e, A.Call):
            return self._bind_call(e, scope)
        if isinstance(e, A.Case):
            return self._bind_case(e, scope)
        if isinstance(e, A.Cast):
            inner = self.bind_expr(e.expr, scope)
            target = parse_type_name(e.type_name, e.precision, e.scale)
            return RexCall("CAST", [inner], target, info=target)
        if isinstance(e, A.InList):
            expr = self.bind_expr(e.expr, scope)
            vals = [self.bind_expr(v, scope) for v in e.values]
            rex = RexCall("IN_LIST", [expr] + vals, BOOLEAN)
            if e.negated:
                return RexCall("NOT", [rex], BOOLEAN)
            return rex
        if isinstance(e, A.Between):
            x = self.bind_expr(e.expr, scope)
            lo = self.bind_expr(e.low, scope)
            hi = self.bind_expr(e.high, scope)
            if e.symmetric:
                cond = RexCall("OR", [
                    RexCall("AND", [RexCall(">=", [x, lo], BOOLEAN),
                                    RexCall("<=", [x, hi], BOOLEAN)], BOOLEAN),
                    RexCall("AND", [RexCall(">=", [x, hi], BOOLEAN),
                                    RexCall("<=", [x, lo], BOOLEAN)], BOOLEAN),
                ], BOOLEAN)
            else:
                cond = RexCall("AND", [RexCall(">=", [x, lo], BOOLEAN),
                                       RexCall("<=", [x, hi], BOOLEAN)], BOOLEAN)
            if e.negated:
                return RexCall("NOT", [cond], BOOLEAN)
            return cond
        if isinstance(e, A.Like):
            x = self.bind_expr(e.expr, scope)
            pat = self.bind_expr(e.pattern, scope)
            esc = self.bind_expr(e.escape, scope) if e.escape else None
            op = {"LIKE": "LIKE", "ILIKE": "ILIKE", "SIMILAR": "SIMILAR"}[e.kind]
            operands = [x, pat] + ([esc] if esc else [])
            rex = RexCall(op, operands, BOOLEAN)
            if e.negated:
                return RexCall("NOT", [rex], BOOLEAN)
            return rex
        if isinstance(e, A.IsNull):
            x = self.bind_expr(e.expr, scope)
            return RexCall("IS_NOT_NULL" if e.negated else "IS_NULL", [x],
                           SqlType("BOOLEAN", nullable=False))
        if isinstance(e, A.IsBool):
            x = self.bind_expr(e.expr, scope)
            base = "IS_TRUE" if e.value else "IS_FALSE"
            op = f"IS_NOT_{'TRUE' if e.value else 'FALSE'}" if e.negated else base
            return RexCall(op, [x], SqlType("BOOLEAN", nullable=False))
        if isinstance(e, A.IsDistinctFrom):
            l = self.bind_expr(e.left, scope)
            r = self.bind_expr(e.right, scope)
            op = "IS_NOT_DISTINCT_FROM" if e.negated else "IS_DISTINCT_FROM"
            return RexCall(op, [l, r], SqlType("BOOLEAN", nullable=False))
        if isinstance(e, A.Subquery):
            if e.kind == "scalar":
                pre = self._select_sq_rex.get(id(e))
                if pre is not None:
                    # decorrelated ahead of binding (SELECT-list position)
                    return pre
                # bind with the outer scope visible so a correlated subquery
                # in an unsupported position fails with a clear message, not
                # a phantom "column not found"
                sub = Binder(self.catalog, self.sql, outer_scope=scope,
                             params=self.params)
                sub.cte_stack = self.cte_stack[:]
                sub_plan = sub.bind_query(e.query)
                if _plan_has_outer(sub_plan):
                    self.error(
                        "Correlated scalar subqueries are only supported as "
                        "top-level WHERE comparison conjuncts", e)
                if len(sub_plan.schema) != 1:
                    self.error("Scalar subquery must return one column", e)
                t = sub_plan.schema[0].stype.with_nullable(True)
                return RexScalarSubquery(sub_plan, t)
            if e.kind == "exists":
                sub = Binder(self.catalog, self.sql, outer_scope=scope,
                             params=self.params)
                sub.cte_stack = self.cte_stack[:]
                sub_plan = sub.bind_query(e.query)
                if _plan_has_outer(sub_plan):
                    self.error(
                        "Correlated EXISTS is only supported as a top-level "
                        "WHERE conjunct", e)
                cnt = LogicalAggregate(
                    input=sub_plan, group_keys=[],
                    aggs=[AggCall("COUNT", [], False, BIGINT, "c")],
                    schema=[Field("c", BIGINT)],
                )
                rex = RexCall(">", [RexScalarSubquery(cnt, BIGINT),
                                    RexLiteral(0, BIGINT)], BOOLEAN)
                if e.negated:
                    return RexCall("NOT", [rex], BOOLEAN)
                return rex
            # IN in general expression position: build boolean via semi join is
            # not expressible -> only supported at top-level WHERE conjuncts
            self.error("IN/ANY subquery only supported in WHERE conjuncts", e)
        if isinstance(e, A.Param):
            if self.params is None:
                self.error("Positional parameters not supported without "
                           "bound values (pass params=[...] or use EXECUTE)", e)
            if not (0 <= e.index < len(self.params)):
                self.error(f"Parameter ${e.index + 1} has no bound value "
                           f"({len(self.params)} supplied)", e)
            return self._bind_param_value(self.params[e.index], e)
        self.error(f"Unsupported expression {type(e).__name__}", e)

    def _bind_param_value(self, v, node) -> RexLiteral:
        """A bound parameter value becomes an inline literal with the same
        python-type inference ``_bind_literal`` applies to parsed literals;
        the parameterization pass (plan/parameterize.py) then re-hoists
        eligible ones, so distinct values still share one compiled shape."""
        import datetime

        if v is None:
            return RexLiteral(None, NULLTYPE)
        if isinstance(v, bool):          # before int: bool is an int subclass
            return RexLiteral(v, SqlType("BOOLEAN", nullable=False))
        if isinstance(v, int):
            t = INTEGER if -(2**31) <= v < 2**31 else BIGINT
            return RexLiteral(v, t.with_nullable(False))
        if isinstance(v, float):
            return RexLiteral(v, SqlType("DOUBLE", nullable=False))
        if isinstance(v, str):
            return RexLiteral(v, SqlType("VARCHAR", nullable=False))
        if isinstance(v, datetime.datetime):
            return RexLiteral(python_value_to_physical(v, TIMESTAMP),
                              SqlType("TIMESTAMP", nullable=False))
        if isinstance(v, datetime.date):
            return RexLiteral(python_value_to_physical(v, DATE),
                              SqlType("DATE", nullable=False))
        if isinstance(v, datetime.time):
            return RexLiteral(python_value_to_physical(v, TIME),
                              SqlType("TIME", nullable=False))
        self.error(f"Unsupported parameter type {type(v).__name__}", node)

    def _bind_literal(self, e: A.Literal) -> RexLiteral:
        tn = e.type_name
        if tn == "BIGINT":
            v = e.value
            t = INTEGER if -(2**31) <= v < 2**31 else BIGINT
            return RexLiteral(v, t.with_nullable(False))
        if tn == "DOUBLE":
            return RexLiteral(float(e.value), SqlType("DOUBLE", nullable=False))
        if tn == "VARCHAR":
            return RexLiteral(e.value, SqlType("VARCHAR", nullable=False))
        if tn == "BOOLEAN":
            return RexLiteral(bool(e.value), SqlType("BOOLEAN", nullable=False))
        if tn == "NULL":
            return RexLiteral(None, NULLTYPE)
        if tn == "DATE":
            return RexLiteral(python_value_to_physical(e.value, DATE),
                              SqlType("DATE", nullable=False))
        if tn == "TIMESTAMP":
            return RexLiteral(python_value_to_physical(e.value, TIMESTAMP),
                              SqlType("TIMESTAMP", nullable=False))
        if tn == "TIME":
            return RexLiteral(python_value_to_physical(e.value, TIME),
                              SqlType("TIME", nullable=False))
        if tn == "SYMBOL":
            return RexLiteral(e.value, SqlType("SYMBOL", nullable=False))
        self.error(f"Unknown literal type {tn}", e)

    def _bind_interval(self, e: A.IntervalLiteral) -> RexLiteral:
        unit = e.unit
        if unit in ("YEAR", "MONTH", "QUARTER") or (e.to_unit in ("MONTH",)):
            months = 0
            if isinstance(e.value, str):
                # '1-2' YEAR TO MONTH
                y, m = e.value.split("-")
                months = int(y) * 12 + int(m)
            else:
                mult = {"YEAR": 12, "QUARTER": 3, "MONTH": 1}[unit]
                months = int(e.value * mult)
            return RexLiteral(months, SqlType("INTERVAL_YEAR_MONTH", nullable=False))
        if isinstance(e.value, str):
            # 'D HH:MM:SS' style compound — parse pieces
            ms = _parse_daytime_interval(e.value, unit, e.to_unit)
            return RexLiteral(ms, SqlType("INTERVAL_DAY_TIME", nullable=False))
        mult = _INTERVAL_UNIT_MS.get(unit)
        if mult is None:
            self.error(f"Unsupported interval unit {unit}", e)
        return RexLiteral(int(e.value * mult), SqlType("INTERVAL_DAY_TIME", nullable=False))

    def _bind_case(self, e: A.Case, scope: Scope) -> RexNode:
        operands: List[RexNode] = []
        if e.operand is not None:
            base = self.bind_expr(e.operand, scope)
            for cond, val in e.whens:
                c = RexCall("=", [base, self.bind_expr(cond, scope)], BOOLEAN)
                operands += [c, self.bind_expr(val, scope)]
        else:
            for cond, val in e.whens:
                operands += [self.bind_expr(cond, scope), self.bind_expr(val, scope)]
        if e.else_ is not None:
            operands.append(self.bind_expr(e.else_, scope))
        else:
            operands.append(RexLiteral(None, NULLTYPE))
        value_types = [operands[i].stype for i in range(1, len(operands), 2)]
        value_types.append(operands[-1].stype)
        out_t = F.infer_call_type("CASE", value_types)
        return RexCall("CASE", operands, out_t)

    def _bind_call(self, e: A.Call, scope: Scope) -> RexNode:
        op = e.op

        # window function?
        if e.over is not None:
            args = [self.bind_expr(a, scope) for a in e.args
                    if not isinstance(a, A.Star)]
            part = [self.bind_expr(p, scope) for p in e.over.partition_by]
            order = [(self.bind_expr(k.expr, scope), k.ascending, k.nulls_first)
                     for k in e.over.order_by]
            if F.is_window_only(op):
                stype = F.infer_agg_type(op, [a.stype for a in args] or [BIGINT])
            elif F.is_aggregate(op):
                stype = F.infer_agg_type(op, [a.stype for a in args] or [BIGINT])
            else:
                self.error(f"Function {op} cannot be used with OVER", e)
            return RexWindowPlaceholder(op=op, operands=args, partition=part,
                                        order=order, frame=e.over.frame, stype=stype)

        if F.is_window_only(op):
            self.error(f"Window function {op} requires OVER", e)

        # aggregate?
        if F.is_aggregate(op):
            if op == "COUNT" and len(e.args) == 1 and isinstance(e.args[0], A.Star):
                args: List[RexNode] = []
            else:
                args = [self.bind_expr(a, scope) for a in e.args]
            filt = self.bind_expr(e.filter, scope) if e.filter is not None else None
            stype = F.infer_agg_type(op, [a.stype for a in args] or [BIGINT])
            return RexAggPlaceholder(op=op, operands=args, distinct=e.distinct,
                                     filter=filt, stype=stype)

        # registered UDF / UDAF?
        fd = self.catalog.get_function(getattr(e, "original_name", op))
        if fd is not None:
            args = [self.bind_expr(a, scope) for a in e.args]
            if fd.aggregation:
                filt = self.bind_expr(e.filter, scope) if e.filter is not None else None
                return RexAggPlaceholder(op=fd.name, operands=args,
                                         distinct=e.distinct, filter=filt,
                                         stype=fd.return_type, udaf=fd)
            return RexUdf(fd.name, fd.func, args, fd.return_type, fd.row_udf)

        # scalar builtin
        args = [self.bind_expr(a, scope) for a in e.args]
        try:
            stype = F.infer_call_type(op, [a.stype for a in args])
        except KeyError:
            self.error(f"Unknown function or operator '{op}'", e)
        return RexCall(op, args, stype)


# ---------------------------------------------------------------------------
# aggregate collector
# ---------------------------------------------------------------------------

class _AggCollectedCall:
    def __init__(self, op, arg_slots, distinct, filter_slot, stype, udaf):
        self.op = op
        self.arg_slots = arg_slots
        self.distinct = distinct
        self.filter_slot = filter_slot
        self.stype = stype
        self.udaf = udaf


class _AggCollector:
    """Builds the pre-projection and rewrites post-agg expressions.

    Output ordinal layout after LogicalAggregate: group keys first (in the
    order of the GROUP BY clause), then one column per aggregate call.
    """

    def __init__(self, group_rex: List[RexNode]):
        self.pre_exprs: List[RexNode] = []
        self.group_slots: List[int] = []
        self.group_rex = group_rex
        self.agg_calls: List[_AggCollectedCall] = []
        for g in group_rex:
            self.group_slots.append(self._slot(g))

    def _slot(self, rex: RexNode) -> int:
        for i, e in enumerate(self.pre_exprs):
            if _rex_equal(e, rex):
                return i
        self.pre_exprs.append(rex)
        return len(self.pre_exprs) - 1

    def _agg_output(self, ph: RexAggPlaceholder) -> int:
        arg_slots = [self._slot(a) for a in ph.operands]
        filter_slot = self._slot(ph.filter) if ph.filter is not None else None
        for i, c in enumerate(self.agg_calls):
            if (c.op == ph.op and c.arg_slots == arg_slots and c.distinct == ph.distinct
                    and c.filter_slot == filter_slot and c.udaf is ph.udaf):
                return len(self.group_rex) + i
        self.agg_calls.append(_AggCollectedCall(ph.op, arg_slots, ph.distinct,
                                                filter_slot, ph.stype, ph.udaf))
        return len(self.group_rex) + len(self.agg_calls) - 1

    def rewrite(self, rex: RexNode) -> RexNode:
        # exact match with a group expression?
        for gi, g in enumerate(self.group_rex):
            if _rex_equal(rex, g):
                return RexInputRef(gi, g.stype)
        if isinstance(rex, RexAggPlaceholder):
            idx = self._agg_output(rex)
            return RexInputRef(idx, rex.stype)
        if isinstance(rex, RexWindowPlaceholder):
            return RexWindowPlaceholder(
                op=rex.op,
                operands=[self.rewrite(o) for o in rex.operands],
                partition=[self.rewrite(p) for p in rex.partition],
                order=[(self.rewrite(o), a, nf) for o, a, nf in rex.order],
                frame=rex.frame, stype=rex.stype,
            )
        if isinstance(rex, RexCall):
            return RexCall(rex.op, [self.rewrite(o) for o in rex.operands],
                           rex.stype, rex.info)
        if isinstance(rex, RexUdf):
            return RexUdf(rex.name, rex.func, [self.rewrite(o) for o in rex.operands],
                          rex.stype, rex.row_udf)
        if isinstance(rex, RexInputRef):
            raise ValidationException(
                "", f"Column ${rex.index} is neither grouped nor aggregated")
        return rex


# ---------------------------------------------------------------------------
# misc helpers
# ---------------------------------------------------------------------------

def _entry_parts(entry: ScopeEntry) -> List[str]:
    if entry.qualifier:
        return [entry.qualifier, entry.name]
    return [entry.name]


def _split_conjuncts(e: A.Expr) -> List[A.Expr]:
    if isinstance(e, A.Call) and e.op == "AND":
        return _split_conjuncts(e.args[0]) + _split_conjuncts(e.args[1])
    return [e]


def _and_ast(conjuncts: List[A.Expr]) -> A.Expr:
    out = conjuncts[0]
    for c in conjuncts[1:]:
        out = A.Call(op="AND", args=[out, c])
    return out


def _and_all(rexes: List[RexNode]) -> RexNode:
    out = rexes[0]
    for r in rexes[1:]:
        out = RexCall("AND", [out, r], BOOLEAN)
    return out


def _default_name(e: A.Expr, i: int) -> str:
    if isinstance(e, A.ColumnRef):
        return e.parts[-1]
    if isinstance(e, A.Cast) and isinstance(e.expr, A.ColumnRef):
        return e.expr.parts[-1]
    return f"EXPR${i}"


def _ast_equal(a: A.Expr, b: A.Expr) -> bool:
    if type(a) is not type(b):
        return False
    if isinstance(a, A.ColumnRef):
        return [p.lower() for p in a.parts] == [p.lower() for p in b.parts] or a.parts[-1].lower() == b.parts[-1].lower()
    if isinstance(a, A.Literal):
        return a.value == b.value
    if isinstance(a, A.Call):
        return a.op == b.op and len(a.args) == len(b.args) and all(
            _ast_equal(x, y) for x, y in zip(a.args, b.args))
    if isinstance(a, A.Cast):
        return a.type_name == b.type_name and _ast_equal(a.expr, b.expr)
    return False


def _const_int(e: A.Expr) -> int:
    if isinstance(e, A.Literal) and isinstance(e.value, int):
        return e.value
    if isinstance(e, A.Call) and e.op == "NEGATE":
        return -_const_int(e.args[0])
    raise ValidationException("", "LIMIT/OFFSET must be integer literals")


def _fold_to_literal(rex: RexNode) -> Optional[RexLiteral]:
    """Tiny constant folder for VALUES rows (e.g. -3, 1+1)."""
    if isinstance(rex, RexLiteral):
        return rex
    if isinstance(rex, RexCall) and all(isinstance(o, RexLiteral) for o in rex.operands):
        vals = [o.value for o in rex.operands]
        try:
            if rex.op == "NEGATE":
                return RexLiteral(-vals[0], rex.stype)
            if rex.op == "+":
                return RexLiteral(vals[0] + vals[1], rex.stype)
            if rex.op == "-":
                return RexLiteral(vals[0] - vals[1], rex.stype)
            if rex.op == "*":
                return RexLiteral(vals[0] * vals[1], rex.stype)
            if rex.op == "/":
                if rex.stype.is_integer:
                    return RexLiteral(int(vals[0] / vals[1]), rex.stype)
                return RexLiteral(vals[0] / vals[1], rex.stype)
            if rex.op == "CAST":
                return RexLiteral(vals[0], rex.stype)
        except Exception:
            return None
    return None


def _parse_daytime_interval(value: str, unit: str, to_unit: Optional[str]) -> int:
    """Parse compound day-time interval strings like '1 2:03:04.5'."""
    value = value.strip()
    sign = 1
    if value.startswith("-"):
        sign = -1
        value = value[1:]
    days = hours = minutes = 0
    seconds = 0.0
    if " " in value:
        d, rest = value.split(" ", 1)
        days = int(d)
        value = rest
    if ":" in value:
        parts = value.split(":")
        if unit == "HOUR" or (unit == "DAY" and days):
            pass
        nums = [float(p) for p in parts]
        if len(nums) == 3:
            hours, minutes, seconds = int(nums[0]), int(nums[1]), nums[2]
        elif len(nums) == 2:
            if unit in ("MINUTE",):
                minutes, seconds = int(nums[0]), nums[1]
            else:
                hours, minutes = int(nums[0]), int(nums[1])
    else:
        v = float(value)
        if unit == "DAY":
            days = int(v)
        elif unit == "HOUR":
            hours = int(v)
        elif unit == "MINUTE":
            minutes = int(v)
        else:
            seconds = v
    ms = (((days * 24 + hours) * 60 + minutes) * 60 + seconds) * 1000
    return sign * int(ms)


# ---------------------------------------------------------------------------
# correlated-subquery plan surgery (used by Binder decorrelation above)
# ---------------------------------------------------------------------------

def _rex_has_outer(rex: RexNode) -> bool:
    if isinstance(rex, RexOuterRef):
        return True
    if isinstance(rex, (RexCall, RexUdf)):
        return any(_rex_has_outer(o) for o in rex.operands)
    return False


def _node_rexes(node: RelNode) -> List[RexNode]:
    if isinstance(node, LogicalFilter):
        return [node.condition]
    if isinstance(node, LogicalProject):
        return list(node.exprs)
    if isinstance(node, LogicalJoin):
        return [node.condition] if node.condition is not None else []
    return []


def _plan_has_outer(plan: RelNode) -> bool:
    if any(_rex_has_outer(r) for r in _node_rexes(plan)):
        return True
    return any(_plan_has_outer(i) for i in plan.inputs)


def _walk_scalar_subqueries(e):
    """Yield scalar A.Subquery nodes inside an expression AST, without
    descending into subquery bodies (each body is bound by its own
    Binder; nested correlation resolves there)."""
    import dataclasses

    if isinstance(e, A.Subquery):
        if e.kind == "scalar":
            yield e
        return
    if not dataclasses.is_dataclass(e):
        return
    for f in dataclasses.fields(e):
        v = getattr(e, f.name, None)
        if isinstance(v, A.Node):
            yield from _walk_scalar_subqueries(v)
        elif isinstance(v, (list, tuple)):
            for item in v:
                if isinstance(item, A.Node):
                    yield from _walk_scalar_subqueries(item)


def _extract_correlated(plan: RelNode, binder: "Binder", node: A.Node):
    """Split the correlated conjuncts out of the plan's top filter(s).

    Returns (plan without the correlated conjuncts, [corr conjunct rex]).
    Correlation anywhere deeper than the top filter stack (join conditions,
    nested subplans, projections) is rejected — those shapes need general
    unnesting, which this engine does not implement (reference: Calcite
    handles them via CorrelationId plans)."""
    from .optimizer import _and_all, _split_conjuncts as _split_rex

    corr: List[RexNode] = []
    core = plan
    while isinstance(core, LogicalProject) and not any(
            _rex_has_outer(e) for e in core.exprs):
        # projections above the filter are irrelevant for EXISTS
        core = core.input
    while isinstance(core, LogicalFilter):
        conjs = _split_rex(core.condition)
        pure = [c for c in conjs if not _rex_has_outer(c)]
        corr.extend(c for c in conjs if _rex_has_outer(c))
        inp = core.input
        if pure:
            cond = _and_all(pure)
            core = LogicalFilter(input=inp, condition=cond,
                                 schema=list(inp.schema))
            break
        core = inp
    if _plan_has_outer(core):
        binder.error("Unsupported correlated subquery "
                     "(correlation below the top-level WHERE)", node)
    return core, corr


def _corr_join_condition(corr: List[RexNode], nl: int) -> RexNode:
    """Correlated conjuncts -> join condition: outer refs address the left
    side verbatim, inner refs shift past it."""
    def rewrite(r: RexNode) -> RexNode:
        if isinstance(r, RexOuterRef):
            return RexInputRef(r.index, r.stype)
        if isinstance(r, RexInputRef):
            return RexInputRef(r.index + nl, r.stype)
        if isinstance(r, RexCall):
            return RexCall(r.op, [rewrite(o) for o in r.operands],
                           r.stype, r.info)
        if isinstance(r, RexUdf):
            return RexUdf(r.name, r.func, [rewrite(o) for o in r.operands],
                          r.stype, r.row_udf)
        return r

    if not corr:
        return RexLiteral(True, BOOLEAN)
    out = rewrite(corr[0])
    for c in corr[1:]:
        out = RexCall("AND", [out, rewrite(c)], BOOLEAN)
    return out


_CMP_FLIP = {"=": "=", "<>": "<>", "<": ">", ">": "<", "<=": ">=", ">=": "<="}


def _flip_cmp(op: str) -> str:
    return _CMP_FLIP[op]
