"""Parameterized plan identity: hoist literals into runtime arguments.

A copy of ``dask_sql_tpu/plan/parameterize.py`` (pure plan code over
``plan/nodes.py``).  The same query shape with other constants (a
dashboard re-running TPC-H Q1 with another ``DELTA``) minted a new plan
fingerprint per literal, so each variant paid its own trace, warm-up and
CUDA-graph capture.  The split: specialize on structure, parameterize on
value.

This pass walks the OPTIMIZED plan and replaces eligible ``RexLiteral``
nodes with ``RexParam`` nodes.  A param fingerprints by position and type
only (``compiled._fp_rex`` emits ``P{i}:{TYPE}``), so every literal
variant of a shape shares one compiled program; the value rides as a
dtype-stable 0-d tensor appended after the table inputs; a CUDA
graph copies it into its own buffer before each replay.

Eligibility is deliberately narrow (v1):

- the literal is a DIRECT operand of a binary comparison
  (``= <> != < <= > >=``) whose other operand subtree contains at least
  one column reference — this guarantees the comparison broadcasts
  against a Column and never hits the both-scalar host branch
  (``ops.comparison``'s ``bool(fn(da, db))``), which would concretize a
  traced value;
- the literal's physical representation is numeric and non-NULL
  (integers, floats, DATE/TIMESTAMP/TIME micros/days).  Strings stay
  specialized: dictionary codes are resolved against the scan dictionary
  at trace time, so the code a string literal maps to is baked into the
  program.  Booleans and NULLs stay baked too (they steer trace-time
  simplifications).

Structure-changing literals are never touched: IN-list arity, LIMIT /
OFFSET counts (plain ints on LogicalSort, not rex), VALUES rows, scalar
subquery bodies, anything under a volatile call (RAND,
CURRENT_TIMESTAMP, ...) or a UDF.  The pass is idempotent — ``RexParam``
nodes pass through untouched — because the compiled path's degradation
ladder re-enters ``try_execute_compiled`` with an already-parameterized
plan.

``DSQL_PARAM_PLANS=0`` is the kill switch: the pass becomes the identity
and every fingerprint/cache key is bit-for-bit what it was before this
subsystem existed.
"""
from __future__ import annotations

import copy
import os
from typing import List, Tuple

from . import nodes as N

# binary comparisons whose literal operands are value-stable to hoist:
# the traced comparison is shape-generic in the scalar operand
PARAM_OPS = frozenset({"=", "<>", "!=", "<", "<=", ">", ">="})

# SqlType names whose physical representation is a plain numeric scalar
# (types.py): safe to pass as a 0-d program argument with a stable dtype
PARAM_TYPE_NAMES = frozenset({
    "TINYINT", "SMALLINT", "INTEGER", "BIGINT",
    "FLOAT", "REAL", "DOUBLE", "DECIMAL",
    "DATE", "TIMESTAMP", "TIME",
})

# mirrors result_cache.VOLATILE_OPS (no import: plan/ must not depend on
# runtime/) — a literal adjacent to one of these stays specialized, so a
# volatile expression can never be partially hoisted into a shared shape
_VOLATILE_OPS = frozenset({
    "RAND", "RANDOM", "RAND_INTEGER",
    "CURRENT_DATE", "CURRENT_TIMESTAMP", "NOW", "LOCALTIMESTAMP",
    "CURRENT_TIME", "LOCALTIME",
})


def param_plans_enabled() -> bool:
    """DSQL_PARAM_PLANS kill switch; default ON."""
    return os.environ.get("DSQL_PARAM_PLANS", "1") != "0"


def _eligible_literal(rex: N.RexNode) -> bool:
    return (isinstance(rex, N.RexLiteral)
            and rex.value is not None
            and not isinstance(rex.value, (bool, str))
            and isinstance(rex.value, (int, float))
            and rex.stype is not None
            and rex.stype.name in PARAM_TYPE_NAMES)


def _has_column_ref(rex: N.RexNode) -> bool:
    if isinstance(rex, N.RexInputRef):
        return True
    if isinstance(rex, (N.RexCall, N.RexUdf)):
        return any(_has_column_ref(o) for o in rex.operands)
    return False


def _contains_volatile(rex: N.RexNode) -> bool:
    if isinstance(rex, N.RexUdf):
        return True
    if isinstance(rex, N.RexCall):
        if rex.op in _VOLATILE_OPS:
            return True
        return any(_contains_volatile(o) for o in rex.operands)
    return False


class _Hoist:
    __slots__ = ("next_slot", "hoisted")

    def __init__(self):
        self.next_slot = 0
        self.hoisted = 0

    def param(self, lit: N.RexLiteral) -> N.RexParam:
        p = N.RexParam(self.next_slot, lit.value, lit.stype)
        self.next_slot += 1
        self.hoisted += 1
        return p


def _walk_rex(rex: N.RexNode, acc: _Hoist) -> N.RexNode:
    """Rewrite eligible literals under this expression; returns ``rex``
    itself when nothing below changed."""
    if not isinstance(rex, N.RexCall):
        # literals NOT in an eligible comparison position stay baked;
        # scalar-subquery plans and UDFs stay specialized wholesale
        return rex
    if rex.op in _VOLATILE_OPS:
        return rex
    if (rex.op in PARAM_OPS and len(rex.operands) == 2
            and not any(_contains_volatile(o) for o in rex.operands)):
        a, b = rex.operands
        new_a, new_b = a, b
        if _eligible_literal(a) and _has_column_ref(b):
            new_a = acc.param(a)
        else:
            new_a = _walk_rex(a, acc)
        if _eligible_literal(b) and _has_column_ref(a):
            new_b = acc.param(b)
        else:
            new_b = _walk_rex(b, acc)
        if new_a is a and new_b is b:
            return rex
        return N.RexCall(rex.op, [new_a, new_b], rex.stype, rex.info)
    new_ops = [_walk_rex(o, acc) for o in rex.operands]
    if all(n is o for n, o in zip(new_ops, rex.operands)):
        return rex
    return N.RexCall(rex.op, new_ops, rex.stype, rex.info)


def _walk_rel(rel: N.RelNode, acc: _Hoist) -> N.RelNode:
    kids = rel.inputs
    new_kids = [_walk_rel(k, acc) for k in kids]
    changed = any(n is not o for n, o in zip(new_kids, kids))

    # only these three node kinds carry hoistable expressions; everything
    # else (Aggregate args, Sort limits, Values rows, Window frames) is
    # structure and stays specialized
    if isinstance(rel, N.LogicalFilter):
        cond = _walk_rex(rel.condition, acc)
        if cond is not rel.condition or changed:
            out = copy.copy(rel)
            out.input = new_kids[0]
            out.condition = cond
            return out
        return rel
    if isinstance(rel, N.LogicalProject):
        exprs = [_walk_rex(e, acc) for e in rel.exprs]
        if changed or any(n is not o for n, o in zip(exprs, rel.exprs)):
            out = copy.copy(rel)
            out.input = new_kids[0]
            out.exprs = exprs
            return out
        return rel
    if isinstance(rel, N.LogicalJoin):
        cond = (None if rel.condition is None
                else _walk_rex(rel.condition, acc))
        if cond is not rel.condition or changed:
            # copy.copy keeps dynamically-attached verdicts (null_aware)
            out = copy.copy(rel)
            out.left, out.right = new_kids
            out.condition = cond
            return out
        return rel
    if changed:
        return rel.with_inputs(new_kids)
    return rel


def parameterize_plan(plan: N.RelNode) -> Tuple[N.RelNode, int]:
    """(rewritten plan, number of literals hoisted THIS call).

    Idempotent: a second pass over the result hoists nothing (RexParam is
    not RexLiteral), so re-entrant callers (the whole→stages degradation
    rung) never double-count or renumber."""
    acc = _Hoist()
    new = _walk_rel(plan, acc)
    return new, acc.hoisted


def collect_params(plan: N.RelNode) -> List[N.RexParam]:
    """Every RexParam in this (sub)plan, ordered by slot.

    Diagnostic/introspection helper — the compiled path orders its
    bound-argument vector by FINGERPRINT traversal instead
    (``compiled._fp_plan`` collects params as it serializes), so the arg
    order and the ``P{i}`` positions in the key can never disagree."""
    out: List[N.RexParam] = []
    seen: set = set()

    def rex(r: N.RexNode):
        if isinstance(r, N.RexParam):
            if id(r) not in seen:
                seen.add(id(r))
                out.append(r)
        elif isinstance(r, (N.RexCall, N.RexUdf)):
            for o in r.operands:
                rex(o)
        elif isinstance(r, N.RexScalarSubquery):
            rel(r.plan)

    def rel(node: N.RelNode):
        if isinstance(node, N.LogicalProject):
            for e in node.exprs:
                rex(e)
        elif isinstance(node, N.LogicalFilter):
            rex(node.condition)
        elif isinstance(node, N.LogicalJoin) and node.condition is not None:
            rex(node.condition)
        for k in node.inputs:
            rel(k)

    rel(plan)
    out.sort(key=lambda p: p.slot)
    return out
