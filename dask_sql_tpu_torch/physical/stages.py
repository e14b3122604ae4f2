"""Stage-graph partitioning: bound the size of every compiled program.

A copy of ``dask_sql_tpu/physical/stages.py``.  There the budget exists
for XLA:TPU compile time, which grows superlinearly with the fused
join/aggregate pipelines of one program; the port keeps the partition
unchanged, so that both packages cut the same plans into the same stages
(and count the same compiles), and each stage is its own program: one
trace, warm-up and CUDA-graph capture, its output materialized into a
padded capacity-class table between stages (``physical/compiled.py``).

The partitioner is a pure bottom-up greedy walk and therefore
deterministic and ancestor-independent: the cuts inside a subtree depend
only on that subtree, so two queries sharing a subplan produce identical
stage plans for the shared part, and their stage programs share one cache
entry (counted as ``cross_query_hits``).

Heavy-node weights: joins, grouped aggregates and windows weigh 1; a
SEMI/ANTI join with a non-equi residual weighs 2.  A single node can
therefore exceed a budget of 1: the bound every program satisfies is
``max(budget, max node weight)``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from ..plan.nodes import LogicalAggregate, LogicalJoin, LogicalWindow, RelNode

#: Heavy-node budget per compiled program, the JAX package's default;
#: override with ``DSQL_STAGE_HEAVY`` (or the legacy ``DSQL_SPLIT_HEAVY``).
DEFAULT_STAGE_HEAVY = 6


def stage_budget(override: Optional[int] = None) -> int:
    """The heavy-node budget: explicit override > env knobs > default."""
    import os

    if override is not None:
        return max(1, int(override))
    for var in ("DSQL_STAGE_HEAVY", "DSQL_SPLIT_HEAVY"):
        v = os.environ.get(var)
        if v:
            return max(1, int(v))
    return DEFAULT_STAGE_HEAVY


def node_weight(rel: RelNode) -> int:
    """Compile-cost weight of ONE node (its subtree excluded)."""
    if isinstance(rel, LogicalJoin):
        # SEMI/ANTI with a non-equi residual lower through the payload
        # exist-test formulation, heavier than a plain equi-join; the
        # residual test is the decomposition the lowering uses
        if rel.join_type in ("SEMI", "ANTI") and rel.condition is not None:
            from ..plan.optimizer import split_join_condition
            _, residual = split_join_condition(rel)
            if residual:
                return 2
        return 1
    if isinstance(rel, (LogicalAggregate, LogicalWindow)):
        return 1
    return 0


def heavy_count(rel: RelNode) -> int:
    """Total heavy weight of a subtree."""
    return node_weight(rel) + sum(heavy_count(i) for i in rel.inputs)


@dataclass
class Stage:
    """One compiled program's plan plus its position in the DAG.

    ``plan`` is the stage subtree with deeper cuts replaced by boundary
    scans; ``scan`` is the boundary node CONSUMERS of this stage read
    through (None for the root stage, whose output is the query result);
    ``deps`` are indices into ``StageGraph.stages`` of the stages whose
    outputs this stage scans.

    The boundary scan's NAME is a content digest of the producing subtree
    (canonical shape + scanned-table uids, physical/compiled.py
    ``_stage_table_name``): equal names imply equal data.
    """

    plan: RelNode
    deps: Tuple[int, ...]
    heavy: int
    scan: Optional[RelNode] = None
    #: statistics-estimated output rows (annotate_stats; None = unknown)
    est_rows: Optional[int] = None


@dataclass
class StageGraph:
    """Stages in topological order (every dep precedes its consumer);
    the last stage is the root and produces the query result."""

    stages: List[Stage]

    @property
    def root(self) -> Stage:
        return self.stages[-1]


def partition(plan: RelNode, budget: int,
              make_scan: Callable[[RelNode], RelNode]) -> StageGraph:
    """Cut ``plan`` into a StageGraph of stages of <= ``budget`` heavy nodes.

    ``make_scan(subtree)`` must return the boundary scan node consumers
    read the subtree's materialized output through (the compiled executor
    passes a ``__split__``-schema table scan named by a content digest of
    the subtree, which is what makes shared subtrees collide into shared
    stage programs across queries).

    Greedy bottom-up: children partition first; at each node, whole child
    subtrees are cut (largest heavy count first, index order on ties) until
    the enclosing count fits the budget.  Cuts never target weight-0
    subtrees — a pure scan/project chain compiles for free and cutting it
    would only pay a materialization round trip.
    """
    budget = max(1, int(budget))
    stages: List[Stage] = []
    scan_stage: Dict[int, int] = {}  # id(boundary scan node) -> stage index

    def stage_deps(rel: RelNode) -> Tuple[int, ...]:
        out: List[int] = []

        def w(r: RelNode) -> None:
            si = scan_stage.get(id(r))
            if si is not None:
                out.append(si)
                return  # a boundary scan is a leaf of THIS stage
            for i in r.inputs:
                w(i)

        w(rel)
        return tuple(dict.fromkeys(out))

    def cut(sub: RelNode, heavy: int) -> RelNode:
        scan = make_scan(sub)
        stages.append(Stage(plan=sub, deps=stage_deps(sub), heavy=heavy,
                            scan=scan))
        scan_stage[id(scan)] = len(stages) - 1
        return scan

    def walk(rel: RelNode) -> Tuple[RelNode, int]:
        kids = [walk(i) for i in rel.inputs]
        total = node_weight(rel) + sum(h for _, h in kids)
        if total > budget and kids:
            order = sorted(range(len(kids)), key=lambda j: (-kids[j][1], j))
            for j in order:
                if total <= budget:
                    break
                sub, h = kids[j]
                if h <= 0:
                    continue  # cutting free subtrees buys nothing
                kids[j] = (cut(sub, h), 0)
                total -= h
        if kids:
            rel = rel.with_inputs([k for k, _ in kids])
        return rel, total

    root_plan, root_heavy = walk(plan)
    stages.append(Stage(plan=root_plan, deps=stage_deps(root_plan),
                        heavy=root_heavy, scan=None))
    return StageGraph(stages)


def annotate_stats(graph: StageGraph, context) -> None:
    """Attach statistics-estimated output rows to every stage
    (runtime/statistics.py — filter selectivity from ingest min/max plus
    join/aggregate cardinality rules).  The estimate rides along to the
    stage spans, so padded-capacity waste (``stage_capacity`` vs
    ``stage_est_rows``) is visible before the first run measures it;
    unknown stays None and costs nothing.
    No-op when adaptive selection is off (DSQL_ADAPTIVE=0)."""
    from ..runtime import statistics as _stats

    if context is None or not _stats.adaptive_enabled():
        return
    for st in graph.stages:
        try:
            est = _stats.estimate_rows(st.plan, context)
        except Exception:
            est = None
        if est is not None:
            st.est_rows = int(est)
