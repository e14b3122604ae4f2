"""Out-of-core (incremental) training and batched prediction.

The counterpart of ``dask_sql_tpu/models/incremental.py``.  ``CREATE MODEL
... WITH (wrap_fit = True)`` over a chunked table streams ``partial_fit``:
the training SELECT's row-local plan (projections, filters, joins to
resident tables above one chunked scan) runs once per host batch through
the streaming executor's machinery (``physical/streaming.py``: each batch
padded to the same shape, so one compiled program serves every batch),
and each batch's result feeds ``partial_fit``.  At most one batch is on
the device or gathered on the host at a time.  ``wrap_predict`` wraps the
estimator in ``BatchedPredictor``, which scores in bounded host slices.
"""
from __future__ import annotations

import logging
from contextlib import closing
from typing import Iterator, List

import numpy as np

logger = logging.getLogger(__name__)


def iter_query_batches(context, plan) -> Iterator:
    """The query's result as one ``Table`` per batch of its chunked scan.

    The plan must be a row stream over exactly one chunked scan: no
    blocking operator (aggregate, sort, window) or set operation on the
    scan's path, so that the batches' results concatenated are the
    query's result.  Subtrees off the path (resident join sides) are
    materialized once.  Holds the streaming executor's lock while it
    runs: the batch entry lives in the context's ``__stream__`` schema."""
    from ..physical import streaming as S
    from ..plan.nodes import (LogicalAggregate, LogicalExcept,
                              LogicalIntersect, LogicalSort, LogicalUnion,
                              LogicalWindow)
    from ..runtime import resilience as _res

    scans = S._chunked_scans(plan, context)
    if len(scans) != 1:
        raise S.StreamingUnsupported(
            f"incremental training needs exactly one chunked table in the "
            f"training query (found {len(scans)})")
    scan = scans[0]
    path = S._path_to(plan, scan)
    if path is None:
        raise S.StreamingUnsupported(
            "chunked table referenced inside a scalar subquery cannot "
            "stream training batches")
    for node in path[:-1]:
        # a blocking operator makes the result not a row stream; a set
        # operation would replay its resident branch into every batch
        if isinstance(node, (LogicalAggregate, LogicalSort, LogicalWindow,
                             LogicalUnion, LogicalIntersect, LogicalExcept)):
            raise S.StreamingUnsupported(
                f"{type(node).__name__} above the chunked scan makes the "
                "training query a blocking computation, not a row-stream; "
                "materialize it into a resident table first or drop "
                "wrap_fit")
    source = context.schema[scan.schema_name].tables[scan.table_name].chunked
    columns = S._scan_columns(scan)
    names = [f.name for f in plan.schema]
    with S._EXEC_LOCK:
        if not S._exec_depth:
            S._tmp_counter[0] = 0
        key = id(context)
        S._exec_depth[key] = S._exec_depth.get(key, 0) + 1
        try:
            # inside the try: the rewriter materializes off-path subtrees
            # into __stream__ temps, which a failure must not leak
            partial = S._stream_partial_plans(plan, scan, path, context)
            for bi in range(source.n_batches):
                _res.check("stream_batch")
                table, row_valid = _res.retry_transient(
                    lambda: source.batch_table(bi, context.device, columns),
                    site="chunked_read")
                S._set_batch_entry(context, table, row_valid)
                result = S._run_resident(partial, context)
                yield result.with_names(names)
        finally:
            S._exec_depth[key] -= 1
            if S._exec_depth[key] == 0:
                del S._exec_depth[key]
                S._cleanup(context)


def _is_classifier(model) -> bool:
    """sklearn's verdict; for an estimator that is not sklearn's (sklearn
    >= 1.6 raises AttributeError without its tags) or without sklearn,
    the legacy ``_estimator_type`` marker."""
    try:
        from sklearn.base import is_classifier
        return is_classifier(model)
    except (ImportError, AttributeError):
        return getattr(model, "_estimator_type", "") == "classifier"


def incremental_fit(model, context, plan, target_column: str,
                    fit_kwargs: dict) -> List[str]:
    """Stream the training query batch by batch through ``partial_fit``;
    returns the feature column names.  A classifier needs the whole label
    set at its first ``partial_fit``: without ``classes`` in
    ``fit_kwargs`` a label-only prescan collects it."""
    from .training import _gather_xy

    fit_kwargs = dict(fit_kwargs)
    if _is_classifier(model) and target_column \
            and "classes" not in fit_kwargs:
        # the prescan streams a label-only projection, optimized again so
        # that column pruning drops the feature columns and subtrees
        from ..plan.nodes import Field, LogicalProject, RexInputRef
        from ..plan.optimizer import optimize
        tgt = next((i for i, f in enumerate(plan.schema)
                    if f.name == target_column), None)
        if tgt is None:
            raise KeyError(
                f"target_column {target_column!r} is not a column of the "
                f"training query (have: "
                f"{[f.name for f in plan.schema]})")
        label_plan = optimize(LogicalProject(
            input=plan, exprs=[RexInputRef(tgt, plan.schema[tgt].stype)],
            schema=[Field(target_column, plan.schema[tgt].stype)]))
        seen = set()
        with closing(iter_query_batches(context, label_plan)) as batches:
            for t in batches:
                seen.update(np.unique(t.column(target_column).to_numpy()
                                      ).tolist())
        fit_kwargs["classes"] = np.sort(np.asarray(sorted(seen)))
        logger.info("incremental fit: prescanned %d classes",
                    len(fit_kwargs["classes"]))

    feature_names: List[str] = []
    n_batches = 0
    # closed here, in this thread, if partial_fit raises: the generator
    # holds the streaming lock
    with closing(iter_query_batches(context, plan)) as batches:
        for t in batches:
            X, y, feature_names = _gather_xy(t, target_column)
            if y is not None:
                model.partial_fit(X, y, **fit_kwargs)
            else:
                model.partial_fit(X, **fit_kwargs)
            n_batches += 1
    if n_batches == 0:
        # the gathered path's fit raises on empty input at CREATE MODEL
        # time: never register an unfit estimator
        raise ValueError(
            "incremental training source produced no batches (empty "
            "chunked table?); refusing to register an unfit model")
    logger.info("incremental fit: %d partial_fit batches", n_batches)
    return feature_names


class BatchedPredictor:
    """``wrap_predict``: prediction in bounded host batches, so that a
    table-sized feature matrix is never scored in one call.  Delegates
    everything else to the wrapped estimator; picklable for EXPORT
    MODEL."""

    #: rows per predict slice: bounds the peak memory of model.predict
    batch_rows = 1 << 20

    def __init__(self, model, batch_rows: int = None):
        self.model = model
        if batch_rows is not None:
            self.batch_rows = int(batch_rows)

    def _batched(self, method: str, X):
        fn = getattr(self.model, method)
        n = len(X)
        if n <= self.batch_rows:
            return fn(X)
        parts = []
        for s in range(0, n, self.batch_rows):
            part = X[s:s + self.batch_rows] if not hasattr(X, "iloc") \
                else X.iloc[s:s + self.batch_rows]
            parts.append(np.asarray(fn(part)))
        return np.concatenate(parts)

    # every scoring method is batched, so that the bound holds for
    # probabilities too
    def predict(self, X):
        return self._batched("predict", X)

    def predict_proba(self, X):
        return self._batched("predict_proba", X)

    def predict_log_proba(self, X):
        return self._batched("predict_log_proba", X)

    def decision_function(self, X):
        return self._batched("decision_function", X)

    def transform(self, X):
        return self._batched("transform", X)

    def __getattr__(self, name):
        # fires only for attributes the wrapper lacks, so the batched
        # methods above stay the wrapper's
        return getattr(self.model, name)

    def __getstate__(self):
        return {"model": self.model, "batch_rows": self.batch_rows}

    def __setstate__(self, state):
        self.model = state["model"]
        self.batch_rows = state["batch_rows"]
