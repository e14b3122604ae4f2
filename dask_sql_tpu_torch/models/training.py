"""SQL-driven ML: CREATE MODEL / CREATE EXPERIMENT / EXPORT MODEL.

The counterpart of ``dask_sql_tpu/models/training.py``: an sklearn-style
estimator, imported by name, is fitted on the host on the result of a
SELECT run on the context's device; an experiment runs a hyperparameter
search; a model is exported with pickle or joblib.

Where every feature column is numeric (the JAX package's ``_all_numeric``:
numpy kinds ``i``, ``f``, ``b`` of the columns' host values), the features
reach the estimator as one float64 matrix, NULL as NaN, cast and stacked
on the device and fetched in one transfer, or stacked from the host copy
a compiled-tier result already holds (``float64_matrix``); it is the
matrix the JAX package gets from ``to_pandas().to_numpy(float64,
na_value=nan)``, in the same memory order.  Other features go through a
pandas frame, as in the JAX package; pandas is imported only then, so a
machine without it trains and predicts on numeric columns.
"""
from __future__ import annotations

import importlib
import logging
import pickle
from typing import Optional, Sequence

import numpy as np
import torch

from ..runtime import telemetry as _tel
from ..sql import ast as A
from ..table import Column, Table, tensors_to_host
from ..utils import import_pandas

logger = logging.getLogger(__name__)

_TEMPORAL = ("DATE", "TIMESTAMP", "TIMESTAMP_WITH_LOCAL_TIME_ZONE")


def import_class(name: str) -> type:
    """Dynamic import of 'package.module.Class'."""
    module_path, _, class_name = name.rpartition(".")
    module = importlib.import_module(module_path)
    return getattr(module, class_name)


def _host_kind(col: Column) -> str:
    """The numpy kind of ``col.to_numpy()``, read without fetching the
    data: an integer or boolean column with a NULL decodes to an object
    array (None), so its kind is ``O`` (one read of its mask)."""
    if col.stype.is_string or col.stype.name == "TIME":
        return "O"
    if col.stype.name in _TEMPORAL:
        return "M"
    if col.stype.name == "INTERVAL_DAY_TIME":
        return "m"
    if col.data.dtype.is_floating_point:
        return "f"
    kind = "b" if col.data.dtype == torch.bool else "i"
    if col.mask is not None and not bool(col.mask.all()):
        return "O"
    return kind


def _all_numeric(cols: Sequence[Column]) -> bool:
    return all(_host_kind(c) in "ifb" for c in cols)


def _as_float64(col: Column) -> torch.Tensor:
    x = col.data.to(torch.float64)
    if col.mask is not None:
        x = torch.where(col.mask, x, torch.full_like(x, float("nan")))
    return x


def _host_float64(col: Column) -> np.ndarray:
    """``_as_float64`` of the column's host copy (a compiled-tier result
    fetched in one transfer)."""
    data, mask = col.host
    x = data.astype(np.float64)
    return x if mask is None else np.where(mask, x, np.nan)


def float64_matrix(cols: Sequence[Column], n_rows: int,
                   order: str = "F") -> np.ndarray:
    """The columns as one (n_rows, len(cols)) float64 host matrix, NULL as
    NaN: cast and stacked on the device, fetched in one transfer, or
    stacked from the columns' host copies where every column has one.  A
    string column is parsed on the host (``astype(float64)`` of its
    values).  ``order="F"`` is the memory order of pandas'
    ``DataFrame.to_numpy``, ``"C"`` that of ``np.column_stack``."""
    if not cols:
        return np.zeros((n_rows, 0), dtype=np.float64)
    on_device = [i for i, c in enumerate(cols)
                 if not (c.stype.is_string or c.stype.name == "TIME")]
    if len(on_device) == len(cols) and all(c.host is not None
                                           for c in cols):
        if order == "F":
            return np.stack([_host_float64(c) for c in cols]).T
        return np.stack([_host_float64(c) for c in cols], axis=1)
    if len(on_device) == len(cols):
        if order == "F":
            (host,) = tensors_to_host([torch.stack(
                [_as_float64(c) for c in cols])])
            return host.T
        (host,) = tensors_to_host([torch.stack(
            [_as_float64(c) for c in cols], dim=1)])
        return host
    out = np.empty((n_rows, len(cols)), dtype=np.float64, order=order)
    if on_device:
        (host,) = tensors_to_host([torch.stack(
            [_as_float64(cols[i]) for i in on_device], dim=1)])
        out[:, on_device] = host
    for i, c in enumerate(cols):
        if i not in on_device:
            out[:, i] = c.to_numpy().astype(np.float64)
    return out


def _gather_xy(table: Table, target_column: Optional[str]):
    """(X, y, feature names) of a training result: X the float64 matrix
    where every feature is numeric, else a pandas frame of the host
    values; y the target's host values (None without a target)."""
    if target_column and target_column not in table.names:
        raise KeyError(target_column)
    names = [n for n in table.names if n != target_column]
    cols = [table.column(n) for n in names]
    y = table.column(target_column).to_numpy() if target_column else None
    if _all_numeric(cols):
        return float64_matrix(cols, table.num_rows), y, names
    pd = import_pandas("Training a model on non-numeric features")
    return pd.DataFrame({n: c.to_numpy() for n, c in zip(names, cols)},
                        columns=names), y, names


def create_model(stmt: A.CreateModel, context, sql: str):
    schema_name, name = context.fqn(stmt.name)
    if name in context.schema[schema_name].models:
        if stmt.if_not_exists:
            return None
        if not stmt.or_replace:
            raise RuntimeError(
                f"A model with the name {name} is already present.")

    kwargs = dict(stmt.kwargs)
    try:
        model_class = kwargs.pop("model_class")
    except KeyError:
        raise AttributeError(
            "Parameters must include a 'model_class' parameter.") from None
    target_column = kwargs.pop("target_column", "")
    wrap_predict = bool(kwargs.pop("wrap_predict", False))
    wrap_fit = bool(kwargs.pop("wrap_fit", False))
    fit_kwargs = kwargs.pop("fit_kwargs", {})

    ModelClass = import_class(model_class)
    model = ModelClass(**kwargs)

    # wrap_fit over a chunked source streams partial_fit batch by batch;
    # over a resident table the whole training set is already on the
    # device, so one fit is the one-partition case of the same thing
    plan = context._get_plan(stmt.query, sql)
    from ..physical.streaming import plan_references_chunked
    if wrap_fit and plan_references_chunked(plan, context):
        if not hasattr(model, "partial_fit"):
            raise AttributeError(
                f"wrap_fit=True over a chunked table needs an estimator "
                f"with partial_fit; {model_class} has none")
        from .incremental import incremental_fit
        feature_names = incremental_fit(model, context, plan,
                                        target_column, fit_kwargs)
        if wrap_predict:
            from .incremental import BatchedPredictor
            model = BatchedPredictor(model)
        context.register_model(name, model, feature_names,
                               schema_name=schema_name)
        return None

    with _tel.span("model_training_query"):
        training_table = context._execute_query_plan(plan)
    with _tel.span("model_gather"):
        X, y, names = _gather_xy(training_table, target_column)
    with _tel.span("model_fit"):
        if y is not None:
            model.fit(X, y, **fit_kwargs)
        else:
            model.fit(X, **fit_kwargs)
    if wrap_predict:
        from .incremental import BatchedPredictor
        model = BatchedPredictor(model)
    context.register_model(name, model, names, schema_name=schema_name)
    return None


def create_experiment(stmt: A.CreateExperiment, context, sql: str):
    schema_name, name = context.fqn(stmt.name)
    if name in context.schema[schema_name].models and not (
            stmt.if_not_exists or stmt.or_replace):
        raise RuntimeError(
            f"An experiment with the name {name} is already present.")
    if name in context.schema[schema_name].models and stmt.if_not_exists:
        return None

    kwargs = dict(stmt.kwargs)
    model_class = kwargs.pop("model_class", None)
    experiment_class = kwargs.pop("experiment_class", None)
    automl_class = kwargs.pop("automl_class", None)
    target_column = kwargs.pop("target_column", "")
    tune_params = kwargs.pop("tune_parameters", {})
    experiment_kwargs = kwargs.pop("experiment_kwargs", {})
    automl_kwargs = kwargs.pop("automl_kwargs", {})

    from .executor_bridge import run_query
    training_table = run_query(context, stmt.query, sql)
    X, y, names = _gather_xy(training_table, target_column)

    if automl_class:
        AutoML = import_class(automl_class)
        automl = AutoML(**automl_kwargs)
        automl.fit(X, y)
        best = getattr(automl, "fitted_pipeline_", automl)
        context.register_model(name, best, names, schema_name=schema_name)
        return None

    if not model_class:
        raise AttributeError(
            "Parameters must include a 'model_class' or 'automl_class'.")
    if not experiment_class:
        raise AttributeError(
            f"Parameters must include a 'experiment_class' parameter for "
            f"tuning {model_class}.")
    ModelClass = import_class(model_class)
    ExperimentClass = import_class(experiment_class)
    model = ModelClass(**kwargs)
    search = ExperimentClass(model, dict(tune_params), **experiment_kwargs)
    search.fit(X, y)

    pd = import_pandas("CREATE EXPERIMENT's results table")
    results = pd.DataFrame(search.cv_results_)
    # parameter objects as strings, for the device table
    for c in results.columns:
        if results[c].dtype == object:
            results[c] = results[c].map(str)
    experiment_table = Table.from_pandas(results, context.device)
    context.schema[schema_name].experiments[name] = experiment_table
    context.register_model(name, search.best_estimator_, names,
                           schema_name=schema_name)
    return experiment_table


def export_model(stmt: A.ExportModel, context, sql: str):
    info = context.resolve_model(stmt.name)
    if info is None:
        raise RuntimeError(
            f"A model with the name {'.'.join(stmt.name)} is not present.")
    model, _ = info
    kwargs = dict(stmt.kwargs)
    fmt = str(kwargs.pop("format", "pickle")).lower()
    try:
        location = kwargs.pop("location")
    except KeyError:
        raise AttributeError(
            "Parameters must include a 'location' parameter.") from None

    if fmt in ("pickle", "pkl"):
        with open(location, "wb") as f:
            pickle.dump(model, f, **kwargs)
    elif fmt == "joblib":
        import joblib
        joblib.dump(model, location, **kwargs)
    elif fmt == "mlflow":
        try:
            import mlflow
        except ImportError:
            raise NotImplementedError(
                "mlflow is not installed in this environment") from None
        mlflow.sklearn.save_model(model, location, **kwargs)
    elif fmt == "onnx":
        raise NotImplementedError("ONNX export is not implemented")
    else:
        raise NotImplementedError(f"Unknown format {fmt}")
    return None

