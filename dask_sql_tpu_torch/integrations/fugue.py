"""Fugue integration: this engine as a fugue SQL engine.

The counterpart of ``dask_sql_tpu/integrations/fugue.py``: a ``SQLEngine``
whose ``select`` runs fugue dataframes through a new ``Context``, an
``ExecutionEngine`` with it as the default SQL engine, and ``fsql_tpu``,
which runs a fugue-SQL workflow over a Context's tables and can register
the results back.  fugue is optional: this module imports it only when
one of these is used.  Without it the module loads, and ``fsql_tpu``,
``TpuSQLEngine()`` and ``TpuSQLExecutionEngine()`` raise ``ImportError``
naming fugue.
"""
from __future__ import annotations

from typing import Any, Dict

_ENGINES = ("TpuSQLEngine", "TpuSQLExecutionEngine")
_classes: Dict[str, type] = {}


def _require_fugue():
    try:
        import fugue
        import fugue.execution.execution_engine as fee
        from fugue.workflow.workflow import (FugueSQLWorkflow,
                                             WorkflowDataFrame)
    except ImportError as exc:
        raise ImportError(
            "The fugue integration requires the 'fugue' package "
            "(pip install fugue)") from exc
    return fugue, fee, FugueSQLWorkflow, WorkflowDataFrame


def _engine_classes() -> Dict[str, type]:
    """The two engine classes, made at first use on fugue's bases."""
    if not _classes:
        fugue, fee, _, _ = _require_fugue()
        from ..context import Context

        class TpuSQLEngine(fee.SQLEngine):
            """A fugue SQL engine backed by this engine."""

            def select(self, dfs, statement: str):
                c = Context()
                for k, v in dfs.items():
                    c.create_table(k, self.execution_engine.to_df(v)
                                   .as_pandas())
                df = c.sql(statement, return_futures=False)
                return self.execution_engine.to_df(df)

        class TpuSQLExecutionEngine(fugue.NativeExecutionEngine):
            """An execution engine with TpuSQLEngine as its SQL engine."""

            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                self._default_sql_engine = TpuSQLEngine(self)

            @property
            def default_sql_engine(self):
                return self._default_sql_engine

        _classes.update(TpuSQLEngine=TpuSQLEngine,
                        TpuSQLExecutionEngine=TpuSQLExecutionEngine)
    return _classes


class _Missing:
    """Stands for an engine class where fugue is missing: making one
    raises the ImportError that names fugue."""

    def __init__(self, *args, **kwargs):
        _require_fugue()


_MISSING = {name: type(name, (_Missing,), {"__module__": __name__})
            for name in _ENGINES}


def __getattr__(name: str):
    if name not in _ENGINES:
        raise AttributeError(name)
    try:
        return _engine_classes()[name]
    except ImportError:
        return _MISSING[name]


def fsql_tpu(sql: str, ctx=None, register: bool = False,
             fugue_conf: Any = None) -> Dict[str, Any]:
    """Run a fugue-SQL workflow against ``ctx``'s tables.  The named steps
    come back as pandas frames; ``register=True`` registers them on
    ``ctx``."""
    _, _, FugueSQLWorkflow, WorkflowDataFrame = _require_fugue()
    engine = _engine_classes()["TpuSQLExecutionEngine"]
    dag = FugueSQLWorkflow()
    dfs = {}
    if ctx is not None:
        for k, entry in ctx.schema[ctx.schema_name].tables.items():
            if entry.rank_rows is not None:
                # this rank's rows (a mesh across processes): the whole
                # table, gathered from every rank
                from ..parallel.gather import whole_entry
                entry = whole_entry(ctx, ctx.schema_name, k)
            if entry.table is not None:
                dfs[k] = dag.df(entry.table.to_pandas())
    result = dag._sql(sql, **dfs)
    dag.run(engine(conf=fugue_conf))

    result_dfs = {k: v.result.native for k, v in result.items()
                  if isinstance(v, WorkflowDataFrame)}
    if register and ctx is not None:
        for k, v in result_dfs.items():
            ctx.create_table(k, v)
    return result_dfs

