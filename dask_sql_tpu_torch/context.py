"""Context: the user-facing catalog and SQL entry point of the port.

The counterpart of ``dask_sql_tpu.Context``: ``create_table`` (a dict of
numpy arrays, a ``Table``, or a pandas frame; it collects the table's
statistics, ``runtime/statistics.py``; ``chunked=True`` keeps the table on
the host in batches, streamed by ``physical/streaming.py``), ``drop_table``, ``alter_table``,
the schemas (``create_schema``, ``drop_schema``, ``alter_schema``,
``fqn``), per-table catalog epochs, ``sql`` (queries with ``params`` for
their ``?`` markers, and every statement of
``physical/rel/custom.py``: DDL, views, CTAS, SHOW, EXPLAIN [ANALYZE],
PREPARE / EXECUTE), ``explain`` and ``register_function`` (column UDFs).
Parsing and optimization are native (``native/``), with the JAX package's
Python parser and optimizer, copied, for what the native ones do not take;
the statistics-driven join order follows either.  Execution tries the
compiled tier first (``physical/compiled.py``: one program per plan, a
CUDA graph on the card) and runs the eager executor
(``physical/rel/executor.py``) where it answers None; ``DSQL_COMPILE=0``
is the opt-out.  Each ``sql`` call runs in a
telemetry trace whose ``QueryReport`` is kept as ``last_report``.

Every plan passes the JAX package's three default layers
(``_execute_query_plan`` and ``_run_query_plan``): tenancy admission
(``runtime/tenancy.py``; ``DSQL_TENANCY=0`` turns it off), the workload
manager's admission with its device-bytes ledger (``runtime/scheduler.py``;
``DSQL_MAX_CONCURRENT_QUERIES=0``) and the result cache
(``runtime/result_cache.py``; ``DSQL_RESULT_CACHE_MB=0``): a repeated
query over unchanged tables is answered from memory without touching the
tiers.  ``run_server`` starts the Presto-wire server on this context
(``server/app.py``).

Queries run on the card unless the caller asks for another device:
``Context()`` means ``device="cuda"`` and raises when CUDA is unavailable;
the tests pass ``device="cpu"``.
"""
from __future__ import annotations

import itertools
import time
from typing import Any, Callable, List, Optional, Tuple, Union

import torch

from .datacontainer import FunctionDescription, SchemaContainer, TableEntry
from .plan.binder import Binder
from .plan.nodes import Field, RelNode
from .plan.optimizer import optimize
from .runtime import statistics as _stats
from .runtime import telemetry as _tel
from .sql import ast as A
from .sql.parser import parse_sql
from .table import Table
from .types import SqlType, parse_type_name, sql_type_from_numpy


class Context:
    """Catalog + SQL entry point.

        from dask_sql_tpu_torch import Context
        c = Context()                     # on the card
        c.create_table("t", {"k": np.array(["a", "b", "a"]), "x": np.arange(3.0)})
        c.sql("SELECT k, SUM(x) AS s FROM t GROUP BY k").to_numpy()
    """

    DEFAULT_SCHEMA_NAME = "root"

    def __init__(self, device: Union[str, torch.device, None] = None):
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Context: CUDA is not available; pass device='cpu' to run on "
                "the CPU")
        from .runtime.gates import refuse

        # the JAX package arms its fleet plane and ingest log here
        refuse("DSQL_FLEET_DIR", "DSQL_INGEST_DIR")
        self.device = device
        self.server = None
        self.schema_name = self.DEFAULT_SCHEMA_NAME
        self.schema = {self.DEFAULT_SCHEMA_NAME:
                       SchemaContainer(self.DEFAULT_SCHEMA_NAME)}
        self.last_report: Optional[_tel.QueryReport] = None
        # catalog epochs: a per-table version every mutating path bumps
        self._table_epochs: dict = {}
        self._epoch_counter = itertools.count(1)
        # PREPARE: name -> PrepareStatement; EXECUTE binds its query anew
        self._prepared: dict = {}
        # a chunked table was registered: plans are checked for chunked
        # scans, which go to the streaming executor
        self._has_chunked = False

    # -------------------------------------------------------------- epochs
    def table_epoch(self, schema_name: str, table_name: str) -> int:
        """The table's catalog epoch; 0 = not mutated since the Context
        was made."""
        return self._table_epochs.get((schema_name, table_name.lower()), 0)

    def catalog_entry(self, schema_name: str, table_name: str) -> TableEntry:
        """The executor's catalog read (raises KeyError like the dict)."""
        return self.schema[schema_name].tables[table_name]

    def bump_table_epoch(self, schema_name: str, table_name: str) -> int:
        """Advance the table's epoch (every mutating path calls this) and
        drop the cached results that scan it."""
        from .runtime import result_cache as _rc

        epoch = next(self._epoch_counter)
        self._table_epochs[(schema_name, table_name.lower())] = epoch
        _rc.get_cache().invalidate_table(schema_name, table_name.lower())
        return epoch

    # ------------------------------------------------------------- schemas
    def create_schema(self, schema_name: str):
        self.schema[schema_name] = SchemaContainer(schema_name)

    def drop_schema(self, schema_name: str):
        if schema_name == self.DEFAULT_SCHEMA_NAME:
            raise RuntimeError(
                f"Default schema {schema_name} cannot be deleted")
        for table_name in list(self.schema[schema_name].tables):
            self.bump_table_epoch(schema_name, table_name)
        del self.schema[schema_name]
        if self.schema_name == schema_name:
            self.schema_name = self.DEFAULT_SCHEMA_NAME

    def alter_schema(self, old_schema_name: str, new_schema_name: str):
        self.schema[new_schema_name] = self.schema.pop(old_schema_name)
        for table_name in list(self.schema[new_schema_name].tables):
            self.bump_table_epoch(old_schema_name, table_name)
            self.bump_table_epoch(new_schema_name, table_name)

    # -------------------------------------------------------------- tables
    def create_table(self, table_name: str, input_table: Any,
                     schema_name: Optional[str] = None, chunked: bool = False,
                     batch_rows: Optional[int] = None) -> None:
        """Register a dict of column -> numpy array (or list), a ``Table``,
        or a pandas DataFrame as a SQL table on this context's device.

        ``chunked=True``: out-of-device-memory mode.  The data stays on the
        host as encoded batches of ``batch_rows`` rows (default
        ``io.chunked.DEFAULT_BATCH_ROWS``) and queries stream it through
        the device one batch at a time (``physical/streaming.py``).  It
        takes a dict of numpy arrays (``ChunkedSource.from_columns``, no
        pandas needed), a pandas frame, a parquet path (pyarrow) or a
        ``ChunkedSource``."""
        schema_name = schema_name or self.schema_name
        if chunked:
            self._create_chunked(table_name, input_table, schema_name,
                                 batch_rows)
            return
        if isinstance(input_table, Table):
            table = Table(input_table.names,
                          [_to(c, self.device) for c in input_table.columns])
        elif isinstance(input_table, dict):
            table = Table.from_pydict(input_table, self.device)
        elif hasattr(input_table, "columns") and hasattr(input_table, "dtypes"):
            table = Table.from_pandas(input_table, self.device)
        else:
            raise TypeError(
                f"create_table: unsupported input {type(input_table).__name__}")
        self.schema[schema_name].tables[table_name.lower()] = TableEntry(
            table=table, stats=_stats.collect_table_stats(table))
        self.bump_table_epoch(schema_name, table_name)

    def _create_chunked(self, table_name: str, input_table: Any,
                        schema_name: str, batch_rows: Optional[int]) -> None:
        from .io.chunked import DEFAULT_BATCH_ROWS, ChunkedSource

        rows = batch_rows or DEFAULT_BATCH_ROWS
        if isinstance(input_table, ChunkedSource):
            source = input_table
        elif isinstance(input_table, dict):
            source = ChunkedSource.from_columns(input_table, batch_rows=rows)
        elif isinstance(input_table, str):
            source = ChunkedSource.from_parquet(input_table, batch_rows=rows)
        elif hasattr(input_table, "columns") and hasattr(input_table, "dtypes"):
            source = ChunkedSource.from_pandas(input_table, batch_rows=rows)
        else:
            raise TypeError(
                "chunked=True accepts a dict of numpy arrays, a pandas "
                "frame, a parquet path or a ChunkedSource")
        self._has_chunked = True
        self.schema[schema_name].tables[table_name.lower()] = TableEntry(
            table=source.schema_table(self.device), chunked=source,
            statistics={"row_count": source.n_rows},
            filepath=input_table if isinstance(input_table, str) else None)
        self.bump_table_epoch(schema_name, table_name)

    def drop_table(self, table_name: str, schema_name: Optional[str] = None):
        schema_name = schema_name or self.schema_name
        del self.schema[schema_name].tables[table_name.lower()]
        self.bump_table_epoch(schema_name, table_name)

    def alter_table(self, old_table_name: str, new_table_name: str,
                    schema_name: Optional[str] = None):
        schema_name = schema_name or self.schema_name
        s = self.schema[schema_name]
        s.tables[new_table_name.lower()] = s.tables.pop(old_table_name.lower())
        self.bump_table_epoch(schema_name, old_table_name)
        self.bump_table_epoch(schema_name, new_table_name)

    # ----------------------------------------------------------- functions
    def register_function(self, f: Callable, name: str,
                          parameters: List[Tuple[str, Any]] = None,
                          return_type: Any = None, replace: bool = False,
                          schema_name: Optional[str] = None,
                          row_udf: bool = False):
        """Register a scalar UDF.  ``parameters`` / ``return_type`` take
        numpy dtypes, Python types or SQL type names; the result is DOUBLE
        unless said otherwise.  A column UDF gets each argument as a numpy
        array; a row UDF (``row_udf=True``) is accepted here and raises
        ``NotImplementedError`` when a query calls it."""
        schema_name = schema_name or self.schema_name
        params = [(pname, _to_sql_type(t)) for pname, t in (parameters or [])]
        rt = (SqlType("DOUBLE") if return_type is None
              else _to_sql_type(return_type))
        fd = FunctionDescription(name=name, parameters=params, return_type=rt,
                                 aggregation=False, func=f, row_udf=row_udf)
        schema = self.schema[schema_name]
        lower = name.lower()
        if not replace and lower in schema.functions and \
                schema.functions[lower].func is not f:
            raise ValueError(f"Function {name} is already registered")
        schema.functions[lower] = fd
        schema.function_lists.append(fd)

    # ----------------------------------------------------------------- sql
    def sql(self, sql: str, return_futures: bool = True,
            params: Optional[list] = None, timeout: Optional[float] = None,
            priority: Optional[str] = None, tenant: Optional[str] = None):
        """Parse, plan, optimize and execute the statements of ``sql``;
        the last one's result is returned.  A query (or EXPLAIN, SHOW,
        DESCRIBE, EXECUTE) returns rows; DDL returns an empty table.

        ``params`` binds the positional ``?`` markers of a query to Python
        values (``$n`` markers parse only inside PREPARE); with the
        compiled tier's parameterized plans every value list reuses one
        program per query shape.  ``timeout`` (seconds; default
        ``DSQL_QUERY_TIMEOUT_MS``, unset or 0: none) is a deadline checked
        at every layer (admission, builds, stage scheduling, eager plan
        nodes), which raises ``runtime.resilience.DeadlineExceeded``; a
        nested call keeps the sooner deadline.  ``priority``
        (``interactive``, ``batch`` or ``background``; default
        ``DSQL_DEFAULT_PRIORITY`` or ``interactive``) is the query's class
        in the workload manager, and ``tenant`` the tenant it bills
        against (``runtime/tenancy.py``; default ``default``).  Returns a
        device ``Table`` (``return_futures=True``) or a pandas DataFrame
        (``return_futures=False``).  The call's telemetry report is kept
        as ``self.last_report``, and its host walls (parse, plan, exec,
        fetch; compile, device and materialize when the report has them)
        as ``self.last_timings``."""
        from contextlib import nullcontext

        from .runtime import resilience as _res, scheduler as _sched
        from .runtime.gates import tenancy_on

        ten_scope = nullcontext()
        if tenant is not None and tenancy_on():
            from .runtime import tenancy as _ten
            ten_scope = _ten.tenant_scope(tenant)
        trace = None
        try:
            with _res.query_scope(timeout_s=timeout), \
                    _tel.trace_scope(sql) as trace, \
                    _sched.priority_scope(priority), ten_scope:
                t0 = time.perf_counter()
                with _tel.span("parse"):
                    stmts = parse_sql(sql)
                timings = {"parse_ms": (time.perf_counter() - t0) * 1e3,
                           "plan_ms": 0.0, "exec_ms": 0.0, "fetch_ms": 0.0}
                self.last_timings = timings
                result = None
                for stmt in stmts:
                    result = self._execute_statement(stmt, sql, params=params)
                if result is None:
                    result = Table([], [])
                if trace is not None:
                    trace.root.attrs["rows_out"] = result.num_rows
                    trace.root.attrs["bytes_out"] = sum(
                        c.data.numel() * c.data.element_size()
                        for c in result.columns)
                if return_futures:
                    return result
                t0 = time.perf_counter()
                with _tel.span("fetch"):
                    result = result.to_pandas()
                timings["fetch_ms"] = (time.perf_counter() - t0) * 1e3
                return result
        finally:
            if trace is not None and trace.report is not None:
                self.last_report = trace.report
                timings = getattr(self, "last_timings", None)
                if timings is not None:
                    for k in ("compile", "device", "materialize"):
                        v = trace.report.phases.get(k)
                        if v is not None:
                            timings[f"{k}_ms"] = v

    def _execute_statement(self, stmt: A.Statement, sql: str,
                           params: Optional[list] = None) -> Optional[Table]:
        from .physical.rel.custom import StatementDispatcher

        timings = getattr(self, "last_timings", None)
        if isinstance(stmt, A.QueryStatement):
            t0 = time.perf_counter()
            with _tel.span("plan"):
                plan = self._get_plan(stmt.query, sql, params=params)
            t1 = time.perf_counter()
            try:
                with _tel.span("execute"):
                    return self._execute_query_plan(plan)
            finally:
                if timings is not None:
                    timings["plan_ms"] += (t1 - t0) * 1e3
                    timings["exec_ms"] += (time.perf_counter() - t1) * 1e3
        handler = StatementDispatcher.get_plugin(type(stmt).__name__)
        with _tel.span("execute", statement=type(stmt).__name__):
            return handler(stmt, self, sql)

    def _execute_query_plan(self, plan: RelNode) -> Table:
        """Every plan a statement executes passes here (queries, CTAS,
        EXECUTE, server requests): tenancy admission outside (a tenant
        over quota is refused before it takes a slot or a queue place;
        a server pre-claim is adopted, not claimed again), then the
        workload manager's admission.  A nested plan (a thread that
        already holds both) passes straight through."""
        from contextlib import nullcontext

        from .runtime import scheduler as _sched
        from .runtime.gates import tenancy_on

        ten_adm = nullcontext()
        if tenancy_on():
            from .runtime import tenancy as _ten
            ten_adm = _ten.admission()
        with ten_adm, _sched.get_manager().admission(plan, self):
            return self._run_query_plan(plan)

    def _run_query_plan(self, plan: RelNode) -> Table:
        """The result cache first: an identical plan over unchanged tables
        (the same epochs and table uids) is answered from memory
        (``result_cache=hit``); ``_rc_bypass`` skips the lookup, not the
        store.  Then the compiled tier, and the eager executor where it
        declines (``DSQL_COMPILE=0``, a plan outside its subset, a runtime
        flag, a rung of its ladder, or a cold plan answered eager while
        its programs build); the span says which with ``tier``:
        ``compiled``, ``eager`` or the tier's own ``eager-compiling``.
        Only a successful execution is stored.  Before all of it, a plan
        that scans a chunked table goes to the streaming executor
        (``physical/streaming.py``), whose batches take the same tiers."""
        from .physical.compiled import try_execute_compiled
        from .physical.rel.executor import RelExecutor
        from .runtime import result_cache as _rc

        if self._has_chunked:
            # a chunked table's entry holds a binding stub: its plans
            # stream through the streaming executor, never the paths below
            from .physical.streaming import (execute_streaming,
                                             plan_references_chunked)
            if plan_references_chunked(plan, self):
                return execute_streaming(plan, self)
        cache = _rc.get_cache()
        ckey = _rc.plan_key(plan, self) if cache.enabled() else None
        if ckey is not None:
            if getattr(self, "_rc_bypass", False):
                _tel.annotate(result_cache="bypass")
            else:
                hit = cache.get(ckey)
                if hit is not None:
                    table, tier = hit
                    _tel.inc("result_cache_hits")
                    _tel.annotate(result_cache="hit",
                                  result_cache_tier=tier)
                    return table
                _tel.inc("result_cache_misses")
        result = try_execute_compiled(plan, self)
        span = _tel.current_span()
        if result is None:
            if span is not None:
                span.attrs.setdefault("tier", "eager")
            result = RelExecutor(self).execute(plan)
        elif span is not None:
            span.attrs.setdefault("tier", "compiled")
        if ckey is not None and result is not None \
                and cache.put(ckey, result):
            _tel.annotate(result_cache="store")
        return result

    def _get_plan(self, query: A.SelectLike, sql: str = "",
                  params: Optional[list] = None) -> RelNode:
        # the context lets the optimizer order join chains by statistics
        return optimize(Binder(self, sql, params=params).bind(query),
                        context=self)

    def explain(self, sql: str) -> str:
        """The optimized plan as text."""
        stmt = parse_sql(sql)[0]
        if isinstance(stmt, (A.ExplainStatement, A.QueryStatement)):
            return self._get_plan(stmt.query, sql).explain()
        return f"-- {type(stmt).__name__}"

    # ----------------------------------------------------- catalog interface
    def fqn(self, identifier: Union[str, List[str]]) -> Tuple[str, str]:
        """Split a (qualified) name into (schema, name)."""
        parts = identifier.split(".") if isinstance(identifier, str) \
            else list(identifier)
        if len(parts) == 2 and parts[0] in self.schema:
            return parts[0], parts[1].lower()
        return self.schema_name, ".".join(parts).lower()

    def resolve_table(self, parts: List[str]):
        """Binder hook: (schema, table, fields, view_plan) or None."""
        candidates = []
        if len(parts) == 1:
            candidates.append((self.schema_name, parts[0]))
        elif len(parts) >= 2:
            candidates.append((parts[0], ".".join(parts[1:])))
            candidates.append((self.schema_name, ".".join(parts)))
        for schema_name, table_name in candidates:
            schema = self.schema.get(schema_name)
            if schema is None:
                continue
            entry = schema.tables.get(table_name.lower())
            if entry is None:
                continue
            if entry.table is None:  # a view: its plan, re-bound per query
                return (schema_name, table_name.lower(),
                        list(entry.plan.schema), entry.plan)
            fields = [Field(n, c.stype) for n, c in
                      zip(entry.table.names, entry.table.columns)]
            return schema_name, table_name.lower(), fields, None
        return None

    def get_function(self, name: str) -> Optional[FunctionDescription]:
        """Binder hook: the registered function of that name, or None."""
        for schema_name in (self.schema_name, self.DEFAULT_SCHEMA_NAME):
            schema = self.schema.get(schema_name)
            if schema is not None and name.lower() in schema.functions:
                return schema.functions[name.lower()]
        return None

    def resolve_model(self, parts: List[str]):
        return None

    # -------------------------------------------------------------- server
    def run_server(self, **kwargs):
        """Start the Presto-wire HTTP server on this context
        (``server/app.py`` ``run_server``)."""
        from .server.app import run_server
        return run_server(context=self, **kwargs)

    def stop_server(self):
        if self.server is not None:
            self.server.shutdown()
            self.server.server_close()
            self.server = None


def _to_sql_type(t) -> SqlType:
    if isinstance(t, SqlType):
        return t
    if isinstance(t, str):
        return parse_type_name(t)
    python = {int: "BIGINT", float: "DOUBLE", str: "VARCHAR", bool: "BOOLEAN"}
    if t in python:
        return SqlType(python[t])
    return sql_type_from_numpy(t)


def _to(col, device):
    from .table import Column

    return Column(col.data.to(device), col.stype,
                  None if col.mask is None else col.mask.to(device),
                  col.dictionary)
