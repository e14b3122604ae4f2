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

The write path: ``append_rows`` (which INSERT INTO and the server's
``POST /v1/ingest`` lower to) appends a coerced batch to a resident table
and bumps its epoch with the batch as a delta record, from which the
materialized views (``runtime/matview.py``, ``runtime/delta.py``) refresh
incrementally.  ``DSQL_INGEST_DIR`` arms the write-ahead log
(``runtime/ingest.py``): appends commit through it, a new Context replays
it, and each query reads the tables as pinned at its admission.

Queries run on the card unless the caller asks for another device:
``Context()`` means ``device="cuda"`` and raises when CUDA is unavailable;
the tests pass ``device="cpu"``.
"""
from __future__ import annotations

import itertools
import logging
import threading
import time
from typing import Any, Callable, List, Optional, Tuple, Union

import torch

from .datacontainer import FunctionDescription, SchemaContainer, TableEntry
from .plan.binder import Binder
from .plan.nodes import Field, RelNode
from .plan.optimizer import optimize
from .runtime import ingest as _ing
from .runtime import statistics as _stats
from .runtime import telemetry as _tel
from .sql import ast as A
from .sql.parser import parse_sql
from .table import Table
from .types import SqlType, parse_type_name, sql_type_from_numpy

logger = logging.getLogger(__name__)


class Context:
    """Catalog + SQL entry point.

        from dask_sql_tpu_torch import Context
        c = Context()                     # on the card
        c.create_table("t", {"k": np.array(["a", "b", "a"]), "x": np.arange(3.0)})
        c.sql("SELECT k, SUM(x) AS s FROM t GROUP BY k").to_numpy()
    """

    DEFAULT_SCHEMA_NAME = "root"

    def __init__(self, device: Union[str, torch.device, None] = None,
                 mesh=None):
        """``mesh``: a ``parallel.mesh.Mesh`` whose first device is this
        context's.  Tables registered on the context are row-sharded over
        it, and queries run as SPMD stages over its shards
        (``parallel/spmd.py``), or on the single-device tiers over the
        padded tables where that declines.  On a mesh across processes
        (``init_multihost`` with a coordinator) every rank makes its own
        context, registers the same tables and runs the same queries in
        the same order; each rank holds the whole padded table."""
        if device is None and mesh is not None:
            device = mesh.devices[0]
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Context: CUDA is not available; pass device='cpu' to run on "
                "the CPU")
        if mesh is not None and device.type == "cuda" \
                and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if mesh is not None and mesh.devices[0] != device:
            raise ValueError(
                f"Context: the mesh's first device {mesh.devices[0]} must be "
                f"the context's device {device}")
        from .runtime.gates import refuse

        # the JAX package arms its fleet plane here
        refuse("DSQL_FLEET_DIR")
        self.device = device
        self.mesh = mesh
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
        # per-table append locks: an append's read-concat-swap (and, with
        # the ingest log armed, its WAL write) never interleaves with
        # another writer's on the same table
        self._append_locks: dict = {}
        self._append_locks_guard = threading.Lock()
        # the ingest log: opened, replayed for registered tables and its
        # flusher started when DSQL_INGEST_DIR arms it (create_table
        # replays tables registered later)
        if _ing.enabled():
            if mesh is not None and mesh.spans_processes:
                # every rank would append to (and replay) one log
                raise NotImplementedError(
                    "Context: the ingest log (DSQL_INGEST_DIR) on a mesh "
                    "across processes, one writer for every rank's "
                    "catalog, is not ported yet")
            _ing.ensure_armed(self)

    # -------------------------------------------------------------- epochs
    def table_epoch(self, schema_name: str, table_name: str) -> int:
        """The table's catalog epoch; 0 = not mutated since the Context
        was made.  Inside a query pinned by the armed ingest log
        (``runtime/ingest.py:pin_scope``) it is the epoch at admission."""
        if _ing.enabled():
            pinned = _ing.pinned_epoch(schema_name, table_name.lower())
            if pinned is not None:
                return pinned
        return self._table_epochs.get((schema_name, table_name.lower()), 0)

    def catalog_entry(self, schema_name: str, table_name: str) -> TableEntry:
        """The executors' catalog read (raises KeyError like the dict).
        Inside a pinned query it is the entry at admission, so one query
        reads one committed prefix of every table while a writer
        appends."""
        if _ing.enabled():
            entry = _ing.pinned_entry(schema_name, table_name)
            if entry is not None:
                return entry
        return self.schema[schema_name].tables[table_name]

    def bump_table_epoch(self, schema_name: str, table_name: str,
                         delta: Optional[Table] = None) -> int:
        """Advance the table's epoch (every mutating path calls this) and
        drop the cached results that scan it.  ``delta``: the appended
        batch of a pure append, recorded on the materialized-view
        registry so that dependent views refresh from it; without it the
        bump is a tombstone and dependents recompute in full."""
        from .runtime import result_cache as _rc

        key = (schema_name, table_name.lower())
        epoch = next(self._epoch_counter)
        self._table_epochs[key] = epoch
        _rc.get_cache().invalidate_table(schema_name, table_name.lower())
        reg = self._matviews()
        if reg is not None:
            if delta is not None:
                reg.record_delta(key, epoch, delta)
            else:
                reg.record_overwrite(key, epoch)
        return epoch

    def _matviews(self):
        """The materialized-view registry, or None before the first
        CREATE MATERIALIZED VIEW."""
        return self.__dict__.get("_matview_registry")

    # ------------------------------------------------------------- schemas
    def create_schema(self, schema_name: str):
        self.schema[schema_name] = SchemaContainer(schema_name)

    def drop_schema(self, schema_name: str):
        if schema_name == self.DEFAULT_SCHEMA_NAME:
            raise RuntimeError(
                f"Default schema {schema_name} cannot be deleted")
        reg = self._matviews()
        if reg is not None:
            reg.discard_schema(schema_name)
        for table_name in list(self.schema[schema_name].tables):
            self.bump_table_epoch(schema_name, table_name)
        del self.schema[schema_name]
        if self.schema_name == schema_name:
            self.schema_name = self.DEFAULT_SCHEMA_NAME

    def alter_schema(self, old_schema_name: str, new_schema_name: str):
        reg = self._matviews()
        if reg is not None:
            # a rename re-keys the catalog under the views: their
            # registry entries go, and the bumps below tombstone
            reg.discard_schema(old_schema_name)
            reg.discard_schema(new_schema_name)
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
        reg = self._matviews()
        if reg is not None:
            # registering over a materialized view's name overwrites it
            reg.discard_view(schema_name, table_name.lower())
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
        row_valid = None
        if self.mesh is not None:
            from .parallel.mesh import shard_table_with_validity
            table, row_valid = shard_table_with_validity(table, self.mesh)
        self.schema[schema_name].tables[table_name.lower()] = TableEntry(
            table=table, row_valid=row_valid,
            stats=_stats.collect_table_stats(table, row_valid=row_valid))
        self.bump_table_epoch(schema_name, table_name)
        if _ing.enabled():
            # the restart path: logged batches of this table apply on the
            # re-registered base; with none pending this is a mid-run
            # re-registration, whose source supersedes the log
            log = _ing.get_log(self, create=True)
            if log.has_pending(schema_name, table_name.lower()):
                log.maybe_replay(schema_name, table_name.lower())
            else:
                log.truncate(schema_name, table_name.lower())

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
        reg = self._matviews()
        if reg is not None:
            reg.discard_view(schema_name, table_name.lower())
        del self.schema[schema_name].tables[table_name.lower()]
        self.bump_table_epoch(schema_name, table_name)
        if _ing.enabled():
            # the table's log dies with it: a later table of the same
            # name must not replay the dropped rows
            log = _ing.get_log(self)
            if log is not None:
                log.truncate(schema_name, table_name.lower())

    def alter_table(self, old_table_name: str, new_table_name: str,
                    schema_name: Optional[str] = None):
        schema_name = schema_name or self.schema_name
        reg = self._matviews()
        if reg is not None:
            reg.discard_view(schema_name, old_table_name.lower())
            reg.discard_view(schema_name, new_table_name.lower())
        s = self.schema[schema_name]
        s.tables[new_table_name.lower()] = s.tables.pop(old_table_name.lower())
        self.bump_table_epoch(schema_name, old_table_name)
        self.bump_table_epoch(schema_name, new_table_name)

    # --------------------------------------------------------------- appends
    def append_rows(self, table_name: str, rows: Any,
                    schema_name: Optional[str] = None) -> int:
        """Append ``rows`` to a registered resident table: the epoch bump
        carries the batch, so the materialized views over the table
        refresh from it (``runtime/matview.py``).  INSERT INTO and
        ``POST /v1/ingest`` lower to this.

        ``rows``: a ``Table``, a dict of columns (numpy arrays or lists),
        a list of row tuples (matched by position) or a pandas DataFrame.
        Columns align with the target case-insensitively by name, or by
        position when the names do not match; a named strict subset
        NULL-fills the other columns; values cast to the target types.
        What does not fit raises ``SchemaMismatch``.  Returns the rows
        appended.  With the ingest log armed (``DSQL_INGEST_DIR``) the
        batch is written to it first and may be held for a micro-batch
        (``DSQL_INGEST_BATCH_ROWS``): the return value is then the rows
        made visible now (0 = buffered)."""
        from .runtime.resilience import UserError

        schema_name = schema_name or self.schema_name
        entry = self.schema[schema_name].tables.get(table_name.lower())
        if entry is None:
            raise UserError(f"Table {table_name} not found in schema "
                            f"{schema_name}; create it before INSERT INTO.")
        if entry.chunked is not None:
            raise UserError(
                f"Table {table_name} is chunked (host-resident batches); "
                "appends are not supported — re-create it from the extended "
                "source instead.")
        if entry.table is None:
            raise UserError(
                f"{table_name} is a view; INSERT INTO targets tables. "
                "Append to its base tables instead.")
        reg = self._matviews()
        if reg is not None and (schema_name, table_name.lower()) in reg.views:
            raise UserError(
                f"{table_name} is a materialized view; INSERT INTO targets "
                "base tables — the view refreshes from their appends.")
        delta = _coerce_delta(entry.table, rows, self.device)
        if delta.num_rows == 0:
            return 0
        if _ing.enabled():
            log = _ing.get_log(self, create=True)
            return log.commit(schema_name, table_name.lower(), delta)
        return self._apply_delta(schema_name, table_name.lower(), delta)

    def _append_lock(self, schema_name: str, table_name: str):
        """The per-table lock an append holds across its read-concat-swap
        (and the ingest log across its WAL write, so that the log's order
        is the order of the swaps).  Reentrant: replay applies under it."""
        key = (schema_name, table_name.lower())
        with self._append_locks_guard:
            lock = self._append_locks.get(key)
            if lock is None:
                lock = self._append_locks[key] = threading.RLock()
            return lock

    def _apply_delta(self, schema_name: str, table_name: str,
                     delta: Table) -> int:
        """Make one coerced batch visible under the table's append lock:
        without it two writers would read the same entry and the later
        swap would drop the earlier batch."""
        with self._append_lock(schema_name, table_name):
            return self._apply_delta_locked(schema_name, table_name, delta)

    def _apply_delta_locked(self, schema_name: str, table_name: str,
                            delta: Table) -> int:
        """A new catalog entry (the base and the batch concatenated, its
        statistics collected anew) and a delta-carrying epoch bump.  The
        entry is fetched and the batch coerced again: under
        micro-batching the table may have been replaced since."""
        from .ops.join import concat_tables
        from .runtime.resilience import UserError

        entry = self.schema[schema_name].tables.get(table_name)
        if entry is None or entry.table is None:
            raise UserError(f"Table {table_name} not found in schema "
                            f"{schema_name}; create it before INSERT INTO.")
        delta = _coerce_delta(entry.table, delta, self.device)
        base, row_valid = entry.table, None
        if entry.row_valid is not None:
            # a sharded base: its valid prefix (the padding is at the end)
            base = base.slice(0, int(entry.row_valid.sum()))
        new_table = concat_tables([base, delta])
        if self.mesh is not None:
            from .parallel.mesh import shard_table_with_validity
            new_table, row_valid = shard_table_with_validity(new_table,
                                                             self.mesh)
        new_entry = TableEntry(
            table=new_table, statistics=entry.statistics,
            filepath=entry.filepath, gpu=entry.gpu, row_valid=row_valid,
            stats=_stats.collect_table_stats(new_table, row_valid=row_valid))
        reg = self._matviews()
        if reg is not None:
            # the swap and the delta record are one step under the
            # registry lock: a refresh that saw the new table before its
            # delta was logged would count the batch twice
            with reg.lock:
                self.schema[schema_name].tables[table_name] = new_entry
                self.bump_table_epoch(schema_name, table_name, delta=delta)
        else:
            self.schema[schema_name].tables[table_name] = new_entry
            self.bump_table_epoch(schema_name, table_name, delta=delta)
        logger.debug("Appended %d rows to %s.%s (now %d)", delta.num_rows,
                     schema_name, table_name, new_table.num_rows)
        return delta.num_rows

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
        workload manager's admission, and the ingest log's snapshot pin
        when it is armed.  A nested plan (a thread that already holds
        both admissions) passes straight through them."""
        from contextlib import nullcontext

        from .runtime import scheduler as _sched
        from .runtime.gates import tenancy_on

        ten_adm = nullcontext()
        if tenancy_on():
            from .runtime import tenancy as _ten
            ten_adm = _ten.admission()
        # under the armed ingest log every scanned table's entry and epoch
        # are pinned at admission: the query reads one committed prefix
        pin = nullcontext()
        if _ing.enabled():
            pin = _ing.pin_scope(self, plan)
        with ten_adm, _sched.get_manager().admission(plan, self), pin:
            return self._run_query_plan(plan)

    def _run_query_plan(self, plan: RelNode) -> Table:
        """The result cache first: an identical plan over unchanged tables
        (the same epochs and table uids) is answered from memory
        (``result_cache=hit``); ``_rc_bypass`` skips the lookup, not the
        store.  Under a mesh the SPMD stage executor (``tier="spmd"``),
        then the compiled tier, and the eager executor where it
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
        # the SPMD stage executor first under a mesh (parallel/spmd.py);
        # None: outside its envelope or a runtime flag tripped, and the
        # single-device tiers serve the padded tables
        result = None
        span = _tel.current_span()
        if self.mesh is not None:
            from .parallel.spmd import try_execute_spmd
            result = try_execute_spmd(plan, self)
            if result is not None and span is not None:
                span.attrs.setdefault("tier", "spmd")
        if result is None:
            result = try_execute_compiled(plan, self)
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
            reg = self._matviews()
            if reg is not None:
                # a materialized view whose bases advanced refreshes here,
                # before the scan binds: a stale view is never served
                entry = reg.maybe_serve(self, schema_name,
                                        table_name.lower(), entry)
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


def _coerce_delta(target: Table, rows: Any, device) -> Table:
    """``rows`` as a Table of ``target``'s column names and types, on
    ``device`` (``append_rows``' alignment and casts, the JAX package's
    rules and messages, without pandas unless ``rows`` is a DataFrame).
    What does not fit raises ``SchemaMismatch`` naming the columns."""
    import numpy as np

    from .physical.rex.cast import cast_column
    from .runtime.resilience import SchemaMismatch, UserError
    from .table import Column, Scalar

    names = list(target.names)
    if isinstance(rows, Table):
        given = list(rows.names)
        cols = [_to(c, device) for c in rows.columns]
        n = rows.num_rows
    elif hasattr(rows, "columns") and hasattr(rows, "dtypes"):
        t = Table.from_pandas(rows, device)
        given = [c for c in rows.columns]
        cols, n = t.columns, t.num_rows
    elif isinstance(rows, dict):
        given = list(rows)
        arrays = [_series_column(v, device)
                  if hasattr(v, "array") and hasattr(v, "dtype")
                  else _host_values(v) for v in rows.values()]
        lengths = {len(a) for a in arrays}
        if len(lengths) > 1:
            raise SchemaMismatch(
                f"appended columns have different lengths {sorted(lengths)}")
        n = lengths.pop() if lengths else 0
        cols = arrays
    elif isinstance(rows, (list, tuple)):
        width = {len(r) for r in rows if isinstance(r, (list, tuple))}
        if width - {len(names)}:
            raise SchemaMismatch(
                f"appended row tuples have {sorted(width)} values but the "
                f"table has {len(names)} columns ({names})")
        given = list(names)
        n = len(rows)
        cols = [_host_values([r[i] for r in rows]) for i in range(len(names))]
    else:
        raise UserError(
            "append_rows accepts a Table, pandas DataFrame, dict of "
            f"columns, or list of row tuples; got {type(rows).__name__}")
    lower_map = {str(c).lower(): i for i, c in enumerate(given)}
    target_lower = {nm.lower() for nm in names}
    if all(nm.lower() in lower_map for nm in names) and \
            len(given) == len(names):
        cols = [cols[lower_map[nm.lower()]] for nm in names]
    elif len(given) == len(names):
        pass  # positional order
    elif 0 < len(given) < len(names) and set(lower_map) <= target_lower:
        # a named strict subset: the other columns fill NULL
        cols = [cols[lower_map[nm.lower()]] if nm.lower() in lower_map
                else None for nm in names]
    else:
        extra = sorted(set(lower_map) - target_lower)
        missing = sorted(target_lower - set(lower_map))
        detail = []
        if extra:
            detail.append(f"unknown column(s) {extra}")
        if missing:
            detail.append(f"missing column(s) {missing}")
        raise SchemaMismatch(
            f"appended rows have columns {given} but the table "
            f"has {names}: " + "; ".join(detail) +
            " — supply target columns by name (any case, a subset "
            "NULL-fills the rest) or all of them positionally")
    out = []
    for col, tgt, name in zip(cols, target.columns, names):
        if col is None or (not isinstance(col, Column)
                           and _all_null(col)):
            out.append(Column.from_scalar(Scalar(None, tgt.stype), n,
                                          device))
            continue
        if not isinstance(col, Column):
            col = Table.from_pydict({name: col}, device).columns[0]
        if col.stype.name != tgt.stype.name:
            try:
                col = cast_column(col, tgt.stype)
            except Exception as exc:
                raise SchemaMismatch(
                    f"column {name!r} of the appended rows "
                    f"({col.stype.name}) does not cast to the table's "
                    f"{tgt.stype.name}: {exc}") from exc
        out.append(col)
    return Table(names, out)


def _series_column(series, device):
    """A pandas Series of a dict batch, encoded at the pandas boundary."""
    from .table import Column, _as_mask, _to_device, host_encode_series

    data, mask, stype, dictionary = host_encode_series(series)
    return Column(_to_device(data, device), stype, _as_mask(mask, device),
                  dictionary)


def _is_na(v) -> bool:
    try:
        return v is None or bool(v != v)
    except (TypeError, ValueError):
        return False


def _host_values(values):
    """A column of an appended batch as a host array: numpy arrays pass
    through; a list of datetimes becomes datetime64, as pandas would
    read it."""
    import datetime

    import numpy as np

    if isinstance(values, np.ndarray):
        return values
    values = list(values)
    present = [v for v in values if not _is_na(v)]
    if present and all(isinstance(v, datetime.datetime) for v in present):
        return np.array([np.datetime64("NaT") if _is_na(v)
                         else np.datetime64(v.replace(tzinfo=None), "us")
                         for v in values], dtype="datetime64[us]")
    if present and all(isinstance(v, datetime.date) for v in present):
        return np.array([np.datetime64("NaT") if _is_na(v)
                         else np.datetime64(v, "D") for v in values],
                        dtype="datetime64[D]")
    return values


def _all_null(values) -> bool:
    import numpy as np

    if isinstance(values, np.ndarray):
        if values.dtype.kind == "f":
            return len(values) > 0 and bool(np.isnan(values).all())
        if values.dtype.kind in "mM":
            return len(values) > 0 and bool(np.isnat(values).all())
        if values.dtype.kind != "O":
            return False
    return len(values) > 0 and all(_is_na(v) for v in values)


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
