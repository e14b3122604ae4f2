"""Whole tables on a mesh across processes, for what the SPMD walker does
not serve.

On a mesh across processes of more than one rank a resident table's
catalog entry holds this rank's rows only (``TableEntry.rank_rows``,
``mesh.place_rank_rows``), with the whole table's statistics and string
dictionaries.  The SPMD walker (``parallel/spmd.py``) reads those rows
as they are, inside ``walker_scope``.  Every other reader of rows needs
the whole table, as the JAX package's single-device tiers read its
global arrays:

- ``whole_tables(context, plan)``: the block in which the single-device
  tiers run ``plan`` (the walker declined it or fell back, alike on every
  rank, or ``DSQL_MESH=0``; a materialized view's refresh; a streamed
  plan's resident tables; a streamed batch plan the walker declines, over
  the batch's rows from every rank, dropped before the next batch's
  gather and when the query ends: ``drop_schema``).  Each rank-local
  table the plan scans is pinned for the block as a whole entry of the
  columns the plan scans
  (``runtime/ingest.carried_pins``): ``Context.catalog_entry`` reads it,
  on this thread and on the threads the compiled tier carries the pins
  to (stage workers, background builds);
- ``whole_entry(context, schema, table, names)``: one table whole (an
  append's base, ANALYZE TABLE, the fugue integration's inputs).

Each rebuilds the columns it lacks with ``mesh.gather_rows`` (one
all_gather per column, in shard order, counted ``mesh_gathers`` and
``mesh_gather_bytes``) on every rank at the same point, inside one agreed
step (``spmd._agreed``: every rank reports what it gathered and how it
ended).  A failed collective, a rank that does not report within the
group's timeout, or ranks that gathered different columns raise
``RankError`` on every rank; a group broken earlier refuses at once.
The gathered columns are cached per table (``Context._gathered``) and
dropped when its epoch moves (``drop``, from ``bump_table_epoch``), so a
repeated plan gathers nothing and the compiled tier's program reads the
same tensors (its CUDA graph replays).  A table that only the walker
reads is never gathered.

A single-device tier that meets a rank-local entry outside these
(``check_whole``, in the compiled tier's and the eager executor's scans)
raises: it would answer from this rank's rows alone.
"""
from __future__ import annotations

import logging
import threading
from contextlib import contextmanager
from typing import Dict, List, Tuple

from ..runtime import ingest as _ing
from ..runtime import telemetry as _tel

logger = logging.getLogger(__name__)

_TLS = threading.local()


@contextmanager
def walker_scope():
    """The SPMD walker's block: its scans read this rank's rows."""
    _TLS.walker = getattr(_TLS, "walker", 0) + 1
    try:
        yield
    finally:
        _TLS.walker -= 1


def check_whole(entry, schema_name: str, table_name: str) -> None:
    """Raise where a single-device tier would read this rank's rows as if
    they were the table."""
    if entry.rank_rows is not None and not getattr(_TLS, "walker", 0):
        raise RuntimeError(
            f"{schema_name}.{table_name} holds this rank's rows only (a mesh "
            f"across processes); a single-device tier reads it whole "
            f"through parallel.gather")


class _Whole:
    """The gathered columns of one rank-local entry, and the whole entries
    made of them, one per column set."""

    __slots__ = ("entry", "cols", "row_valid", "views")

    def __init__(self, entry):
        self.entry = entry
        self.cols: Dict[str, object] = {}
        self.row_valid = None
        self.views: Dict[tuple, object] = {}

    def view(self, names: List[str]):
        from ..datacontainer import TableEntry
        from ..table import Table

        key = tuple(names)
        hit = self.views.get(key)
        if hit is None:
            hit = self.views[key] = TableEntry(
                table=Table(list(names), [self.cols[n] for n in names]),
                stats=self.entry.stats, row_valid=self.row_valid)
        return hit


def _cache(context) -> Dict[Tuple[str, str], _Whole]:
    return context.__dict__.setdefault("_gathered", {})


def drop(context, schema_name: str, table_name: str) -> None:
    """Forget a table's gathered columns (its epoch moved)."""
    context.__dict__.get("_gathered", {}).pop(
        (schema_name, table_name.lower()), None)


def drop_schema(context, schema_name: str) -> None:
    """Forget the gathered columns of every table of ``schema_name`` (a
    streamed query's ``__stream__`` batch, before the next batch's gather
    and when the query ends)."""
    cache = context.__dict__.get("_gathered", {})
    for key in [k for k in cache if k[0] == schema_name]:
        del cache[key]


def _record(context, key, entry) -> _Whole:
    cache = _cache(context)
    rec = cache.get(key)
    if rec is None or rec.entry is not entry:
        rec = cache[key] = _Whole(entry)
    return rec


def _columns(entry, wanted) -> List[str]:
    """The table's columns among ``wanted``, in the table's order; a plan
    that scans none (``COUNT(*)``) still gets the first, which carries
    the row count."""
    names = [n for n in entry.table.names if n in wanted]
    return names or list(entry.table.names[:1])


def _fill(context, wants: list) -> None:
    """Gather, in one agreed step, the columns of ``wants`` ((key, entry,
    names) per table) that are not cached yet."""
    from ..table import Table
    from . import group as G
    from .mesh import gather_rows
    from .spmd import RankError, _agreed

    todo = []
    for key, entry, names in wants:
        rec = _record(context, key, entry)
        missing = [n for n in names if n not in rec.cols]
        need_rv = entry.row_valid is not None and rec.row_valid is None
        if missing or need_rv:
            todo.append((key, entry, rec, missing, need_rv))
    if not todo:
        return
    mesh = context.mesh
    group = mesh.group
    work = [(f"{key[0]}.{key[1]}", missing, need_rv,
             int(entry.table.num_rows)) for key, entry, _, missing, need_rv
            in todo]

    def run():
        out = []
        for _, entry, _, missing, need_rv in todo:
            part = Table(missing, [entry.table.column(n) for n in missing])
            out.append(gather_rows(part, entry.row_valid if need_rv
                                   else None, mesh))
        G.wait_device(group, "a gather of catalog rows")
        return out

    try:
        if group.broken is not None:
            raise RankError(f"rank {mesh.rank}: the mesh's process group "
                            f"broke earlier ({group.broken}); set it up "
                            f"again with init_multihost")
        with group.lock:
            got = _agreed(mesh, run, lambda: work)
    except RankError as e:
        _tel.inc("spmd_rank_errors")
        _tel.annotate(spmd_error=f"RankError: {str(e)[:200]}")
        raise
    for (_, _, rec, _, need_rv), (table, valid) in zip(todo, got):
        rec.cols.update(zip(table.names, table.columns))
        if need_rv:
            rec.row_valid = valid
    logger.debug("gathered %s", work)


def _plan_wants(context, plan) -> list:
    """(key, entry, names) of every rank-local table ``plan`` scans, with
    the columns its scans read, in the plan's order (alike on every
    rank)."""
    scans: list = []
    _ing._collect_scans(plan, scans)
    by_key: Dict[Tuple[str, str], list] = {}
    for scan in scans:
        sc = context.schema.get(scan.schema_name)
        entry = sc.tables.get(scan.table_name) if sc is not None else None
        if entry is None or entry.rank_rows is None:
            continue
        by_key.setdefault((scan.schema_name, scan.table_name),
                          [entry, set()])[1].update(f.name
                                                    for f in scan.schema)
    return [(key, entry, _columns(entry, wanted))
            for key, (entry, wanted) in by_key.items()]


@contextmanager
def whole_tables(context, plan):
    """The block in which a single-device tier runs ``plan``: every
    rank-local table it scans pinned as a whole entry of its scanned
    columns, gathered where they are not cached (module docstring)."""
    wants = _plan_wants(context, plan)
    if not wants:
        yield
        return
    _fill(context, wants)
    pins = dict(_ing.current_pins() or {})
    cache = _cache(context)
    for key, _, names in wants:
        pins[key] = (cache[key].view(names), context.table_epoch(*key))
    with _ing.carried_pins(pins):
        yield


def whole_entry(context, schema_name: str, table_name: str, names=None):
    """The table's entry whole: itself where it is whole, else a whole
    entry of ``names`` (every column by default), gathered where the
    columns are not cached."""
    entry = context.schema[schema_name].tables[table_name]
    if entry.rank_rows is None:
        return entry
    names = _columns(entry, set(entry.table.names if names is None
                                else names))
    key = (schema_name, table_name)
    _fill(context, [(key, entry, names)])
    return _cache(context)[key].view(names)
