"""Catalog containers: schemas, tables, functions, models.

Mirrors the reference's datacontainer.py (SchemaContainer,
upstream dask_sql/datacontainer.py:184-191, FunctionDescription :9) —
but tables are device-columnar ``Table`` objects (see table.py for why no
frontend/backend column mapping is needed here).
"""
from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Any, Callable, Dict, List, Optional, Tuple

from .table import Table
from .types import SqlType


@dataclass
class FunctionDescription:
    name: str
    parameters: List[Tuple[str, SqlType]]
    return_type: SqlType
    aggregation: bool
    func: Callable = None
    row_udf: bool = False


@dataclass(frozen=True)
class RankRows:
    """What a rank-local catalog entry holds on a mesh across processes:
    rows ``[first, first + padded // world)`` of the global padded table
    of ``padded`` rows, of which the first ``rows`` are real."""
    padded: int
    rows: int
    first: int


@dataclass
class TableEntry:
    """A registered table: materialized device table or a lazy view plan."""
    table: Optional[Table] = None
    plan: Any = None               # bound RelNode for CREATE VIEW ... AS
    statistics: Optional[dict] = None
    # ingest-time TableStats (runtime/statistics.py): row count, per-column
    # NDV/min-max/null-fraction/dense-int detection — drives adaptive
    # operator dispatch, join ordering, and the scheduler's working-set
    # estimate.  Separate from ``statistics`` (the user-supplied dict kept
    # for reference parity).
    stats: Any = None
    filepath: Optional[str] = None
    gpu: bool = False              # parity flag only
    # mesh mode: columns are padded to a multiple of the mesh size and
    # row-sharded; row_valid (same sharding) marks the real rows
    row_valid: Any = None
    # a mesh across processes of more than one rank: the table, its
    # row_valid included, holds this rank's rows only (``RankRows``; the
    # statistics and string dictionaries stay the whole table's).  None:
    # the entry is whole (every other mesh, CTAS and view results, temps)
    rank_rows: Optional[RankRows] = None
    # out-of-HBM mode: host-resident ChunkedSource (io/chunked.py);
    # ``table`` is then a 1-row binding stub, and execution must go through
    # physical/streaming.py (context routes it)
    chunked: Any = None


class SchemaContainer:
    def __init__(self, name: str):
        self.name = name
        self.tables: Dict[str, TableEntry] = {}
        self.models: Dict[str, Tuple[Any, List[str]]] = {}
        self.experiments: Dict[str, Table] = {}
        self.functions: Dict[str, FunctionDescription] = {}
        self.function_lists: List[FunctionDescription] = []

    def add_table(self, name: str, entry: TableEntry):
        self.tables[name] = entry
