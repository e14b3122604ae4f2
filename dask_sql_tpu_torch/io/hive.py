"""Hive metastore ingestion: DESCRIBE FORMATTED -> columnar device Table.

The counterpart of ``dask_sql_tpu/io/hive.py``, with the same state-machine
parse of ``DESCRIBE FORMATTED`` / ``SHOW PARTITIONS`` output (pure Python),
the same InputFormat -> reader mapping and partition-column synthesis,
duck-typed over any DB-API-like cursor (``execute`` plus ``fetchall`` on
the cursor or on the execute result): pyhive, a sqlalchemy connection or a
test double.  The files are read through pandas, imported inside the
functions that read, and land in a ``Table`` on the caller's device.
"""
from __future__ import annotations

import ast
import contextlib
import glob as _glob
import logging
import os
from typing import Any, Dict, Optional, Tuple

from ..table import Table
from ..utils import import_pandas

logger = logging.getLogger(__name__)

# hive type name -> the pandas dtype the column is cast to before upload
_HIVE_TYPES = {
    "TINYINT": "int8", "SMALLINT": "int16", "INT": "int32", "INTEGER": "int32",
    "BIGINT": "int64", "FLOAT": "float32", "DOUBLE": "float64",
    "DECIMAL": "float64", "NUMERIC": "float64", "BOOLEAN": "bool",
    "STRING": "object", "VARCHAR": "object", "CHAR": "object",
    "DATE": "datetime64[ns]", "TIMESTAMP": "datetime64[ns]",
    "BINARY": "object",
}


def _hive_cast(df, col: str, hive_type: str):
    base = hive_type.upper().split("(")[0].strip()
    dtype = _HIVE_TYPES.get(base)
    if dtype is None:
        logger.warning("Unknown hive type %s for column %s", hive_type, col)
        return df
    if df[col].dtype != dtype:
        try:
            df[col] = df[col].astype(dtype)
        except (TypeError, ValueError):
            logger.warning("Could not cast %s to %s", col, dtype)
    return df


def _fetch_all(cursor, sql: str):
    """pyhive fetches on the cursor, sqlalchemy on the execute result."""
    result = cursor.execute(sql)
    try:
        return result.fetchall()
    except AttributeError:
        return cursor.fetchall()


def parse_hive_table_description(
    cursor, schema: str, table_name: str, partition: Optional[str] = None
) -> Tuple[Dict, Dict, Dict, Dict]:
    """State-machine parse of DESCRIBE FORMATTED output: the (columns,
    table, storage, partitions) information dicts, in insertion order."""
    _fetch_all(cursor, f"USE {schema}")
    if partition:
        rows = _fetch_all(
            cursor, f"DESCRIBE FORMATTED {table_name} PARTITION ({partition})")
    else:
        rows = _fetch_all(cursor, f"DESCRIBE FORMATTED {table_name}")

    table_information: Dict = {}
    column_information: Dict = {}
    storage_information: Dict = {}
    partition_information: Dict = {}
    mode = "column"
    last_field = None

    for key, value, value2 in rows:
        key = key.strip().rstrip(":") if key else ""
        value = value.strip() if value else ""
        value2 = value2.strip() if value2 else ""

        if key == "# col_name":
            continue
        if key in ("# Detailed Table Information",
                   "# Detailed Partition Information"):
            mode = "table"
        elif key == "# Storage Information":
            mode = "storage"
        elif key == "# Partition Information":
            mode = "partition"
        elif key.startswith("#"):
            mode = None
        elif key:
            if not value:
                value = dict()
            target = {"column": column_information, "storage":
                      storage_information, "table": table_information,
                      "partition": partition_information}.get(mode)
            if target is not None:
                target[key] = value
                last_field = target[key]
        elif value and isinstance(last_field, dict):
            last_field[value] = value2

    return (column_information, table_information, storage_information,
            partition_information)


def parse_hive_partition_description(cursor, schema: str, table_name: str):
    """SHOW PARTITIONS -> ['key=value/key2=value2', ...]."""
    _fetch_all(cursor, f"USE {schema}")
    return [row[0] for row in _fetch_all(cursor,
                                         f"SHOW PARTITIONS {table_name}")]


def _normalize_location(loc: str) -> str:
    if loc.startswith("dbfs:/") and not loc.startswith("dbfs://"):
        loc = f"dbfs://{loc.lstrip('dbfs:')}"
    if loc.startswith("file:"):
        loc = loc[len("file:"):]
    # skip dot and underscore files (_SUCCESS and the like)
    return os.path.join(loc, "[A-Za-z0-9-]*")


def _expand_files(pattern: str):
    """Glob expansion: fsspec for remote URIs (hdfs://, s3://, dbfs://),
    the standard library's glob for local paths.  Returns
    (filesystem or None, paths)."""
    if "://" in pattern:
        import fsspec
        fs, _, paths = fsspec.get_fs_token_paths(pattern)
        return fs, (paths or [pattern])
    return None, (sorted(_glob.glob(pattern)) or [pattern])


def _read_location(location: str, fmt: str, column_information: Dict,
                   storage_information: Dict, **kwargs):
    pd = import_pandas("Reading a Hive table")
    fs, paths = _expand_files(_normalize_location(location))

    @contextlib.contextmanager
    def _open(p):
        if fs is None:
            yield p
        else:
            with fs.open(p, "rb") as f:
                yield f

    def _read_all(reader):
        out = []
        for p in paths:
            with _open(p) as f:
                out.append(reader(f))
        return out

    if fmt in ("TextInputFormat", "SequenceFileInputFormat"):
        sep = storage_information.get("Storage Desc Params", {}) \
            .get("field.delim", ",")
        frames = _read_all(
            lambda f: pd.read_csv(f, sep=sep, header=None, **kwargs))
    elif fmt in ("ParquetInputFormat", "MapredParquetInputFormat"):
        # only the metastore's columns: a partition directory (.../col=3/)
        # would otherwise surface as an extra column and the positional
        # rename below would mislabel the data
        kwargs.setdefault("columns", list(column_information.keys()))
        frames = _read_all(lambda f: pd.read_parquet(f, **kwargs))
    elif fmt == "OrcInputFormat":
        frames = _read_all(lambda f: pd.read_orc(f, **kwargs))
    elif fmt == "JsonInputFormat":
        frames = _read_all(lambda f: pd.read_json(f, lines=True, **kwargs))
    else:
        raise AttributeError(f"Do not understand hive's table format {fmt}")
    df = pd.concat(frames, ignore_index=True) if len(frames) > 1 else frames[0]
    df = df.rename(columns=dict(zip(df.columns, column_information.keys())))
    for col, hive_type in column_information.items():
        df = _hive_cast(df, col, hive_type)
    return df


def hive_table_to_pandas(cursor, table_name: str, schema: str = "default",
                         **kwargs):
    """A Hive table (every partition) as one pandas frame."""
    (column_information, table_information, storage_information,
     partition_information) = parse_hive_table_description(
        cursor, schema, table_name)

    if "InputFormat" in storage_information:
        fmt = storage_information["InputFormat"].split(".")[-1]
    elif "InputFormat" in table_information:  # the databricks layout
        fmt = table_information["InputFormat"].split(".")[-1]
    else:
        raise RuntimeError(
            "Do not understand the output of 'DESCRIBE FORMATTED <table>'")

    if partition_information:
        pd = import_pandas("Reading a Hive table")
        partitions = parse_hive_partition_description(cursor, schema,
                                                      table_name)
        frames = []
        for partition in partitions:
            (part_cols, part_table, _, _) = parse_hive_table_description(
                cursor, schema, table_name, partition=partition)
            df = _read_location(part_table["Location"], fmt, part_cols,
                                storage_information, **kwargs)
            values = ast.literal_eval(part_table["Partition Value"])
            for i, (pkey, ptype) in enumerate(partition_information.items()):
                df[pkey] = values[i]
                df = _hive_cast(df, pkey, ptype)
            frames.append(df)
        return pd.concat(frames, ignore_index=True)

    return _read_location(table_information["Location"], fmt,
                          column_information, storage_information, **kwargs)


class HiveInput:
    """Duck-typed Hive ingestion (registered as an input plugin)."""

    @staticmethod
    def is_hive_like(input_item: Any, **kwargs) -> bool:
        if kwargs.get("format") == "hive" or kwargs.get("file_format") == "hive":
            return True
        mod = type(input_item).__module__ or ""
        if mod.startswith("pyhive"):
            return True
        # sqlalchemy: only a Connection is a cursor Hive can use
        if mod.startswith("sqlalchemy"):
            return (type(input_item).__name__ == "Connection"
                    and hasattr(input_item, "execute"))
        return False

    @staticmethod
    def to_table(input_item: Any, *, device, table_name: Optional[str] = None,
                 **kwargs) -> Table:
        name = kwargs.pop("hive_table_name", table_name)
        schema = kwargs.pop("hive_schema_name", "default")
        kwargs.pop("format", None)
        kwargs.pop("file_format", None)
        df = hive_table_to_pandas(input_item, name, schema, **kwargs)
        return Table.from_pandas(df, device)
