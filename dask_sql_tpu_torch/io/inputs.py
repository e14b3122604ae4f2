"""Input plugins: anything ``Context.create_table`` takes -> a device Table.

The counterpart of ``dask_sql_tpu/io/inputs.py``: ``InputUtil.to_table``
probes the registered plugins in order (the Context registers them in the
JAX package's order: a ``Table``, a pandas frame or Series, a dict, a
pyarrow table, a Hive cursor, an intake catalog, a file path); a list of
inputs becomes one table through ``ops/join.py``'s ``concat_tables``.
Every table lands on ``device``.

A ``Table`` and a dict of numpy arrays need neither pandas nor pyarrow.
The readers (csv/tsv/txt, parquet, json, feather/arrow, orc, Hive,
intake) read through pandas, imported inside the plugin that reads; a
machine without it raises ``ImportError`` naming pandas.  A pandas or
pyarrow object is recognised only where its package is already imported
(whoever made the object imported it), so probing an input never imports
either.
"""
from __future__ import annotations

import os
import sys
from typing import Any, Optional

from ..table import Column, Table
from ..utils import Pluggable, import_pandas

#: create_table's own keywords, never passed to a reader
_NOT_READ = ("persist", "schema_name", "statistics", "gpu", "table_name")


class InputUtil(Pluggable):
    """Probes input plugins in registration order."""

    @classmethod
    def to_table(cls, input_item: Any, *, device, **kwargs) -> Table:
        if isinstance(input_item, list):
            from ..ops.join import concat_tables
            return concat_tables([cls.to_table(i, device=device, **kwargs)
                                  for i in input_item])
        for plugin in cls.get_plugins():
            if plugin.is_correct_input(input_item, **kwargs):
                return plugin.to_table(input_item, device=device, **kwargs)
        raise ValueError(f"Do not understand the input type {type(input_item)}")


def _loaded(module: str):
    """``module`` if this process has imported it, else None."""
    return sys.modules.get(module)


def table_on_device(table: Table, device) -> Table:
    """``table`` with every column moved to ``device``."""
    return Table(table.names, [
        Column(c.data.to(device), c.stype,
               None if c.mask is None else c.mask.to(device), c.dictionary)
        for c in table.columns])


class BaseInputPlugin:
    def is_correct_input(self, input_item, **kwargs) -> bool:
        raise NotImplementedError

    def to_table(self, input_item, *, device, **kwargs) -> Table:
        raise NotImplementedError


class DeviceTableInputPlugin(BaseInputPlugin):
    """Already a ``Table``: its columns move to ``device``."""

    def is_correct_input(self, input_item, **kwargs):
        return isinstance(input_item, Table)

    def to_table(self, input_item, *, device, **kwargs):
        return table_on_device(input_item, device)


class PandasLikeInputPlugin(BaseInputPlugin):
    """A pandas DataFrame or Series."""

    def is_correct_input(self, input_item, **kwargs):
        pd = _loaded("pandas")
        return pd is not None and isinstance(input_item,
                                             (pd.DataFrame, pd.Series))

    def to_table(self, input_item, *, device, **kwargs):
        pd = _loaded("pandas")
        if isinstance(input_item, pd.Series):
            input_item = input_item.to_frame()
        return Table.from_pandas(input_item, device)


class DictInputPlugin(BaseInputPlugin):
    """A dict of column -> numpy array or list (no pandas)."""

    def is_correct_input(self, input_item, **kwargs):
        return isinstance(input_item, dict)

    def to_table(self, input_item, *, device, **kwargs):
        return Table.from_pydict(input_item, device)


class ArrowInputPlugin(BaseInputPlugin):
    def is_correct_input(self, input_item, **kwargs):
        pa = _loaded("pyarrow")
        return pa is not None and isinstance(input_item, pa.Table)

    def to_table(self, input_item, *, device, **kwargs):
        import_pandas("A pyarrow table")
        return Table.from_pandas(input_item.to_pandas(), device)


class LocationInputPlugin(BaseInputPlugin):
    """A file path -> the reader of its extension (or of ``file_format``)."""

    def is_correct_input(self, input_item, **kwargs):
        return isinstance(input_item, str)

    def to_table(self, input_item: str, *, device,
                 file_format: Optional[str] = None, **kwargs) -> Table:
        if not file_format:
            file_format = os.path.splitext(input_item)[1].lstrip(".")
        file_format = (file_format or "").lower()
        read_kwargs = {k: v for k, v in kwargs.items() if k not in _NOT_READ}
        readers = {"csv": "read_csv", "tsv": "read_csv", "txt": "read_csv",
                   "parquet": "read_parquet", "pq": "read_parquet",
                   "json": "read_json", "feather": "read_feather",
                   "arrow": "read_feather", "orc": "read_orc"}
        if file_format not in readers:
            raise AttributeError(
                f"Do not understand input format {file_format}")
        pd = import_pandas(f"Reading a {file_format} file")
        if file_format == "tsv" and "sep" not in read_kwargs:
            read_kwargs["sep"] = "\t"
        df = getattr(pd, readers[file_format])(input_item, **read_kwargs)
        return Table.from_pandas(df, device)


class HiveInputPlugin(BaseInputPlugin):
    """Hive metastore tables through any DB-API-like cursor
    (``io/hive.py``)."""

    def is_correct_input(self, input_item, **kwargs):
        from .hive import HiveInput
        return HiveInput.is_hive_like(input_item, **kwargs)

    def to_table(self, input_item, *, device, **kwargs):
        from .hive import HiveInput
        return HiveInput.to_table(input_item, device=device, **kwargs)


class IntakeCatalogInputPlugin(BaseInputPlugin):
    """Intake catalogs: the named entry is read into pandas and encoded
    to a device Table.  Takes a Catalog object or, with
    ``file_format="intake"``, a catalog path or URL."""

    @staticmethod
    def _intake():
        try:
            import intake
            return intake
        except ImportError:
            return None

    def is_correct_input(self, input_item, file_format=None, **kwargs):
        if file_format == "intake":
            # claimed without intake too, so that to_table raises the
            # ImportError that names it
            return True
        intake = _loaded("intake")
        return (intake is not None
                and isinstance(input_item, intake.catalog.Catalog))

    def to_table(self, input_item, *, device, table_name=None,
                 file_format=None, **kwargs):
        intake = self._intake()
        if intake is None:
            raise ImportError("Intake ingestion requires intake")
        table_name = kwargs.pop("intake_table_name", table_name)
        catalog_kwargs = kwargs.pop("catalog_kwargs", {})
        if isinstance(input_item, str):
            input_item = intake.open_catalog(input_item, **catalog_kwargs)
        read_kwargs = {k: v for k, v in kwargs.items() if k not in _NOT_READ}
        source = input_item[table_name](**read_kwargs) if read_kwargs \
            else input_item[table_name]
        return Table.from_pandas(source.read(), device)
