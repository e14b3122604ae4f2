"""Columnar device tables on torch tensors.

The counterpart of ``dask_sql_tpu/table.py``: a table is an ordered list of
``Column`` objects, each wrapping one torch tensor on an explicit device.
Renames and projections are host-side list surgery.

Null handling: every column may carry a boolean validity ``mask`` (True =
valid) on the same device as its data.

Strings are dictionary-encoded at ingestion: ``data`` holds int32 codes into
a host-side numpy ``dictionary`` of unique values; string work runs on the
(small) dictionary on the host and on codes on the device.  The dictionary
order and the rank order (``dict_sort_order``) are the JAX package's, so
static GROUP BY slots and output order agree between the two engines.

pandas is imported only inside ``from_pandas`` / ``to_pandas`` and
``host_encode_series``: the main path runs on dicts of numpy arrays.
"""
from __future__ import annotations

import itertools
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Iterable, Optional, Sequence

import numpy as np
import torch

from .types import (
    SqlType,
    DOUBLE,
    INTEGER,
    VARCHAR,
    physical_dtype,
    physical_to_python_value,
    sql_type_from_numpy,
    torch_dtype,
)


# ---------------------------------------------------------------------------
# Scalar
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Scalar:
    """A typed SQL scalar in physical representation. ``value is None`` = NULL."""

    value: Any
    stype: SqlType

    @property
    def is_null(self) -> bool:
        return self.value is None


# ---------------------------------------------------------------------------
# Column
# ---------------------------------------------------------------------------

class Column:
    """One device column: tensor data + optional validity mask + logical type.

    ``host`` optionally holds (data, mask) numpy copies of the same values
    (a compiled-tier result fetched in one transfer): ``to_numpy`` reads
    them instead of the device."""

    __slots__ = ("data", "mask", "stype", "dictionary", "host")

    def __init__(
        self,
        data: torch.Tensor,
        stype: SqlType,
        mask: Optional[torch.Tensor] = None,
        dictionary: Optional[np.ndarray] = None,
        host: Optional[tuple] = None,
    ):
        self.data = data
        self.stype = stype
        self.mask = mask
        self.dictionary = dictionary
        self.host = host
        if stype.is_string and dictionary is None:
            raise ValueError("string columns require a dictionary")

    # -- constructors ------------------------------------------------------
    @staticmethod
    def from_numpy(values: np.ndarray, device: torch.device,
                   stype: Optional[SqlType] = None,
                   mask: Optional[np.ndarray] = None) -> "Column":
        data, m, st, dictionary = host_encode_numpy(values, stype, mask)
        return Column(_to_device(data, device), st, _as_mask(m, device),
                      dictionary)

    @staticmethod
    def from_encoded(data: np.ndarray, stype: SqlType,
                     mask: Optional[np.ndarray],
                     dictionary: Optional[np.ndarray],
                     device: torch.device) -> "Column":
        """Upload already-encoded physical data (see ``convert.py``)."""
        return Column(_to_device(np.asarray(data, physical_dtype(stype)),
                                 device),
                      stype, _as_mask(mask, device), dictionary)

    @staticmethod
    def _encode_strings(values: np.ndarray, mask: Optional[np.ndarray],
                        device: torch.device) -> "Column":
        data, m, st, dictionary = _host_encode_strings(values, mask)
        return Column(_to_device(data, device), st, _as_mask(m, device),
                      dictionary)

    @staticmethod
    def from_scalar(scalar: Scalar, length: int,
                    device: torch.device) -> "Column":
        stype = scalar.stype
        if scalar.is_null:
            if stype.name == "NULL":
                stype = DOUBLE
            null_mask = torch.zeros(length, dtype=torch.bool, device=device)
            if stype.is_string:
                return Column(torch.zeros(length, dtype=torch.int32,
                                          device=device),
                              stype, null_mask, np.array([""], dtype=object))
            return Column(torch.zeros(length, dtype=torch_dtype(stype),
                                      device=device), stype, null_mask)
        if stype.is_string:
            return Column(torch.zeros(length, dtype=torch.int32,
                                      device=device), stype, None,
                          np.array([scalar.value], dtype=object))
        return Column(torch.full((length,), scalar.value,
                                 dtype=torch_dtype(stype), device=device),
                      stype, None)

    # -- basics ------------------------------------------------------------
    def __len__(self) -> int:
        return int(self.data.shape[0])

    @property
    def device(self) -> torch.device:
        return self.data.device

    def valid_mask(self) -> torch.Tensor:
        """Always-materialized validity mask."""
        if self.mask is None:
            return torch.ones(self.data.shape[0], dtype=torch.bool,
                              device=self.data.device)
        return self.mask

    def null_count(self) -> int:
        if self.mask is None:
            return 0
        return int((~self.mask).sum())

    def take(self, indices: torch.Tensor) -> "Column":
        """Gather rows by position (device gather)."""
        data = self.data[indices]
        mask = None if self.mask is None else self.mask[indices]
        return Column(data, self.stype, mask, self.dictionary)

    def slice(self, start: int, stop: int) -> "Column":
        data = self.data[start:stop]
        mask = None if self.mask is None else self.mask[start:stop]
        return Column(data, self.stype, mask, self.dictionary)

    # -- dictionary helpers ------------------------------------------------
    def decode(self) -> np.ndarray:
        """Host numpy array of python objects (strings/None) for a string column."""
        if not self.stype.is_string:
            raise TypeError(f"decode() needs a string column, got {self.stype}")
        codes = self.data.cpu().numpy()
        out = self.dictionary[np.clip(codes, 0, len(self.dictionary) - 1)]
        if self.mask is not None:
            out = out.copy()
            out[~self.mask.cpu().numpy()] = None
        return out

    def dict_ranks(self) -> "Column":
        """Codes mapped to sort-order ranks (``dict_sort_order``): the rank
        array is built on the host (the dictionary is small) and gathered on
        the device."""
        if not self.stype.is_string:
            raise TypeError(f"dict_ranks() needs a string column, got {self.stype}")
        order = dict_sort_order(self.dictionary)
        ranks = np.empty(len(order), dtype=np.int32)
        ranks[order] = np.arange(len(order), dtype=np.int32)
        ranks_t = torch.from_numpy(ranks).to(self.data.device)
        data = ranks_t[self.data.clamp(0, len(ranks) - 1).long()]
        return Column(data, INTEGER, self.mask)

    # -- host conversion ---------------------------------------------------
    def to_numpy(self) -> np.ndarray:
        """Host representation with rich types; nulls become None/NaN/NaT."""
        if self.host is not None:
            data, mask = self.host
        else:
            data = self.data.cpu().numpy()
            mask = None if self.mask is None else self.mask.cpu().numpy()
        if mask is not None and mask.all():
            mask = None
        if self.stype.is_string:
            d = self.dictionary
            out = d[np.clip(data, 0, len(d) - 1)]
            if mask is not None:
                out = out.copy()
                out[~mask] = None
            return out
        return host_decode(data, mask, self.stype)

    def to_pylist(self) -> list:
        """Python values: dates and timestamps as ``datetime`` objects,
        intervals as ``timedelta``, every NULL as None (a float NULL too,
        where the JAX package's list keeps NaN)."""
        values = self.to_numpy()
        out = values.tolist()
        if values.dtype.kind == "f" and self.mask is not None:
            mask = (self.host[1] if self.host is not None
                    and self.host[1] is not None else
                    self.mask.cpu().numpy())
            for i in np.flatnonzero(~mask).tolist():
                out[i] = None
        return out

    def __repr__(self):
        return f"Column({self.stype}, len={len(self)}, nulls={self.null_count()})"


def host_decode(data: np.ndarray, mask: Optional[np.ndarray],
                stype: SqlType) -> np.ndarray:
    """Physical host data + mask -> rich numpy values (the JAX package's
    ``Column.to_numpy`` rules: NaT for temporal nulls, NaN for float nulls,
    None in an object array for int/bool nulls)."""
    n = stype.name
    if n == "DATE":
        out = data.astype("datetime64[D]")
        if mask is not None:
            out[~mask] = np.datetime64("NaT")
        return out
    if n in ("TIMESTAMP", "TIMESTAMP_WITH_LOCAL_TIME_ZONE"):
        out = data.astype("datetime64[us]")
        if mask is not None:
            out[~mask] = np.datetime64("NaT")
        return out
    if n == "INTERVAL_DAY_TIME":
        out = data.astype("timedelta64[ms]")
        if mask is not None:
            out[~mask] = np.timedelta64("NaT")
        return out
    if n == "TIME":
        vals = [physical_to_python_value(int(v), stype) for v in data.tolist()]
        out = np.array(vals, dtype=object)
        if mask is not None:
            out[~mask] = None
        return out
    if mask is not None:
        if data.dtype.kind == "f":
            out = data.copy()
            out[~mask] = np.nan
            return out
        out = data.astype(object)
        out[~mask] = None
        return out
    return data


def dict_sort_order(dictionary: np.ndarray) -> np.ndarray:
    """Dictionary indices in string sort order: order[rank] = dict index.

    The single source of truth for string collation — group ordering,
    MIN/MAX, and static-domain key decoding must all agree on it.
    """
    return np.argsort(dictionary.astype(str), kind="stable")


def _to_device(data: np.ndarray, device: torch.device) -> torch.Tensor:
    """A tensor on ``device`` that never shares memory with ``data``."""
    data = np.ascontiguousarray(data)
    if torch.device(device).type == "cpu" or not data.flags.writeable:
        data = data.copy()
    return torch.from_numpy(data).to(device)


def tensors_to_host(tensors: Sequence[torch.Tensor]) -> list:
    """Numpy copies of ``tensors`` in one device-to-host transfer: on the
    card the tensors are packed as bytes into one buffer and copied into
    pinned host memory; on the CPU each is copied."""
    tensors = list(tensors)
    if not tensors or not tensors[0].is_cuda:
        return [t.detach().clone().numpy() for t in tensors]
    pieces = [t.contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    packed = torch.cat(pieces)
    host = torch.empty(packed.shape, dtype=torch.uint8, pin_memory=True)
    host.copy_(packed, non_blocking=True)
    torch.cuda.current_stream(packed.device).synchronize()
    buf = host.numpy()
    out, off = [], 0
    for t, p in zip(tensors, pieces):
        nb = p.numel()
        np_dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
        out.append(buf[off:off + nb].copy().view(np_dtype)
                   .reshape(tuple(t.shape)))
        off += nb
    return out


def array_to_device(data: np.ndarray, device: torch.device) -> torch.Tensor:
    """Upload ``data`` without a host synchronisation: on the card through
    pinned memory with a non-blocking copy (ordered on the current
    stream); the result never shares memory with ``data``."""
    device = torch.device(device)
    if device.type != "cuda":
        return _to_device(data, device)
    data = np.ascontiguousarray(data)
    if not data.flags.writeable:
        data = data.copy()
    return torch.from_numpy(data).pin_memory().to(device, non_blocking=True)


#: staging copies split into slices of this many bytes, copied by a pool
#: of threads when a batch holds at least ``_STAGE_PARALLEL_BYTES``
_STAGE_SLICE = 8 << 20
_STAGE_PARALLEL_BYTES = 32 << 20
_stage_pool: Optional[ThreadPoolExecutor] = None
_stage_pool_lock = threading.Lock()


def _stage_workers() -> Optional[ThreadPoolExecutor]:
    """The staging copy threads, started at the first large upload (never
    at import); None on a one-core host."""
    global _stage_pool
    with _stage_pool_lock:
        if _stage_pool is None:
            n = min(8, os.cpu_count() or 1)
            if n < 2:
                return None
            _stage_pool = ThreadPoolExecutor(n, thread_name_prefix="dsql-stage")
        return _stage_pool


def _stage(buf: np.ndarray, arrays, offsets, pads) -> None:
    """Copy ``arrays`` into ``buf`` at ``offsets``, each followed by
    ``pads`` zero bytes: the host copy into pinned memory bounds an
    upload, so a large batch is copied in slices by threads (numpy
    releases the interpreter lock for the copies)."""
    slices = []
    for a, off, pad in zip(arrays, offsets, pads):
        raw = a.view(np.uint8)
        for s in range(0, len(raw), _STAGE_SLICE):
            slices.append((off + s, raw[s:s + _STAGE_SLICE]))
        if pad:
            buf[off + len(raw):off + len(raw) + pad] = 0

    def copy(item):
        off, raw = item
        buf[off:off + len(raw)] = raw

    total = sum(len(raw) for _, raw in slices)
    pool = _stage_workers() if total >= _STAGE_PARALLEL_BYTES else None
    if pool is None:
        for item in slices:
            copy(item)
    else:
        list(pool.map(copy, slices))


def arrays_to_device(arrays: Sequence[np.ndarray], device: torch.device,
                     pad_to: Optional[int] = None) -> list:
    """Upload host arrays together without a host synchronisation, each
    padded with zeros to ``pad_to`` elements when given.  On the card they
    are copied (``_stage``) into one pinned staging buffer (16-byte
    aligned slices) and sent in one non-blocking copy, whose device buffer
    the results view.  The staging buffer comes from PyTorch's caching
    host allocator, which records the copy's event and hands the block out
    again only after the copy has finished, so a later batch never refills
    a buffer still in flight.  The results never share memory with
    ``arrays``."""
    device = torch.device(device)
    arrays = [np.ascontiguousarray(a).reshape(-1) for a in arrays]
    lengths = [len(a) if pad_to is None else max(pad_to, len(a))
               for a in arrays]
    if device.type != "cuda":
        return [_to_device(np.concatenate([a, np.zeros(n - len(a), a.dtype)])
                           if n > len(a) else a, device)
                for a, n in zip(arrays, lengths)]
    offsets, total = [], 0
    for a, n in zip(arrays, lengths):
        total = -(-total // 16) * 16
        offsets.append(total)
        total += n * a.itemsize
    stage = torch.empty(max(total, 1), dtype=torch.uint8, pin_memory=True)
    _stage(stage.numpy(), arrays, offsets,
           [(n - len(a)) * a.itemsize for a, n in zip(arrays, lengths)])
    dev = stage.to(device, non_blocking=True)
    return [dev[off:off + n * a.itemsize]
            .view(torch.from_numpy(np.empty(0, a.dtype)).dtype)
            for a, off, n in zip(arrays, offsets, lengths)]


def _as_mask(mask, device: torch.device) -> Optional[torch.Tensor]:
    if mask is None:
        return None
    mask = np.asarray(mask, dtype=bool)
    if mask.all():
        return None
    return _to_device(mask, device)


# ---------------------------------------------------------------------------
# Table
# ---------------------------------------------------------------------------

class Table:
    """An ordered, named collection of equal-length Columns."""

    __slots__ = ("names", "columns", "uid")

    _uid_counter = itertools.count()

    def __init__(self, names: Sequence[str], columns: Sequence[Column]):
        if len(names) != len(columns):
            raise ValueError(f"{len(names)} names for {len(columns)} columns")
        self.names = list(names)
        self.columns = list(columns)
        self.uid = next(Table._uid_counter)

    # -- constructors ------------------------------------------------------
    @staticmethod
    def from_pandas(df, device: torch.device) -> "Table":
        names, cols = [], []
        for name in df.columns:
            data, mask, stype, dictionary = host_encode_series(df[name])
            names.append(str(name))
            cols.append(Column(_to_device(data, device), stype,
                               _as_mask(mask, device), dictionary))
        return Table(names, cols)

    @staticmethod
    def from_pydict(data: dict, device: torch.device) -> "Table":
        names, cols = [], []
        for k, v in data.items():
            names.append(k)
            if isinstance(v, Column):
                cols.append(v)
            else:
                arr = np.asarray(v) if not _has_none(v) else np.asarray(v, dtype=object)
                if arr.dtype.kind == "O" and not _all_strings(arr):
                    arr2, mask = _denull(v)
                    cols.append(Column.from_numpy(arr2, device, mask=mask))
                else:
                    cols.append(Column.from_numpy(arr, device))
        return Table(names, cols)

    # -- basics ------------------------------------------------------------
    @property
    def num_rows(self) -> int:
        if not self.columns:
            return 0
        return len(self.columns[0])

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    def column(self, name: str) -> Column:
        return self.columns[self.names.index(name)]

    def with_names(self, names: Sequence[str]) -> "Table":
        return Table(list(names), self.columns)

    def limit_to(self, names: Iterable[str]) -> "Table":
        names = list(names)
        return Table(names, [self.column(n) for n in names])

    def take(self, indices: torch.Tensor) -> "Table":
        return Table(self.names, [c.take(indices) for c in self.columns])

    def slice(self, start: int, stop: int) -> "Table":
        return Table(self.names, [c.slice(start, stop) for c in self.columns])

    def schema(self) -> list:
        return list(zip(self.names, [c.stype for c in self.columns]))

    # -- host conversion ---------------------------------------------------
    def to_numpy(self) -> dict:
        """{name: host numpy array} with the rich types of ``Column.to_numpy``."""
        return {name: col.to_numpy() for name, col in zip(self.names, self.columns)}

    def to_pandas(self):
        import pandas as pd

        return pd.DataFrame(self.to_numpy(), columns=list(self.names))

    def to_pylist(self) -> list:
        """Rows as lists of Python values (``Column.to_pylist``), without
        pandas: the server's and the REPL's output path."""
        cols = [c.to_pylist() for c in self.columns]
        return [list(row) for row in zip(*cols)] if cols else []

    def __repr__(self):
        parts = ", ".join(f"{n}: {c.stype}" for n, c in zip(self.names, self.columns))
        return f"Table[{self.num_rows} rows]({parts})"


# ---------------------------------------------------------------------------
# host-side ingestion encoding (numpy; pandas only in host_encode_series)
# ---------------------------------------------------------------------------

_PANDAS_NULLABLE_NUMPY = {
    "Int8": np.int8, "Int16": np.int16, "Int32": np.int32, "Int64": np.int64,
    "UInt8": np.uint8, "UInt16": np.uint16, "UInt32": np.uint32, "UInt64": np.uint64,
    "Float32": np.float32, "Float64": np.float64, "boolean": np.bool_,
}


def host_encode_numpy(values: np.ndarray, stype: Optional[SqlType] = None,
                      mask: Optional[np.ndarray] = None,
                      dictionary: Optional[np.ndarray] = None):
    """Ingestion encoding on HOST arrays: (data, mask, stype, dictionary),
    by the JAX package's rules (``dask_sql_tpu.table.host_encode_numpy``).
    ``dictionary``: a sorted dictionary shared by every batch of a chunked
    source (``io/chunked.py``), which string values are encoded against."""
    values = np.asarray(values)
    if values.dtype.kind == "O" and (stype is None or not stype.is_string):
        import decimal as _decimal

        isna = np.array([v is None or (isinstance(v, float)
                                       and np.isnan(v)) for v in values],
                        dtype=bool)
        present = values[~isna]
        if len(present) and all(isinstance(v, _decimal.Decimal)
                                and v.is_finite() for v in present):
            # all-finite decimal.Decimal columns ingest as DECIMAL(p, s)
            # with p measured from the data (types.exact_decimal_scale)
            scale = 0
            int_digits = 1
            for v in present:
                t = v.as_tuple()
                scale = max(scale, -int(t.exponent))
                int_digits = max(int_digits, len(t.digits) + int(t.exponent))
            precision = int_digits + scale
            data = np.array([0.0 if na else float(v)
                             for v, na in zip(values, isna)], dtype=np.float64)
            m = (~isna if mask is None
                 else (np.asarray(mask, bool) & ~isna))
            if m.all():
                m = None
            from .types import decimal as _mk_decimal
            if scale > 9 or precision > 15:
                return data, m, _mk_decimal(max(precision, 16), scale), None
            return data, m, _mk_decimal(15, scale), None
    if stype is None:
        stype = sql_type_from_numpy(values.dtype)
    if values.dtype.kind in ("O", "U", "S") or stype.is_string:
        return _host_encode_strings(values, mask, dictionary)
    if values.dtype.kind == "M":
        vals = values.astype("datetime64[us]").astype(np.int64)
        na = np.isnat(values)
        if na.any():
            mask = ~na if mask is None else (mask & ~na)
        return vals, mask, stype, None
    if values.dtype.kind == "m":
        vals = values.astype("timedelta64[ms]").astype(np.int64)
        na = np.isnat(values)
        if na.any():
            mask = ~na if mask is None else (mask & ~na)
        return vals, mask, stype, None
    if values.dtype.kind == "f":
        # NaN means NULL on ingestion (pandas semantics)
        na = np.isnan(values)
        if na.any():
            mask = ~na if mask is None else (np.asarray(mask, bool) & ~na)
            values = np.where(na, 0.0, values)
    dtype = physical_dtype(stype)
    return values.astype(dtype, copy=False), mask, stype, None


def _decode_bytes_objects(values: np.ndarray) -> np.ndarray:
    """bytes values become str via utf-8/surrogateescape so binary columns
    behave as strings end to end."""
    if any(isinstance(v, (bytes, bytearray)) for v in values):
        values = np.array(
            [v.decode("utf-8", "surrogateescape")
             if isinstance(v, (bytes, bytearray)) else v for v in values],
            dtype=object)
    return values


def string_uniques(values: np.ndarray) -> np.ndarray:
    """Sorted unique strings of a column (NULLs -> ""): the dictionary pass
    of a chunked source, with ingestion's null semantics."""
    if np.asarray(values).dtype.kind == "U":
        return np.unique(np.asarray(values)).astype(object)
    values = _decode_bytes_objects(np.asarray(values, dtype=object))
    isna = np.array([v is None or (isinstance(v, float) and np.isnan(v))
                     for v in values], dtype=bool)
    safe = np.where(isna, "", values).astype(str)
    return np.unique(safe).astype(object)


def _encode_against(safe: np.ndarray, dictionary: np.ndarray) -> np.ndarray:
    """Codes of ``safe`` in a sorted shared dictionary (binary search); a
    value the dictionary lacks raises, as in the JAX package, where it
    would otherwise take a neighbour's code."""
    dict_str = dictionary.astype(str)
    codes = np.searchsorted(dict_str, safe)
    clipped = np.clip(codes, 0, len(dict_str) - 1)
    if not np.array_equal(dict_str[clipped], safe):
        missing = np.unique(safe[dict_str[clipped] != safe])[:5]
        raise ValueError(
            "string batch contains values absent from the shared "
            f"dictionary (first few: {missing.tolist()!r}); the "
            "dictionary pass missed this column's values")
    return clipped


def _host_encode_strings(values: np.ndarray, mask: Optional[np.ndarray],
                         dictionary: Optional[np.ndarray] = None):
    if np.asarray(values).dtype.kind == "U":
        # fixed-width unicode arrays hold no nulls: one vectorized unique
        values = np.asarray(values).reshape(-1)
        if dictionary is None:
            dictionary, codes = np.unique(values, return_inverse=True)
            dictionary = dictionary.astype(object)
        else:
            codes = _encode_against(values, dictionary)
        return codes.astype(np.int32).reshape(-1), mask, VARCHAR, dictionary
    values = _decode_bytes_objects(np.asarray(values, dtype=object))
    isna = np.array([v is None or (isinstance(v, float) and np.isnan(v))
                     for v in values], dtype=bool)
    safe = np.where(isna, "", values).astype(str)
    if dictionary is None:
        dictionary, codes = np.unique(safe, return_inverse=True)
        dictionary = dictionary.astype(object)
    else:
        codes = _encode_against(safe, dictionary)
    codes = codes.astype(np.int32).reshape(-1)
    if isna.any():
        m = ~isna if mask is None else (np.asarray(mask, bool) & ~isna)
    else:
        m = mask
    return codes, m, VARCHAR, dictionary


def host_encode_series(s, dictionary: Optional[np.ndarray] = None):
    """Host-side encoding of a pandas Series: (data, mask, stype, dict).

    pandas 3 gives string columns ``StringDtype`` (``str``), on which
    ``np.issubdtype`` raises: every extension dtype is converted here, at
    the pandas boundary, before any numpy dtype test.  ``dictionary``: a
    chunked source's shared dictionary (``host_encode_numpy``)."""
    import pandas as pd

    dtype = s.dtype
    if str(dtype) in _PANDAS_NULLABLE_NUMPY:
        arr = s.array
        mask = ~np.asarray(arr.isna())
        vals = arr.to_numpy(dtype=_PANDAS_NULLABLE_NUMPY[str(dtype)], na_value=0)
        return host_encode_numpy(vals, mask=mask if not mask.all() else None,
                                 dictionary=dictionary)
    if isinstance(dtype, pd.StringDtype) or str(dtype) in ("string", "str"):
        vals = s.to_numpy(dtype=object, na_value=None)
        return host_encode_numpy(vals, dictionary=dictionary)
    if isinstance(dtype, pd.CategoricalDtype):
        if dictionary is not None:
            # the shared dictionary overrides a batch's own categories
            # (arrow row groups may carry differing ones)
            return host_encode_numpy(s.astype(object).to_numpy(),
                                     dictionary=dictionary)
        cats = s.cat.categories.to_numpy(dtype=object)
        codes = s.cat.codes.to_numpy().astype(np.int32)
        mask = codes >= 0
        if mask.all():
            mask = None
        return np.where(codes < 0, 0, codes).astype(np.int32), mask, VARCHAR, cats
    if isinstance(dtype, pd.DatetimeTZDtype):
        # tz-aware -> UTC naive
        s = s.dt.tz_convert("UTC").dt.tz_localize(None)
        return host_encode_numpy(s.to_numpy(), dictionary=dictionary)
    return host_encode_numpy(s.to_numpy(), dictionary=dictionary)


def _has_none(v) -> bool:
    try:
        return any(x is None for x in v)
    except TypeError:
        return False


def _all_strings(arr) -> bool:
    return all(isinstance(x, str) for x in arr.tolist())


def _denull(v):
    vals = list(v)
    mask = np.array([x is not None for x in vals])
    if all(isinstance(x, str) or x is None for x in vals):
        arr = np.array(["" if x is None else x for x in vals], dtype=object)
        return arr, mask
    arr = np.array([0 if x is None else x for x in vals])
    return arr, mask
