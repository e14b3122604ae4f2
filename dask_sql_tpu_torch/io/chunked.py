"""Out-of-device-memory table source: host-resident encoded batches.

The counterpart of ``dask_sql_tpu/io/chunked.py``.  A table larger than
the card lives on the HOST as already-encoded columnar batches (numpy:
numeric data and int32 string codes), and the streaming executor
(``physical/streaming.py``) uploads one fixed-size batch at a time and
runs the same compiled program on each.

Two invariants make every batch one program:

- every batch is padded to exactly ``batch_rows`` rows; a short batch
  carries a row-validity mask (``row_valid``), so all full batches share
  one program and the short last one a second;
- string dictionaries are GLOBAL across batches (the sorted uniques of
  the whole column, then each batch encoded against them), so every
  batch's program key (the dictionaries' content fingerprints) is equal.

On the card a batch is uploaded in one non-blocking copy from a pinned
staging buffer (``table.arrays_to_device``), and the compiled tier copies
it into a CUDA graph's input buffers (``physical/compiled.py``
``_copied_positions``): a batch is one device copy and one replay.

Constructors: ``from_columns`` (a dict of numpy arrays, without pandas: the
card's machine has none), ``from_pandas`` and ``from_parquet`` (pyarrow);
the last two import pandas and pyarrow inside themselves.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..runtime import faults as _faults, telemetry as _tel
from ..runtime.resilience import UserError
from ..table import (Column, Table, arrays_to_device, host_encode_numpy,
                     host_encode_series, string_uniques)
from ..types import torch_dtype

DEFAULT_BATCH_ROWS = 1 << 22  # 4M rows a batch: a few hundred MB on the card


class ChunkedInputError(UserError, ValueError):
    """Unrepresentable input shape (a typed user error, still a
    ValueError)."""


def _is_string_input(values: np.ndarray) -> bool:
    return values.dtype.kind in ("U", "S") or (
        values.dtype.kind == "O"
        and all(v is None or isinstance(v, (str, bytes, bytearray))
                or (isinstance(v, float) and np.isnan(v))
                for v in values.tolist()))


def _column_input(values) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """(values, mask) of one ``from_columns`` column: lists with None
    become a masked array, as ``Table.from_pydict`` takes them."""
    from ..table import _all_strings, _denull, _has_none

    if isinstance(values, np.ndarray):
        return values, None
    arr = (np.asarray(values) if not _has_none(values)
           else np.asarray(values, dtype=object))
    if arr.dtype.kind == "O" and not _all_strings(arr):
        return _denull(values)
    return arr, None


class ChunkedSource:
    """Host-side encoded columnar batches with a shared schema."""

    def __init__(self, names: Sequence[str], stypes, dictionaries,
                 batches: List[list], n_rows: int, batch_rows: int):
        self.names = list(names)
        self.stypes = list(stypes)
        self.dictionaries = list(dictionaries)
        self.batches = batches          # per batch: [(data, mask), ...]
        self.n_rows = n_rows
        self.batch_rows = batch_rows

    # ------------------------------------------------------------ building
    @staticmethod
    def from_columns(columns: dict, batch_rows: int = DEFAULT_BATCH_ROWS
                     ) -> "ChunkedSource":
        """Encode ``{name: numpy array (or list)}`` into host batches
        without pandas: the chunked counterpart of the dict that
        ``Context.create_table`` takes.  String columns get one sorted
        dictionary over the whole column (``string_uniques``), then each
        batch is encoded against it, as ``from_pandas`` does."""
        names = list(columns)
        inputs = [_column_input(columns[n]) for n in names]
        lengths = {len(v) for v, _ in inputs}
        if len(lengths) > 1:
            raise ChunkedInputError(
                f"from_columns: columns of different lengths {sorted(lengths)}")
        n = lengths.pop() if lengths else 0
        batch_rows = max(int(batch_rows), 1)
        dicts = [string_uniques(v) if _is_string_input(v) else None
                 for v, _ in inputs]
        stypes: list = [None] * len(names)
        dictionaries: list = [None] * len(names)
        batches: List[list] = []
        for s0 in range(0, max(n, 1), batch_rows):
            enc = []
            for ci, (values, mask) in enumerate(inputs):
                data, m, stype, dictionary = host_encode_numpy(
                    values[s0:s0 + batch_rows],
                    mask=None if mask is None else mask[s0:s0 + batch_rows],
                    dictionary=dicts[ci])
                stypes[ci] = stype
                if dictionary is not None:
                    dictionaries[ci] = dictionary
                enc.append((data, m))
            batches.append(enc)
        return ChunkedSource(names, stypes, dictionaries, batches, n,
                             batch_rows)

    @staticmethod
    def from_pandas(df, batch_rows: int = DEFAULT_BATCH_ROWS,
                    _precomputed_dicts: Optional[dict] = None
                    ) -> "ChunkedSource":
        """Encode a pandas frame into host batches (shared dictionaries)."""
        import pandas as pd

        n = len(df)
        batch_rows = max(int(batch_rows), 1)
        dicts = {}
        if _precomputed_dicts:
            dicts.update(_precomputed_dicts)
        # pass 1: a global sorted dictionary per string-ish column
        # (categoricals too: their per-batch category order must not leak)
        for name in df.columns:
            if name in dicts:
                continue
            s = df[name]
            is_cat = isinstance(s.dtype, pd.CategoricalDtype)
            if s.dtype == object or is_cat or str(s.dtype) in ("string", "str"):
                if str(s.dtype) in ("string", "str"):
                    vals = s.to_numpy(dtype=object, na_value=None)
                else:
                    vals = s.astype(object).to_numpy()
                dicts[name] = string_uniques(vals)
        # pass 2: encode per batch against the shared dictionaries
        batches: List[list] = []
        names = list(df.columns)
        stypes: list = [None] * len(names)
        dictionaries: list = [None] * len(names)
        for s0 in range(0, max(n, 1), batch_rows):
            chunk = df.iloc[s0:s0 + batch_rows]
            enc = []
            for ci, name in enumerate(names):
                data, mask, stype, dictionary = host_encode_series(
                    chunk[name], dictionary=dicts.get(name))
                stypes[ci] = stype
                if dictionary is not None:
                    dictionaries[ci] = dictionary
                enc.append((data, mask))
            batches.append(enc)
        return ChunkedSource(names, stypes, dictionaries, batches, n,
                             batch_rows)

    @staticmethod
    def from_parquet(path: str, batch_rows: int = DEFAULT_BATCH_ROWS
                     ) -> "ChunkedSource":
        """Two-pass parquet ingestion that never materializes the whole
        file as one pandas frame: pass 1 unions per-row-group string
        uniques into global dictionaries, pass 2 encodes record batches
        into host batches (pyarrow)."""
        import pyarrow.parquet as pq
        import pyarrow.types as patypes

        def _needs_global_dict(t) -> bool:
            # any arrow type whose pandas conversion yields object values
            # shares ONE dictionary across row groups, or merged batches
            # would decode against piece 0's codes
            for pred in ("is_string", "is_large_string", "is_string_view",
                         "is_binary", "is_large_binary",
                         "is_fixed_size_binary", "is_binary_view",
                         "is_dictionary"):
                fn = getattr(patypes, pred, None)
                if fn is not None and fn(t):
                    return True
            return False

        pf = pq.ParquetFile(path)
        schema = pf.schema_arrow
        for f in schema:
            if patypes.is_nested(f.type):
                raise ChunkedInputError(
                    f"from_parquet: column {f.name!r} has nested arrow type "
                    f"{f.type} — not representable as a columnar SQL type")
        str_cols = [f.name for f in schema if _needs_global_dict(f.type)]
        uniques = {c: [] for c in str_cols}
        if str_cols:
            for rg in range(pf.num_row_groups):
                tbl = pf.read_row_group(rg, columns=str_cols)
                for c in str_cols:
                    vals = tbl.column(c).to_pandas().astype(object).to_numpy()
                    uniques[c].append(string_uniques(vals))
        dicts = {c: np.unique(np.concatenate(u)).astype(object)
                 for c, u in uniques.items() if u}

        pieces = []
        for batch in pf.iter_batches(batch_size=batch_rows):
            pieces.append(ChunkedSource.from_pandas(
                batch.to_pandas(), batch_rows=batch_rows,
                _precomputed_dicts=dicts))
        if not pieces:
            return ChunkedSource.from_pandas(pf.read().to_pandas(),
                                             batch_rows=batch_rows)
        source = pieces[0]
        for extra in pieces[1:]:
            for ci, name in enumerate(source.names):
                a, b = source.dictionaries[ci], extra.dictionaries[ci]
                if a is b:
                    continue
                if (a is None) != (b is None) or (
                        a is not None and not np.array_equal(a, b)):
                    # a column type slipped past _needs_global_dict and got
                    # per-piece dictionaries: mixing their codes would
                    # decode wrong values
                    raise ChunkedInputError(
                        f"from_parquet: column {name!r} produced differing "
                        "per-piece dictionaries; its arrow type needs a "
                        "global dictionary pass")
            source.batches.extend(extra.batches)
            source.n_rows += extra.n_rows
        # iter_batches can emit a short batch at row-group edges;
        # re-batching keeps every batch but the last at batch_rows
        source._rebatch()
        return source

    def _rebatch(self) -> None:
        """Normalize to fixed-size batches after concatenating pieces.

        Incremental: pieces stream through a per-column carry buffer and
        are released as they are consumed, so the transient footprint is
        one output batch plus one input piece."""
        if all(len(b[0][0]) == self.batch_rows for b in self.batches[:-1]):
            return
        cols = len(self.names)
        has_mask = [any(b[ci][1] is not None for b in self.batches)
                    for ci in range(cols)]
        dtypes = [self.batches[0][ci][0].dtype for ci in range(cols)]
        out: List[list] = []
        pending: List[list] = [[] for _ in range(cols)]  # (data, mask)
        pending_rows = 0

        def emit(k: int) -> None:
            nonlocal pending_rows
            enc = []
            for ci in range(cols):
                frags = pending[ci]
                datas, masks, got = [], [], 0
                while got < k:
                    data, mask = frags[0]
                    take = min(k - got, len(data))
                    datas.append(data[:take])
                    if has_mask[ci]:
                        masks.append(mask[:take] if mask is not None
                                     else np.ones(take, dtype=bool))
                    if take == len(data):
                        frags.pop(0)
                    else:
                        frags[0] = (data[take:],
                                    None if mask is None else mask[take:])
                    got += take
                data = (datas[0] if len(datas) == 1
                        else np.concatenate(datas))
                mask = None
                if has_mask[ci]:
                    mask = (masks[0] if len(masks) == 1
                            else np.concatenate(masks))
                enc.append((data, mask))
            pending_rows -= k
            out.append(enc)

        src = self.batches
        for bi in range(len(src)):
            piece = src[bi]
            src[bi] = None  # release: the carry buffer bounds memory
            n = len(piece[0][0]) if piece else 0
            for ci in range(cols):
                pending[ci].append(piece[ci])
            pending_rows += n
            while pending_rows >= self.batch_rows:
                emit(self.batch_rows)
        if pending_rows:
            emit(pending_rows)
        if not out:
            # zero-row table: keep the one-empty-batch invariant
            out.append([(np.zeros(0, dtype=dtypes[ci]), None)
                        for ci in range(cols)])
        self.batches = out

    # ----------------------------------------------------------- consuming
    @property
    def n_batches(self) -> int:
        return len(self.batches)

    def schema_table(self, device) -> Table:
        """A 1-row stub with the names, types and dictionaries, for binding
        only: the context sends every plan that scans it to the streaming
        executor, so no path computes on it."""
        cols = []
        for ci, stype in enumerate(self.stypes):
            dtype = (torch.from_numpy(
                np.empty(0, self.batches[0][ci][0].dtype)).dtype
                if self.batches else torch_dtype(stype))
            dictionary = self.dictionaries[ci]
            if stype.is_string and dictionary is None:
                dictionary = np.array([""], dtype=object)
            cols.append(Column(torch.zeros(1, dtype=dtype, device=device),
                               stype, None, dictionary))
        return Table(self.names, cols)

    def batch_table(self, i: int, device, columns=None
                    ) -> Tuple[Table, Optional[torch.Tensor]]:
        """The device ``Table`` of batch ``i``, padded to ``batch_rows``,
        and its ``row_valid`` (None for a full batch).  ``columns``: the
        names the scan reads (all when None); only those are uploaded.

        The upload is the ``chunked_read`` fault site: the caller retries
        transients (the encoded host batch is immutable, so an upload can
        run again).  Its byte count annotates the enclosing span
        (``upload_bytes``)."""
        _faults.maybe_fail("chunked_read")
        keep = [ci for ci, name in enumerate(self.names)
                if columns is None or name in columns]
        enc = self.batches[i]
        n = len(enc[0][0]) if enc else 0
        arrays = []
        for data, mask in (enc[ci] for ci in keep):
            arrays.append(data)
            if mask is not None:
                arrays.append(mask)
        upload_bytes = sum(int(a.itemsize) * self.batch_rows for a in arrays)
        tensors = iter(arrays_to_device(arrays, device,
                                        pad_to=self.batch_rows))
        cols = []
        for ci in keep:
            dev = next(tensors)
            m = next(tensors) if enc[ci][1] is not None else None
            cols.append(Column(dev, self.stypes[ci], m,
                               self.dictionaries[ci]))
        row_valid = None
        if n < self.batch_rows:
            row_valid = torch.arange(self.batch_rows, device=device) < n
        _tel.annotate(upload_bytes=upload_bytes)
        return Table([self.names[ci] for ci in keep], cols), row_valid

