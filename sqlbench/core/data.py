"""The benchmark's own data container and the helpers its generators share.

A data set is ``{table: {column: Col}}``.  Every column lives on one
device as a tensor: integers and keys as int64, decimals as float64, dates
as int64 days since 1970-01-01, strings as int32 codes into a sorted
dictionary of Python strings (held on the host).  The generators make the
tensors with a ``torch.Generator`` on the device; the harness hands them to
the system under test, and the plain reference reads them again after the
window from a fresh generation with the same seed.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch

KINDS = ("int", "float", "date", "str")


@dataclass
class Col:
    kind: str
    data: torch.Tensor
    dictionary: Optional[np.ndarray] = None   # sorted, object dtype

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown column kind {self.kind!r}")
        if (self.kind == "str") != (self.dictionary is not None):
            raise ValueError("a string column needs a dictionary, and only it")


Dataset = Dict[str, Dict[str, Col]]


def generator(device: torch.device, seed: int, stream: int) -> torch.Generator:
    """A generator on ``device`` for one table of one seed: every table has
    its own stream, so tables do not depend on the order they are made in."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream * 7_919 + 17) % (1 << 63))
    return g


def days(iso: str) -> int:
    """Days since 1970-01-01 of an ISO date."""
    return int((np.datetime64(iso, "D") - np.datetime64("1970-01-01", "D"))
               .astype(np.int64))


def digits(nums: np.ndarray, width: int) -> np.ndarray:
    """ASCII digits of non-negative ``nums`` as a uint8 matrix: zero-padded
    to ``width`` columns, or, with ``width`` 0, left-aligned without
    padding (trailing NUL bytes, which numpy's ``S`` type drops)."""
    nums = np.asarray(nums, np.int64)
    n_dig = max(width, len(str(int(nums.max()))) if len(nums) else 1)
    out = np.empty((len(nums), n_dig), np.uint8)
    x = nums.copy()
    for k in range(n_dig - 1, -1, -1):
        out[:, k] = x % 10 + 48
        x //= 10
    if width:
        return out
    lengths = np.maximum(1, np.floor(np.log10(np.maximum(nums, 1))).astype(
        np.int64) + 1)
    shift = n_dig - lengths
    idx = np.arange(n_dig)[None, :] + shift[:, None]
    left = np.take_along_axis(out, np.minimum(idx, n_dig - 1), axis=1)
    left[idx >= n_dig] = 0
    return left


def strings(*parts) -> np.ndarray:
    """Row-wise concatenation of parts, each a ``str`` (the same for every
    row) or a uint8 matrix (``digits``), as an object array of str."""
    n = max(p.shape[0] for p in parts if not isinstance(p, str))
    mats = [np.tile(np.frombuffer(p.encode(), np.uint8), (n, 1))
            if isinstance(p, str) else p for p in parts]
    mat = np.ascontiguousarray(np.concatenate(mats, axis=1))
    return mat.view(f"S{mat.shape[1]}").ravel().astype(str).astype(object)


def unique_strings(values: np.ndarray, device: torch.device) -> Col:
    """A column of distinct strings, one per row: the sorted dictionary and
    each row's code in it."""
    values = np.asarray(values, dtype=object)
    order = np.argsort(values.astype(str), kind="stable")
    codes = np.empty(len(values), np.int32)
    codes[order] = np.arange(len(values), dtype=np.int32)
    return Col("str", torch.from_numpy(codes).to(device), values[order])


def encode(values: Sequence[str], device: torch.device) -> Col:
    """A column of strings that may repeat: the sorted dictionary of the
    distinct ones and each row's code in it."""
    dictionary, codes = np.unique(np.asarray(values, dtype=object),
                                  return_inverse=True)
    return Col("str", torch.from_numpy(codes.astype(np.int32)).to(device),
               dictionary.astype(object))


def choice(g: torch.Generator, values: Sequence[str], n: int,
           device: torch.device, probs: Optional[Sequence[float]] = None,
           index: Optional[torch.Tensor] = None) -> Col:
    """``n`` strings drawn from ``values`` (uniformly, or by ``probs``), or
    the strings ``values[index]`` when ``index`` is given."""
    if index is None:
        if probs is None:
            index = torch.randint(0, len(values), (n,), generator=g,
                                  device=device)
        else:
            cum = torch.tensor(np.cumsum(probs)[:-1], dtype=torch.float64,
                               device=device)
            u = torch.rand(n, generator=g, dtype=torch.float64, device=device)
            index = torch.searchsorted(cum, u, right=True)
    dictionary = np.array(sorted(set(values)), dtype=object)
    pos = {v: i for i, v in enumerate(dictionary)}
    remap = torch.tensor([pos[v] for v in values], dtype=torch.int32,
                         device=device)
    return Col("str", remap[index], dictionary)


def fixed(values: Sequence, kind: str, device: torch.device) -> Col:
    """A small column given whole (dimension tables of a few rows)."""
    if kind == "str":
        arr = np.asarray(values, dtype=object)
        dictionary = np.array(sorted(set(arr.tolist())), dtype=object)
        codes = np.searchsorted(dictionary.astype(str), arr.astype(str))
        return Col("str", torch.from_numpy(codes.astype(np.int32)).to(device),
                   dictionary)
    dtype = torch.float64 if kind == "float" else torch.int64
    return Col(kind, torch.as_tensor(np.asarray(values), dtype=dtype,
                                     device=device))


def blank(n: int, device: torch.device) -> Col:
    """An empty-string column (TPC-H's comments, left blank)."""
    return Col("str", torch.zeros(n, dtype=torch.int32, device=device),
               np.array([""], dtype=object))


def round2(x: torch.Tensor) -> torch.Tensor:
    """numpy's ``round(x, 2)`` (half to even) on a float64 tensor."""
    return torch.round(x * 100.0) / 100.0


def rows(table: Dict[str, Col]) -> int:
    return int(next(iter(table.values())).data.shape[0])


def digest(data: Dataset) -> str:
    """A digest of every column's bits and dictionary: the same seed must
    give the same digest, so the reference reads what the program read."""
    h = hashlib.sha256()
    for tname in sorted(data):
        for cname in sorted(data[tname]):
            col = data[tname][cname]
            t = col.data
            bits = (t.view(torch.int64) if t.dtype == torch.float64
                    else t.to(torch.int64))
            # two positional sums: order-sensitive, in int64 (wraps alike)
            w = torch.arange(1, t.shape[0] + 1, device=t.device,
                             dtype=torch.int64)
            h.update(f"{tname}.{cname}:{col.kind}:{t.shape[0]}:"
                     f"{int(bits.sum())}:{int((bits * w).sum())}".encode())
            if col.dictionary is not None:
                h.update("\x1f".join(col.dictionary.tolist()).encode())
    return h.hexdigest()[:32]
