"""High-cardinality string matching: vectorized host bitmaps and a device
bytes-matrix LIKE.

The counterpart of ``dask_sql_tpu/ops/strings_fast.py``.  The plain string
path runs one Python regex per dictionary entry, which is fine at TPC-H
cardinalities and a cliff at a million distinct values.  Two faster
strategies, picked per call by ``like_op`` (``physical/rex/ops.py``):

- ``like_bitmap_vectorized``: a LIKE pattern of literal chunks separated by
  ``%`` (no ``_``) evaluates over the whole dictionary with ``np.strings``
  (startswith / endswith / find from per-entry starts): one C pass per chunk.
- ``device_like_bitmap``: at or past ``DSQL_DEVICE_STRING_THRESHOLD``
  distinct values the dictionary is padded into a ``[D, L]`` uint8 bytes
  matrix on the column's device (built once per dictionary and device,
  memoized) and chunk matching runs as shifted byte comparisons there; the
  per-entry bitmap stays on the device for the code gather.

Both give the per-entry bitmap the regex path gives; patterns outside the
chunk grammar (``_`` wildcards, SIMILAR TO, non-ASCII ILIKE on the device)
get None and take the regex path.
"""
from __future__ import annotations

import os
import weakref
from typing import List, Optional, Tuple

import numpy as np
import torch

DEVICE_STRING_THRESHOLD = int(
    os.environ.get("DSQL_DEVICE_STRING_THRESHOLD", str(1 << 15)))
_MAX_DEVICE_STR_LEN = 128

# LIKE calls answered by each strategy (``like_bitmap`` in
# physical/rex/ops.py counts them)
stats = {"device_bitmaps": 0, "vectorized_bitmaps": 0, "regex_bitmaps": 0}

# numpy 2's string ufuncs, or numpy 1's np.char functions of the same names
_nps = getattr(np, "strings", np.char)


def parse_like_chunks(pattern: str, escape: Optional[str]
                      ) -> Optional[Tuple[List[str], bool, bool]]:
    """(chunks, anchor_start, anchor_end) for %-separated literal patterns;
    None when the pattern needs full regex (``_`` wildcard)."""
    chunks: List[str] = []
    cur: List[str] = []
    i = 0
    n = len(pattern)
    ends_wild = False
    while i < n:
        c = pattern[i]
        if escape and c == escape and i + 1 < n:
            cur.append(pattern[i + 1])
            ends_wild = False
            i += 2
            continue
        if c == "_":
            return None
        if c == "%":
            if cur:
                chunks.append("".join(cur))
                cur = []
            ends_wild = True
        else:
            cur.append(c)
            ends_wild = False
        i += 1
    if cur:
        chunks.append("".join(cur))
    anchor_start = bool(pattern) and pattern[0] != "%"
    anchor_end = bool(pattern) and not ends_wild
    return chunks, anchor_start, anchor_end


def like_bitmap_vectorized(d: np.ndarray, pattern: str,
                           escape: Optional[str],
                           kind: str) -> Optional[np.ndarray]:
    """Per-dictionary-entry LIKE bitmap via np.strings; None = not eligible."""
    if kind == "SIMILAR":
        return None
    parsed = parse_like_chunks(pattern, escape)
    if parsed is None:
        return None
    chunks, anchor_start, anchor_end = parsed
    s = np.asarray(d, dtype=str)
    if kind == "ILIKE":
        s = _nps.lower(s)
        chunks = [c.lower() for c in chunks]
    D = len(s)
    if not chunks:
        if pattern == "":
            return _nps.str_len(s) == 0  # LIKE '' matches only ''
        return np.ones(D, dtype=bool)  # '%', '%%', ... match everything
    if len(chunks) == 1 and anchor_start and anchor_end:
        return s == chunks[0]
    ok = np.ones(D, dtype=bool)
    slen = _nps.str_len(s)
    pos = np.zeros(D, dtype=np.int64)
    last = len(chunks) - 1
    for i, chunk in enumerate(chunks):
        if i == 0 and anchor_start:
            ok &= _nps.startswith(s, chunk)
            pos = np.full(D, len(chunk), dtype=np.int64)
            continue
        if i == last and anchor_end:
            ok &= _nps.endswith(s, chunk)
            ok &= (slen - len(chunk)) >= pos
            continue
        idx = _nps.find(s, chunk, pos, slen)
        ok &= idx >= 0
        pos = np.where(idx >= 0, idx + len(chunk), pos)
    return ok


# ---------------------------------------------------------------------------
# device bytes-matrix path
# ---------------------------------------------------------------------------

# id(dictionary) -> (weakref, np str-dtype copy): the object -> <U astype of
# a large dictionary costs more than the matching itself; convert once
_str_memo: dict = {}


def dict_as_str(dictionary: np.ndarray) -> np.ndarray:
    key = id(dictionary)
    hit = _str_memo.get(key)
    if hit is not None and hit[0]() is dictionary:
        return hit[1]
    s = np.asarray(dictionary, dtype=str)
    _str_memo[key] = (
        weakref.ref(dictionary, lambda _r, k=key: _str_memo.pop(k, None)), s)
    return s


# (id(dictionary), device) -> (weakref, bytes [D, L] uint8, lens [D] int32,
# all_ascii): a dictionary used on the CPU and on the card has one matrix
# on each
_matrix_memo: dict = {}


def _encode_matrix(dictionary: np.ndarray):
    """Host (bytes [D, L] uint8, lens [D] int32), or None past the length
    cap.  One vectorized UTF-8 encode; a dictionary holding NUL characters
    (which fixed-width bytes would strip at the end of an entry) is
    encoded entry by entry."""
    s = dict_as_str(dictionary)
    D = len(s)
    if D and (_nps.find(s, "\x00") < 0).all():
        enc = _nps.encode(s, "utf-8")
        L = enc.dtype.itemsize
        lens = _nps.str_len(enc).astype(np.int32)
        if L > _MAX_DEVICE_STR_LEN:
            return None
        if L == 0:
            return np.zeros((D, 1), np.uint8), lens
        return enc.view(np.uint8).reshape(D, L), lens
    encoded = [str(v).encode("utf-8") for v in dictionary]
    L = max((len(b) for b in encoded), default=1)
    if L > _MAX_DEVICE_STR_LEN:
        return None
    mat = np.zeros((D, max(L, 1)), dtype=np.uint8)
    lens = np.empty(D, dtype=np.int32)
    for i, b in enumerate(encoded):
        lens[i] = len(b)
        mat[i, :len(b)] = np.frombuffer(b, dtype=np.uint8)
    return mat, lens


def _bytes_matrix(dictionary: np.ndarray, device: torch.device):
    """(bytes [D, L] uint8, lens [D] int32, all_ascii) on ``device`` for a
    dictionary, or None when it holds strings longer than 128 bytes."""
    device = torch.device(device)
    key = (id(dictionary), str(device))
    hit = _matrix_memo.get(key)
    if hit is not None and hit[0]() is dictionary:
        return hit[1], hit[2], hit[3]
    built = _encode_matrix(dictionary)
    if built is None:
        return None
    mat, lens = built
    all_ascii = bool((mat < 128).all())
    dev_mat = torch.from_numpy(np.ascontiguousarray(mat)).to(device)
    dev_lens = torch.from_numpy(lens).to(device)
    _matrix_memo[key] = (
        weakref.ref(dictionary, lambda _r, k=key: _matrix_memo.pop(k, None)),
        dev_mat, dev_lens, all_ascii)
    return dev_mat, dev_lens, all_ascii


def _chunk_occurrences(B: torch.Tensor, lens: torch.Tensor, chunk: bytes):
    """(occ, w): occ[d, j] is True where ``chunk`` matches B[d] at byte
    offset j with the window inside the entry's length."""
    D, L = B.shape
    m = len(chunk)
    if m > L:
        # longer than every entry: nothing matches; w = 1 keeps the
        # downstream argmax / gather shapes valid
        return torch.zeros((D, 1), dtype=torch.bool, device=B.device), 1
    w = L - m + 1
    acc = torch.ones((D, w), dtype=torch.bool, device=B.device)
    for k, byte in enumerate(chunk):
        acc &= B[:, k:k + w] == byte
    win_ok = (torch.arange(w, device=B.device)[None, :] + m) <= lens[:, None]
    return acc & win_ok, w


def device_like_bitmap(dictionary: np.ndarray, pattern: str,
                       escape: Optional[str], kind: str,
                       device: torch.device) -> Optional[torch.Tensor]:
    """Per-dictionary-entry LIKE bitmap computed on ``device``; None when
    the pattern or the dictionary is outside the device grammar."""
    if kind == "SIMILAR":
        return None
    parsed = parse_like_chunks(pattern, escape)
    if parsed is None:
        return None
    chunks, anchor_start, anchor_end = parsed
    built = _bytes_matrix(dictionary, device)
    if built is None:
        return None
    B, lens, all_ascii = built
    if kind == "ILIKE":
        if not (all_ascii and pattern.isascii()):
            return None  # non-ASCII case folding needs the host path
        B = torch.where((B >= 65) & (B <= 90), B + 32, B)
        chunks = [c.lower() for c in chunks]
    enc = [c.encode("utf-8") for c in chunks]
    D = B.shape[0]
    if not enc:
        if pattern == "":
            return lens == 0  # LIKE '' matches only ''
        return torch.ones(D, dtype=torch.bool, device=B.device)
    ok = torch.ones(D, dtype=torch.bool, device=B.device)
    pos = torch.zeros(D, dtype=torch.int64, device=B.device)
    last = len(enc) - 1
    for i, chunk in enumerate(enc):
        m = len(chunk)
        occ, w = _chunk_occurrences(B, lens, chunk)
        if i == 0 and anchor_start and i == last and anchor_end:
            # exact equality: prefix match and exact length
            ok = ok & occ[:, 0] & (lens == m)
            continue
        if i == 0 and anchor_start:
            ok = ok & occ[:, 0]
            pos = torch.full((D,), m, dtype=torch.int64, device=B.device)
            continue
        if i == last and anchor_end:
            at = (lens.to(torch.int64) - m).clamp(0, w - 1)
            end_hit = torch.gather(occ, 1, at[:, None])[:, 0]
            ok = ok & end_hit & (lens - m >= pos)
            continue
        cand = occ & (torch.arange(w, device=B.device)[None, :] >= pos[:, None])
        found = cand.any(dim=1)
        idx = torch.argmax(cand.to(torch.uint8), dim=1)
        ok = ok & found
        pos = torch.where(found, idx + m, pos)
    return ok
