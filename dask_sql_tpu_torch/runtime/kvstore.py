"""Small keyed JSON documents shared across processes.

The counterpart of ``dask_sql_tpu/runtime/kvstore.py``, cut to what the
learned-caps file of the compiled tier (``DSQL_CAPS_FILE``,
``DSQL_CAPS_SEED``; ``physical/compiled.py``) and the quarantine store
(``runtime/quarantine.py``) need: content-digest keys, a read that takes a
missing or corrupt file as empty, an atomic tmp + rename write, and
``MtimeCachedJsonFile``.  Concurrent writers can lose a race (one
re-learn or re-mark), never corrupt the file.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
from typing import Dict, Optional

logger = logging.getLogger(__name__)


def digest_key(obj, size: int = 16) -> str:
    """Stable content digest of ``repr(obj)``."""
    return hashlib.blake2b(repr(obj).encode(), digest_size=size).hexdigest()


def read_json_dict(path: str) -> Dict[str, dict]:
    """A {key: dict} JSON file; a missing, corrupt or truncated file and
    non-dict values read as absent."""
    try:
        with open(path) as f:
            loaded = json.load(f)
        if not isinstance(loaded, dict):
            return {}
        return {k: dict(v) for k, v in loaded.items() if isinstance(v, dict)}
    except (OSError, ValueError):
        return {}


def atomic_write_json(path: str, data: dict) -> bool:
    """Write ``data`` as JSON by tmp + atomic rename; False (logged at
    debug) when the path is unwritable: persistence never fails a query."""
    tmp = f"{path}.tmp{os.getpid()}.{threading.get_ident()}"
    try:
        with open(tmp, "w") as f:
            json.dump(data, f)
        os.replace(tmp, path)
        return True
    except OSError:
        logger.debug("store file %s not writable", path)
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


class MtimeCachedJsonFile:
    """A {key: dict} JSON file with an mtime-validated in-memory cache
    (reads are cheap enough for per-query hot paths) and read-merge-replace
    writes.  ``path`` is re-resolved per call via the callable so env-flipped
    configuration (tests, operators) takes effect without restart."""

    def __init__(self, path_fn):
        self._path_fn = path_fn
        self._lock = threading.Lock()
        self._cached: Dict[str, dict] = {}
        self._cached_mtime: Optional[int] = None

    def path(self) -> Optional[str]:
        return self._path_fn()

    def read(self) -> Dict[str, dict]:
        path = self.path()
        if not path:
            return {}
        try:
            mtime = os.stat(path).st_mtime_ns
        except OSError:
            with self._lock:
                self._cached, self._cached_mtime = {}, None
            return {}
        with self._lock:
            if self._cached_mtime == mtime:
                return dict(self._cached)
        data = read_json_dict(path)
        with self._lock:
            self._cached, self._cached_mtime = data, mtime
        return dict(data)

    def write(self, data: Dict[str, dict]) -> None:
        path = self.path()
        if not path:
            return
        if atomic_write_json(path, data):
            with self._lock:
                self._cached = dict(data)
                try:
                    self._cached_mtime = os.stat(path).st_mtime_ns
                except OSError:
                    self._cached_mtime = None
