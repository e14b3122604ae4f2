"""Small keyed JSON documents shared across processes.

The counterpart of ``dask_sql_tpu/runtime/kvstore.py``, cut to what the
learned-caps file of the compiled tier (``DSQL_CAPS_FILE``,
``DSQL_CAPS_SEED``; ``physical/compiled.py``) needs: content-digest keys,
a read that takes a missing or corrupt file as empty, and an atomic
tmp + rename write.  Concurrent writers can lose a race (one re-learn),
never corrupt the file.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
from typing import Dict

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
