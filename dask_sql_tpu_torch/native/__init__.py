"""Loader for the native (C++) SQL parser and plan optimizer.

The counterpart of ``dask_sql_tpu/native/__init__.py``.  The sources in
this directory (``lexer``, ``parser``, ``json``, ``plan``, ``optimizer``
and ``api``) are copies of the JAX package's ``native/`` sources; the one
change of behaviour is in ``parser.cpp``, which numbers ``?`` markers left
to right as the Python parser does (the JAX package's gives each index
0).  They
build at first use with g++ (one compiler process per source, all started
together, then one link) into ``build/dask_sql_tpu_torch/`` at the repo
root; the library's file name carries a hash of the sources and flags, so
an edit rebuilds it.  The library is loaded with ctypes.

``DSQL_NATIVE=0`` switches the native path off (checked on every call):
``load`` then returns None and the callers take the Python parser and
optimizer.  Otherwise a failed build or load raises, with the compiler's
output: the native path never gives way to Python silently.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import json
import os
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional

_HERE = Path(__file__).resolve().parent
_SOURCES = ("lexer.cpp", "parser.cpp", "json.cpp", "plan.cpp",
            "optimizer.cpp", "api.cpp")
_HEADERS = ("lexer.h", "parser.h", "json.h", "plan.h")
_CXX = "g++"
_CXXFLAGS = ("-O2", "-std=c++17", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _build_dir() -> Path:
    return _HERE.parents[1] / "build" / "dask_sql_tpu_torch"


def _library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256()
    for name in _SOURCES + _HEADERS:
        h.update(name.encode() + b"\0" + (_HERE / name).read_bytes())
    h.update(" ".join((_CXX,) + _CXXFLAGS).encode())
    return _build_dir() / f"libdsqlparser-{h.hexdigest()[:16]}.so"


def _run(cmd) -> None:
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
    except OSError as exc:
        raise RuntimeError(f"native library: cannot run {cmd[0]}: {exc}"
                           ) from exc
    if proc.returncode != 0:
        raise RuntimeError(
            f"native library: {' '.join(map(str, cmd))} failed "
            f"({proc.returncode}):\n{proc.stderr}")


def build() -> Dict[str, object]:
    """Build the library unless it exists.  Returns {"path", "seconds",
    "built"}; raises RuntimeError with the compiler's stderr on failure.
    A file lock keeps concurrent processes from building it twice."""
    out = _library_path()
    if out.exists():
        return {"path": str(out), "seconds": 0.0, "built": False}
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / ".dsqlparser.lock", "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        if out.exists():
            return {"path": str(out), "seconds": 0.0, "built": False}
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
            objs = [os.path.join(tmp, s[:-4] + ".o") for s in _SOURCES]
            with ThreadPoolExecutor(len(_SOURCES)) as pool:
                list(pool.map(_run, [
                    [_CXX, *_CXXFLAGS, "-c", str(_HERE / s), "-o", o]
                    for s, o in zip(_SOURCES, objs)]))
            lib = os.path.join(tmp, "lib.so")
            _run([_CXX, *_CXXFLAGS, "-shared", "-o", lib, *objs])
            os.replace(lib, out)
        return {"path": str(out), "seconds": time.perf_counter() - t0,
                "built": True}


def load() -> Optional[ctypes.CDLL]:
    """The loaded library (built on first use), or None under
    ``DSQL_NATIVE=0``."""
    global _lib
    if os.environ.get("DSQL_NATIVE", "1") == "0":
        return None
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            path = build()["path"]
            try:
                lib = ctypes.CDLL(path)
            except OSError as exc:
                raise RuntimeError(f"native library: cannot load {path}: "
                                   f"{exc}") from exc
            lib.dsql_parse.argtypes = [ctypes.c_char_p]
            lib.dsql_parse.restype = ctypes.c_void_p  # freed by dsql_free
            lib.dsql_free.argtypes = [ctypes.c_void_p]
            lib.dsql_free.restype = None
            lib.dsql_optimize.argtypes = [ctypes.c_char_p, ctypes.c_int]
            lib.dsql_optimize.restype = ctypes.c_void_p
            _lib = lib
    return _lib


def available() -> bool:
    """True unless ``DSQL_NATIVE=0`` (a failed build raises)."""
    return load() is not None


def _take(lib: ctypes.CDLL, ptr) -> dict:
    if not ptr:
        raise RuntimeError("native library: no result (out of memory)")
    try:
        raw = ctypes.string_at(ptr)
    finally:
        lib.dsql_free(ptr)
    return json.loads(raw.decode("utf-8"))


def parse_to_json(sql: str) -> Optional[dict]:
    """The native parse's envelope: ``{"ok": [statements]}`` or
    ``{"error": {"msg", "line", "col", "width"}}``; None under
    ``DSQL_NATIVE=0``."""
    lib = load()
    if lib is None:
        return None
    return _take(lib, lib.dsql_parse(sql.encode("utf-8")))


def optimize_to_json(plan_json: str, enable_pruning: bool = True
                     ) -> Optional[dict]:
    """The native optimizer's envelope for a serialized plan: ``{"ok":
    plan}`` or ``{"error": {"msg", ...}}``; None under ``DSQL_NATIVE=0``."""
    lib = load()
    if lib is None:
        return None
    return _take(lib, lib.dsql_optimize(plan_json.encode("utf-8"),
                                        1 if enable_pruning else 0))
