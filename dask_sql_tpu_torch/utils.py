"""Cross-cutting utilities: plugin machinery and SQL error pretty-printing.

TPU-native re-implementation of the reference's utils
(upstream dask_sql/utils.py): ``Pluggable`` (utils.py:54-81) is the
single extension mechanism shared by the REL converter, REX converter and
input plugins; ``ParsingException`` (utils.py:84-174) renders a caret marker
under the offending SQL fragment.
"""
from __future__ import annotations

import uuid
from typing import Any, Dict


class Pluggable:
    """Base class providing a per-subclass plugin registry.

    Mirrors the semantics of the reference's Pluggable (utils.py:54-81): each
    direct subclass gets its own registry dict keyed by plugin name; plugins
    are singletons; ``replace=False`` keeps the first registration.
    """

    __plugins: Dict[type, Dict[str, Any]] = {}

    @classmethod
    def add_plugin(cls, name: str, plugin: Any, replace: bool = True) -> None:
        registry = Pluggable.__plugins.setdefault(cls, {})
        if name in registry and not replace:
            return
        registry[name] = plugin

    @classmethod
    def get_plugin(cls, name: str) -> Any:
        return Pluggable.__plugins.setdefault(cls, {})[name]

    @classmethod
    def get_plugins(cls) -> list:
        return list(Pluggable.__plugins.setdefault(cls, {}).values())

    @classmethod
    def has_plugin(cls, name: str) -> bool:
        return name in Pluggable.__plugins.setdefault(cls, {})


class ParsingException(Exception):
    """Parse/validation error with a ``^``-marked SQL excerpt.

    Reference behavior: utils.py:84-174 turns Calcite's "From line X, column Y
    to line X2, column Y2" messages into a caret-underlined SQL snippet.  Our
    native parser reports (line, col, length) directly.
    """

    def __init__(self, sql: str, message: str, line: int = None, col: int = None,
                 length: int = 1):
        self.sql = sql
        self.raw_message = message
        # 1-based position, consumed by the Presto server's errorLocation
        # (the reference exposes from_line/from_col the same way)
        self.line = line
        self.col = col
        if line is not None and sql:
            lines = sql.splitlines()
            if 0 < line <= len(lines):
                bad = lines[line - 1]
                marker = " " * (col - 1) + "^" * max(1, min(length, len(bad) - col + 1))
                message = (
                    f"{message}\n\n"
                    f"\tline {line}, column {col}\n\n"
                    f"\t{bad}\n"
                    f"\t{marker}"
                )
        super().__init__(message)


class ValidationException(ParsingException):
    """Binder/validator error (unknown column, type mismatch...)."""


class OptimizationException(Exception):
    pass


def new_temporary_column(existing) -> str:
    """A column name guaranteed unique (reference: utils.py:248-256)."""
    while True:
        name = f"__tmp_{uuid.uuid4().hex[:12]}"
        if name not in existing:
            return name


def convert_sql_kwargs(kwargs) -> dict:
    """Normalize a parsed kwargs dict (values are python literals already).

    The reference converts a Java SqlKwargs HashMap (utils.py:198-235); our
    native parser produces python values directly, including nested dicts
    (MAP/MULTISET) and lists (ARRAY), so this just passes through while
    lower-casing string 'True'/'False' style values is NOT done — parser
    already typed them.
    """
    return dict(kwargs)
