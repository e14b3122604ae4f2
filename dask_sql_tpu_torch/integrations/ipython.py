"""The IPython ``%%sql`` magic.

The counterpart of ``dask_sql_tpu/integrations/ipython.py``:
``auto_include=True`` registers the pandas DataFrames of the caller's
namespace as tables before each query; ``highlighting_mime_type`` builds
a CodeMirror mime type from the live operator registry, so that the
highlighted keywords and functions are those the engine accepts.  IPython
and pandas are imported inside the functions that use them.
"""
from __future__ import annotations

import json

# keywords of the SQL dialect and of the statement grammar
KEYWORDS = [
    "select", "from", "where", "group", "by", "having", "order", "limit",
    "offset", "fetch", "first", "next", "rows", "only", "as", "on", "using",
    "join", "inner", "left", "right", "full", "outer", "cross", "union",
    "all", "distinct", "case", "when", "then", "else", "end", "and", "or",
    "not", "in", "exists", "between", "like", "similar", "is", "escape",
    "over", "partition", "range", "preceding", "following", "current",
    "row", "unbounded", "with", "values", "interval", "cast", "filter",
    "nulls", "asc", "desc", "tablesample", "system", "bernoulli",
    # the statements
    "create", "drop", "show", "describe", "analyze", "use", "table",
    "tables", "schema", "schemas", "columns", "model", "models",
    "experiment", "predict", "export", "view", "if", "replace", "compute",
    "statistics", "for",
]


def ipython_integration(context, auto_include: bool = False,
                        disable_highlighting: bool = False):
    try:
        from IPython.core.magic import register_line_cell_magic
    except ImportError:
        raise ImportError("IPython is not installed") from None

    def sql(line, cell=None):
        query = cell if cell is not None else line
        if auto_include:
            import pandas as pd
            ip = _get_ipython()
            if ip is not None:
                for name, val in ip.user_ns.items():
                    if isinstance(val, pd.DataFrame) \
                            and not name.startswith("_"):
                        context.create_table(name, val)
        return context.sql(query).to_pandas()

    sql.__name__ = "sql"
    register_line_cell_magic(sql)
    if not disable_highlighting:
        _register_syntax_highlighting()


def highlighting_mime_type() -> dict:
    """The CodeMirror sql-mode mime type, from the live registries."""
    from ..physical.rex.ops import OPERATION_MAPPING
    from ..types import _PHYSICAL

    def as_set(items):
        return {str(k).lower(): True for k in items}

    return {
        "name": "sql",
        "keywords": as_set(KEYWORDS + list(OPERATION_MAPPING)),
        "builtin": as_set(_PHYSICAL.keys()),
        "atoms": as_set(["false", "true", "null"]),
        "dateSQL": as_set(["time"]),
        "support": as_set(["ODBCdotTable", "doubleQuote", "zerolessFloat"]),
    }


def highlighting_js() -> str:
    """The javascript that registers the CodeMirror mode."""
    return (
        'require(["codemirror/lib/codemirror"]);\n'
        'CodeMirror.defineMIME("text/x-dasksql", '
        + json.dumps(highlighting_mime_type())
        + ');\n'
        'CodeMirror.modeInfo.push({name: "Dask SQL (TPU)", '
        'mime: "text/x-dasksql", mode: "sql"});\n'
        "IPython.CodeCell.options_default.highlight_modes"
        "['magic_text/x-dasksql'] = {'reg': ['^%%sql']};\n"
        "IPython.notebook.events.on('kernel_ready.Kernel', () => {\n"
        "  IPython.notebook.get_cells().map(cell =>\n"
        "    cell.code_mirror ? cell.auto_highlight() : cell);\n"
        "});\n"
    )


def _register_syntax_highlighting() -> None:
    """Ship the CodeMirror mode to the front end (nothing without
    IPython)."""
    try:
        from IPython.core import display
    except ImportError:
        return
    display.display_javascript(highlighting_js(), raw=True)


def _get_ipython():
    try:
        from IPython import get_ipython
        return get_ipython()
    except ImportError:
        return None
