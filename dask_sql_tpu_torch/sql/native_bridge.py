"""Bridge: the native parser's JSON -> the AST dataclasses in ``ast.py``.

The counterpart of ``dask_sql_tpu/sql/native_bridge.py``.  The C++ parser
(``native/parser.cpp``) serializes each AST node as
``{"t": "<ClassName>", <field>: <value>, ...}`` with field names identical to
the dataclasses, so reconstruction is mechanical; the only special cases are
tuple-valued fields (pos, frame bounds, sample, whens, projections, ctes) and
the ``{"__map__": [...]}`` encoding of SQL MAP kwargs values (whose keys may
be non-strings, which JSON objects cannot carry).
"""
from __future__ import annotations

from typing import Any, List, Optional

from ..utils import ParsingException
from . import ast as A

_NODE_TYPES = {
    name: getattr(A, name)
    for name in (
        "Literal", "IntervalLiteral", "ColumnRef", "Star", "Param", "Call",
        "Case", "Cast", "InList", "Between", "Like", "IsNull", "IsBool",
        "IsDistinctFrom", "Subquery", "TableRef", "SubqueryRelation",
        "JoinRelation", "PredictRelation", "SortKey", "Select", "SetOp",
        "ValuesQuery", "QueryStatement", "CreateTable", "CreateTableAs",
        "DropTable", "CreateSchema", "DropSchema", "UseSchema", "ShowSchemas",
        "ShowTables", "ShowColumns", "ShowModels", "DescribeModel",
        "AnalyzeTable", "CreateModel", "DropModel", "CreateExperiment",
        "ExportModel", "DescribeTable", "ExplainStatement", "WindowSpec",
    )
}


def _tuple2(v):
    return tuple(v) if v is not None else None


def _convert_kwarg_value(v):
    if isinstance(v, dict):
        if "__map__" in v and len(v) == 1:
            items = [_convert_kwarg_value(x) for x in v["__map__"]]
            return dict(zip(items[0::2], items[1::2]))
        return {k: _convert_kwarg_value(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_convert_kwarg_value(x) for x in v]
    return v


def _convert(v: Any) -> Any:
    """Recursively convert a JSON value into AST nodes."""
    if isinstance(v, dict):
        t = v.get("t")
        cls = _NODE_TYPES.get(t)
        if cls is None:
            raise ValueError(f"unknown native AST node type: {t!r}")
        fields = {}
        orig_name = None
        for key, val in v.items():
            if key == "t":
                continue
            if key == "orig":
                orig_name = val
                continue
            if key == "pos":
                fields["pos"] = tuple(val)
            elif key == "kwargs":
                fields["kwargs"] = _convert_kwarg_value(val)
            elif key == "projections":
                fields["projections"] = [( _convert(e), a) for e, a in val]
            elif key == "ctes":
                fields["ctes"] = [(name, _convert(q)) for name, q in val]
            elif key == "whens":
                fields["whens"] = [(_convert(c), _convert(x)) for c, x in val]
            elif key == "rows":
                fields["rows"] = [[_convert(e) for e in row] for row in val]
            elif key == "frame":
                fields["frame"] = (
                    None if val is None
                    else (val[0], _tuple2(val[1]), _tuple2(val[2]))
                )
            elif key == "sample":
                fields["sample"] = _tuple2(val)
            elif key == "using":
                fields["using"] = val  # list, "NATURAL", or None
            elif isinstance(val, dict):
                fields[key] = _convert(val)
            elif isinstance(val, list) and key in (
                "args", "values", "partition_by", "order_by", "group_by",
            ):
                fields[key] = [_convert(x) for x in val]
            else:
                fields[key] = val
        node = cls(**fields)
        if orig_name is not None:
            node.original_name = orig_name
        return node
    return v


def json_to_statements(envelope: dict, sql: str) -> Optional[List[A.Statement]]:
    """Convert the native parser's JSON envelope to AST statements.

    Raises ParsingException for parse errors (same shape as the Python
    parser's); returns None only if the envelope is malformed.
    """
    if "error" in envelope:
        e = envelope["error"]
        raise ParsingException(sql, e["msg"], e["line"], e["col"],
                               max(1, e.get("width", 1)))
    if "ok" not in envelope:
        return None
    return [_convert(stmt) for stmt in envelope["ok"]]
