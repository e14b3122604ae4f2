"""REX evaluator: bound expression tree -> Column/Scalar over a Table.

The counterpart of ``dask_sql_tpu/physical/rex/evaluate.py``: expression
nodes dispatch through a Pluggable registry keyed on the node class name.
An uncorrelated scalar subquery runs its plan once and becomes a Scalar
(inside a compiled trace, the tracer inlines it instead); a parameter
reads its node's value (the compiled tier bakes it into the program); a column UDF (``Context.register_function``) runs on
the host over numpy arrays.  A row UDF, which the JAX package feeds a
pandas row at a time, raises ``NotImplementedError``: the card's machine
has no pandas.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

from ...plan.nodes import (
    RexCall, RexInputRef, RexLiteral, RexNode, RexParam, RexScalarSubquery,
    RexUdf,
)
from ...table import Column, Scalar, Table
from ...types import physical_to_python_value, python_value_to_physical
from ...utils import Pluggable
from .cast import cast_value
from .ops import OPERATION_MAPPING


class RexExecutor(Pluggable):
    """Dispatches on rex node class name -- extension point for custom rex."""

    @classmethod
    def convert(cls, rex: RexNode, table: Table, executor) -> Union[Column, Scalar]:
        name = type(rex).__name__
        if not cls.has_plugin(name):
            raise NotImplementedError(f"Expression {name} is not ported yet")
        return cls.get_plugin(name)(rex, table, executor)


def _eval_input_ref(rex: RexInputRef, table: Table, executor):
    return table.columns[rex.index]


def _eval_literal(rex: RexLiteral, table: Table, executor):
    return Scalar(rex.value, rex.stype)


def _eval_param(rex: RexParam, table: Table, executor):
    return Scalar(rex.value, rex.stype)


def _eval_call(rex: RexCall, table: Table, executor):
    if rex.op == "CAST":
        v = RexExecutor.convert(rex.operands[0], table, executor)
        return cast_value(v, rex.info)
    args = [RexExecutor.convert(o, table, executor) for o in rex.operands]
    try:
        fn = OPERATION_MAPPING[rex.op]
    except KeyError:
        raise NotImplementedError(
            f"Operation {rex.op} is not ported yet") from None
    return fn(args, rex.stype, table)


def _eval_scalar_subquery(rex: RexScalarSubquery, table: Table, executor):
    if getattr(executor, "is_tracer", False):
        # compiled tier: the subplan joins the trace; its result broadcasts
        # to a column whose NULL-ness is a device mask
        return executor.traced_scalar_subquery(rex, table)
    sub = executor.execute(rex.plan)
    if sub.num_rows == 0:
        return Scalar(None, rex.stype)
    if sub.num_rows > 1:
        raise RuntimeError("Scalar subquery returned more than one row")
    v = sub.columns[0].to_numpy().tolist()[0]
    if v is None or (isinstance(v, float) and np.isnan(v)):
        return Scalar(None, rex.stype)
    return Scalar(python_value_to_physical(v, rex.stype), rex.stype)


def _eval_udf(rex: RexUdf, table: Table, executor):
    """A column UDF: called once with each argument as a host numpy array
    (NULLs as NaN / None / NaT) or a Python scalar; a returned array (or
    tensor) becomes a column of the UDF's return type on the table's
    device, a scalar a Scalar."""
    if rex.row_udf:
        raise NotImplementedError(
            f"Row UDF {rex.name} is not ported yet (it needs pandas)")
    args = [RexExecutor.convert(o, table, executor) for o in rex.operands]
    host_args = [a.to_numpy() if isinstance(a, Column)
                 else physical_to_python_value(a.value, a.stype)
                 for a in args]
    out = rex.func(*host_args)
    if isinstance(out, torch.Tensor):
        out = out.cpu().numpy()
    out = np.asarray(out)
    if out.ndim == 0:
        return Scalar(python_value_to_physical(out.item(), rex.stype),
                      rex.stype)
    device = executor.device if executor is not None else table.columns[0].device
    return cast_value(Column.from_numpy(out, device), rex.stype)


RexExecutor.add_plugin("RexInputRef", _eval_input_ref)
RexExecutor.add_plugin("RexLiteral", _eval_literal)
RexExecutor.add_plugin("RexParam", _eval_param)
RexExecutor.add_plugin("RexCall", _eval_call)
RexExecutor.add_plugin("RexScalarSubquery", _eval_scalar_subquery)
RexExecutor.add_plugin("RexUdf", _eval_udf)


def evaluate_rex(rex: RexNode, table: Table, executor=None) -> Union[Column, Scalar]:
    return RexExecutor.convert(rex, table, executor)


def evaluate_predicate(rex: RexNode, table: Table, executor=None):
    """A boolean rex as a row mask (NULL -> False), or a bool for a scalar."""
    v = evaluate_rex(rex, table, executor)
    if isinstance(v, Scalar):
        return bool(v.value) if not v.is_null else False
    data = v.data.to(torch.bool)
    if v.mask is not None:
        data = data & v.mask
    return data
