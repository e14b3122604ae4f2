"""Run a bound query AST through plan and execution (the ML statements
hold their inner SELECT as an AST)."""
from __future__ import annotations

from ..table import Table


def run_query(context, query_ast, sql: str) -> Table:
    plan = context._get_plan(query_ast, sql)
    # the whole execution route, not a direct RelExecutor call: a chunked
    # source must stream (the eager executor would compute on its one-row
    # binding stub), and resident plans take the compiled tier first
    return context._execute_query_plan(plan)
