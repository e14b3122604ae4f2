"""Interactive SQL REPL over the port.

The counterpart of ``dask_sql_tpu/cmd.py``: the ``dask-sql-tpu-torch``
console entry.  A prompt_toolkit session with SQL highlighting when
prompt_toolkit is installed, else ``input()``; results print as a small
text table over ``Table.to_pylist`` (no pandas: the card's machine has
none).  ``--load-test-data`` registers the synthetic ``timeseries`` table
(a month of minutes) built in numpy.
"""
from __future__ import annotations

import argparse
import logging

import numpy as np


def _make_test_data() -> dict:
    """The JAX package's timeseries table, from the same seeded stream."""
    rng = np.random.RandomState(42)
    n = 30 * 24 * 60  # a month of minutes
    return {
        "timestamp": (np.datetime64("2000-01-01T00:00", "m")
                      + np.arange(n)).astype("datetime64[us]"),
        "id": rng.randint(800, 1200, n),
        "name": rng.choice(list("ABCDEFGH"), n).astype(object),
        "x": rng.uniform(-1, 1, n),
        "y": rng.uniform(-1, 1, n),
    }


def _cell(v) -> str:
    if v is None:
        return "NULL"
    if hasattr(v, "isoformat"):
        return v.isoformat(sep=" ") if hasattr(v, "date") else v.isoformat()
    return str(v)


def format_table(table, max_rows: int = 60) -> str:
    """A text table of ``table``: the header, then up to ``max_rows`` rows
    (the first and last halves when there are more), then the shape."""
    rows = table.to_pylist()
    shown = rows
    if len(rows) > max_rows:
        half = max_rows // 2
        shown = rows[:half] + [None] + rows[-half:]
    cells = [[str(n) for n in table.names]]
    cells += [["..."] * len(table.names) if r is None else
              [_cell(v) for v in r] for r in shown]
    widths = [max(len(row[i]) for row in cells)
              for i in range(len(table.names))]
    lines = ["  ".join(c.rjust(w) for c, w in zip(row, widths))
             for row in cells]
    lines.append(f"[{len(rows)} rows x {len(table.names)} columns]")
    return "\n".join(lines)


def cmd_loop(context=None, client=None, startup: bool = False,
             log_level=None):
    """Read SQL statements and print their results until ``quit``,
    ``exit`` or end of input.  ``context`` defaults to a new
    ``Context()`` on the card; ``client`` is accepted for the JAX
    package's signature and unused there too."""
    if log_level:
        logging.basicConfig(level=log_level)
    from .context import Context

    context = context or Context()
    if startup:
        context.sql("SELECT 1 + 1")

    try:
        from prompt_toolkit import PromptSession
        from prompt_toolkit.lexers import PygmentsLexer
        from pygments.lexers.sql import SqlLexer
        session = PromptSession(lexer=PygmentsLexer(SqlLexer))
        prompt = lambda: session.prompt("(dask-sql-tpu) > ")  # noqa: E731
    except ImportError:
        prompt = lambda: input("(dask-sql-tpu) > ")  # noqa: E731

    while True:
        try:
            text = prompt()
        except (EOFError, KeyboardInterrupt):
            break
        text = text.rstrip(";").strip()
        if not text:
            continue
        if text.lower() in ("quit", "exit"):
            break
        try:
            result = context.sql(text)
            if result is not None and result.num_columns:
                print(format_table(result))
        except Exception as e:  # pragma: no cover - interactive
            print(f"{type(e).__name__}: {e}")


def main(argv=None):  # pragma: no cover - console entry
    parser = argparse.ArgumentParser(description="dask-sql-tpu-torch REPL")
    parser.add_argument("--load-test-data", action="store_true",
                        help="Register a synthetic timeseries table "
                             "'timeseries'")
    parser.add_argument("--startup", action="store_true",
                        help="Run a first query at startup")
    parser.add_argument("--log-level", default=None)
    parser.add_argument("--device", default=None,
                        help="the Context's device (default: cuda)")
    args = parser.parse_args(argv)

    from .context import Context
    context = Context(device=args.device)
    if args.load_test_data:
        context.create_table("timeseries", _make_test_data())
    cmd_loop(context=context, startup=args.startup, log_level=args.log_level)


if __name__ == "__main__":  # pragma: no cover
    main()
