"""The port's REPL (``dask_sql_tpu_torch/cmd.py``) on the CPU.

- ``cmd_loop`` fed from a scripted ``input()`` (prompt_toolkit is made
  unimportable, as on a machine without it): each statement's result
  prints as a text table whose cells are the query's ``to_pylist``
  values, DDL prints nothing, an error prints its type and message and
  the loop goes on, and ``quit`` (or the end of input) ends it.
- ``format_table`` keeps the first and last rows of a long result.
- ``--load-test-data``'s table equals the JAX package's
  ``_make_test_data`` frame value for value (timestamps, ids, names and
  both doubles, exact).
"""
import builtins
import sys

import numpy as np
import pytest

from dask_sql_tpu import cmd as jax_cmd
from dask_sql_tpu_torch import Context, cmd_loop
from dask_sql_tpu_torch import cmd as port_cmd


def _script(monkeypatch, lines):
    feed = iter(lines)

    def fake_input(prompt=""):
        try:
            return next(feed)
        except StopIteration:
            raise EOFError from None

    monkeypatch.setattr(builtins, "input", fake_input)
    monkeypatch.setitem(sys.modules, "prompt_toolkit", None)


@pytest.fixture()
def ctx():
    c = Context(device="cpu")
    c.create_table("t", {"k": np.array(["a", "b", "a"], dtype=object),
                         "x": np.array([1.5, 2.0, 4.0])})
    return c


def test_repl_prints_results_and_errors(ctx, monkeypatch, capsys):
    _script(monkeypatch, [
        "SELECT k, SUM(x) AS s FROM t GROUP BY k ORDER BY k;",
        "",
        "CREATE TABLE u AS SELECT k FROM t",
        "SELECT COUNT(*) AS n FROM u",
        "SELECT * FROM missing",
        "quit",
        "SELECT 1 AS never",
    ])
    cmd_loop(context=ctx)
    out = capsys.readouterr().out.splitlines()
    assert out[0].split() == ["k", "s"]
    assert out[1].split() == ["a", "5.5"] and out[2].split() == ["b", "2.0"]
    assert out[3] == "[2 rows x 2 columns]"
    assert out[4].split() == ["n"] and out[5].split() == ["3"]
    assert out[7].startswith("ValidationException:")
    assert not any("never" in line for line in out)   # quit ended the loop
    assert "u" in ctx.schema["root"].tables


def test_repl_ends_at_end_of_input(ctx, monkeypatch, capsys):
    _script(monkeypatch, ["SELECT 1 + 1 AS x"])
    cmd_loop(context=ctx)
    out = capsys.readouterr().out.splitlines()
    assert [line.split() for line in out[:2]] == [["x"], ["2"]]


def test_format_table_elides_the_middle(ctx):
    c = Context(device="cpu")
    c.create_table("n", {"i": np.arange(100)})
    text = port_cmd.format_table(c.sql("SELECT i FROM n ORDER BY i"),
                                 max_rows=6)
    lines = text.splitlines()
    assert [line.strip() for line in lines[1:8]] == [
        "0", "1", "2", "...", "97", "98", "99"]
    assert lines[-1] == "[100 rows x 1 columns]"


def test_test_data_equals_jax():
    port = port_cmd._make_test_data()
    jax = jax_cmd._make_test_data()
    assert list(port) == list(jax.columns)
    np.testing.assert_array_equal(
        port["timestamp"], jax["timestamp"].to_numpy().astype("datetime64[us]"))
    for name in ("id", "x", "y"):
        np.testing.assert_array_equal(port[name], jax[name].to_numpy())
    assert port["name"].tolist() == jax["name"].tolist()
    c = Context(device="cpu")
    c.create_table("timeseries", port)
    got = c.sql("SELECT COUNT(*) AS n, MIN(\"timestamp\") AS t0 "
                "FROM timeseries").to_pylist()
    assert got[0][0] == 30 * 24 * 60
    assert str(got[0][1]) == "2000-01-01 00:00:00"
