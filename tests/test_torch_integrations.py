"""The port's integrations (``integrations/ipython.py``,
``integrations/fugue.py``) against the JAX package's.

The ``%%sql`` magic is registered through IPython with
``register_line_cell_magic`` and ``display_javascript`` patched: the magic
answers as the JAX package's does (``auto_include`` included), and the
CodeMirror mime type and javascript, built from the live operator
registries, are equal to the JAX package's.  The fugue integration loads
without fugue, and making an engine or running ``fsql_tpu`` raises the
``ImportError`` that names it, as in the JAX package.
"""
import json
import sys

import numpy as np
import pandas as pd
import pytest
import torch

import dask_sql_tpu.integrations.ipython as jax_ipython
from dask_sql_tpu import Context as JaxContext
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.integrations import ipython as port_ipython

CPU = torch.device("cpu")


def test_mime_type_and_javascript_equal_jax():
    got = port_ipython.highlighting_mime_type()
    assert json.dumps(got, sort_keys=True) == json.dumps(
        jax_ipython.highlighting_mime_type(), sort_keys=True)
    assert port_ipython.highlighting_js() == jax_ipython.highlighting_js()
    from dask_sql_tpu_torch.physical.rex.ops import OPERATION_MAPPING
    assert all(got["keywords"][str(op).lower()] for op in OPERATION_MAPPING)
    assert got["builtin"]["varchar"] and got["atoms"] == {
        "false": True, "true": True, "null": True}


@pytest.fixture
def magic(monkeypatch):
    """register_line_cell_magic and display_javascript of the installed
    IPython, patched to keep what they are given."""
    import IPython
    import IPython.core.display
    import IPython.core.magic

    kept = {"magics": [], "js": []}
    monkeypatch.setattr(IPython.core.magic, "register_line_cell_magic",
                        lambda fn: kept["magics"].append(fn) or fn)
    monkeypatch.setattr(IPython.core.display, "display_javascript",
                        lambda js, raw=False: kept["js"].append((js, raw)))
    monkeypatch.setattr(IPython, "get_ipython", lambda: None)
    return kept


def test_magic_answers_as_jax(magic):
    df = pd.DataFrame({"a": np.arange(6), "k": list("xyxyxz")})
    jc, pc = JaxContext(), Context(device=CPU)
    for ctx in (jc, pc):
        ctx.create_table("t", df)
    jc.ipython_magic()
    pc.ipython_magic()
    jax_magic, port_magic = magic["magics"]
    assert port_magic.__name__ == jax_magic.__name__ == "sql"
    assert magic["js"][0] == magic["js"][1]
    assert magic["js"][1][1] is True
    q = "SELECT k, SUM(a) AS s FROM t GROUP BY k ORDER BY k"
    for args in ((q,), ("", q)):
        pd.testing.assert_frame_equal(port_magic(*args), jax_magic(*args))


def test_magic_auto_include_and_no_highlighting(magic, monkeypatch):
    class Shell:
        user_ns = {"frame": pd.DataFrame({"v": [1.5, 2.5]}),
                   "_hidden": pd.DataFrame({"v": [9.0]}), "other": 3}

    monkeypatch.setattr(port_ipython, "_get_ipython", lambda: Shell())
    monkeypatch.setattr(jax_ipython, "_get_ipython", lambda: Shell())
    jc, pc = JaxContext(), Context(device=CPU)
    jax_ipython.ipython_integration(jc, auto_include=True,
                                    disable_highlighting=True)
    port_ipython.ipython_integration(pc, auto_include=True,
                                     disable_highlighting=True)
    assert magic["js"] == []
    jax_magic, port_magic = magic["magics"]
    q = "SELECT SUM(v) AS s FROM frame"
    pd.testing.assert_frame_equal(port_magic(q), jax_magic(q))
    assert "_hidden" not in pc.schema["root"].tables
    assert set(pc.schema["root"].tables) == set(jc.schema["root"].tables)


def test_magic_without_ipython_names_it(monkeypatch):
    monkeypatch.setitem(sys.modules, "IPython", None)
    monkeypatch.setitem(sys.modules, "IPython.core", None)
    monkeypatch.setitem(sys.modules, "IPython.core.magic", None)
    for ctx in (JaxContext(), Context(device=CPU)):
        with pytest.raises(ImportError, match="IPython is not installed"):
            ctx.ipython_magic()


@pytest.mark.parametrize("blocked", [False, True])
def test_fugue_is_gated_as_in_jax(monkeypatch, blocked):
    """Without fugue (not installed here; or blocked in sys.modules) the
    module loads, and the engines and fsql_tpu raise ImportError naming
    fugue, as the JAX package's do."""
    if blocked:
        monkeypatch.setitem(sys.modules, "fugue", None)
    import dask_sql_tpu.integrations.fugue as jax_fugue
    import dask_sql_tpu_torch.integrations.fugue as port_fugue

    for engine in ("TpuSQLEngine", "TpuSQLExecutionEngine"):
        messages = []
        for mod in (jax_fugue, port_fugue):
            with pytest.raises(ImportError, match="fugue") as info:
                getattr(mod, engine)()
            messages.append(str(info.value))
        assert messages[0] == messages[1]
    for mod in (jax_fugue, port_fugue):
        with pytest.raises(ImportError, match="'fugue' package"):
            mod.fsql_tpu("SELECT * FROM t", Context(device=CPU))
    assert "fugue" not in sys.modules or sys.modules["fugue"] is None
