"""Nothing the benchmark runs imports JAX, the JAX package or the
repository's ``benchmarks/``; the reference imports nothing of the port.
Top-level module names are compared whole: ``dask_sql_tpu_torch`` begins
with ``dask_sql_tpu`` and is allowed for the harness."""
import ast
import subprocess
import sys

import pytest

from sqlbench_helpers import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "dask_sql_tpu", "benchmarks"}
SOURCES = sorted(p for p in (ROOT / "sqlbench").rglob("*.py")
                 if "__pycache__" not in p.parts)


def imported_top_levels(path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_forbidden_import(path):
    assert not imported_top_levels(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((ROOT / "sqlbench" / "reference")
                                        .glob("*.py")))
def test_reference_imports_nothing_of_the_port(path):
    assert "dask_sql_tpu_torch" not in imported_top_levels(path)


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split("
         "'.')[0] for m in sys.modules}))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_the_harness_and_port_load_no_jax():
    loaded = _loaded("import sqlbench.core.harness, sqlbench.control\n"
                     "import sqlbench.core.trace\n"
                     "import dask_sql_tpu_torch\n"
                     "from sqlbench.core import manifest\n"
                     "[manifest.reader(m['name']) for m in manifest.manifest()"
                     "['per_layer'] + manifest.manifest()['end_to_end']]")
    assert not loaded & FORBIDDEN
    assert "dask_sql_tpu_torch" in loaded


def test_the_reference_loads_nothing_of_the_port():
    loaded = _loaded("import sqlbench.reference.tpch, sqlbench.gen.tpch")
    assert not loaded & (FORBIDDEN | {"dask_sql_tpu_torch"})
