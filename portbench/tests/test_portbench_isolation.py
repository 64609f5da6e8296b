"""Nothing the benchmark runs imports JAX or the JAX package (top-level names compared whole), and the
plain references import nothing of the program."""
import ast
import sys

import pytest
from conftest import BENCH

import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "metrics_tpu"}


def imported_tops(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_the_references_import_nothing_of_the_program(path):
    tops = imported_tops(path)
    assert "metrics_tpu_torch" not in tops and tops <= {"__future__", "typing", "torch", "numpy", "math"}


def test_the_module_check_compares_whole_top_level_names(monkeypatch):
    import metrics_tpu_torch  # noqa: F401  (its name begins with the JAX package's)

    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "metrics_tpu.ops", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert harness.forbidden_modules() == ["jaxlib", "metrics_tpu.ops"]
