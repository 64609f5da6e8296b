"""The port stands alone: nothing under ``metrics_tpu_torch/``, and not
``chip_smoke.py``, imports JAX or the JAX package, and importing the port
loads no JAX module."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "metrics_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def _forbidden(module):
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "metrics_tpu")


def test_port_files_exist():
    assert (ROOT / "chip_smoke.py").is_file()
    assert len(PORT_FILES) > 20


@pytest.mark.parametrize("path", PORT_FILES, ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_import(path):
    bad = sorted({m for m in _imported_modules(path) if _forbidden(m)})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, metrics_tpu_torch, metrics_tpu_torch.interop, metrics_tpu_torch.ops.histogram; "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'metrics_tpu')); "
        "assert not bad, bad"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
