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
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for module in ("ops/segments.py", "regression/advanced.py", "retrieval/base.py", "functional/pairwise/distances.py",
                   "functional/classification/ranking.py", "functional/retrieval/kernels.py",
                   "wrappers/bootstrapping.py", "wrappers/classwise.py", "wrappers/minmax.py",
                   "wrappers/multioutput.py", "wrappers/tracker.py", "functional/image/helper.py",
                   "functional/image/psnr.py", "functional/image/ssim.py", "functional/image/spectral.py",
                   "image/base.py", "image/psnr.py", "image/ssim.py", "image/spectral.py",
                   "models/__init__.py", "models/inception.py", "models/lpips.py", "models/manifest.py",
                   "image/generative.py", "functional/detection/__init__.py", "functional/detection/box_ops.py",
                   "functional/detection/rle.py", "detection/__init__.py", "detection/mean_ap.py",
                   "utils/imports.py", "ops/text_native.py", "functional/text/helper.py", "functional/text/wer.py",
                   "functional/text/bleu.py", "functional/text/sacre_bleu.py", "functional/text/chrf.py",
                   "functional/text/ter.py", "functional/text/eed.py", "functional/text/rouge.py",
                   "functional/text/squad.py", "functional/text/perplexity.py", "functional/text/bert.py",
                   "functional/text/infolm.py", "text/basic.py", "text/advanced.py", "functional/audio/snr.py",
                   "functional/audio/sdr.py", "functional/audio/pit.py", "functional/audio/stoi.py",
                   "functional/audio/host.py", "audio/metrics.py", "ops/faults.py", "ops/telemetry.py",
                   "ops/journal.py", "parallel/sync.py", "parallel/bucketing.py", "ops/perf.py", "ops/fleetobs.py",
                   "ops/progcache.py", "ops/autotune.py"):
        assert f"metrics_tpu_torch/{module}" in names


@pytest.mark.parametrize("path", PORT_FILES, ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_import(path):
    bad = sorted({m for m in _imported_modules(path) if _forbidden(m)})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, metrics_tpu_torch, metrics_tpu_torch.interop, metrics_tpu_torch.ops.histogram, "
        "metrics_tpu_torch.ops.segments, metrics_tpu_torch.regression, metrics_tpu_torch.retrieval, "
        "metrics_tpu_torch.functional.pairwise, metrics_tpu_torch.classification.ranking, "
        "metrics_tpu_torch.wrappers, metrics_tpu_torch.image, metrics_tpu_torch.functional.image, "
        "metrics_tpu_torch.models, metrics_tpu_torch.models.manifest, metrics_tpu_torch.image.generative, "
        "metrics_tpu_torch.detection, metrics_tpu_torch.functional.detection, metrics_tpu_torch.text, "
        "metrics_tpu_torch.functional.text, metrics_tpu_torch.ops.text_native, metrics_tpu_torch.audio, "
        "metrics_tpu_torch.functional.audio, metrics_tpu_torch.ops.faults, metrics_tpu_torch.ops.telemetry, "
        "metrics_tpu_torch.ops.journal, metrics_tpu_torch.parallel.sync, metrics_tpu_torch.parallel.bucketing; "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'metrics_tpu')); "
        "assert not bad, bad"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_importing_the_port_starts_no_thread():
    """The watchdog and the dispatcher of the sync planes start at their first use, not at import."""
    code = (
        "import threading; before = threading.active_count(); "
        "import metrics_tpu_torch, metrics_tpu_torch.parallel.sync, metrics_tpu_torch.parallel.bucketing; "
        "assert threading.active_count() == before, [t.name for t in threading.enumerate()]"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
