"""Build the CUDA sources under ``csrc/`` at first use and load them with ``ctypes``.

Each source is compiled alone by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds). The
library lands in ``build/metrics_tpu_torch/`` beside the package, named by a
hash of the source and the flags, so an edited source builds anew and an
unchanged one is reused. A failed build raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC_DIR.parent.parent / "build" / "metrics_tpu_torch"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",  # registers, shared memory and spills per kernel, kept in the build log
)

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.is_file():
        return str(default)
    raise RuntimeError("nvcc was not found on PATH or under CUDA_HOME; it is needed to build the CUDA kernels")


def library_path(source: str) -> Path:
    """Where the library built from ``csrc/<source>`` lives."""
    src = CSRC_DIR / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless its library is already built; return the library's path.

    The compiler's output (``-Xptxas=-v``) is kept beside it with the suffix ``.log``.
    """
    out = library_path(source)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed with code {proc.returncode} on {source}:\n{proc.stdout}{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent builder sees the old state or the whole library
    return out


def load(source: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<source>``, built first if needed."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            _loaded[source] = lib
        return lib


__all__ = ["BUILD_DIR", "CSRC_DIR", "build", "library_path", "load"]
