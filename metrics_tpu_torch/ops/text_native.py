"""The host text library: ``csrc/text_kernels.cpp`` built with ``g++`` at first use, loaded with ``ctypes``.

JAX counterpart: `metrics_tpu/native/__init__.py` (``_load`` `:83`,
``intern_ids`` `:126`, ``levenshtein`` `:145`, ``levenshtein_matrix`` `:155`,
``lcs_length`` `:167`, ``levenshtein_batch`` `:205`, ``lcs_batch`` `:210`,
``codepoints`` `:215`, ``eed_batch`` `:220`). The dynamic programs of the text
metrics (edit distance, LCS, EED) run over interned int32 ids in C++; this is
host code, not a device kernel.

The library is built with the JAX package's flags (``-O3 -shared -fPIC
-std=c++17``) into ``build/metrics_tpu_torch/`` beside the package, named by a
hash of the source and the flags, like the CUDA sources (``ops/_native.py``).
There is no switch and no fallback: a failed build raises with the
compiler's output. The plain Python versions of the same programs live beside
their callers in ``functional/text/`` and serve only as the tests' reference.
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
from typing import List, Optional, Sequence, Tuple

import numpy as np

from metrics_tpu_torch.ops._native import BUILD_DIR, CSRC_DIR

SOURCE = "text_kernels.cpp"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

#: Dynamic programs run so far (one a sequence pair), and calls into the library, counted at the call.
DP_CALLS = 0
LIBRARY_CALLS = 0

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_F64P = ctypes.POINTER(ctypes.c_double)


def library_path() -> Path:
    """Where the library built from ``csrc/text_kernels.cpp`` lives."""
    src = CSRC_DIR / SOURCE
    digest = hashlib.sha256(src.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build() -> Path:
    """Compile the library unless it is already built; return its path. Raises with the compiler's output."""
    out = library_path()
    if out.is_file():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ was not found on PATH; it is needed to build the host text library")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([cxx, *CXX_FLAGS, str(CSRC_DIR / SOURCE), "-o", tmp], capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed with code {proc.returncode} on {SOURCE}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent builder sees no library or the whole one
    return out


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            f64 = ctypes.c_double
            lib.mt_levenshtein.restype = ctypes.c_int32
            lib.mt_levenshtein.argtypes = [_I32P, ctypes.c_int32, _I32P, ctypes.c_int32]
            lib.mt_levenshtein_batch.restype = None
            lib.mt_levenshtein_batch.argtypes = [_I32P, _I64P, _I32P, _I64P, ctypes.c_int64, _I32P]
            lib.mt_levenshtein_matrix.restype = None
            lib.mt_levenshtein_matrix.argtypes = [_I32P, ctypes.c_int32, _I32P, ctypes.c_int32, _I32P]
            lib.mt_lcs.restype = ctypes.c_int32
            lib.mt_lcs.argtypes = [_I32P, ctypes.c_int32, _I32P, ctypes.c_int32]
            lib.mt_lcs_batch.restype = None
            lib.mt_lcs_batch.argtypes = [_I32P, _I64P, _I32P, _I64P, ctypes.c_int64, _I32P]
            lib.mt_eed_score.restype = f64
            lib.mt_eed_score.argtypes = [_I32P, ctypes.c_int32, _I32P, ctypes.c_int32, ctypes.c_int32, f64, f64, f64, f64]
            lib.mt_eed_batch.restype = None
            lib.mt_eed_batch.argtypes = [_I32P, _I64P, _I32P, _I64P, ctypes.c_int64, ctypes.c_int32, f64, f64, f64, f64, _F64P]
            _lib = lib
        return _lib


def _count(pairs: int) -> None:
    global DP_CALLS, LIBRARY_CALLS
    DP_CALLS += pairs
    LIBRARY_CALLS += 1


def intern_ids(*seqs: Sequence) -> List[np.ndarray]:
    """Map hashable tokens to dense int32 ids shared by all the sequences, in order of first sight."""
    vocab: dict = {}
    out = []
    for s in seqs:
        arr = np.empty(len(s), dtype=np.int32)
        for i, tok in enumerate(s):
            arr[i] = vocab.setdefault(tok, len(vocab))
        out.append(arr)
    return out


def _as_i32(a) -> Tuple["ctypes._Pointer", np.ndarray]:
    """(pointer, the array that owns its buffer): the caller holds the array for the length of the C call."""
    a = np.ascontiguousarray(a, dtype=np.int32)
    return a.ctypes.data_as(_I32P), a


def levenshtein(a_ids, b_ids) -> int:
    """Edit distance between two id sequences."""
    lib = load()
    pa, a = _as_i32(a_ids)
    pb, b = _as_i32(b_ids)
    _count(1)
    return int(lib.mt_levenshtein(pa, len(a), pb, len(b)))


def levenshtein_matrix(a_ids, b_ids) -> np.ndarray:
    """The full (m+1, n+1) int32 table of the edit-distance program."""
    lib = load()
    pa, a = _as_i32(a_ids)
    pb, b = _as_i32(b_ids)
    out = np.empty((len(a) + 1, len(b) + 1), dtype=np.int32)
    _count(1)
    lib.mt_levenshtein_matrix(pa, len(a), pb, len(b), out.ctypes.data_as(_I32P))
    return out


def lcs_length(a_ids, b_ids) -> int:
    """Length of the longest common subsequence of two id sequences."""
    lib = load()
    pa, a = _as_i32(a_ids)
    pb, b = _as_i32(b_ids)
    _count(1)
    return int(lib.mt_lcs(pa, len(a), pb, len(b)))


def _pack(seqs: Sequence) -> Tuple[np.ndarray, np.ndarray]:
    off = np.zeros(len(seqs) + 1, dtype=np.int64)
    np.cumsum([len(s) for s in seqs], out=off[1:])
    flat = np.concatenate([np.asarray(s, np.int32) for s in seqs]) if seqs else np.zeros(0, np.int32)
    return np.ascontiguousarray(flat, np.int32), off


def _batch(fn_name: str, a_seqs: Sequence, b_seqs: Sequence) -> np.ndarray:
    if len(a_seqs) != len(b_seqs):
        raise ValueError(f"Expected as many first sequences as second ones, got {len(a_seqs)} and {len(b_seqs)}")
    lib = load()
    a_flat, a_off = _pack(a_seqs)
    b_flat, b_off = _pack(b_seqs)
    out = np.empty(len(a_seqs), dtype=np.int32)
    _count(len(a_seqs))
    getattr(lib, fn_name)(
        a_flat.ctypes.data_as(_I32P), a_off.ctypes.data_as(_I64P),
        b_flat.ctypes.data_as(_I32P), b_off.ctypes.data_as(_I64P),
        len(a_seqs), out.ctypes.data_as(_I32P),
    )
    return out


def levenshtein_batch(a_seqs: Sequence, b_seqs: Sequence) -> np.ndarray:
    """Edit distances of k pairs in one call (the pairs packed as CSR)."""
    return _batch("mt_levenshtein_batch", a_seqs, b_seqs)


def lcs_batch(a_seqs: Sequence, b_seqs: Sequence) -> np.ndarray:
    """LCS lengths of k pairs in one call."""
    return _batch("mt_lcs_batch", a_seqs, b_seqs)


def codepoints(s: str) -> np.ndarray:
    """The Unicode codepoints of a string as int32 (the ids of the character programs)."""
    return np.frombuffer(s.encode("utf-32-le"), dtype=np.int32)


def eed_batch(
    hyp_seqs: Sequence,
    ref_seqs: Sequence,
    alpha: float,
    rho: float,
    deletion: float,
    insertion: float,
    space_id: int = 32,
) -> np.ndarray:
    """EED sentence scores (float64) of k (hypothesis, reference) codepoint pairs in one call."""
    if len(hyp_seqs) != len(ref_seqs):
        raise ValueError(f"Expected as many hypotheses as references, got {len(hyp_seqs)} and {len(ref_seqs)}")
    lib = load()
    h_flat, h_off = _pack(hyp_seqs)
    r_flat, r_off = _pack(ref_seqs)
    out = np.empty(len(hyp_seqs), dtype=np.float64)
    _count(len(hyp_seqs))
    lib.mt_eed_batch(
        h_flat.ctypes.data_as(_I32P), h_off.ctypes.data_as(_I64P),
        r_flat.ctypes.data_as(_I32P), r_off.ctypes.data_as(_I64P),
        len(hyp_seqs), space_id, alpha, rho, deletion, insertion, out.ctypes.data_as(_F64P),
    )
    return out


__all__ = [
    "SOURCE",
    "build",
    "load",
    "library_path",
    "intern_ids",
    "codepoints",
    "levenshtein",
    "levenshtein_batch",
    "levenshtein_matrix",
    "lcs_length",
    "lcs_batch",
    "eed_batch",
]
