"""Optional-dependency flags.

The port's own copy of `metrics_tpu/utils/imports.py:64-73`: the flags gate
host helpers (the NLTK stemmer, the ``regex`` tokenizers, the transformers hub
models of BERTScore and InfoLM, scipy's assignment solver and resampler, the
PESQ backend). The device path needs only torch.
"""
from __future__ import annotations

import importlib.util
from functools import lru_cache


@lru_cache()
def package_available(name: str) -> bool:
    """True if ``import name`` would succeed (a spec lookup, no import)."""
    try:
        return importlib.util.find_spec(name) is not None
    except (ModuleNotFoundError, ValueError):
        return False


_SCIPY_AVAILABLE = package_available("scipy")
_NLTK_AVAILABLE = package_available("nltk")
_REGEX_AVAILABLE = package_available("regex")
_TRANSFORMERS_AVAILABLE = package_available("transformers")
_PESQ_AVAILABLE = package_available("pesq")
_PYSTOI_AVAILABLE = package_available("pystoi")

__all__ = [
    "package_available",
    "_SCIPY_AVAILABLE",
    "_NLTK_AVAILABLE",
    "_REGEX_AVAILABLE",
    "_TRANSFORMERS_AVAILABLE",
    "_PESQ_AVAILABLE",
    "_PYSTOI_AVAILABLE",
]
