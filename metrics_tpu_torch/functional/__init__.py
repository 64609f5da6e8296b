"""Functional metrics: plain functions on tensors (JAX counterpart: `metrics_tpu/functional`)."""
from metrics_tpu_torch.functional.classification import *  # noqa: F401,F403
from metrics_tpu_torch.functional.classification import __all__ as _classification_all

__all__ = list(_classification_all)
