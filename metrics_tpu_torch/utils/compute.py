"""Numerically careful compute helpers (JAX counterpart: `metrics_tpu/utils/compute.py`)."""
from __future__ import annotations

import torch
from torch import Tensor


def _safe_divide(num: Tensor, denom: Tensor) -> Tensor:
    """``num / denom`` with 0 where ``denom == 0`` (the reference's ``_safe_divide``).

    Integer operands are promoted to float32, as ``jnp.result_type(x, float32)`` does.
    """
    num = num if num.is_floating_point() else num.to(torch.float32)
    denom = denom if denom.is_floating_point() else denom.to(torch.float32)
    zero = denom == 0
    return torch.where(zero, torch.zeros_like(num), num / torch.where(zero, torch.ones_like(denom), denom))


__all__ = ["_safe_divide"]
