"""Numerically careful compute helpers (JAX counterpart: `metrics_tpu/utils/compute.py`)."""
from __future__ import annotations

import functools
from typing import Any, Callable

import torch
from torch import Tensor


def high_precision(fn: Callable) -> Callable:
    """Run ``fn`` with float32 matrix products and convolutions at full float32 precision.

    On the card a float32 product runs in TF32 (a 10-bit mantissa) whenever
    the caller has set ``torch.set_float32_matmul_precision("high")`` or
    ``"medium"``, which loses integer exactness on counts above 2048; and a
    float32 convolution runs in TF32 whenever ``torch.backends.cudnn.allow_tf32``
    is True, which is PyTorch's default. The wrapper sets ``"highest"`` and
    clears ``cudnn.allow_tf32`` for the duration of the call, and restores the
    caller's settings afterwards, also when ``fn`` raises. The settings are
    process-wide, as they are in PyTorch.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.utils.compute import high_precision
        >>> torch.set_float32_matmul_precision("high")
        >>> high_precision(torch.get_float32_matmul_precision)()
        'highest'
        >>> torch.get_float32_matmul_precision()
        'high'
        >>> torch.set_float32_matmul_precision("highest")
        >>> high_precision(lambda: torch.backends.cudnn.allow_tf32)()
        False
        >>> torch.backends.cudnn.allow_tf32
        True
    """

    @functools.wraps(fn)
    def wrapper(*args: Any, **kwargs: Any) -> Any:
        previous = torch.get_float32_matmul_precision()
        previous_conv = torch.backends.cudnn.allow_tf32
        torch.set_float32_matmul_precision("highest")
        torch.backends.cudnn.allow_tf32 = False
        try:
            return fn(*args, **kwargs)
        finally:
            torch.set_float32_matmul_precision(previous)
            torch.backends.cudnn.allow_tf32 = previous_conv

    return wrapper


def _safe_xlogy(x: Tensor, y: Tensor) -> Tensor:
    """``x * log(y)``, 0 where ``x == 0`` whatever ``y`` holds (JAX counterpart `metrics_tpu/utils/compute.py:38`).

    Written as two ``where``s, not ``torch.xlogy``: that returns NaN for
    ``x == 0, y == NaN``, where the JAX form returns 0.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.utils.compute import _safe_xlogy
        >>> _safe_xlogy(torch.tensor([0.0, 0.0, 2.0]), torch.tensor([float("nan"), 0.0, 1.0]))
        tensor([0., 0., 0.])
    """
    zero = x == 0
    safe_y = torch.where(zero, torch.ones_like(y), y)
    return torch.where(zero, torch.zeros_like(x), x * torch.log(safe_y))


def _l2_norm(x: Tensor, dim: int, keepdim: bool = False) -> Tensor:
    """``sqrt(sum(x * x))`` along ``dim``, as ``jnp.linalg.norm`` computes it.

    Not ``torch.linalg.vector_norm``: on the CPU it sums float32 squares in a
    few running accumulators, and over a 2**24-row stream its norm is off by
    1e-3 relative, where ``torch.sum`` (and JAX) stay near 1e-7.
    """
    return torch.sqrt((x * x).sum(dim=dim, keepdim=keepdim))


def _safe_divide(num: Tensor, denom: Tensor) -> Tensor:
    """``num / denom`` with 0 where ``denom == 0`` (the reference's ``_safe_divide``).

    Integer operands are promoted to float32, as ``jnp.result_type(x, float32)`` does.
    """
    num = num if num.is_floating_point() else num.to(torch.float32)
    denom = denom if denom.is_floating_point() else denom.to(torch.float32)
    zero = denom == 0
    return torch.where(zero, torch.zeros_like(num), num / torch.where(zero, torch.ones_like(denom), denom))


def _auc_compute(x: Tensor, y: Tensor, reorder: bool = False) -> Tensor:
    """Trapezoidal area under ``(x, y)``, optionally sorting by ``x`` first.

    The direction is read from the data without a host read: the area is
    negated when ``x`` never increases, and a curve that goes both ways is
    integrated as it is (JAX counterpart `metrics_tpu/utils/compute.py:51`).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.utils.compute import _auc_compute
        >>> _auc_compute(torch.tensor([3.0, 2.0, 1.0, 0.0]), torch.tensor([2.0, 2.0, 1.0, 0.0]))
        tensor(4.)
    """
    if reorder:
        order = torch.argsort(x, stable=True)
        x, y = x[order], y[order]
    dx = x[1:] - x[:-1]
    direction = torch.where((dx <= 0).all(), -1.0, 1.0)
    return direction * torch.trapezoid(y, x)


__all__ = ["high_precision", "_l2_norm", "_safe_divide", "_safe_xlogy", "_auc_compute"]
