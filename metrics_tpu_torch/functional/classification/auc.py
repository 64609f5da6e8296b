"""Area under any (x, y) curve by the trapezoidal rule.

JAX counterpart: `metrics_tpu/functional/classification/auc.py`; reference
`src/torchmetrics/functional/classification/auc.py`.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.compute import _auc_compute


def _auc_update(x: Tensor, y: Tensor) -> Tuple[Tensor, Tensor]:
    if x.ndim > 1:
        x = x.squeeze()
    if y.ndim > 1:
        y = y.squeeze()
    if x.ndim > 1 or y.ndim > 1:
        raise ValueError(f"Expected both `x` and `y` tensor to be 1d, but got tensors with dimension {x.ndim} and {y.ndim}")
    _check_same_shape(x, y)
    return x, y


def _auc_compute_without_check(x: Tensor, y: Tensor, direction: float = 1.0) -> Tensor:
    return torch.trapezoid(y, x) * direction


def auc(x: Tensor, y: Tensor, reorder: bool = False) -> Tensor:
    """Area under the (x, y) polyline.

    Without ``reorder``, ``x`` must be monotone (one host read checks it);
    with it, the points are sorted by ``x`` first.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import auc
        >>> x = torch.tensor([0, 1, 2, 3])
        >>> y = torch.tensor([0, 1, 2, 2])
        >>> auc(x, y)
        tensor(4.)
    """
    x, y = _auc_update(x, y)
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    if not reorder:
        dx = x[1:] - x[:-1]
        if not bool((dx >= 0).all() | (dx <= 0).all()):
            raise ValueError("The `x` array is neither increasing or decreasing. Try setting the reorder argument to `True`.")
    return _auc_compute(x, y, reorder)


__all__ = ["auc"]
