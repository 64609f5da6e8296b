"""Element-wise error metrics: MSE, MAE, MSLE, MAPE, SMAPE and WMAPE.

JAX counterpart: `metrics_tpu/functional/regression/basic.py` (reference
`functional/regression/{mse,mae,log_mse,mape,symmetric_mape,wmape}.py`).
Each is a summed error, a count and a division.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _check_same_shape

_EPS = 1.17e-06


def _mean_squared_error_update(preds: Tensor, target: Tensor, num_outputs: int = 1) -> Tuple[Tensor, int]:
    _check_same_shape(preds, target)
    if num_outputs == 1:
        preds = preds.reshape(-1)
        target = target.reshape(-1)
    diff = (preds - target).to(torch.float32)
    return torch.sum(diff * diff, dim=0), target.shape[0] if num_outputs > 1 else target.numel()


def _mean_squared_error_compute(sum_squared_error: Tensor, n_obs: Union[int, Tensor], squared: bool = True) -> Tensor:
    mse = sum_squared_error / n_obs
    return mse if squared else torch.sqrt(mse)


def mean_squared_error(preds: Tensor, target: Tensor, squared: bool = True, num_outputs: int = 1) -> Tensor:
    """MSE, or RMSE with ``squared=False``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import mean_squared_error
        >>> x = torch.tensor([0.0, 1.0, 2.0, 3.0])
        >>> y = torch.tensor([0.0, 1.0, 2.0, 2.0])
        >>> mean_squared_error(x, y)
        tensor(0.2500)
    """
    sum_squared_error, n_obs = _mean_squared_error_update(preds, target, num_outputs)
    return _mean_squared_error_compute(sum_squared_error, n_obs, squared)


def _mean_absolute_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, int]:
    _check_same_shape(preds, target)
    return torch.sum(torch.abs(preds.to(torch.float32) - target)), target.numel()


def _mean_absolute_error_compute(sum_abs_error: Tensor, n_obs: Union[int, Tensor]) -> Tensor:
    return sum_abs_error / n_obs


def mean_absolute_error(preds: Tensor, target: Tensor) -> Tensor:
    """MAE.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import mean_absolute_error
        >>> x = torch.tensor([0.0, 1.0, 2.0, 3.0])
        >>> y = torch.tensor([0.0, 1.0, 2.0, 1.0])
        >>> mean_absolute_error(x, y)
        tensor(0.5000)
    """
    sum_abs_error, n_obs = _mean_absolute_error_update(preds, target)
    return _mean_absolute_error_compute(sum_abs_error, n_obs)


def _mean_squared_log_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, int]:
    _check_same_shape(preds, target)
    diff = torch.log1p(preds.to(torch.float32)) - torch.log1p(target.to(torch.float32))
    return torch.sum(diff * diff), target.numel()


def _mean_squared_log_error_compute(sum_squared_log_error: Tensor, n_obs: Union[int, Tensor]) -> Tensor:
    return sum_squared_log_error / n_obs


def mean_squared_log_error(preds: Tensor, target: Tensor) -> Tensor:
    """MSLE: the mean squared error of ``log1p`` of both.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import mean_squared_log_error
        >>> preds = torch.tensor([2.5, 5.0, 4.0, 8.0])
        >>> target = torch.tensor([3.0, 5.0, 2.5, 7.0])
        >>> round(float(mean_squared_log_error(preds, target)), 4)
        0.0397
    """
    sum_squared_log_error, n_obs = _mean_squared_log_error_update(preds, target)
    return _mean_squared_log_error_compute(sum_squared_log_error, n_obs)


def _mean_absolute_percentage_error_update(preds: Tensor, target: Tensor, epsilon: float = _EPS) -> Tuple[Tensor, int]:
    _check_same_shape(preds, target)
    abs_per_error = torch.abs(preds - target) / torch.clamp(torch.abs(target), min=epsilon)
    return torch.sum(abs_per_error), target.numel()


def _mean_absolute_percentage_error_compute(sum_abs_per_error: Tensor, n_obs: Union[int, Tensor]) -> Tensor:
    return sum_abs_per_error / n_obs


def mean_absolute_percentage_error(preds: Tensor, target: Tensor) -> Tensor:
    """MAPE, each denominator clamped at a small epsilon.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import mean_absolute_percentage_error
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> round(float(mean_absolute_percentage_error(preds, target)), 4)
        0.3274
    """
    sum_abs_per_error, n_obs = _mean_absolute_percentage_error_update(preds, target)
    return _mean_absolute_percentage_error_compute(sum_abs_per_error, n_obs)


def _symmetric_mape_update(preds: Tensor, target: Tensor, epsilon: float = _EPS) -> Tuple[Tensor, int]:
    _check_same_shape(preds, target)
    abs_per_error = 2 * torch.abs(preds - target) / torch.clamp(torch.abs(target) + torch.abs(preds), min=epsilon)
    return torch.sum(abs_per_error), target.numel()


def symmetric_mean_absolute_percentage_error(preds: Tensor, target: Tensor) -> Tensor:
    """SMAPE: the mean of 2|p - t| / (|t| + |p|).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import symmetric_mean_absolute_percentage_error
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> round(float(symmetric_mean_absolute_percentage_error(preds, target)), 4)
        0.5788
    """
    sum_abs_per_error, n_obs = _symmetric_mape_update(preds, target)
    return sum_abs_per_error / n_obs


def _weighted_mape_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    _check_same_shape(preds, target)
    return torch.sum(torch.abs(preds - target)), torch.sum(torch.abs(target))


def _weighted_mape_compute(sum_abs_error: Tensor, sum_scale: Tensor, epsilon: float = _EPS) -> Tensor:
    return sum_abs_error / torch.clamp(sum_scale, min=epsilon)


def weighted_mean_absolute_percentage_error(preds: Tensor, target: Tensor) -> Tensor:
    """WMAPE: Σ|p - t| / Σ|t|.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import weighted_mean_absolute_percentage_error
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> round(float(weighted_mean_absolute_percentage_error(preds, target)), 4)
        0.16
    """
    sum_abs_error, sum_scale = _weighted_mape_update(preds, target)
    return _weighted_mape_compute(sum_abs_error, sum_scale)


__all__ = [
    "mean_squared_error",
    "mean_absolute_error",
    "mean_squared_log_error",
    "mean_absolute_percentage_error",
    "symmetric_mean_absolute_percentage_error",
    "weighted_mean_absolute_percentage_error",
]
