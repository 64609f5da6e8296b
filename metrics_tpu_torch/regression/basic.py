"""Element-wise error metrics: MSE, MAE, MSLE, MAPE, SMAPE and WMAPE.

JAX counterpart: `metrics_tpu/regression/basic.py`; reference
`regression/{mse,mae,log_mse,mape,symmetric_mape,wmape}.py`. Every state is
a sum; the counts are int32.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
from torch import Tensor

from metrics_tpu_torch.functional.regression.basic import (
    _mean_absolute_error_compute,
    _mean_absolute_error_update,
    _mean_absolute_percentage_error_compute,
    _mean_absolute_percentage_error_update,
    _mean_squared_error_compute,
    _mean_squared_error_update,
    _mean_squared_log_error_compute,
    _mean_squared_log_error_update,
    _symmetric_mape_update,
    _weighted_mape_compute,
    _weighted_mape_update,
)
from metrics_tpu_torch.metric import Metric


class _SumAndCount(Metric):
    """A summed error under ``_sum_name`` and an int32 count, from ``_update_fn``."""

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    _sum_name: str
    _update_fn: Callable

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state(self._sum_name, default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds = torch.as_tensor(preds, device=self.device)
        target = torch.as_tensor(target, device=self.device)
        summed, n_obs = type(self)._update_fn(preds, target)
        setattr(self, self._sum_name, getattr(self, self._sum_name) + summed)
        self.total = self.total + n_obs


class MeanSquaredError(Metric):
    """MSE, or RMSE with ``squared=False``; one value an output with ``num_outputs``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MeanSquaredError
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> mean_squared_error = MeanSquaredError(device="cpu")
        >>> mean_squared_error(preds, target)
        tensor(0.3750)
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(self, squared: bool = True, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(num_outputs, int) or num_outputs < 1:
            raise ValueError(f"Expected num_outputs to be a positive integer but got {num_outputs}")
        self.num_outputs = num_outputs
        shape = () if num_outputs == 1 else (num_outputs,)
        self.add_state("sum_squared_error", default=torch.zeros(shape), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")
        self.squared = squared

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds = torch.as_tensor(preds, device=self.device)
        target = torch.as_tensor(target, device=self.device)
        sum_squared_error, n_obs = _mean_squared_error_update(preds, target, self.num_outputs)
        self.sum_squared_error = self.sum_squared_error + sum_squared_error
        self.total = self.total + n_obs

    def compute(self) -> Tensor:
        return _mean_squared_error_compute(self.sum_squared_error, self.total, self.squared)


class MeanAbsoluteError(_SumAndCount):
    """MAE.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MeanAbsoluteError
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> mean_absolute_error = MeanAbsoluteError(device="cpu")
        >>> mean_absolute_error(preds, target)
        tensor(0.5000)
    """

    _sum_name = "sum_abs_error"
    _update_fn = staticmethod(_mean_absolute_error_update)

    def compute(self) -> Tensor:
        return _mean_absolute_error_compute(self.sum_abs_error, self.total)


class MeanSquaredLogError(_SumAndCount):
    """MSLE.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MeanSquaredLogError
        >>> preds = torch.tensor([2.5, 5.0, 4.0, 8.0])
        >>> target = torch.tensor([3.0, 5.0, 2.5, 7.0])
        >>> mean_squared_log_error = MeanSquaredLogError(device="cpu")
        >>> round(float(mean_squared_log_error(preds, target)), 4)
        0.0397
    """

    _sum_name = "sum_squared_log_error"
    _update_fn = staticmethod(_mean_squared_log_error_update)

    def compute(self) -> Tensor:
        return _mean_squared_log_error_compute(self.sum_squared_log_error, self.total)


class MeanAbsolutePercentageError(_SumAndCount):
    """MAPE.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MeanAbsolutePercentageError
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> mape = MeanAbsolutePercentageError(device="cpu")
        >>> round(float(mape(preds, target)), 4)
        0.3274
    """

    _sum_name = "sum_abs_per_error"
    _update_fn = staticmethod(_mean_absolute_percentage_error_update)

    def compute(self) -> Tensor:
        return _mean_absolute_percentage_error_compute(self.sum_abs_per_error, self.total)


class SymmetricMeanAbsolutePercentageError(_SumAndCount):
    """SMAPE.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import SymmetricMeanAbsolutePercentageError
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> smape = SymmetricMeanAbsolutePercentageError(device="cpu")
        >>> round(float(smape(preds, target)), 4)
        0.5788
    """

    _sum_name = "sum_abs_per_error"
    _update_fn = staticmethod(_symmetric_mape_update)

    def compute(self) -> Tensor:
        return self.sum_abs_per_error / self.total


class WeightedMeanAbsolutePercentageError(Metric):
    """WMAPE.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import WeightedMeanAbsolutePercentageError
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> wmape = WeightedMeanAbsolutePercentageError(device="cpu")
        >>> round(float(wmape(preds, target)), 4)
        0.16
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_abs_error", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("sum_scale", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds = torch.as_tensor(preds, device=self.device)
        target = torch.as_tensor(target, device=self.device)
        sum_abs_error, sum_scale = _weighted_mape_update(preds, target)
        self.sum_abs_error = self.sum_abs_error + sum_abs_error
        self.sum_scale = self.sum_scale + sum_scale

    def compute(self) -> Tensor:
        return _weighted_mape_compute(self.sum_abs_error, self.sum_scale)


__all__ = [
    "MeanSquaredError",
    "MeanAbsoluteError",
    "MeanSquaredLogError",
    "MeanAbsolutePercentageError",
    "SymmetricMeanAbsolutePercentageError",
    "WeightedMeanAbsolutePercentageError",
]
