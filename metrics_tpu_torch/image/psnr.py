"""PeakSignalNoiseRatio.

JAX counterpart: `metrics_tpu/image/psnr.py:20`; reference `image/psnr.py:25-141`.
Scalar sum and count states when ``dim`` is None, ``cat`` lists of each
update's reductions otherwise; without a ``data_range`` the target's observed
minimum and maximum are states reduced by min and max, kept on the device.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.functional.image.psnr import _psnr_compute, _psnr_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.prints import rank_zero_warn


class PeakSignalNoiseRatio(Metric):
    """PSNR = 10·log10(range² / MSE), accumulated over batches.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import PeakSignalNoiseRatio
        >>> psnr = PeakSignalNoiseRatio(device="cpu")
        >>> preds = torch.tensor([[0.0, 1.0], [2.0, 3.0]])
        >>> target = torch.tensor([[3.0, 2.0], [1.0, 0.0]])
        >>> round(float(psnr(preds, target)), 3)
        2.553
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        data_range: Optional[float] = None,
        base: float = 10.0,
        reduction: Optional[str] = "elementwise_mean",
        dim: Optional[Union[int, Tuple[int, ...]]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if dim is None and reduction != "elementwise_mean":
            rank_zero_warn(f"The `reduction={reduction}` will not have any effect when `dim` is None.")

        if dim is None:
            self.add_state("sum_squared_error", default=torch.tensor(0.0), dist_reduce_fx="sum")
            # a float32 count, as in JAX: an int32 would wrap past 2**31 pixels
            self.add_state("total", default=torch.tensor(0.0), dist_reduce_fx="sum")
        else:
            self.add_state("sum_squared_error", default=[], dist_reduce_fx="cat")
            self.add_state("total", default=[], dist_reduce_fx="cat")

        if data_range is None:
            if dim is not None:
                raise ValueError("The `data_range` must be given when `dim` is not None.")
            self.data_range = None
            self.add_state("min_target", default=torch.tensor(0.0), dist_reduce_fx="min")
            self.add_state("max_target", default=torch.tensor(0.0), dist_reduce_fx="max")
        else:
            self.add_state("data_range", default=torch.tensor(float(data_range)), dist_reduce_fx="mean")
        self.base = base
        self.reduction = reduction
        self.dim = tuple(dim) if isinstance(dim, Sequence) else dim

    def update(self, preds: Tensor, target: Tensor) -> None:
        sum_squared_error, n_obs = _psnr_update(preds, target, dim=self.dim)
        if self.dim is None:
            if self.data_range is None:
                self.min_target = torch.minimum(target.min(), self.min_target)
                self.max_target = torch.maximum(target.max(), self.max_target)
            self.sum_squared_error = self.sum_squared_error + sum_squared_error
            self.total = self.total + n_obs
        else:
            self.sum_squared_error.append(sum_squared_error)
            self.total.append(n_obs)

    def compute(self) -> Tensor:
        data_range = self.data_range if self.data_range is not None else self.max_target - self.min_target
        if self.dim is None:
            sum_squared_error = self.sum_squared_error
            total = self.total
        else:
            sum_squared_error = torch.cat([v.reshape(-1) for v in self.sum_squared_error])
            total = torch.cat([v.reshape(-1) for v in self.total])
        return _psnr_compute(sum_squared_error, total, data_range, base=self.base, reduction=self.reduction)


__all__ = ["PeakSignalNoiseRatio"]
