"""Peak signal-to-noise ratio.

JAX counterpart: `metrics_tpu/functional/image/psnr.py` (``_psnr_update`` `:16`,
``_psnr_compute`` `:49`, ``peak_signal_noise_ratio`` `:61`); reference
`functional/image/psnr.py:23-160`. With ``data_range=None`` the range is the
target's ``max - min``, a tensor on the device: no host read.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.parallel.sync import reduce as _reduce
from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.prints import rank_zero_warn


def _psnr_update(
    preds: Tensor, target: Tensor, dim: Optional[Union[int, Tuple[int, ...]]] = None
) -> Tuple[Tensor, Tensor]:
    if dim is None:
        sum_squared_error = torch.sum((preds - target) ** 2)
        n_obs = torch.tensor(target.numel(), device=target.device)
        return sum_squared_error, n_obs
    diff = preds - target
    dim_list = [dim] if isinstance(dim, int) else list(dim)
    if not dim_list:
        # an empty dim reduces every dim, as the reference's explicit branch does
        return torch.sum(diff * diff), torch.tensor(float(target.numel()), device=target.device)
    sum_squared_error = torch.sum(diff * diff, dim=dim_list)
    count = 1
    for d in dim_list:
        count *= target.shape[d]
    # float32 counts broadcast to the kept dims, as in JAX
    n_obs = torch.full(sum_squared_error.shape, float(count), dtype=torch.float32, device=target.device)
    return sum_squared_error, n_obs


def _psnr_compute(
    sum_squared_error: Tensor,
    n_obs: Tensor,
    data_range: Tensor,
    base: float = 10.0,
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    psnr_base_e = 2 * torch.log(data_range) - torch.log(sum_squared_error / n_obs)
    psnr_vals = psnr_base_e * (10 / torch.log(torch.tensor(float(base))))
    return _reduce(psnr_vals, reduction)


def peak_signal_noise_ratio(
    preds: Tensor,
    target: Tensor,
    data_range: Optional[float] = None,
    base: float = 10.0,
    reduction: Optional[str] = "elementwise_mean",
    dim: Optional[Union[int, Tuple[int, ...]]] = None,
) -> Tensor:
    """PSNR = 10·log10(range² / MSE).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import peak_signal_noise_ratio
        >>> pred = torch.tensor([[0.0, 1.0], [2.0, 3.0]])
        >>> target = torch.tensor([[3.0, 2.0], [1.0, 0.0]])
        >>> round(float(peak_signal_noise_ratio(pred, target)), 3)
        2.553
    """
    if dim is None and reduction != "elementwise_mean":
        rank_zero_warn(f"The `reduction={reduction}` will not have any effect when `dim` is None.")
    _check_same_shape(preds, target)
    if data_range is None:
        if dim is not None:
            raise ValueError("The `data_range` must be given when `dim` is not None.")
        data_range_t = target.max() - target.min()
    else:
        data_range_t = torch.tensor(float(data_range), device=target.device)
    sum_squared_error, n_obs = _psnr_update(preds, target, dim=dim)
    return _psnr_compute(sum_squared_error, n_obs, data_range_t, base=base, reduction=reduction)


__all__ = ["peak_signal_noise_ratio"]
