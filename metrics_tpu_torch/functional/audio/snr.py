"""The SNR family: closed-form energy ratios over the last (time) axis.

JAX counterpart: `metrics_tpu/functional/audio/snr.py` (``signal_noise_ratio``
`:15`, ``scale_invariant_signal_distortion_ratio`` `:36`,
``scale_invariant_signal_noise_ratio`` `:63`), with JAX's ``eps`` (the input
dtype's) and order of operations.
"""
from __future__ import annotations

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _check_same_shape


def signal_noise_ratio(preds: Tensor, target: Tensor, zero_mean: bool = False) -> Tensor:
    """SNR = 10·log10(‖target‖² / ‖target − preds‖²) over the last axis.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import signal_noise_ratio
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> round(float(signal_noise_ratio(preds, target)), 2)
        16.18
    """
    _check_same_shape(preds, target)
    eps = torch.finfo(preds.dtype).eps
    if zero_mean:
        target = target - torch.mean(target, dim=-1, keepdim=True)
        preds = preds - torch.mean(preds, dim=-1, keepdim=True)
    noise = target - preds
    snr_value = (torch.sum(target**2, dim=-1) + eps) / (torch.sum(noise**2, dim=-1) + eps)
    return 10 * torch.log10(snr_value)


def scale_invariant_signal_distortion_ratio(preds: Tensor, target: Tensor, zero_mean: bool = False) -> Tensor:
    """SI-SDR: the SNR after projecting ``preds`` onto the direction of ``target``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import scale_invariant_signal_distortion_ratio
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> scale_invariant_signal_distortion_ratio(preds, target).round(decimals=4)
        tensor(18.4030)
    """
    _check_same_shape(preds, target)
    eps = torch.finfo(preds.dtype).eps
    if zero_mean:
        target = target - torch.mean(target, dim=-1, keepdim=True)
        preds = preds - torch.mean(preds, dim=-1, keepdim=True)
    alpha = (torch.sum(preds * target, dim=-1, keepdim=True) + eps) / (
        torch.sum(target**2, dim=-1, keepdim=True) + eps
    )
    target_scaled = alpha * target
    noise = target_scaled - preds
    val = (torch.sum(target_scaled**2, dim=-1) + eps) / (torch.sum(noise**2, dim=-1) + eps)
    return 10 * torch.log10(val)


def scale_invariant_signal_noise_ratio(preds: Tensor, target: Tensor) -> Tensor:
    """SI-SNR = SI-SDR of the zero-mean signals.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import scale_invariant_signal_noise_ratio
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> scale_invariant_signal_noise_ratio(preds, target).round(decimals=4)
        tensor(15.0918)
    """
    return scale_invariant_signal_distortion_ratio(preds=preds, target=target, zero_mean=True)


__all__ = [
    "signal_noise_ratio",
    "scale_invariant_signal_noise_ratio",
    "scale_invariant_signal_distortion_ratio",
]
