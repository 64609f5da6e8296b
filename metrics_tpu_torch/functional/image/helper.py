"""Shared image kernels: Gaussian and uniform windows, the depthwise convolution, padding, pooling.

JAX counterpart: `metrics_tpu/functional/image/helper.py:19-75`; reference
`functional/image/helper.py`. The depthwise window conv is ``F.conv2d`` /
``F.conv3d`` with ``groups=C`` (cuDNN on the card), and the pool
``F.avg_pool2d`` / ``avg_pool3d``. Both run under
:func:`~metrics_tpu_torch.utils.compute.high_precision`, which clears
``torch.backends.cudnn.allow_tf32`` (True by default) for the call: a TF32
convolution keeps a 10-bit mantissa and moves SSIM by about 1e-3.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from metrics_tpu_torch.utils.compute import high_precision


def _gaussian(kernel_size: int, sigma: float, dtype: torch.dtype, device: torch.device) -> Tensor:
    dist = torch.arange((1 - kernel_size) / 2, (1 + kernel_size) / 2, 1, dtype=dtype, device=device)
    gauss = torch.exp(-(dist**2) / (2 * sigma**2))
    return gauss / gauss.sum()


def _gaussian_kernel_2d(
    kernel_size: Sequence[int], sigma: Sequence[float], dtype: torch.dtype = torch.float32, device=None
) -> Tensor:
    """(kh, kw) separable Gaussian window."""
    gk_h = _gaussian(kernel_size[0], sigma[0], dtype, device)
    gk_w = _gaussian(kernel_size[1], sigma[1], dtype, device)
    return torch.outer(gk_h, gk_w)


def _gaussian_kernel_3d(
    kernel_size: Sequence[int], sigma: Sequence[float], dtype: torch.dtype = torch.float32, device=None
) -> Tensor:
    k = _gaussian_kernel_2d(kernel_size[:2], sigma[:2], dtype, device)
    gk_d = _gaussian(kernel_size[2], sigma[2], dtype, device)
    return torch.einsum("hw,d->hwd", k, gk_d)


def _uniform_kernel(kernel_size: Sequence[int], dtype: torch.dtype = torch.float32, device=None) -> Tensor:
    return torch.ones(tuple(kernel_size), dtype=dtype, device=device) / float(math.prod(kernel_size))


@high_precision
def _depthwise_conv(x: Tensor, kernel: Tensor) -> Tensor:
    """Depthwise (per-channel) valid convolution of (B, C, *spatial) by one window shared across channels."""
    channels = x.shape[1]
    weight = kernel.expand((channels, 1) + tuple(kernel.shape))
    conv = F.conv2d if kernel.ndim == 2 else F.conv3d
    return conv(x.to(kernel.dtype), weight, groups=channels)


def _reflect_pad(x: Tensor, pads: Sequence[Tuple[int, int]]) -> Tensor:
    """Reflection-pad the trailing spatial dims of (B, C, *spatial); ``pads`` in dim order."""
    flat = [p for pair in reversed(list(pads)) for p in pair]  # F.pad takes the last dim first
    return F.pad(x, flat, mode="reflect")


@high_precision
def _avg_pool(x: Tensor, window: int = 2) -> Tensor:
    """Non-overlapping average pool over every spatial dim of (B, C, *spatial)."""
    pool = F.avg_pool2d if x.ndim == 4 else F.avg_pool3d
    return pool(x, window)


__all__ = [
    "_avg_pool",
    "_depthwise_conv",
    "_gaussian_kernel_2d",
    "_gaussian_kernel_3d",
    "_reflect_pad",
    "_uniform_kernel",
]
