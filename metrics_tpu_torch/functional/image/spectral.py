"""Spectral and statistical image metrics: UQI, ERGAS, SAM, D-lambda, image gradients.

JAX counterpart: `metrics_tpu/functional/image/spectral.py` (``_image_update``
`:17`, UQI `:32`, ERGAS `:88`, SAM `:116`, D-lambda `:142`, ``image_gradients``
`:181`); reference `functional/image/{uqi,ergas,sam,d_lambda,gradients}.py`.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import Tensor

from metrics_tpu_torch.functional.image.helper import _depthwise_conv, _gaussian_kernel_2d, _reflect_pad
from metrics_tpu_torch.parallel.sync import reduce as _reduce
from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.compute import _l2_norm


def _image_update(preds: Tensor, target: Tensor, format_tensors: bool = True) -> Tuple[Tensor, Tensor]:
    """Check (B, C, H, W) pairs; ``format_tensors=False`` leaves out the float32 casts
    (buffered rows take them when they are observed)."""
    _check_same_shape(preds, target)
    if preds.ndim != 4:
        raise ValueError(f"Expected `preds` and `target` to have BxCxHxW shape. Got preds: {tuple(preds.shape)}.")
    if not format_tensors:
        return preds, target
    if preds.dtype != target.dtype:
        target = target.to(preds.dtype)
    return preds.to(torch.float32), target.to(torch.float32)


def universal_image_quality_index(
    preds: Tensor,
    target: Tensor,
    kernel_size: Sequence[int] = (11, 11),
    sigma: Sequence[float] = (1.5, 1.5),
    reduction: Optional[str] = "elementwise_mean",
    data_range: Optional[float] = None,
) -> Tensor:
    """UQI: SSIM without the stabilising constants.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import universal_image_quality_index
        >>> preds = torch.rand(8, 3, 16, 16, generator=torch.Generator().manual_seed(0))
        >>> target = preds * 0.75
        >>> round(float(universal_image_quality_index(preds, target)), 2)
        0.92
    """
    preds, target = _image_update(preds, target)
    if len(kernel_size) != 2 or len(sigma) != 2:
        raise ValueError(
            "Expected `kernel_size` and `sigma` to have the length of two."
            f" Got kernel_size: {len(kernel_size)} and sigma: {len(sigma)}."
        )
    if any(x % 2 == 0 or x <= 0 for x in kernel_size):
        raise ValueError(f"Expected `kernel_size` to have odd positive number. Got {kernel_size}.")
    if any(y <= 0 for y in sigma):
        raise ValueError(f"Expected `sigma` to have positive number. Got {sigma}.")

    kernel = _gaussian_kernel_2d(kernel_size, sigma, preds.dtype, preds.device)
    pad_h = (kernel_size[0] - 1) // 2
    pad_w = (kernel_size[1] - 1) // 2
    preds_p = _reflect_pad(preds, [(pad_h, pad_h), (pad_w, pad_w)])
    target_p = _reflect_pad(target, [(pad_h, pad_h), (pad_w, pad_w)])

    stacked = torch.cat((preds_p, target_p, preds_p * preds_p, target_p * target_p, preds_p * target_p), dim=0)
    del preds_p, target_p
    out = _depthwise_conv(stacked, kernel)
    del stacked
    b = preds.shape[0]
    mu_pred, mu_target, e_pp, e_tt, e_pt = (out[i * b : (i + 1) * b] for i in range(5))

    mu_pred_sq = mu_pred**2
    mu_target_sq = mu_target**2
    mu_pred_target = mu_pred * mu_target
    sigma_pred_sq = e_pp - mu_pred_sq
    sigma_target_sq = e_tt - mu_target_sq
    sigma_pred_target = e_pt - mu_pred_target

    upper = 2 * sigma_pred_target
    lower = sigma_pred_sq + sigma_target_sq
    uqi_idx = ((2 * mu_pred_target) * upper) / ((mu_pred_sq + mu_target_sq) * lower)
    uqi_idx = uqi_idx[..., pad_h:-pad_h, pad_w:-pad_w]
    return _reduce(uqi_idx, reduction)


def error_relative_global_dimensionless_synthesis(
    preds: Tensor,
    target: Tensor,
    ratio: Union[int, float] = 4,
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    """ERGAS = 100·ratio·sqrt(mean over bands of (RMSE_b / mean_b)²).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import error_relative_global_dimensionless_synthesis
        >>> preds = torch.rand(8, 3, 16, 16, generator=torch.Generator().manual_seed(42))
        >>> target = preds * 0.75
        >>> round(float(error_relative_global_dimensionless_synthesis(preds, target)))
        154
    """
    preds, target = _image_update(preds, target)
    b, c, h, w = preds.shape
    preds_f = preds.reshape(b, c, h * w)
    target_f = target.reshape(b, c, h * w)
    diff = preds_f - target_f
    sum_squared_error = torch.sum(diff * diff, dim=2)
    rmse_per_band = torch.sqrt(sum_squared_error / (h * w))
    mean_target = torch.mean(target_f, dim=2)
    ergas_score = 100 * ratio * torch.sqrt(torch.sum((rmse_per_band / mean_target) ** 2, dim=1) / c)
    return _reduce(ergas_score, reduction)


def spectral_angle_mapper(
    preds: Tensor,
    target: Tensor,
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    """The angle between the band vectors of each pixel.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import spectral_angle_mapper
        >>> grid = torch.arange(8 * 3 * 16 * 16, dtype=torch.float32)
        >>> preds = (torch.sin(grid) * 0.5 + 0.5).reshape(8, 3, 16, 16)
        >>> target = (torch.cos(grid) * 0.5 + 0.5).reshape(8, 3, 16, 16)
        >>> round(float(spectral_angle_mapper(preds, target)), 4)
        0.8221
    """
    preds, target = _image_update(preds, target)
    if preds.shape[1] <= 1:
        raise ValueError(
            f"Expected channel dimension of `preds` and `target` to be larger than 1. Got preds: {preds.shape[1]}."
        )
    dot_product = (preds * target).sum(dim=1)
    preds_norm = _l2_norm(preds, dim=1)
    target_norm = _l2_norm(target, dim=1)
    sam_score = torch.arccos(torch.clamp(dot_product / (preds_norm * target_norm), -1, 1))
    return _reduce(sam_score, reduction)


def spectral_distortion_index(
    preds: Tensor,
    target: Tensor,
    p: int = 1,
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    """D-lambda: the distance between the band-pair UQI matrices of preds and of target.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import spectral_distortion_index
        >>> grid = torch.arange(2 * 3 * 16 * 16, dtype=torch.float32)
        >>> preds = ((grid * 17) % 23 / 23.0).reshape(2, 3, 16, 16)
        >>> target = ((grid * 7) % 19 / 19.0).reshape(2, 3, 16, 16)
        >>> round(float(spectral_distortion_index(preds, target)), 4)
        0.211
    """
    if not isinstance(p, int) or p <= 0:
        raise ValueError(f"Expected `p` to be a positive integer. Got p: {p}.")
    preds, target = _image_update(preds, target)
    length = preds.shape[1]
    m1 = torch.zeros((length, length), device=preds.device)
    m2 = torch.zeros((length, length), device=preds.device)
    for k in range(length):
        for r in range(k, length):
            v1 = universal_image_quality_index(target[:, k : k + 1], target[:, r : r + 1])
            v2 = universal_image_quality_index(preds[:, k : k + 1], preds[:, r : r + 1])
            m1[k, r] = m1[r, k] = v1
            m2[k, r] = m2[r, k] = v2
    diff = torch.abs(m1 - m2) ** p
    if length == 1:
        output = diff ** (1.0 / p)
    else:
        output = (torch.sum(diff) / (length * (length - 1))) ** (1.0 / p)
    return _reduce(output, reduction)


def image_gradients(img: Tensor) -> Tuple[Tensor, Tensor]:
    """Finite differences (dy, dx) of a batch of images, zero in the last row and column.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import image_gradients
        >>> image = torch.arange(0, 1 * 1 * 5 * 5, dtype=torch.float32).reshape(1, 1, 5, 5)
        >>> dy, dx = image_gradients(image)
        >>> dy[0, 0, :, :]
        tensor([[5., 5., 5., 5., 5.],
                [5., 5., 5., 5., 5.],
                [5., 5., 5., 5., 5.],
                [5., 5., 5., 5., 5.],
                [0., 0., 0., 0., 0.]])
    """
    if img.ndim != 4:
        raise RuntimeError(f"The size of the image tensor {tuple(img.shape)} is different from BxCxHxW")
    dy = img[..., 1:, :] - img[..., :-1, :]
    dx = img[..., :, 1:] - img[..., :, :-1]
    return F.pad(dy, (0, 0, 0, 1)), F.pad(dx, (0, 1, 0, 0))


__all__ = [
    "error_relative_global_dimensionless_synthesis",
    "image_gradients",
    "spectral_angle_mapper",
    "spectral_distortion_index",
    "universal_image_quality_index",
]
