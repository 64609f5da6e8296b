"""SSIM and multi-scale SSIM.

JAX counterpart: `metrics_tpu/functional/image/ssim.py` (``_ssim_compute``
`:42`, SSIM `:133`, MS-SSIM `:172`); reference
`functional/image/ssim.py:26-520`. A Gaussian or uniform window convolves
reflection-padded inputs; the five statistics (preds, target, preds²,
target², preds·target) go through one depthwise convolution of the stacked
batch. MS-SSIM repeats it over an average-pool pyramid with beta exponents.
Statistics run in at least float32, whatever the inputs' dtype: the variances
are differences of products. ``data_range=None`` takes the inputs' range as a
tensor on the device: no host read.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.functional.image.helper import (
    _avg_pool,
    _depthwise_conv,
    _gaussian_kernel_2d,
    _gaussian_kernel_3d,
    _reflect_pad,
    _uniform_kernel,
)
from metrics_tpu_torch.parallel.sync import reduce as _reduce
from metrics_tpu_torch.utils.checks import _check_same_shape


def _ssim_check_inputs(preds: Tensor, target: Tensor, format_tensors: bool = True) -> Tuple[Tensor, Tensor]:
    """Check (B, C, H, W) or (B, C, D, H, W) pairs; ``format_tensors=False`` leaves out the
    cast of ``target`` to the dtype of ``preds`` (buffered rows take it when they are observed)."""
    _check_same_shape(preds, target)
    if preds.ndim not in (4, 5):
        raise ValueError(
            f"Expected `preds` and `target` to have BxCxHxW or BxCxDxHxW shape. Got preds: {tuple(preds.shape)}."
        )
    if format_tensors and preds.dtype != target.dtype:
        target = target.to(preds.dtype)
    return preds, target


def _ssim_compute(
    preds: Tensor,
    target: Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    reduction: Optional[str] = "elementwise_mean",
    data_range: Optional[float] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    return_full_image: bool = False,
    return_contrast_sensitivity: bool = False,
):
    is_3d = preds.ndim == 5
    nd = 3 if is_3d else 2
    if not isinstance(kernel_size, Sequence):
        kernel_size = nd * [kernel_size]
    if not isinstance(sigma, Sequence):
        sigma = nd * [sigma]
    if len(kernel_size) != preds.ndim - 2 or len(sigma) != preds.ndim - 2:
        raise ValueError(
            f"`kernel_size` has dimension {len(kernel_size)}, but expected to be two less that target dimensionality,"
            f" which is: {preds.ndim}"
        )
    if any(x % 2 == 0 or x <= 0 for x in kernel_size):
        raise ValueError(f"Expected `kernel_size` to have odd positive number. Got {kernel_size}.")
    if any(y <= 0 for y in sigma):
        raise ValueError(f"Expected `sigma` to have positive number. Got {sigma}.")

    if data_range is None:
        data_range = torch.maximum(preds.max() - preds.min(), target.max() - target.min())
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    dtype = preds.dtype if preds.is_floating_point() else torch.float32
    dtype = torch.promote_types(dtype, torch.float32)
    preds = preds.to(dtype)
    target = target.to(dtype)

    if gaussian_kernel:
        gauss_kernel_size = [int(3.5 * s + 0.5) * 2 + 1 for s in sigma]
        make = _gaussian_kernel_3d if is_3d else _gaussian_kernel_2d
        kernel = make(gauss_kernel_size, sigma, dtype, preds.device)
        pads = [(ks - 1) // 2 for ks in gauss_kernel_size]
    else:
        kernel = _uniform_kernel(kernel_size, dtype, preds.device)
        pads = [(ks - 1) // 2 for ks in kernel_size]

    pad_spec = [(p, p) for p in pads]
    preds_p = _reflect_pad(preds, pad_spec)
    target_p = _reflect_pad(target, pad_spec)

    # one depthwise conv over the 5-way stacked batch
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
    del out, mu_pred, mu_target, e_pp, e_tt, e_pt

    upper = 2 * sigma_pred_target + c2
    lower = sigma_pred_sq + sigma_target_sq + c2
    ssim_full = ((2 * mu_pred_target + c1) * upper) / ((mu_pred_sq + mu_target_sq + c1) * lower)

    crop = tuple([slice(None), slice(None)] + [slice(p, s - p) for p, s in zip(pads, ssim_full.shape[2:])])
    ssim_idx = ssim_full[crop]
    per_image = ssim_idx.reshape(ssim_idx.shape[0], -1).mean(-1)

    if return_contrast_sensitivity:
        cs = (upper / lower)[crop]
        return _reduce(per_image, reduction), _reduce(cs.reshape(cs.shape[0], -1).mean(-1), reduction)
    if return_full_image:
        return _reduce(per_image, reduction), _reduce(ssim_full, reduction)
    return _reduce(per_image, reduction)


def structural_similarity_index_measure(
    preds: Tensor,
    target: Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    reduction: Optional[str] = "elementwise_mean",
    data_range: Optional[float] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    return_full_image: bool = False,
    return_contrast_sensitivity: bool = False,
):
    """SSIM between batches of images (2-D) or volumes (3-D).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import structural_similarity_index_measure
        >>> preds = torch.rand(8, 3, 16, 16, generator=torch.Generator().manual_seed(0))
        >>> target = preds * 0.75
        >>> round(float(structural_similarity_index_measure(preds, target)), 2)
        0.92
    """
    preds, target = _ssim_check_inputs(preds, target)
    return _ssim_compute(
        preds,
        target,
        gaussian_kernel,
        sigma,
        kernel_size,
        reduction,
        data_range,
        k1,
        k2,
        return_full_image,
        return_contrast_sensitivity,
    )


def multiscale_structural_similarity_index_measure(
    preds: Tensor,
    target: Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    reduction: Optional[str] = "elementwise_mean",
    data_range: Optional[float] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    betas: Tuple[float, ...] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
    normalize: Optional[str] = None,
) -> Tensor:
    """MS-SSIM over an average-pool pyramid with beta exponents.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import multiscale_structural_similarity_index_measure
        >>> preds = torch.rand(2, 3, 192, 192, generator=torch.Generator().manual_seed(42))
        >>> target = preds * 0.75
        >>> round(float(multiscale_structural_similarity_index_measure(preds, target, data_range=1.0)), 2)
        0.96
    """
    preds, target = _ssim_check_inputs(preds, target)
    if not isinstance(betas, tuple) or not all(isinstance(beta, float) for beta in betas):
        raise ValueError("Argument `betas` is expected to be of a type tuple of floats.")
    if normalize and normalize not in ("relu", "simple"):
        raise ValueError("Argument `normalize` to be expected either `None`, `relu` or `simple`")

    nd = preds.ndim - 2
    ks = nd * [kernel_size] if not isinstance(kernel_size, Sequence) else list(kernel_size)
    if preds.shape[-1] < 2 ** len(betas) or preds.shape[-2] < 2 ** len(betas):
        raise ValueError(
            f"For a given number of `betas` parameters {len(betas)}, the image height and width dimensions must be"
            f" larger than or equal to {2 ** len(betas)}."
        )
    _betas_div = max(1, (len(betas) - 1)) ** 2
    if preds.shape[-2] // _betas_div <= ks[0] - 1:
        raise ValueError(
            f"For a given number of `betas` parameters {len(betas)} and kernel size {ks[0]},"
            f" the image height must be larger than {(ks[0] - 1) * _betas_div}."
        )
    if preds.shape[-1] // _betas_div <= ks[1] - 1:
        raise ValueError(
            f"For a given number of `betas` parameters {len(betas)} and kernel size {ks[1]},"
            f" the image width must be larger than {(ks[1] - 1) * _betas_div}."
        )

    sim_list: List[Tensor] = []
    cs_list: List[Tensor] = []
    p, t = preds, target
    for _ in range(len(betas)):
        sim, cs = _ssim_compute(
            p, t, gaussian_kernel, sigma, kernel_size, reduction, data_range, k1, k2,
            return_contrast_sensitivity=True,
        )
        if normalize == "relu":
            sim = torch.relu(sim)
            cs = torch.relu(cs)
        sim_list.append(sim)
        cs_list.append(cs)
        p = _avg_pool(p, 2)
        t = _avg_pool(t, 2)

    sim_stack = torch.stack(sim_list)
    cs_stack = torch.stack(cs_list)
    if normalize == "simple":
        sim_stack = (sim_stack + 1) / 2
        cs_stack = (cs_stack + 1) / 2

    betas_t = torch.tensor(betas, dtype=torch.float32, device=sim_stack.device)
    if reduction in ("none", None):
        betas_t = betas_t[:, None]
    sim_stack = sim_stack**betas_t
    cs_stack = cs_stack**betas_t
    return torch.prod(cs_stack[:-1], dim=0) * sim_stack[-1]


__all__ = ["multiscale_structural_similarity_index_measure", "structural_similarity_index_measure"]
