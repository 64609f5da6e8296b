"""StructuralSimilarityIndexMeasure and MultiScaleStructuralSimilarityIndexMeasure.

JAX counterpart: `metrics_tpu/image/ssim.py` (`:23`, `:84`); reference
`image/ssim.py:25-262`. Both buffer the raw rows and run the stacked
depthwise convolution of :mod:`metrics_tpu_torch.functional.image.ssim` over
their concatenation in ``compute``.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple, Union

from torch import Tensor

from metrics_tpu_torch.functional.image.ssim import (
    _ssim_check_inputs,
    _ssim_compute,
    multiscale_structural_similarity_index_measure,
)
from metrics_tpu_torch.image.base import _CatImageMetric


class StructuralSimilarityIndexMeasure(_CatImageMetric):
    """SSIM over the accumulated batches.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import StructuralSimilarityIndexMeasure
        >>> preds = torch.rand(8, 3, 16, 16, generator=torch.Generator().manual_seed(0))
        >>> ssim = StructuralSimilarityIndexMeasure(data_range=1.0, device="cpu")
        >>> round(float(ssim(preds, preds * 0.75)), 2)
        0.92
    """

    higher_is_better = True
    is_differentiable = True
    full_state_update = False

    _input_check = staticmethod(_ssim_check_inputs)
    _warn_name = "SSIM"

    def __init__(
        self,
        gaussian_kernel: bool = True,
        sigma: Union[float, Sequence[float]] = 1.5,
        kernel_size: Union[int, Sequence[int]] = 11,
        reduction: Optional[str] = "elementwise_mean",
        data_range: Optional[float] = None,
        k1: float = 0.01,
        k2: float = 0.03,
        return_full_image: bool = False,
        return_contrast_sensitivity: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.gaussian_kernel = gaussian_kernel
        self.sigma = sigma
        self.kernel_size = kernel_size
        self.reduction = reduction
        self.data_range = data_range
        self.k1 = k1
        self.k2 = k2
        self.return_full_image = return_full_image
        self.return_contrast_sensitivity = return_contrast_sensitivity

    def compute(self):
        preds, target = self._cat_states()
        return _ssim_compute(
            preds,
            target,
            self.gaussian_kernel,
            self.sigma,
            self.kernel_size,
            self.reduction,
            self.data_range,
            self.k1,
            self.k2,
            self.return_full_image,
            self.return_contrast_sensitivity,
        )


class MultiScaleStructuralSimilarityIndexMeasure(_CatImageMetric):
    """MS-SSIM over the accumulated batches.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MultiScaleStructuralSimilarityIndexMeasure
        >>> preds = torch.rand(2, 3, 192, 192, generator=torch.Generator().manual_seed(42))
        >>> ms_ssim = MultiScaleStructuralSimilarityIndexMeasure(data_range=1.0, device="cpu")
        >>> round(float(ms_ssim(preds, preds * 0.75)), 2)
        0.96
    """

    higher_is_better = True
    is_differentiable = True
    full_state_update = False

    _input_check = staticmethod(_ssim_check_inputs)
    _warn_name = "MS_SSIM"

    def __init__(
        self,
        gaussian_kernel: bool = True,
        kernel_size: Union[int, Sequence[int]] = 11,
        sigma: Union[float, Sequence[float]] = 1.5,
        reduction: Optional[str] = "elementwise_mean",
        data_range: Optional[float] = None,
        k1: float = 0.01,
        k2: float = 0.03,
        betas: Tuple[float, ...] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
        normalize: Optional[str] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if not isinstance(kernel_size, (Sequence, int)):
            raise ValueError(
                f"Argument `kernel_size` expected to be an sequence or an int, or a single int. Got {kernel_size}"
            )
        if isinstance(kernel_size, Sequence) and (
            len(kernel_size) not in (2, 3) or not all(isinstance(ks, int) for ks in kernel_size)
        ):
            raise ValueError(
                "Argument `kernel_size` expected to be an sequence of size 2 or 3 where each element is an int, "
                f"or a single int. Got {kernel_size}"
            )
        self.gaussian_kernel = gaussian_kernel
        self.sigma = sigma
        self.kernel_size = kernel_size
        self.reduction = reduction
        self.data_range = data_range
        self.k1 = k1
        self.k2 = k2
        if not isinstance(betas, tuple):
            raise ValueError("Argument `betas` is expected to be of a type tuple.")
        if not all(isinstance(beta, float) for beta in betas):
            raise ValueError("Argument `betas` is expected to be a tuple of floats.")
        self.betas = betas
        if normalize and normalize not in ("relu", "simple"):
            raise ValueError("Argument `normalize` to be expected either `None` or one of 'relu' or 'simple'")
        self.normalize = normalize

    def compute(self) -> Tensor:
        preds, target = self._cat_states()
        return multiscale_structural_similarity_index_measure(
            preds,
            target,
            gaussian_kernel=self.gaussian_kernel,
            sigma=self.sigma,
            kernel_size=self.kernel_size,
            reduction=self.reduction,
            data_range=self.data_range,
            k1=self.k1,
            k2=self.k2,
            betas=self.betas,
            normalize=self.normalize,
        )


__all__ = ["MultiScaleStructuralSimilarityIndexMeasure", "StructuralSimilarityIndexMeasure"]
