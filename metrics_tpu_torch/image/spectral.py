"""UniversalImageQualityIndex, ErrorRelativeGlobalDimensionlessSynthesis,
SpectralAngleMapper and SpectralDistortionIndex.

JAX counterpart: `metrics_tpu/image/spectral.py` (`:22`, `:60`, `:92`, `:119`);
reference `image/{uqi,ergas,sam,d_lambda}.py`. Each buffers the raw rows and
applies its function to their concatenation in ``compute``.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Union

from torch import Tensor

from metrics_tpu_torch.functional.image.spectral import (
    error_relative_global_dimensionless_synthesis,
    spectral_angle_mapper,
    spectral_distortion_index,
    universal_image_quality_index,
)
from metrics_tpu_torch.image.base import _CatImageMetric


class UniversalImageQualityIndex(_CatImageMetric):
    """UQI: SSIM without the stabilising constants.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import UniversalImageQualityIndex
        >>> preds = torch.rand(8, 3, 16, 16, generator=torch.Generator().manual_seed(0))
        >>> uqi = UniversalImageQualityIndex(device="cpu")
        >>> round(float(uqi(preds, preds * 0.75)), 2)
        0.92
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        kernel_size: Sequence[int] = (11, 11),
        sigma: Sequence[float] = (1.5, 1.5),
        reduction: Optional[str] = "elementwise_mean",
        data_range: Optional[float] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.kernel_size = kernel_size
        self.sigma = sigma
        self.reduction = reduction
        self.data_range = data_range

    def compute(self) -> Tensor:
        preds, target = self._cat_states()
        return universal_image_quality_index(preds, target, self.kernel_size, self.sigma, self.reduction, self.data_range)


class ErrorRelativeGlobalDimensionlessSynthesis(_CatImageMetric):
    """ERGAS, the pan-sharpening quality index.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import ErrorRelativeGlobalDimensionlessSynthesis
        >>> preds = torch.rand(8, 3, 16, 16, generator=torch.Generator().manual_seed(42))
        >>> ergas = ErrorRelativeGlobalDimensionlessSynthesis(device="cpu")
        >>> round(float(ergas(preds, preds * 0.75)))
        154
    """

    higher_is_better = False
    is_differentiable = True
    full_state_update = False

    def __init__(self, ratio: Union[int, float] = 4, reduction: Optional[str] = "elementwise_mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.ratio = ratio
        self.reduction = reduction

    def compute(self) -> Tensor:
        preds, target = self._cat_states()
        return error_relative_global_dimensionless_synthesis(preds, target, self.ratio, self.reduction)


class SpectralAngleMapper(_CatImageMetric):
    """The mean angle between the band vectors of preds and target.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import SpectralAngleMapper
        >>> grid = torch.arange(8 * 3 * 16 * 16, dtype=torch.float32)
        >>> preds = (torch.sin(grid) * 0.5 + 0.5).reshape(8, 3, 16, 16)
        >>> target = (torch.cos(grid) * 0.5 + 0.5).reshape(8, 3, 16, 16)
        >>> round(float(SpectralAngleMapper(device="cpu")(preds, target)), 4)
        0.8221
    """

    higher_is_better = False
    is_differentiable = True
    full_state_update = False

    def __init__(self, reduction: Optional[str] = "elementwise_mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.reduction = reduction

    def compute(self) -> Tensor:
        preds, target = self._cat_states()
        return spectral_angle_mapper(preds, target, self.reduction)


class SpectralDistortionIndex(_CatImageMetric):
    """D-lambda, the spectral distortion between the band-pair UQI matrices.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import SpectralDistortionIndex
        >>> g = torch.Generator().manual_seed(42)
        >>> preds, target = torch.rand(8, 3, 16, 16, generator=g), torch.rand(8, 3, 16, 16, generator=g)
        >>> float(SpectralDistortionIndex(device="cpu")(preds, target)) > 0
        True
    """

    higher_is_better = True
    is_differentiable = True
    full_state_update = False

    def __init__(self, p: int = 1, reduction: str = "elementwise_mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(p, int) or p <= 0:
            raise ValueError(f"Expected `p` to be a positive integer. Got p: {p}.")
        self.p = p
        allowed_reduction = ("elementwise_mean", "sum", "none")
        if reduction not in allowed_reduction:
            raise ValueError(f"Expected argument `reduction` be one of {allowed_reduction} but got {reduction}")
        self.reduction = reduction

    def compute(self) -> Tensor:
        preds, target = self._cat_states()
        return spectral_distortion_index(preds, target, self.p, self.reduction)


__all__ = [
    "ErrorRelativeGlobalDimensionlessSynthesis",
    "SpectralAngleMapper",
    "SpectralDistortionIndex",
    "UniversalImageQualityIndex",
]
