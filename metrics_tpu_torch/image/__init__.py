"""Image module metrics (JAX counterpart: `metrics_tpu/image`).

The image-quality metrics (PSNR, SSIM, MS-SSIM, UQI, ERGAS, SAM, D-lambda)
and the model-backed ones (FrechetInceptionDistance, KernelInceptionDistance,
InceptionScore, LearnedPerceptualImagePatchSimilarity), whose networks are in
:mod:`metrics_tpu_torch.models`.
"""
from metrics_tpu_torch.image.generative import (
    FrechetInceptionDistance,
    InceptionScore,
    KernelInceptionDistance,
    LearnedPerceptualImagePatchSimilarity,
)
from metrics_tpu_torch.image.psnr import PeakSignalNoiseRatio
from metrics_tpu_torch.image.spectral import (
    ErrorRelativeGlobalDimensionlessSynthesis,
    SpectralAngleMapper,
    SpectralDistortionIndex,
    UniversalImageQualityIndex,
)
from metrics_tpu_torch.image.ssim import (
    MultiScaleStructuralSimilarityIndexMeasure,
    StructuralSimilarityIndexMeasure,
)

__all__ = [
    "ErrorRelativeGlobalDimensionlessSynthesis",
    "FrechetInceptionDistance",
    "InceptionScore",
    "KernelInceptionDistance",
    "LearnedPerceptualImagePatchSimilarity",
    "MultiScaleStructuralSimilarityIndexMeasure",
    "PeakSignalNoiseRatio",
    "SpectralAngleMapper",
    "SpectralDistortionIndex",
    "StructuralSimilarityIndexMeasure",
    "UniversalImageQualityIndex",
]
