"""Image module metrics (JAX counterpart: `metrics_tpu/image`).

FrechetInceptionDistance, KernelInceptionDistance, InceptionScore and
LearnedPerceptualImagePatchSimilarity, with their networks, are not ported yet.
"""
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
    "MultiScaleStructuralSimilarityIndexMeasure",
    "PeakSignalNoiseRatio",
    "SpectralAngleMapper",
    "SpectralDistortionIndex",
    "StructuralSimilarityIndexMeasure",
    "UniversalImageQualityIndex",
]
