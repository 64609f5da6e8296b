"""Functional image metrics (JAX counterpart: `metrics_tpu/functional/image`).

FID, KID, IS and LPIPS, with their networks, are not ported yet.
"""
from metrics_tpu_torch.functional.image.psnr import peak_signal_noise_ratio
from metrics_tpu_torch.functional.image.spectral import (
    error_relative_global_dimensionless_synthesis,
    image_gradients,
    spectral_angle_mapper,
    spectral_distortion_index,
    universal_image_quality_index,
)
from metrics_tpu_torch.functional.image.ssim import (
    multiscale_structural_similarity_index_measure,
    structural_similarity_index_measure,
)

__all__ = [
    "error_relative_global_dimensionless_synthesis",
    "image_gradients",
    "multiscale_structural_similarity_index_measure",
    "peak_signal_noise_ratio",
    "spectral_angle_mapper",
    "spectral_distortion_index",
    "structural_similarity_index_measure",
    "universal_image_quality_index",
]
