"""Functional audio metrics (JAX counterpart: `metrics_tpu/functional/audio`)."""
from metrics_tpu_torch.functional.audio.host import (
    perceptual_evaluation_speech_quality,
    short_time_objective_intelligibility,
)
from metrics_tpu_torch.functional.audio.pit import permutation_invariant_training, pit_permutate
from metrics_tpu_torch.functional.audio.sdr import signal_distortion_ratio
from metrics_tpu_torch.functional.audio.snr import (
    scale_invariant_signal_distortion_ratio,
    scale_invariant_signal_noise_ratio,
    signal_noise_ratio,
)

__all__ = [
    "signal_noise_ratio",
    "scale_invariant_signal_noise_ratio",
    "signal_distortion_ratio",
    "scale_invariant_signal_distortion_ratio",
    "permutation_invariant_training",
    "pit_permutate",
    "perceptual_evaluation_speech_quality",
    "short_time_objective_intelligibility",
]
