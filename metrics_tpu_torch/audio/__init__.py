"""Audio module metrics (JAX counterpart: `metrics_tpu/audio`)."""
from metrics_tpu_torch.audio.metrics import (
    PermutationInvariantTraining,
    PerceptualEvaluationSpeechQuality,
    ScaleInvariantSignalDistortionRatio,
    ScaleInvariantSignalNoiseRatio,
    ShortTimeObjectiveIntelligibility,
    SignalDistortionRatio,
    SignalNoiseRatio,
)

__all__ = [
    "SignalNoiseRatio",
    "ScaleInvariantSignalNoiseRatio",
    "SignalDistortionRatio",
    "ScaleInvariantSignalDistortionRatio",
    "PermutationInvariantTraining",
    "PerceptualEvaluationSpeechQuality",
    "ShortTimeObjectiveIntelligibility",
]
