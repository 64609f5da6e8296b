"""metrics_tpu_torch: the PyTorch and CUDA port of metrics_tpu, for NVIDIA Hopper.

The JAX package ``metrics_tpu`` stays the reference; this package mirrors
its layout and names. Metrics are ``nn.Module``s whose states live on the
current CUDA device unless a ``device`` is given (``device="cpu"`` runs on
the CPU). The confusion-matrix histogram runs a hand-written CUDA kernel
(``csrc/bincount.cu``), built with ``nvcc`` at first use.
"""
from metrics_tpu_torch import functional
from metrics_tpu_torch.__about__ import __version__
from metrics_tpu_torch.classification import (
    Accuracy,
    ConfusionMatrix,
    F1Score,
    FBetaScore,
    Precision,
    Recall,
    StatScores,
)
from metrics_tpu_torch.collections import MetricCollection
from metrics_tpu_torch.interop import load_reference_state
from metrics_tpu_torch.metric import Metric

__all__ = [
    "Accuracy",
    "ConfusionMatrix",
    "F1Score",
    "FBetaScore",
    "Metric",
    "MetricCollection",
    "Precision",
    "Recall",
    "StatScores",
    "__version__",
    "functional",
    "load_reference_state",
]
