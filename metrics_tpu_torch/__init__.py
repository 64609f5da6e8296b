"""metrics_tpu_torch: the PyTorch and CUDA port of metrics_tpu, for NVIDIA Hopper.

The JAX package ``metrics_tpu`` stays the reference; this package mirrors
its layout and names. Metrics are ``nn.Module``s whose states live on the
current CUDA device unless a ``device`` is given (``device="cpu"`` runs on
the CPU). The confusion-matrix histogram runs a hand-written CUDA kernel
(``csrc/bincount.cu``), built with ``nvcc`` at first use.

Ported so far: the classification metrics built on stat scores (Accuracy,
Precision, Recall, F1Score, FBetaScore, Specificity, Dice, StatScores) and
on the confusion matrix (ConfusionMatrix, CohenKappa, MatthewsCorrCoef,
JaccardIndex), HammingDistance, the curve family (PrecisionRecallCurve,
ROC, AUROC, AveragePrecision, AUC, CalibrationError and the binned curves),
the aggregators (Max, Min, Sum, Cat, Mean) and MetricCollection, and state
sync across processes
(``metrics_tpu_torch.parallel``): ``compute()`` reduces the states over the
``torch.distributed`` process group, a whole suite in one collective.
"""
from metrics_tpu_torch import functional, parallel
from metrics_tpu_torch.__about__ import __version__
from metrics_tpu_torch.aggregation import CatMetric, MaxMetric, MeanMetric, MinMetric, SumMetric
from metrics_tpu_torch.classification import (
    AUC,
    AUROC,
    Accuracy,
    AveragePrecision,
    BinnedAveragePrecision,
    BinnedPrecisionRecallCurve,
    BinnedRecallAtFixedPrecision,
    CalibrationError,
    CohenKappa,
    ConfusionMatrix,
    Dice,
    F1Score,
    FBetaScore,
    HammingDistance,
    JaccardIndex,
    MatthewsCorrCoef,
    Precision,
    PrecisionRecallCurve,
    Recall,
    ROC,
    Specificity,
    StatScores,
)
from metrics_tpu_torch.collections import MetricCollection
from metrics_tpu_torch.interop import load_reference_state
from metrics_tpu_torch.metric import Metric

__all__ = [
    "AUC",
    "AUROC",
    "Accuracy",
    "AveragePrecision",
    "BinnedAveragePrecision",
    "BinnedPrecisionRecallCurve",
    "BinnedRecallAtFixedPrecision",
    "CalibrationError",
    "CatMetric",
    "CohenKappa",
    "ConfusionMatrix",
    "Dice",
    "F1Score",
    "FBetaScore",
    "HammingDistance",
    "JaccardIndex",
    "MatthewsCorrCoef",
    "MaxMetric",
    "MeanMetric",
    "Metric",
    "MetricCollection",
    "MinMetric",
    "Precision",
    "PrecisionRecallCurve",
    "ROC",
    "Recall",
    "Specificity",
    "StatScores",
    "SumMetric",
    "__version__",
    "functional",
    "load_reference_state",
    "parallel",
]
