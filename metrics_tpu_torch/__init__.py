"""metrics_tpu_torch: the PyTorch and CUDA port of metrics_tpu, for NVIDIA Hopper.

The JAX package ``metrics_tpu`` stays the reference; this package mirrors
its layout and names. Metrics are ``nn.Module``s whose states live on the
current CUDA device unless a ``device`` is given (``device="cpu"`` runs on
the CPU). The histogram of the confusion matrices, calibration bins and
retrieval query groups runs a hand-written CUDA kernel
(``csrc/bincount.cu``), built with ``nvcc`` at first use.

Ported so far: the whole classification domain (the stat-score family,
the confusion-matrix family, HammingDistance, the curve family, HingeLoss,
KLDivergence and the ranking metrics), the regression metrics, the pairwise
distances (functional), the retrieval metrics, the aggregators (Max, Min,
Sum, Cat, Mean) and MetricCollection, and state sync across processes
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
    CoverageError,
    Dice,
    F1Score,
    FBetaScore,
    HammingDistance,
    HingeLoss,
    JaccardIndex,
    KLDivergence,
    LabelRankingAveragePrecision,
    LabelRankingLoss,
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
from metrics_tpu_torch.regression import (
    CosineSimilarity,
    ExplainedVariance,
    MeanAbsoluteError,
    MeanAbsolutePercentageError,
    MeanSquaredError,
    MeanSquaredLogError,
    PearsonCorrCoef,
    R2Score,
    SpearmanCorrCoef,
    SymmetricMeanAbsolutePercentageError,
    TweedieDevianceScore,
    WeightedMeanAbsolutePercentageError,
)
from metrics_tpu_torch.retrieval import (
    RetrievalFallOut,
    RetrievalHitRate,
    RetrievalMAP,
    RetrievalMetric,
    RetrievalMRR,
    RetrievalNormalizedDCG,
    RetrievalPrecision,
    RetrievalPrecisionRecallCurve,
    RetrievalRecall,
    RetrievalRecallAtFixedPrecision,
    RetrievalRPrecision,
)

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
    "CosineSimilarity",
    "CoverageError",
    "Dice",
    "ExplainedVariance",
    "F1Score",
    "FBetaScore",
    "HammingDistance",
    "HingeLoss",
    "JaccardIndex",
    "KLDivergence",
    "LabelRankingAveragePrecision",
    "LabelRankingLoss",
    "MatthewsCorrCoef",
    "MaxMetric",
    "MeanAbsoluteError",
    "MeanAbsolutePercentageError",
    "MeanMetric",
    "MeanSquaredError",
    "MeanSquaredLogError",
    "Metric",
    "MetricCollection",
    "MinMetric",
    "PearsonCorrCoef",
    "Precision",
    "PrecisionRecallCurve",
    "R2Score",
    "ROC",
    "Recall",
    "RetrievalFallOut",
    "RetrievalHitRate",
    "RetrievalMAP",
    "RetrievalMRR",
    "RetrievalMetric",
    "RetrievalNormalizedDCG",
    "RetrievalPrecision",
    "RetrievalPrecisionRecallCurve",
    "RetrievalRPrecision",
    "RetrievalRecall",
    "RetrievalRecallAtFixedPrecision",
    "SpearmanCorrCoef",
    "Specificity",
    "StatScores",
    "SumMetric",
    "SymmetricMeanAbsolutePercentageError",
    "TweedieDevianceScore",
    "WeightedMeanAbsolutePercentageError",
    "__version__",
    "functional",
    "load_reference_state",
    "parallel",
]
