from metrics_tpu_torch.regression.advanced import (
    CosineSimilarity,
    ExplainedVariance,
    PearsonCorrCoef,
    R2Score,
    SpearmanCorrCoef,
    TweedieDevianceScore,
)
from metrics_tpu_torch.regression.basic import (
    MeanAbsoluteError,
    MeanAbsolutePercentageError,
    MeanSquaredError,
    MeanSquaredLogError,
    SymmetricMeanAbsolutePercentageError,
    WeightedMeanAbsolutePercentageError,
)

__all__ = [
    "CosineSimilarity",
    "ExplainedVariance",
    "MeanAbsoluteError",
    "MeanAbsolutePercentageError",
    "MeanSquaredError",
    "MeanSquaredLogError",
    "PearsonCorrCoef",
    "R2Score",
    "SpearmanCorrCoef",
    "SymmetricMeanAbsolutePercentageError",
    "TweedieDevianceScore",
    "WeightedMeanAbsolutePercentageError",
]
