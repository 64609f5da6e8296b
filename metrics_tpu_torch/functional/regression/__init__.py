from metrics_tpu_torch.functional.regression.basic import (
    mean_absolute_error,
    mean_absolute_percentage_error,
    mean_squared_error,
    mean_squared_log_error,
    symmetric_mean_absolute_percentage_error,
    weighted_mean_absolute_percentage_error,
)
from metrics_tpu_torch.functional.regression.correlation import cosine_similarity, pearson_corrcoef, spearman_corrcoef
from metrics_tpu_torch.functional.regression.moments import explained_variance, r2_score, tweedie_deviance_score

__all__ = [
    "cosine_similarity",
    "explained_variance",
    "mean_absolute_error",
    "mean_absolute_percentage_error",
    "mean_squared_error",
    "mean_squared_log_error",
    "pearson_corrcoef",
    "r2_score",
    "spearman_corrcoef",
    "symmetric_mean_absolute_percentage_error",
    "tweedie_deviance_score",
    "weighted_mean_absolute_percentage_error",
]
