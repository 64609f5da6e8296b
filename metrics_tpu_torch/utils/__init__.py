from metrics_tpu_torch.utils.data import (
    apply_to_collection,
    dim_zero_cat,
    dim_zero_max,
    dim_zero_mean,
    dim_zero_min,
    dim_zero_sum,
    select_topk,
    to_categorical,
    to_onehot,
)
from metrics_tpu_torch.utils.exceptions import MetricsUserError
from metrics_tpu_torch.utils.prints import rank_zero_only, rank_zero_warn

__all__ = [
    "apply_to_collection",
    "dim_zero_cat",
    "dim_zero_max",
    "dim_zero_mean",
    "dim_zero_min",
    "dim_zero_sum",
    "select_topk",
    "to_categorical",
    "to_onehot",
    "MetricsUserError",
    "rank_zero_only",
    "rank_zero_warn",
]
