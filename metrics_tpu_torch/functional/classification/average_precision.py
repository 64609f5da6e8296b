"""Average precision: the area under the precision-recall curve, as a step function.

JAX counterpart: `metrics_tpu/functional/classification/average_precision.py`
(the update `:20`, the eager compute `:39`, the averages `:85`); reference
`src/torchmetrics/functional/classification/average_precision.py:27-160`.
The weighted average's class support comes from ``_bincount`` (the CUDA
kernel on the card) where the JAX package calls ``jnp.bincount``: the counts
are integers either way.
"""
from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.precision_recall_curve import (
    _precision_recall_curve_compute,
    _precision_recall_curve_update,
)
from metrics_tpu_torch.utils.data import _bincount
from metrics_tpu_torch.utils.prints import rank_zero_warn


def _average_precision_update(
    preds: Tensor,
    target: Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    average: Optional[str] = "macro",
    format_tensors: bool = True,
) -> Tuple[Tensor, Tensor, int, Optional[int]]:
    # before formatting, multi-class input is the one whose preds carry an extra (class) dimension
    if average == "micro" and preds.ndim == target.ndim + 1:
        raise ValueError("Cannot use `micro` average with multi-class input")
    return _precision_recall_curve_update(preds, target, num_classes, pos_label, format_tensors=format_tensors)


def _average_precision_compute(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    pos_label: Optional[int] = None,
    average: Optional[str] = "macro",
) -> Union[List[Tensor], Tensor]:
    if average == "micro" and preds.ndim == target.ndim:
        preds = preds.reshape(-1)
        target = target.reshape(-1)
        num_classes = 1

    precision, recall, _ = _precision_recall_curve_compute(preds, target, num_classes, pos_label)
    if average == "weighted":
        if preds.ndim == target.ndim and target.ndim > 1:
            weights = target.sum(dim=0).to(torch.float32)
        else:
            weights = _bincount_float(target, num_classes)
        weights = weights / weights.sum()
    else:
        weights = None
    return _average_precision_compute_with_precision_recall(precision, recall, num_classes, average, weights)


def _bincount_float(target: Tensor, num_classes: int) -> Tensor:
    return _bincount(target.reshape(-1), minlength=num_classes).to(torch.float32)


def _average_precision_compute_with_precision_recall(
    precision,
    recall,
    num_classes: int,
    average: Optional[str] = "macro",
    weights: Optional[Tensor] = None,
) -> Union[List[Tensor], Tensor]:
    # the step-function integral; the last precision entry is pinned at 1
    if num_classes == 1:
        return -torch.sum((recall[1:] - recall[:-1]) * precision[:-1])

    res = [-torch.sum((r[1:] - r[:-1]) * p[:-1]) for p, r in zip(precision, recall)]

    if average in ("macro", "weighted"):
        res_arr = torch.stack(res)
        nan_mask = torch.isnan(res_arr)
        if bool(nan_mask.any()):
            rank_zero_warn(
                "Average precision score for one or more classes was `nan`. Ignoring these classes in average",
                UserWarning,
            )
        if average == "macro":
            valid = ~nan_mask
            return torch.sum(torch.where(valid, res_arr, 0.0)) / torch.clamp(valid.sum(), min=1)
        weights = torch.ones_like(res_arr) if weights is None else weights
        return torch.sum(torch.where(nan_mask, 0.0, res_arr * weights))
    if average in ("none", None):
        return res
    allowed_average = ("micro", "macro", "weighted", "none", None)
    raise ValueError(f"Expected argument `average` to be one of {allowed_average} but got {average}")


def average_precision(
    preds: Tensor,
    target: Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    average: Optional[str] = "macro",
) -> Union[List[Tensor], Tensor]:
    """Average precision score.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import average_precision
        >>> pred = torch.tensor([0.0, 1.0, 2.0, 3.0])
        >>> target = torch.tensor([0, 1, 1, 1])
        >>> average_precision(pred, target, pos_label=1)
        tensor(1.)
    """
    preds, target, num_classes, pos_label = _average_precision_update(preds, target, num_classes, pos_label, average)
    return _average_precision_compute(preds, target, num_classes, pos_label, average)


__all__ = ["average_precision"]
