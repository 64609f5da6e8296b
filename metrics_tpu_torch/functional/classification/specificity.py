"""Specificity = tn / (tn + fp).

JAX counterpart: `metrics_tpu/functional/classification/specificity.py`
(reference `functional/classification/specificity.py`). Absent classes are
flagged -1 rather than removed, as in ``precision_recall.py``.
"""
from __future__ import annotations

from typing import Optional

from torch import Tensor

from metrics_tpu_torch.functional.classification.precision_recall import _check_average_arg, _prf_update
from metrics_tpu_torch.functional.classification.stat_scores import _reduce_stat_scores
from metrics_tpu_torch.utils.enums import AverageMethod, MDMCAverageMethod


def _specificity_compute(
    tp: Tensor,
    fp: Tensor,
    tn: Tensor,
    fn: Tensor,
    average: Optional[str],
    mdmc_average: Optional[str],
) -> Tensor:
    numerator = tn
    denominator = tn + fp
    if mdmc_average != MDMCAverageMethod.SAMPLEWISE and average in (AverageMethod.NONE, None):
        absent = (tp + fp + fn) == 0
        numerator = numerator.masked_fill(absent, -1)
        denominator = denominator.masked_fill(absent, -1)
    return _reduce_stat_scores(
        numerator=numerator,
        denominator=denominator,
        weights=None if average != AverageMethod.WEIGHTED else tn + fp,
        average=average,
        mdmc_average=mdmc_average,
    )


def specificity(
    preds,
    target,
    average: Optional[str] = "micro",
    mdmc_average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    num_classes: Optional[int] = None,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    multiclass: Optional[bool] = None,
) -> Tensor:
    """Specificity (true negative rate).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import specificity
        >>> preds  = torch.tensor([2, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> specificity(preds, target, average='macro', num_classes=3)
        tensor(0.6111)
    """
    _check_average_arg(average, mdmc_average, num_classes, ignore_index)
    tp, fp, tn, fn = _prf_update(
        preds, target, average, mdmc_average, num_classes, threshold, top_k, multiclass, ignore_index
    )
    return _specificity_compute(tp, fp, tn, fn, average, mdmc_average)


__all__ = ["specificity"]
