"""Precision and recall.

JAX counterpart: `metrics_tpu/functional/classification/precision_recall.py`
(reference `functional/classification/precision_recall.py`). Absent classes
are flagged -1 rather than removed (see ``accuracy.py``).
"""
from __future__ import annotations

from typing import Optional, Tuple

from torch import Tensor

from metrics_tpu_torch.functional.classification.stat_scores import _reduce_stat_scores, _stat_scores_update
from metrics_tpu_torch.utils.checks import _input_squeeze
from metrics_tpu_torch.utils.enums import AverageMethod, MDMCAverageMethod


def _flag_absent(numerator, denominator, tp, fp, fn, average, mdmc_average):
    """-1-flag classes absent from preds and target (macro/none averages)."""
    if mdmc_average != MDMCAverageMethod.SAMPLEWISE and average in (
        AverageMethod.MACRO,
        AverageMethod.NONE,
        None,
    ):
        absent = (tp + fp + fn) == 0
        numerator = numerator.masked_fill(absent, -1)
        denominator = denominator.masked_fill(absent, -1)
    return numerator, denominator


def _check_average_arg(average, mdmc_average, num_classes, ignore_index, top_k=None):
    allowed_average = ("micro", "macro", "weighted", "samples", "none", None)
    if average not in allowed_average:
        raise ValueError(f"The `average` has to be one of {allowed_average}, got {average}.")
    allowed_mdmc_average = (None, "samplewise", "global")
    if mdmc_average not in allowed_mdmc_average:
        raise ValueError(f"The `mdmc_average` has to be one of {allowed_mdmc_average}, got {mdmc_average}.")
    if average in ("macro", "weighted", "none", None) and (not num_classes or num_classes < 1):
        raise ValueError(f"When you set `average` as {average}, you have to provide the number of classes.")
    if num_classes and ignore_index is not None and (not ignore_index < num_classes or num_classes == 1):
        raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {num_classes} classes")


def _precision_compute(
    tp: Tensor,
    fp: Tensor,
    fn: Tensor,
    average: Optional[str],
    mdmc_average: Optional[str],
) -> Tensor:
    numerator, denominator = _flag_absent(tp, tp + fp, tp, fp, fn, average, mdmc_average)
    return _reduce_stat_scores(
        numerator=numerator,
        denominator=denominator,
        weights=None if average != AverageMethod.WEIGHTED else tp + fn,
        average=average,
        mdmc_average=mdmc_average,
    )


def _recall_compute(
    tp: Tensor,
    fp: Tensor,
    fn: Tensor,
    average: Optional[str],
    mdmc_average: Optional[str],
) -> Tensor:
    numerator, denominator = _flag_absent(tp, tp + fn, tp, fp, fn, average, mdmc_average)
    return _reduce_stat_scores(
        numerator=numerator,
        denominator=denominator,
        weights=None if average != AverageMethod.WEIGHTED else tp + fn,
        average=average,
        mdmc_average=mdmc_average,
    )


def _prf_update(preds, target, average, mdmc_average, num_classes, threshold, top_k, multiclass, ignore_index):
    preds, target = _input_squeeze(preds, target)
    reduce = "macro" if average in ("weighted", "none", None) else average
    return _stat_scores_update(
        preds,
        target,
        reduce=reduce,
        mdmc_reduce=mdmc_average,
        threshold=threshold,
        num_classes=num_classes,
        top_k=top_k,
        multiclass=multiclass,
        ignore_index=ignore_index,
    )


def precision(
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
    """Precision = tp / (tp + fp).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import precision
        >>> preds  = torch.tensor([2, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> precision(preds, target, average='macro', num_classes=3)
        tensor(0.1667)
    """
    _check_average_arg(average, mdmc_average, num_classes, ignore_index)
    tp, fp, tn, fn = _prf_update(
        preds, target, average, mdmc_average, num_classes, threshold, top_k, multiclass, ignore_index
    )
    return _precision_compute(tp, fp, fn, average, mdmc_average)


def recall(
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
    """Recall = tp / (tp + fn).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import recall
        >>> preds  = torch.tensor([2, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> recall(preds, target, average='macro', num_classes=3)
        tensor(0.3333)
    """
    _check_average_arg(average, mdmc_average, num_classes, ignore_index)
    tp, fp, tn, fn = _prf_update(
        preds, target, average, mdmc_average, num_classes, threshold, top_k, multiclass, ignore_index
    )
    return _recall_compute(tp, fp, fn, average, mdmc_average)


def precision_recall(
    preds,
    target,
    average: Optional[str] = "micro",
    mdmc_average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    num_classes: Optional[int] = None,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    multiclass: Optional[bool] = None,
) -> Tuple[Tensor, Tensor]:
    """Both precision and recall from one stat-scores pass.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import precision_recall
        >>> preds = torch.tensor([2, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> precision_recall(preds, target, average='macro', num_classes=3)
        (tensor(0.1667), tensor(0.3333))
    """
    _check_average_arg(average, mdmc_average, num_classes, ignore_index)
    tp, fp, tn, fn = _prf_update(
        preds, target, average, mdmc_average, num_classes, threshold, top_k, multiclass, ignore_index
    )
    return (
        _precision_compute(tp, fp, fn, average, mdmc_average),
        _recall_compute(tp, fp, fn, average, mdmc_average),
    )


__all__ = ["precision", "recall", "precision_recall"]
