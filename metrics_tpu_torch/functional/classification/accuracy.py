"""Accuracy (subset accuracy and top-k included).

JAX counterpart: `metrics_tpu/functional/classification/accuracy.py`
(reference `functional/classification/accuracy.py`). Classes absent from
both preds and target are flagged -1 rather than removed, so
``_reduce_stat_scores`` gives them zero weight with every shape static.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.stat_scores import _reduce_stat_scores, _stat_scores_update
from metrics_tpu_torch.utils.checks import _check_classification_inputs, _input_format_classification, _input_squeeze
from metrics_tpu_torch.utils.enums import AverageMethod, DataType, MDMCAverageMethod


def _mode(
    preds: Tensor,
    target: Tensor,
    threshold: float,
    top_k: Optional[int],
    num_classes: Optional[int],
    multiclass: Optional[bool],
    ignore_index: Optional[int] = None,
) -> DataType:
    return _check_classification_inputs(
        preds,
        target,
        threshold=threshold,
        top_k=top_k,
        num_classes=num_classes,
        multiclass=multiclass,
        ignore_index=ignore_index,
    )


def _check_subset_validity(mode: DataType) -> bool:
    return mode in (DataType.MULTILABEL, DataType.MULTIDIM_MULTICLASS)


def _accuracy_update(
    preds,
    target,
    reduce: Optional[str],
    mdmc_reduce: Optional[str],
    threshold: float,
    num_classes: Optional[int],
    top_k: Optional[int],
    multiclass: Optional[bool],
    ignore_index: Optional[int],
    mode: DataType,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    if mode == DataType.MULTILABEL and top_k:
        raise ValueError("You can not use the `top_k` parameter to calculate accuracy for multi-label inputs.")
    preds, target = _input_squeeze(preds, target)
    return _stat_scores_update(
        preds,
        target,
        reduce=reduce,
        mdmc_reduce=mdmc_reduce,
        threshold=threshold,
        num_classes=num_classes,
        top_k=top_k,
        multiclass=multiclass,
        ignore_index=ignore_index,
        mode=mode,
    )


def _accuracy_compute(
    tp: Tensor,
    fp: Tensor,
    tn: Tensor,
    fn: Tensor,
    average: Optional[str],
    mdmc_average: Optional[str],
    mode: DataType,
) -> Tensor:
    simple_average = (AverageMethod.MICRO, AverageMethod.SAMPLES)
    if (mode == DataType.BINARY and average in simple_average) or mode == DataType.MULTILABEL:
        numerator = tp + tn
        denominator = tp + tn + fp + fn
    else:
        numerator = tp
        denominator = tp + fn

    if mdmc_average != MDMCAverageMethod.SAMPLEWISE and average in (AverageMethod.MACRO, AverageMethod.NONE, None):
        # flag classes absent from both preds and target with -1; the reducer
        # gives them zero weight (static-shape form of reference `:177-190`)
        absent = (tp + fp + fn) == 0
        numerator = numerator.masked_fill(absent, -1)
        denominator = denominator.masked_fill(absent, -1)

    return _reduce_stat_scores(
        numerator=numerator,
        denominator=denominator,
        weights=None if average != AverageMethod.WEIGHTED else tp + fn,
        average=average,
        mdmc_average=mdmc_average,
    )


def _subset_accuracy_update(
    preds,
    target,
    threshold: float,
    top_k: Optional[int],
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor]:
    preds, target = _input_squeeze(preds, target)
    preds, target, mode = _input_format_classification(
        preds, target, threshold=threshold, top_k=top_k, ignore_index=ignore_index
    )

    if mode == DataType.MULTILABEL and top_k:
        raise ValueError("You can not use the `top_k` parameter to calculate accuracy for multi-label inputs.")

    def count(n: int) -> Tensor:
        return torch.tensor(n, dtype=torch.int32, device=preds.device)

    if mode == DataType.MULTILABEL:
        correct = (preds == target).all(dim=1).sum(dtype=torch.int32)
        total = count(target.shape[0])
    elif mode == DataType.MULTICLASS:
        correct = (preds * target).sum(dtype=torch.int32)
        total = target.sum(dtype=torch.int32)
    elif mode == DataType.MULTIDIM_MULTICLASS:
        sample_correct = (preds * target).sum(dim=(1, 2), dtype=torch.int32)
        correct = (sample_correct == target.shape[2]).sum(dtype=torch.int32)
        total = count(target.shape[0])
    else:
        correct, total = count(0), count(0)
    return correct, total


def _subset_accuracy_compute(correct: Tensor, total: Tensor) -> Tensor:
    return correct.to(torch.float32) / total


def accuracy(
    preds,
    target,
    average: Optional[str] = "micro",
    mdmc_average: Optional[str] = "global",
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    subset_accuracy: bool = False,
    num_classes: Optional[int] = None,
    multiclass: Optional[bool] = None,
    ignore_index: Optional[int] = None,
) -> Tensor:
    """Accuracy score.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import accuracy
        >>> target = torch.tensor([0, 1, 2, 3])
        >>> preds = torch.tensor([0, 2, 1, 3])
        >>> accuracy(preds, target)
        tensor(0.5000)
    """
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
    if top_k is not None and (not isinstance(top_k, int) or top_k <= 0):
        raise ValueError(f"The `top_k` should be an integer larger than 0, got {top_k}")

    preds, target = _input_squeeze(preds, target)
    mode = _mode(preds, target, threshold, top_k, num_classes, multiclass, ignore_index)
    reduce = "macro" if average in ("weighted", "none", None) else average

    if subset_accuracy and _check_subset_validity(mode):
        correct, total = _subset_accuracy_update(preds, target, threshold, top_k, ignore_index)
        return _subset_accuracy_compute(correct, total)
    tp, fp, tn, fn = _accuracy_update(
        preds, target, reduce, mdmc_average, threshold, num_classes, top_k, multiclass, ignore_index, mode
    )
    return _accuracy_compute(tp, fp, tn, fn, average, mdmc_average, mode)


__all__ = ["accuracy"]
