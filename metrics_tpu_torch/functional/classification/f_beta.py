"""F-beta and F1.

JAX counterpart: `metrics_tpu/functional/classification/f_beta.py`
(reference `functional/classification/f_beta.py`). Absent classes and
``ignore_index`` are flagged -1 (zero weight in the reducer) rather than removed.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.precision_recall import _check_average_arg
from metrics_tpu_torch.functional.classification.stat_scores import _reduce_stat_scores, _stat_scores_update
from metrics_tpu_torch.utils.checks import _input_squeeze
from metrics_tpu_torch.utils.compute import _safe_divide
from metrics_tpu_torch.utils.enums import AverageMethod, MDMCAverageMethod


def _fbeta_compute(
    tp: Tensor,
    fp: Tensor,
    tn: Tensor,
    fn: Tensor,
    beta: float,
    ignore_index: Optional[int],
    average: Optional[str],
    mdmc_average: Optional[str],
) -> Tensor:
    if average == AverageMethod.MICRO and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        # -1-flagged entries (ignored classes) are masked out of the micro sums
        keep = (tp >= 0).to(torch.float32)
        tp_s = (tp * keep).sum()
        precision_ = _safe_divide(tp_s, (tp * keep + fp * keep).sum())
        recall_ = _safe_divide(tp_s, (tp * keep + fn * keep).sum())
    else:
        precision_ = _safe_divide(tp.to(torch.float32), tp + fp)
        recall_ = _safe_divide(tp.to(torch.float32), tp + fn)

    num = (1 + beta**2) * precision_ * recall_
    denom = beta**2 * precision_ + recall_
    denom = torch.where(denom == 0.0, 1.0, denom)

    if mdmc_average != MDMCAverageMethod.SAMPLEWISE and average not in (AverageMethod.MICRO, AverageMethod.SAMPLES):
        # classes with no tp/fp/fn are meaningless; ignored classes arrive as -3
        total = tp + fp + fn
        absent = (total == 0) | (total == -3)
        num = num.masked_fill(absent, -1.0)
        denom = denom.masked_fill(absent, -1.0)
        if ignore_index is not None and ignore_index >= 0:
            num[..., ignore_index] = -1.0
            denom[..., ignore_index] = -1.0
    elif ignore_index is not None and mdmc_average == MDMCAverageMethod.SAMPLEWISE and average not in (
        AverageMethod.MICRO,
        AverageMethod.SAMPLES,
    ):
        num[..., ignore_index] = -1.0
        denom[..., ignore_index] = -1.0

    return _reduce_stat_scores(
        numerator=num,
        denominator=denom,
        weights=None if average != AverageMethod.WEIGHTED else tp + fn,
        average=average,
        mdmc_average=mdmc_average,
    )


def fbeta_score(
    preds,
    target,
    beta: float = 1.0,
    average: Optional[str] = "micro",
    mdmc_average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    num_classes: Optional[int] = None,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    multiclass: Optional[bool] = None,
) -> Tensor:
    """F-beta = (1 + beta^2) * P * R / (beta^2 * P + R).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import fbeta_score
        >>> target = torch.tensor([0, 1, 2, 0, 1, 2])
        >>> preds = torch.tensor([0, 2, 1, 0, 0, 1])
        >>> fbeta_score(preds, target, num_classes=3, beta=0.5)
        tensor(0.3333)
    """
    _check_average_arg(average, mdmc_average, num_classes, ignore_index)
    preds, target = _input_squeeze(preds, target)
    reduce = "macro" if average in ("weighted", "none", None) else average
    tp, fp, tn, fn = _stat_scores_update(
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
    return _fbeta_compute(tp, fp, tn, fn, beta, ignore_index, average, mdmc_average)


def f1_score(
    preds,
    target,
    beta: float = 1.0,
    average: Optional[str] = "micro",
    mdmc_average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    num_classes: Optional[int] = None,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    multiclass: Optional[bool] = None,
) -> Tensor:
    """F1 = harmonic mean of precision and recall (fbeta with beta=1).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import f1_score
        >>> target = torch.tensor([0, 1, 2, 0, 1, 2])
        >>> preds = torch.tensor([0, 2, 1, 0, 0, 1])
        >>> f1_score(preds, target, num_classes=3)
        tensor(0.3333)
    """
    return fbeta_score(
        preds, target, 1.0, average, mdmc_average, ignore_index, num_classes, threshold, top_k, multiclass
    )


__all__ = ["fbeta_score", "f1_score"]
