"""Dice score.

JAX counterpart: `metrics_tpu/functional/classification/dice.py` (reference
`functional/classification/dice.py`: ``_dice_compute``, ``dice`` and the
legacy ``dice_score`` on probability maps).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.precision_recall import _check_average_arg, _prf_update
from metrics_tpu_torch.functional.classification.stat_scores import _reduce_stat_scores
from metrics_tpu_torch.parallel.sync import reduce
from metrics_tpu_torch.utils.data import to_categorical
from metrics_tpu_torch.utils.enums import AverageMethod, MDMCAverageMethod


def _dice_compute(
    tp: Tensor,
    fp: Tensor,
    fn: Tensor,
    average: Optional[str],
    mdmc_average: Optional[str],
    zero_division: int = 0,
) -> Tensor:
    numerator = 2 * tp
    denominator = 2 * tp + fp + fn
    if mdmc_average != MDMCAverageMethod.SAMPLEWISE and average in (AverageMethod.MACRO, AverageMethod.NONE, None):
        absent = (tp + fp + fn) == 0
        numerator = numerator.masked_fill(absent, -1)
        denominator = denominator.masked_fill(absent, -1)
    return _reduce_stat_scores(
        numerator=numerator,
        denominator=denominator,
        weights=None if average != AverageMethod.WEIGHTED else tp + fn,
        average=average,
        mdmc_average=mdmc_average,
        zero_division=zero_division,
    )


def dice(
    preds,
    target,
    zero_division: int = 0,
    average: Optional[str] = "micro",
    mdmc_average: Optional[str] = "global",
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    num_classes: Optional[int] = None,
    multiclass: Optional[bool] = None,
    ignore_index: Optional[int] = None,
) -> Tensor:
    """Dice = 2·tp / (2·tp + fp + fn).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import dice
        >>> preds  = torch.tensor([2, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> dice(preds, target, average='micro')
        tensor(0.2500)
    """
    _check_average_arg(average, mdmc_average, num_classes, ignore_index)
    tp, fp, tn, fn = _prf_update(
        preds, target, average, mdmc_average, num_classes, threshold, top_k, multiclass, ignore_index
    )
    return _dice_compute(tp, fp, fn, average, mdmc_average, zero_division)


def dice_score(
    preds: Tensor,
    target: Tensor,
    bg: bool = False,
    nan_score: float = 0.0,
    no_fg_score: float = 0.0,
    reduction: str = "elementwise_mean",
) -> Tensor:
    """Legacy dice over probability maps ``(N, C, ...)``, one score per class.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import dice_score
        >>> preds = torch.tensor([[0.1, 0.8, 0.1], [0.6, 0.2, 0.2], [0.2, 0.2, 0.6]])
        >>> target = torch.tensor([1, 0, 2])
        >>> dice_score(preds, target)
        tensor(1.)
    """
    num_classes = preds.shape[1]
    bg_inv = 1 - int(bg)
    pred_lab = to_categorical(preds)
    scores = []
    for i in range(bg_inv, num_classes):
        t_i = target == i
        p_i = pred_lab == i
        has_fg = t_i.sum() > 0
        tp = (p_i & t_i).sum().to(torch.float32)
        fp = (p_i & ~t_i).sum().to(torch.float32)
        fn = (~p_i & t_i).sum().to(torch.float32)
        denom = 2 * tp + fp + fn
        score = torch.where(denom > 0, 2 * tp / torch.where(denom > 0, denom, 1.0), float(nan_score))
        score = torch.where(has_fg, score, float(no_fg_score))
        scores.append(score)
    return reduce(torch.stack(scores), reduction)


__all__ = ["dice", "dice_score"]
