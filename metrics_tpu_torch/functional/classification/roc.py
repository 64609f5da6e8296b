"""ROC curve.

JAX counterpart: `metrics_tpu/functional/classification/roc.py` (the single-
and multi-class computes `:31`, `:64`); reference
`src/torchmetrics/functional/classification/roc.py`. Eager and exact, like
the precision-recall curve it shares ``_binary_clf_curve`` with. Each class
reads the last false- and true-positive counts on the host, to warn when a
class has no negatives or no positives (`roc.py:42,52`).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.precision_recall_curve import (
    _binary_clf_curve,
    _precision_recall_curve_update,
)
from metrics_tpu_torch.ops import telemetry as _telemetry
from metrics_tpu_torch.utils.prints import rank_zero_warn


def _roc_update(
    preds: Tensor,
    target: Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    format_tensors: bool = True,
) -> Tuple[Tensor, Tensor, int, Optional[int]]:
    return _precision_recall_curve_update(preds, target, num_classes, pos_label, format_tensors=format_tensors)


def _roc_compute_single_class(
    preds: Tensor,
    target: Tensor,
    pos_label: int,
    sample_weights: Optional[Sequence] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    fps, tps, thresholds = _binary_clf_curve(preds, target, sample_weights, pos_label)
    return _roc_from_counts(fps, tps, thresholds)


@_telemetry.ranged("curve-area")
def _roc_from_counts(fps: Tensor, tps: Tensor, thresholds: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """The ROC's points from the cumulative counts at each distinct score."""
    # prepend (0, 0) so that the curve starts at the origin
    tps = torch.cat([torch.zeros(1, dtype=tps.dtype, device=tps.device), tps])
    fps = torch.cat([torch.zeros(1, dtype=fps.dtype, device=fps.device), fps])
    thresholds = torch.cat([thresholds[0:1] + 1, thresholds])

    with _telemetry.trace_range("host-read", "roc-negatives"):
        no_negatives = float(fps[-1]) <= 0
    if no_negatives:
        rank_zero_warn(
            "No negative samples in targets, false positive value should be meaningless."
            " Returning zero tensor in false positive score",
            UserWarning,
            stacklevel=6,  # the line that asked for the curve, past the range's frame and the split
        )
        fpr = torch.zeros_like(thresholds)
    else:
        fpr = fps / fps[-1]

    with _telemetry.trace_range("host-read", "roc-positives"):
        no_positives = float(tps[-1]) <= 0
    if no_positives:
        rank_zero_warn(
            "No positive samples in targets, true positive value should be meaningless."
            " Returning zero tensor in true positive score",
            UserWarning,
            stacklevel=6,
        )
        tpr = torch.zeros_like(thresholds)
    else:
        tpr = tps / tps[-1]
    return fpr, tpr, thresholds


def _roc_compute_multi_class(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    sample_weights: Optional[Sequence] = None,
) -> Tuple[List[Tensor], List[Tensor], List[Tensor]]:
    fpr, tpr, thresholds = [], [], []
    for cls in range(num_classes):
        if target.ndim > 1:  # multilabel
            res = roc(preds[:, cls], target[:, cls], num_classes=1, pos_label=1, sample_weights=sample_weights)
        else:
            res = roc(preds[:, cls], target, num_classes=1, pos_label=cls, sample_weights=sample_weights)
        fpr.append(res[0])
        tpr.append(res[1])
        thresholds.append(res[2])
    return fpr, tpr, thresholds


def _roc_compute(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    pos_label: Optional[int] = None,
    sample_weights: Optional[Sequence] = None,
) -> Union[Tuple[Tensor, ...], Tuple[List[Tensor], ...]]:
    if num_classes == 1 and preds.ndim == 1:
        if pos_label is None:
            pos_label = 1
        return _roc_compute_single_class(preds, target, pos_label, sample_weights)
    return _roc_compute_multi_class(preds, target, num_classes, sample_weights)


def roc(
    preds: Tensor,
    target: Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    sample_weights: Optional[Sequence] = None,
) -> Union[Tuple[Tensor, ...], Tuple[List[Tensor], ...]]:
    """(fpr, tpr, thresholds) at every distinct score, from the origin.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import roc
        >>> pred = torch.tensor([0.0, 1.0, 2.0, 3.0])
        >>> target = torch.tensor([0, 1, 1, 1])
        >>> fpr, tpr, thresholds = roc(pred, target, pos_label=1)
        >>> fpr
        tensor([0., 0., 0., 0., 1.])
        >>> tpr
        tensor([0.0000, 0.3333, 0.6667, 1.0000, 1.0000])
        >>> thresholds
        tensor([4., 3., 2., 1., 0.])
    """
    preds, target, num_classes, pos_label = _roc_update(preds, target, num_classes, pos_label)
    return _roc_compute(preds, target, num_classes, pos_label, sample_weights)


__all__ = ["roc"]
