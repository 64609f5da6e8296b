"""Exact precision-recall curve: a sort, then a scan over the distinct thresholds.

JAX counterpart: `metrics_tpu/functional/classification/precision_recall_curve.py`
(``_binary_clf_curve`` `:31`, the update `:64`, the single- and multi-class
computes `:125`, `:144`); reference
`src/torchmetrics/functional/classification/precision_recall_curve.py`.

The curve has one point per distinct score, so its length depends on the
data. It runs eagerly at the end of an epoch, and reads the device where the
JAX package does: the distinct-threshold indices (``nonzero``) and, per
class, the index where the recall first reaches 1. Those reads are counted
on the card by ``chip_smoke.py``. The fixed-memory alternative is the binned
curve family (:mod:`metrics_tpu_torch.classification.binned_precision_recall`).

The cumulative counts are float32, as in the JAX package (the int32 target
is multiplied by ``1.0`` before the sum): sums of 0 and 1 are exact in
float32 in any order up to 2**24 scores, so the curves agree bit for bit on
the CPU and on the card up to that size.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.utils.prints import rank_zero_warn


def _binary_clf_curve(
    preds: Tensor,
    target: Tensor,
    sample_weights: Optional[Sequence] = None,
    pos_label: int = 1,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Cumulative false and true positives at each distinct score, scores descending.

    A stable descending sort keeps tied scores in input order; a tie run ends
    where two neighbouring sorted scores differ (``-0.0`` and ``+0.0`` do
    not; every NaN does, and NaN scores sort last).
    """
    if sample_weights is not None:
        sample_weights = torch.as_tensor(sample_weights, dtype=torch.float32, device=preds.device)

    if preds.ndim > target.ndim:
        preds = preds[:, 0]
    if target.shape[0] == 0:
        # JAX's gather of the last score fails with a TypeError on no rows
        raise TypeError("A curve needs at least one sample, got an empty batch")
    order = torch.argsort(-preds, stable=True)
    preds = preds[order]
    target = target[order]
    weight = sample_weights[order] if sample_weights is not None else 1.0

    distinct_idx = torch.nonzero(preds[1:] - preds[:-1])[:, 0]
    last = torch.tensor([target.shape[0] - 1], dtype=distinct_idx.dtype, device=preds.device)
    threshold_idxs = torch.cat([distinct_idx, last])
    target = (target == pos_label).to(torch.int32)
    tps = torch.cumsum(target * weight, dim=0)[threshold_idxs]

    if sample_weights is not None:
        fps = torch.cumsum((1 - target) * weight, dim=0)[threshold_idxs]
    else:
        fps = 1 + threshold_idxs - tps
    return fps, tps, preds[threshold_idxs]


def _precision_recall_curve_update(
    preds: Tensor,
    target: Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    format_tensors: bool = True,
    warn: bool = True,
) -> Tuple[Tensor, Tensor, int, Optional[int]]:
    """Resolve the classes and flatten the inputs to ``(N,)`` or ``(N, C)`` scores.

    ``format_tensors=False`` resolves and checks the shapes only, and returns
    the tensors as they came: the module metrics buffer raw rows and format
    them when they are observed (the transform commutes with concatenation).
    ``warn=False`` silences the ``pos_label`` warning when rows already
    warned about are formatted again.
    """
    if preds.ndim == target.ndim:
        if pos_label is None:
            pos_label = 1
        if num_classes is not None and num_classes != 1:
            # multilabel
            if num_classes != preds.shape[1]:
                raise ValueError(
                    f"Argument `num_classes` was set to {num_classes} in"
                    f" metric `precision_recall_curve` but detected {preds.shape[1]}"
                    " number of classes from predictions"
                )
            if format_tensors:
                preds = preds.transpose(0, 1).reshape(num_classes, -1).T
                target = target.transpose(0, 1).reshape(num_classes, -1).T
        else:
            if format_tensors:
                preds = preds.reshape(-1)
                target = target.reshape(-1)
            num_classes = 1
    elif preds.ndim == target.ndim + 1:
        if pos_label is not None and warn:
            rank_zero_warn(
                f"Argument `pos_label` should be `None` when running multiclass precision recall curve. Got {pos_label}"
            )
        if num_classes != preds.shape[1]:
            raise ValueError(
                f"Argument `num_classes` was set to {num_classes} in"
                f" metric `precision_recall_curve` but detected {preds.shape[1]}"
                " number of classes from predictions"
            )
        if format_tensors:
            preds = preds.transpose(0, 1).reshape(num_classes, -1).T
            target = target.reshape(-1)
    else:
        raise ValueError("preds and target must have same number of dimensions, or one additional dimension for preds")
    return preds, target, num_classes, pos_label


def _precision_recall_curve_compute_single_class(
    preds: Tensor,
    target: Tensor,
    pos_label: int,
    sample_weights: Optional[Sequence] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    fps, tps, thresholds = _binary_clf_curve(preds, target, sample_weights, pos_label)
    precision = tps / (tps + fps)
    recall = tps / tps[-1]

    # cut the curve at full recall and flip it, so that recall decreases
    last_ind = int(torch.nonzero(tps == tps[-1])[0, 0])
    sl = slice(0, last_ind + 1)
    one = torch.ones(1, dtype=precision.dtype, device=precision.device)
    precision = torch.cat([precision[sl].flip(0), one])
    recall = torch.cat([recall[sl].flip(0), torch.zeros(1, dtype=recall.dtype, device=recall.device)])
    thresholds = thresholds[sl].flip(0)
    return precision, recall, thresholds


def _precision_recall_curve_compute_multi_class(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    sample_weights: Optional[Sequence] = None,
) -> Tuple[List[Tensor], List[Tensor], List[Tensor]]:
    precision, recall, thresholds = [], [], []
    for cls in range(num_classes):
        preds_cls = preds[:, cls]
        if target.ndim > 1:
            res = precision_recall_curve(
                preds_cls, target[:, cls], num_classes=1, pos_label=1, sample_weights=sample_weights
            )
        else:
            res = precision_recall_curve(preds_cls, target, num_classes=1, pos_label=cls, sample_weights=sample_weights)
        precision.append(res[0])
        recall.append(res[1])
        thresholds.append(res[2])
    return precision, recall, thresholds


def _precision_recall_curve_compute(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    pos_label: Optional[int] = None,
    sample_weights: Optional[Sequence] = None,
) -> Union[Tuple[Tensor, ...], Tuple[List[Tensor], ...]]:
    if num_classes == 1:
        if pos_label is None:
            pos_label = 1
        return _precision_recall_curve_compute_single_class(preds, target, pos_label, sample_weights)
    return _precision_recall_curve_compute_multi_class(preds, target, num_classes, sample_weights)


def precision_recall_curve(
    preds: Tensor,
    target: Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    sample_weights: Optional[Sequence] = None,
) -> Union[Tuple[Tensor, ...], Tuple[List[Tensor], ...]]:
    """(precision, recall, thresholds) at every distinct score.

    Multi-class and multi-label inputs give one curve per class, in lists.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import precision_recall_curve
        >>> pred = torch.tensor([0.0, 1.0, 2.0, 3.0])
        >>> target = torch.tensor([0, 1, 1, 0])
        >>> precision, recall, thresholds = precision_recall_curve(pred, target, pos_label=1)
        >>> precision
        tensor([0.6667, 0.5000, 0.0000, 1.0000])
        >>> recall
        tensor([1.0000, 0.5000, 0.0000, 0.0000])
        >>> thresholds
        tensor([1., 2., 3.])
    """
    preds, target, num_classes, pos_label = _precision_recall_curve_update(preds, target, num_classes, pos_label)
    return _precision_recall_curve_compute(preds, target, num_classes, pos_label, sample_weights)


__all__ = ["precision_recall_curve"]
