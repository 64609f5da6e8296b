"""Jaccard index (intersection over union) from the confusion matrix.

JAX counterpart: `metrics_tpu/functional/classification/jaccard.py`
(reference `functional/classification/jaccard.py`). The ignored class's row
is zeroed in a copy, never in place: ``JaccardIndex.compute`` passes its
accumulated state.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.confusion_matrix import _confusion_matrix_update


def _jaccard_from_confmat(
    confmat: Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    ignore_index: Optional[int] = None,
    absent_score: float = 0.0,
) -> Tensor:
    allowed_average = ("micro", "macro", "weighted", "none", None)
    if average not in allowed_average:
        raise ValueError(f"The `average` has to be one of {allowed_average}, got {average}.")
    if confmat.ndim != 2:
        raise ValueError(f"the Jaccard index takes a (C, C) confusion matrix, got shape {tuple(confmat.shape)}")
    ignored = ignore_index is not None and 0 <= ignore_index < num_classes
    if ignored:
        confmat = confmat.clone()
        confmat[ignore_index] = 0

    if average in ("none", None):
        intersection = torch.diag(confmat)
        union = confmat.sum(0) + confmat.sum(1) - intersection
        empty = union == 0
        scores = intersection.to(torch.float32) / union.masked_fill(empty, 1).to(torch.float32)
        scores = scores.masked_fill(empty, absent_score)
        if ignored:
            scores = torch.cat([scores[:ignore_index], scores[ignore_index + 1 :]])
        return scores
    if average == "macro":
        return torch.mean(_jaccard_from_confmat(confmat, num_classes, "none", ignore_index, absent_score))
    if average == "micro":
        intersection = torch.sum(torch.diag(confmat))
        union = torch.sum(confmat.sum(0) + confmat.sum(1) - torch.diag(confmat))
        return intersection.to(torch.float32) / union.to(torch.float32)
    # weighted
    weights = confmat.sum(dim=1).to(torch.float32) / confmat.sum().to(torch.float32)
    if ignored:
        weights = torch.cat([weights[:ignore_index], weights[ignore_index + 1 :]])
    scores = _jaccard_from_confmat(confmat, num_classes, "none", ignore_index, absent_score)
    return torch.sum(weights * scores)


def jaccard_index(
    preds,
    target,
    num_classes: int,
    average: Optional[str] = "macro",
    ignore_index: Optional[int] = None,
    absent_score: float = 0.0,
    threshold: float = 0.5,
) -> Tensor:
    """Jaccard index |A∩B| / |A∪B|.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import jaccard_index
        >>> target = torch.tensor([[0, 1, 1], [1, 1, 0]])
        >>> pred = torch.tensor([[0, 1, 0], [1, 1, 1]])
        >>> jaccard_index(pred, target, num_classes=2)
        tensor(0.4667)
    """
    confmat = _confusion_matrix_update(preds, target, num_classes, threshold)
    return _jaccard_from_confmat(confmat, num_classes, average, ignore_index, absent_score)


__all__ = ["jaccard_index"]
