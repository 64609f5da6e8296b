"""JaccardIndex module metric (JAX counterpart: `metrics_tpu/classification/jaccard.py`).

A ``ConfusionMatrix`` whose ``compute`` turns the accumulated int32 matrix
into intersection over union. ``compute`` reads the state and never writes
into it, so a second ``compute()`` gives the same value.
"""
from __future__ import annotations

from typing import Any, Optional

from torch import Tensor

from metrics_tpu_torch.classification.confusion_matrix import ConfusionMatrix
from metrics_tpu_torch.functional.classification.jaccard import _jaccard_from_confmat


class JaccardIndex(ConfusionMatrix):
    """Jaccard index (IoU) from an accumulated confusion matrix.

    With ``multilabel=True`` the state is the (C, 2, 2) multilabel matrix,
    accumulated as ``ConfusionMatrix`` does; ``compute`` refuses it with a
    ``ValueError``, as the JAX package does.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import JaccardIndex
        >>> target = torch.tensor([[0, 1], [1, 1]])
        >>> preds = torch.tensor([[0, 1], [0, 1]])
        >>> jaccard = JaccardIndex(num_classes=2, device="cpu")
        >>> jaccard(preds, target)
        tensor(0.5833)
    """

    is_differentiable: Optional[bool] = False
    higher_is_better: Optional[bool] = True
    full_state_update: Optional[bool] = False

    def __init__(
        self,
        num_classes: int,
        average: Optional[str] = "macro",
        ignore_index: Optional[int] = None,
        absent_score: float = 0.0,
        threshold: float = 0.5,
        multilabel: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(num_classes=num_classes, normalize=None, threshold=threshold, multilabel=multilabel, **kwargs)
        self.average = average
        self.ignore_index = ignore_index
        self.absent_score = absent_score

    def compute(self) -> Tensor:
        return _jaccard_from_confmat(self.confmat, self.num_classes, self.average, self.ignore_index, self.absent_score)


__all__ = ["JaccardIndex"]
