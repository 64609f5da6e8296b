"""ConfusionMatrix module metric (JAX counterpart: `metrics_tpu/classification/confusion_matrix.py`).

Each update is one bincount over ``C**2`` label pairs, which on the card is
the CUDA kernel of ``ops/histogram.py``.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.confusion_matrix import (
    _confusion_matrix_compute,
    _confusion_matrix_update,
)
from metrics_tpu_torch.metric import Metric


class ConfusionMatrix(Metric):
    """(C, C) confusion matrix ((C, 2, 2) for multilabel).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import ConfusionMatrix
        >>> target = torch.tensor([1, 1, 0, 0])
        >>> preds = torch.tensor([0, 1, 0, 0])
        >>> confmat = ConfusionMatrix(num_classes=2, device="cpu")
        >>> confmat(preds, target)
        tensor([[2, 0],
                [1, 1]], dtype=torch.int32)
    """

    is_differentiable: Optional[bool] = False
    higher_is_better: Optional[bool] = None
    full_state_update: Optional[bool] = False

    def __init__(
        self,
        num_classes: int,
        normalize: Optional[str] = None,
        threshold: float = 0.5,
        multilabel: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.normalize = normalize
        self.threshold = threshold
        self.multilabel = multilabel

        allowed_normalize = ("true", "pred", "all", "none", None)
        if normalize not in allowed_normalize:
            raise ValueError(f"Argument average needs to one of the following: {allowed_normalize}")

        shape = (num_classes, 2, 2) if multilabel else (num_classes, num_classes)
        self.add_state("confmat", default=torch.zeros(shape, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        confmat = _confusion_matrix_update(preds, target, self.num_classes, self.threshold, self.multilabel)
        self.confmat = self.confmat + confmat

    def compute(self) -> Tensor:
        return _confusion_matrix_compute(self.confmat, self.normalize)


__all__ = ["ConfusionMatrix"]
