"""MatthewsCorrCoef module metric (JAX counterpart: `metrics_tpu/classification/matthews_corrcoef.py`).

Its state is the int32 (C, C) confusion matrix, so in a ``MetricCollection``
it shares one compute group, and one bincount per update, with
``CohenKappa``, ``JaccardIndex`` and ``ConfusionMatrix`` of the same width.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.matthews_corrcoef import (
    _matthews_corrcoef_compute,
    _matthews_corrcoef_update,
)
from metrics_tpu_torch.metric import Metric


class MatthewsCorrCoef(Metric):
    """Matthews correlation coefficient from an accumulated confusion matrix.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MatthewsCorrCoef
        >>> target = torch.tensor([1, 1, 0, 0])
        >>> preds = torch.tensor([0, 1, 0, 0])
        >>> matthews_corrcoef = MatthewsCorrCoef(num_classes=2, device="cpu")
        >>> matthews_corrcoef(preds, target)
        tensor(0.5774)
    """

    is_differentiable: Optional[bool] = False
    higher_is_better: Optional[bool] = True
    full_state_update: Optional[bool] = False

    def __init__(self, num_classes: int, threshold: float = 0.5, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.threshold = threshold
        self.add_state("confmat", default=torch.zeros((num_classes, num_classes), dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        self.confmat = self.confmat + _matthews_corrcoef_update(preds, target, self.num_classes, self.threshold)

    def compute(self) -> Tensor:
        return _matthews_corrcoef_compute(self.confmat)


__all__ = ["MatthewsCorrCoef"]
