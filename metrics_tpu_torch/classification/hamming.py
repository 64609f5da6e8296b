"""HammingDistance module metric (JAX counterpart: `metrics_tpu/classification/hamming.py`).

Both states are int32 0-d tensors, as in the JAX package.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.hamming import _hamming_distance_compute, _hamming_distance_update
from metrics_tpu_torch.metric import Metric


class HammingDistance(Metric):
    """Share of wrongly predicted labels over all label positions.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import HammingDistance
        >>> target = torch.tensor([[0, 1], [1, 1]])
        >>> preds = torch.tensor([[0, 1], [0, 1]])
        >>> hamming = HammingDistance(device="cpu")
        >>> hamming(preds, target)
        tensor(0.2500)
    """

    is_differentiable: Optional[bool] = False
    higher_is_better: Optional[bool] = False
    full_state_update: Optional[bool] = False

    def __init__(self, threshold: float = 0.5, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("correct", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")
        self.threshold = threshold

    def update(self, preds: Tensor, target: Tensor) -> None:
        correct, total = _hamming_distance_update(preds, target, self.threshold)
        self.correct = self.correct + correct
        self.total = self.total + total

    def compute(self) -> Tensor:
        return _hamming_distance_compute(self.correct, self.total)


__all__ = ["HammingDistance"]
