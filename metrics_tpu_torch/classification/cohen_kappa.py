"""CohenKappa module metric (JAX counterpart: `metrics_tpu/classification/cohen_kappa.py`).

Its state is the int32 (C, C) confusion matrix, shared in a compute group
with the other confusion-matrix metrics of the same width.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.cohen_kappa import _cohen_kappa_compute, _cohen_kappa_update
from metrics_tpu_torch.metric import Metric


class CohenKappa(Metric):
    """Cohen's kappa from an accumulated confusion matrix.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import CohenKappa
        >>> target = torch.tensor([1, 1, 0, 0])
        >>> preds = torch.tensor([0, 1, 0, 0])
        >>> cohenkappa = CohenKappa(num_classes=2, device="cpu")
        >>> cohenkappa(preds, target)
        tensor(0.5000)
    """

    is_differentiable: Optional[bool] = False
    higher_is_better: Optional[bool] = True
    full_state_update: Optional[bool] = False

    def __init__(
        self,
        num_classes: int,
        weights: Optional[str] = None,
        threshold: float = 0.5,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.weights = weights
        self.threshold = threshold
        allowed_weights = ("linear", "quadratic", "none", None)
        if self.weights not in allowed_weights:
            raise ValueError(f"Argument weights needs to one of the following: {allowed_weights}")
        self.add_state("confmat", default=torch.zeros((num_classes, num_classes), dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        self.confmat = self.confmat + _cohen_kappa_update(preds, target, self.num_classes, self.threshold)

    def compute(self) -> Tensor:
        return _cohen_kappa_compute(self.confmat, self.weights)


__all__ = ["CohenKappa"]
