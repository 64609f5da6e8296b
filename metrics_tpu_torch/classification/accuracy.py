"""Accuracy module metric.

JAX counterpart: `metrics_tpu/classification/accuracy.py` (reference
`classification/accuracy.py:31-260`): the stat-score states plus
``correct``/``total`` sum states for subset accuracy.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch import Tensor

from metrics_tpu_torch.classification.stat_scores import StatScores
from metrics_tpu_torch.functional.classification.accuracy import (
    _accuracy_compute,
    _check_subset_validity,
    _mode,
    _subset_accuracy_compute,
    _subset_accuracy_update,
)
from metrics_tpu_torch.utils.enums import DataType


class Accuracy(StatScores):
    """Accuracy (micro/macro/weighted/samplewise, top-k, subset mode).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Accuracy
        >>> target = torch.tensor([0, 1, 2, 3])
        >>> preds = torch.tensor([0, 2, 1, 3])
        >>> accuracy = Accuracy(device="cpu")
        >>> accuracy(preds, target)
        tensor(0.5000)
    """

    is_differentiable: Optional[bool] = False
    higher_is_better: Optional[bool] = True
    full_state_update: Optional[bool] = False

    def __init__(
        self,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        average: Optional[str] = "micro",
        # the class defaults to None while the functional form defaults to
        # "global", as in the reference
        mdmc_average: Optional[str] = None,
        ignore_index: Optional[int] = None,
        top_k: Optional[int] = None,
        multiclass: Optional[bool] = None,
        subset_accuracy: bool = False,
        **kwargs: Any,
    ) -> None:
        allowed_average = ("micro", "macro", "weighted", "samples", "none", None)
        if average not in allowed_average:
            raise ValueError(f"The `average` has to be one of {allowed_average}, got {average}.")

        super().__init__(
            reduce="macro" if average in ("weighted", "none", None) else average,
            mdmc_reduce=mdmc_average,
            threshold=threshold,
            top_k=top_k,
            num_classes=num_classes,
            multiclass=multiclass,
            ignore_index=ignore_index,
            **kwargs,
        )
        self.average = average
        self.add_state("correct", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")
        self.subset_accuracy = subset_accuracy
        self.mode: Optional[DataType] = None

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds = torch.as_tensor(preds)
        target = torch.as_tensor(target, device=preds.device)
        mode = _mode(preds, target, self.threshold, self.top_k, self.num_classes, self.multiclass, self.ignore_index)
        if not self.mode:
            self.mode = mode
        elif self.mode != mode:
            raise ValueError(f"You can not use {mode} inputs with {self.mode} inputs.")

        if self.subset_accuracy and _check_subset_validity(self.mode):
            correct, total = _subset_accuracy_update(
                preds, target, threshold=self.threshold, top_k=self.top_k, ignore_index=self.ignore_index
            )
            self.correct = self.correct + correct
            self.total = self.total + total
        else:
            if self.mode == DataType.MULTILABEL and self.top_k:
                raise ValueError("You can not use the `top_k` parameter to calculate accuracy for multi-label inputs.")
            super().update(preds, target)

    def compute(self) -> Tensor:
        if self.subset_accuracy and _check_subset_validity(self.mode):
            return _subset_accuracy_compute(self.correct, self.total)
        tp, fp, tn, fn = self._get_final_stats()
        return _accuracy_compute(tp, fp, tn, fn, self.average, self.mdmc_reduce, self.mode)


__all__ = ["Accuracy"]
