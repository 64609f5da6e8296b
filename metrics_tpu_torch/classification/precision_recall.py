"""Precision and Recall module metrics (JAX counterpart: `metrics_tpu/classification/precision_recall.py`)."""
from __future__ import annotations

from typing import Any, Optional

from torch import Tensor

from metrics_tpu_torch.classification.stat_scores import StatScores
from metrics_tpu_torch.functional.classification.precision_recall import _precision_compute, _recall_compute


class _PrecisionRecallBase(StatScores):
    is_differentiable: Optional[bool] = False
    higher_is_better: Optional[bool] = True
    full_state_update: Optional[bool] = False

    def __init__(
        self,
        num_classes: Optional[int] = None,
        threshold: float = 0.5,
        average: Optional[str] = "micro",
        mdmc_average: Optional[str] = None,
        ignore_index: Optional[int] = None,
        top_k: Optional[int] = None,
        multiclass: Optional[bool] = None,
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


class Precision(_PrecisionRecallBase):
    """Precision = tp / (tp + fp).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Precision
        >>> preds = torch.tensor([2, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> precision = Precision(average='macro', num_classes=3, device="cpu")
        >>> precision(preds, target)
        tensor(0.1667)
    """

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._get_final_stats()
        return _precision_compute(tp, fp, fn, self.average, self.mdmc_reduce)


class Recall(_PrecisionRecallBase):
    """Recall = tp / (tp + fn).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Recall
        >>> preds = torch.tensor([2, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> recall = Recall(average='macro', num_classes=3, device="cpu")
        >>> recall(preds, target)
        tensor(0.3333)
    """

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._get_final_stats()
        return _recall_compute(tp, fp, fn, self.average, self.mdmc_reduce)


__all__ = ["Precision", "Recall"]
