"""Dice module metric (JAX counterpart: `metrics_tpu/classification/dice.py`)."""
from __future__ import annotations

from typing import Any, Optional

from torch import Tensor

from metrics_tpu_torch.classification.precision_recall import _PrecisionRecallBase
from metrics_tpu_torch.functional.classification.dice import _dice_compute


class Dice(_PrecisionRecallBase):
    """Dice coefficient = 2·tp / (2·tp + fp + fn).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Dice
        >>> preds = torch.tensor([2, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> dice = Dice(average='micro', device="cpu")
        >>> dice(preds, target)
        tensor(0.2500)
    """

    def __init__(
        self,
        zero_division: int = 0,
        num_classes: Optional[int] = None,
        threshold: float = 0.5,
        average: Optional[str] = "micro",
        mdmc_average: Optional[str] = "global",
        ignore_index: Optional[int] = None,
        top_k: Optional[int] = None,
        multiclass: Optional[bool] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_classes=num_classes,
            threshold=threshold,
            average=average,
            mdmc_average=mdmc_average,
            ignore_index=ignore_index,
            top_k=top_k,
            multiclass=multiclass,
            **kwargs,
        )
        self.zero_division = zero_division

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._get_final_stats()
        return _dice_compute(tp, fp, fn, self.average, self.mdmc_reduce, self.zero_division)


__all__ = ["Dice"]
