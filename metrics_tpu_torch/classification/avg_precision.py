"""AveragePrecision over every buffered score.

JAX counterpart: `metrics_tpu/classification/avg_precision.py`; reference
`src/torchmetrics/classification/avg_precision.py`.
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.classification._raw_state import _RawPairStateMixin
from metrics_tpu_torch.functional.classification.average_precision import (
    _average_precision_compute,
    _average_precision_update,
)
from metrics_tpu_torch.functional.classification.precision_recall_curve import _precision_recall_curve_update
from metrics_tpu_torch.metric import Metric


class AveragePrecision(_RawPairStateMixin, Metric):
    """Average precision of every score seen since the last reset.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import AveragePrecision
        >>> preds = torch.tensor([0.1, 0.4, 0.35, 0.8])
        >>> target = torch.tensor([0, 0, 1, 1])
        >>> average_precision = AveragePrecision(pos_label=1, device="cpu")
        >>> average_precision(preds, target)
        tensor(0.8333)
    """

    is_differentiable: Optional[bool] = False
    higher_is_better: Optional[bool] = True
    full_state_update: Optional[bool] = False

    def __init__(
        self,
        num_classes: Optional[int] = None,
        pos_label: Optional[int] = None,
        average: Optional[str] = "macro",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.pos_label = pos_label
        allowed_average = ("micro", "macro", "weighted", "none", None)
        if average not in allowed_average:
            raise ValueError(f"Expected argument `average` to be one of {allowed_average} but got {average}")
        self.average = average
        self.add_state("preds", default=[], dist_reduce_fx="cat")
        self.add_state("target", default=[], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds = torch.as_tensor(preds, device=self.device)
        target = torch.as_tensor(target, device=self.device)
        preds, target, num_classes, pos_label = _average_precision_update(
            preds, target, self.num_classes, self.pos_label, self.average, format_tensors=False
        )
        self.preds.append(preds)
        self.target.append(target)
        self.num_classes = num_classes
        self.pos_label = pos_label

    def _format_row(self, preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
        p, t, _, _ = _precision_recall_curve_update(preds, target, self.num_classes, self.pos_label, warn=False)
        return p, t

    def compute(self) -> Union[Tensor, List[Tensor]]:
        preds, target = self._cat_raw()
        preds, target, num_classes, pos_label = _precision_recall_curve_update(
            preds, target, self.num_classes, self.pos_label, warn=False
        )
        return _average_precision_compute(preds, target, num_classes, pos_label, self.average)


__all__ = ["AveragePrecision"]
