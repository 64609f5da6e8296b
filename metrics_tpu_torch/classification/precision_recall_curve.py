"""PrecisionRecallCurve: the exact curve over every buffered score.

JAX counterpart: `metrics_tpu/classification/precision_recall_curve.py`;
reference `src/torchmetrics/classification/precision_recall_curve.py`.
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.classification._raw_state import _RawPairStateMixin
from metrics_tpu_torch.functional.classification.precision_recall_curve import (
    _precision_recall_curve_compute,
    _precision_recall_curve_update,
)
from metrics_tpu_torch.metric import Metric


class PrecisionRecallCurve(_RawPairStateMixin, Metric):
    """The exact precision-recall curve of every score seen since the last reset.

    ``update`` checks the shapes and buffers the raw rows; the curve is
    computed from all of them at ``compute``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import PrecisionRecallCurve
        >>> preds = torch.tensor([0.0, 1.0, 2.0, 3.0])
        >>> target = torch.tensor([0, 1, 1, 0])
        >>> pr_curve = PrecisionRecallCurve(pos_label=1, device="cpu")
        >>> precision, recall, thresholds = pr_curve(preds, target)
        >>> precision
        tensor([0.6667, 0.5000, 0.0000, 1.0000])
        >>> recall
        tensor([1.0000, 0.5000, 0.0000, 0.0000])
        >>> thresholds
        tensor([1., 2., 3.])
    """

    is_differentiable: Optional[bool] = False
    higher_is_better: Optional[bool] = None
    full_state_update: Optional[bool] = False

    def __init__(self, num_classes: Optional[int] = None, pos_label: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.pos_label = pos_label
        self.add_state("preds", default=[], dist_reduce_fx="cat")
        self.add_state("target", default=[], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds = torch.as_tensor(preds, device=self.device)
        target = torch.as_tensor(target, device=self.device)
        preds, target, num_classes, pos_label = _precision_recall_curve_update(
            preds, target, self.num_classes, self.pos_label, format_tensors=False
        )
        self.preds.append(preds)
        self.target.append(target)
        self.num_classes = num_classes
        self.pos_label = pos_label

    def _format_row(self, preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
        p, t, _, _ = _precision_recall_curve_update(preds, target, self.num_classes, self.pos_label, warn=False)
        return p, t

    def compute(self) -> Union[Tuple[Tensor, ...], Tuple[List[Tensor], ...]]:
        preds, target = self._cat_raw()
        preds, target, num_classes, pos_label = _precision_recall_curve_update(
            preds, target, self.num_classes, self.pos_label, warn=False
        )
        return _precision_recall_curve_compute(preds, target, num_classes, pos_label)


__all__ = ["PrecisionRecallCurve"]
