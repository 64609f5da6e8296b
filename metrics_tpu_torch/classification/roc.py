"""ROC: the exact receiver operating characteristic over every buffered score.

JAX counterpart: `metrics_tpu/classification/roc.py`; reference
`src/torchmetrics/classification/roc.py`.
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.classification._raw_state import _RawPairStateMixin
from metrics_tpu_torch.functional.classification.precision_recall_curve import _precision_recall_curve_update
from metrics_tpu_torch.functional.classification.roc import _roc_compute, _roc_update
from metrics_tpu_torch.metric import Metric


class ROC(_RawPairStateMixin, Metric):
    """The ROC curve of every score seen since the last reset.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import ROC
        >>> preds = torch.tensor([0.0, 1.0, 2.0, 3.0])
        >>> target = torch.tensor([0, 1, 1, 1])
        >>> roc = ROC(pos_label=1, device="cpu")
        >>> fpr, tpr, thresholds = roc(preds, target)
        >>> fpr
        tensor([0., 0., 0., 0., 1.])
        >>> tpr
        tensor([0.0000, 0.3333, 0.6667, 1.0000, 1.0000])
        >>> thresholds
        tensor([4., 3., 2., 1., 0.])
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
        preds, target, num_classes, pos_label = _roc_update(
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
        return _roc_compute(preds, target, num_classes, pos_label)


__all__ = ["ROC"]
