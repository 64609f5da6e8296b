"""AUROC: the area under the ROC curve of every buffered score.

JAX counterpart: `metrics_tpu/classification/auroc.py`; reference
`src/torchmetrics/classification/auroc.py`.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.classification._raw_state import _RawPairStateMixin
from metrics_tpu_torch.functional.classification.auroc import _auroc_compute, _auroc_format, _auroc_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.enums import AverageMethod


class AUROC(_RawPairStateMixin, Metric):
    """Area under the ROC curve of every score seen since the last reset.

    ``update`` resolves the input case (binary, multi-class, multi-label) with
    the full validation, checks that it stays the same, and buffers the raw
    rows.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import AUROC
        >>> preds = torch.tensor([0.13, 0.26, 0.08, 0.19, 0.34])
        >>> target = torch.tensor([0, 0, 1, 1, 1])
        >>> auroc = AUROC(pos_label=1, device="cpu")
        >>> auroc(preds, target)
        tensor(0.5000)
    """

    is_differentiable: Optional[bool] = False
    higher_is_better: Optional[bool] = True
    full_state_update: Optional[bool] = False

    def __init__(
        self,
        num_classes: Optional[int] = None,
        pos_label: Optional[int] = None,
        average: Optional[str] = "macro",
        max_fpr: Optional[float] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.pos_label = pos_label
        self.average = average
        self.max_fpr = max_fpr

        allowed_average = (None, AverageMethod.MACRO, AverageMethod.WEIGHTED, AverageMethod.MICRO, AverageMethod.NONE)
        if self.average not in allowed_average:
            raise ValueError(
                f"Argument `average` expected to be one of the following: {allowed_average} but got {average}"
            )
        if self.max_fpr is not None and (not isinstance(max_fpr, float) or not 0 < max_fpr <= 1):
            raise ValueError(f"`max_fpr` should be a float in range (0, 1], got: {max_fpr}")

        self.mode = None
        self.add_state("preds", default=[], dist_reduce_fx="cat")
        self.add_state("target", default=[], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds = torch.as_tensor(preds, device=self.device)
        target = torch.as_tensor(target, device=self.device)
        preds, target, mode = _auroc_update(preds, target, format_tensors=False)
        self.preds.append(preds)
        self.target.append(target)
        if self.mode and self.mode != mode:
            raise ValueError(
                "The mode of data (binary, multi-label, multi-class) should be constant, but changed"
                f" between batches from {self.mode} to {mode}"
            )
        self.mode = mode

    def _format_row(self, preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
        # the rows were checked at update: only the layout transform of the mode runs
        if self.mode is None:
            p, t, _ = _auroc_update(preds, target)
            return p, t
        return _auroc_format(preds, target, self.mode)

    def compute(self) -> Tensor:
        # after a sync the preds are one tensor, not a list
        have_data = len(self.preds) > 0 if isinstance(self.preds, list) else self.preds.numel() > 0
        if not self.mode and not have_data:
            raise RuntimeError("You have to have determined mode.")
        preds, target = self._cat_raw()
        mode = self.mode
        if mode is None:
            # a state loaded into a fresh metric: the mode is derived again from the stored rows
            preds, target, mode = _auroc_update(preds, target)
        else:
            preds, target = _auroc_format(preds, target, mode)
        return _auroc_compute(preds, target, mode, self.num_classes, self.pos_label, self.average, self.max_fpr)


__all__ = ["AUROC"]
