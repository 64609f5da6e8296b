"""AUC: the area under an accumulated (x, y) curve.

JAX counterpart: `metrics_tpu/classification/auc.py`; reference
`src/torchmetrics/classification/auc.py`.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.auc import _auc_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.compute import _auc_compute
from metrics_tpu_torch.utils.data import dim_zero_cat


class AUC(Metric):
    """Area under every (x, y) point seen since the last reset.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import AUC
        >>> auc = AUC(reorder=True, device="cpu")
        >>> auc.update(torch.tensor([0.0, 1.0, 2.0, 3.0]), torch.tensor([0.0, 1.0, 2.0, 2.0]))
        >>> auc.compute()
        tensor(4.)
    """

    is_differentiable: Optional[bool] = False
    higher_is_better: Optional[bool] = None
    full_state_update: Optional[bool] = False

    def __init__(self, reorder: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.reorder = reorder
        self.add_state("x", default=[], dist_reduce_fx="cat")
        self.add_state("y", default=[], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        x, y = _auc_update(torch.as_tensor(preds, device=self.device), torch.as_tensor(target, device=self.device))
        self.x.append(x)
        self.y.append(y)

    def compute(self) -> Tensor:
        return _auc_compute(dim_zero_cat(self.x).to(torch.float32), dim_zero_cat(self.y).to(torch.float32), self.reorder)


__all__ = ["AUC"]
