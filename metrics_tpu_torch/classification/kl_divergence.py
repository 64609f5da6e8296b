"""KLDivergence: KL(P ‖ Q) accumulated over batches.

JAX counterpart: `metrics_tpu/classification/kl_divergence.py`; reference
`src/torchmetrics/classification/kl_divergence.py`.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.kl_divergence import _kld_compute, _kld_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.data import dim_zero_cat


class KLDivergence(Metric):
    """KL(P ‖ Q) accumulated over batches: a summed state for ``"mean"`` and
    ``"sum"``, every row's value for ``"none"``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import KLDivergence
        >>> p = torch.tensor([[0.36, 0.48, 0.16]])
        >>> q = torch.tensor([[1 / 3, 1 / 3, 1 / 3]])
        >>> kl_divergence = KLDivergence(device="cpu")
        >>> round(float(kl_divergence(p, q)), 4)
        0.0853
    """

    is_differentiable: Optional[bool] = True
    higher_is_better: Optional[bool] = False
    full_state_update: Optional[bool] = False

    def __init__(self, log_prob: bool = False, reduction: Optional[str] = "mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(log_prob, bool):
            raise TypeError(f"Expected argument `log_prob` to be bool but got {log_prob}")
        allowed_reduction = ("mean", "sum", "none", None)
        if reduction not in allowed_reduction:
            raise ValueError(f"Expected argument `reduction` to be one of {allowed_reduction} but got {reduction}")
        self.log_prob = log_prob
        self.reduction = reduction

        if self.reduction in ("mean", "sum"):
            self.add_state("measures", torch.tensor(0.0), dist_reduce_fx="sum")
        else:
            self.add_state("measures", [], dist_reduce_fx="cat")
        self.add_state("total", torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, p: Tensor, q: Tensor) -> None:
        p = torch.as_tensor(p, device=self.device)
        q = torch.as_tensor(q, device=self.device)
        measures, total = _kld_update(p, q, self.log_prob)
        if self.reduction is None or self.reduction == "none":
            self.measures.append(measures)
        else:
            self.measures = self.measures + measures.sum()
        self.total = self.total + total

    def compute(self) -> Tensor:
        measures = dim_zero_cat(self.measures) if self.reduction in ("none", None) else self.measures
        return _kld_compute(measures, self.total, self.reduction)


__all__ = ["KLDivergence"]
