"""Multi-label ranking metrics: CoverageError, LabelRankingAveragePrecision, LabelRankingLoss.

JAX counterpart: `metrics_tpu/classification/ranking.py`; reference
`src/torchmetrics/classification/ranking.py`. Each keeps a summed measure,
an int32 row count and the summed sample weights.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.ranking import (
    _coverage_error_update,
    _label_ranking_average_precision_update,
    _label_ranking_loss_update,
    _ranking_compute,
)
from metrics_tpu_torch.metric import Metric


class _RankingBase(Metric):
    is_differentiable: Optional[bool] = False
    full_state_update: Optional[bool] = False
    _update_fn: Callable

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("measure", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")
        self.add_state("sample_weight", torch.tensor(0.0), dist_reduce_fx="sum")
        self._weighted = False

    def update(self, preds: Tensor, target: Tensor, sample_weight: Optional[Tensor] = None) -> None:
        preds = torch.as_tensor(preds, device=self.device)
        target = torch.as_tensor(target, device=self.device)
        if sample_weight is not None:
            sample_weight = torch.as_tensor(sample_weight, device=self.device)
        measure, total, weight = type(self)._update_fn(preds, target, sample_weight)
        self.measure = self.measure + measure
        self.total = self.total + total
        if weight is not None:
            self._weighted = True
            self.sample_weight = self.sample_weight + weight

    def compute(self) -> Tensor:
        return _ranking_compute(self.measure, self.total, self.sample_weight if self._weighted else None)


class CoverageError(_RankingBase):
    """Average depth of the ranking needed to cover every relevant label.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import CoverageError
        >>> preds = torch.tensor([[-0.25, 0.50, 0.10], [-0.05, 0.75, 0.95]])
        >>> target = torch.tensor([[1, 0, 1], [0, 1, 0]])
        >>> metric = CoverageError(device="cpu")
        >>> metric(preds, target)
        tensor(2.5000)
    """

    higher_is_better: Optional[bool] = False
    _update_fn = staticmethod(_coverage_error_update)


class LabelRankingAveragePrecision(_RankingBase):
    """Label ranking average precision for multi-label data.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import LabelRankingAveragePrecision
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.80, 0.90]])
        >>> target = torch.tensor([[1, 0, 0], [0, 0, 1]])
        >>> metric = LabelRankingAveragePrecision(device="cpu")
        >>> metric(preds, target)
        tensor(1.)
    """

    higher_is_better: Optional[bool] = True
    _update_fn = staticmethod(_label_ranking_average_precision_update)


class LabelRankingLoss(_RankingBase):
    """Average share of label pairs ranked the wrong way round.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import LabelRankingLoss
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.80, 0.90]])
        >>> target = torch.tensor([[1, 0, 0], [0, 0, 1]])
        >>> metric = LabelRankingLoss(device="cpu")
        >>> metric(preds, target)
        tensor(0.)
    """

    higher_is_better: Optional[bool] = False
    _update_fn = staticmethod(_label_ranking_loss_update)


__all__ = ["CoverageError", "LabelRankingAveragePrecision", "LabelRankingLoss"]
