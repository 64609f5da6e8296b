"""The binned curve family: precision and recall on a fixed threshold grid.

JAX counterpart: `metrics_tpu/classification/binned_precision_recall.py`
(``BinnedPrecisionRecallCurve``, ``BinnedAveragePrecision``,
``BinnedRecallAtFixedPrecision``); reference
`src/torchmetrics/classification/binned_precision_recall.py:46-302`.

The state is three ``(C, T)`` count grids, so its memory stays the same
however many scores arrive. Each update counts the whole batch against every
threshold in one compare and contraction
(:func:`metrics_tpu_torch.ops.binned.binned_curve_counts`). The thresholds
are host numpy, as in the JAX package; their copy on the metric's device is
made once per device, so that an update copies nothing from the host.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.average_precision import (
    _average_precision_compute_with_precision_recall,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.ops.binned import binned_curve_counts
from metrics_tpu_torch.utils.data import to_onehot

METRIC_EPS = 1e-6


def _recall_at_precision(
    precision: Tensor, recall: Tensor, thresholds: Tensor, min_precision: float
) -> Tuple[Tensor, Tensor]:
    """The largest recall with precision >= ``min_precision``, and its threshold.

    Ties on the recall go to the higher precision, then to the higher
    threshold, as the reference's ``max`` over (recall, precision, threshold)
    tuples does; with no such point the recall is 0 and the threshold 1e6.
    """
    n = thresholds.shape[0]
    ok = precision[:n] >= min_precision
    rec = torch.where(ok, recall[:n], -torch.inf)
    rmax = torch.max(rec)
    any_ok = torch.isfinite(rmax)
    cand = ok & (rec == rmax)
    pmax = torch.max(torch.where(cand, precision[:n], -torch.inf))
    cand = cand & (precision[:n] == pmax)
    tbest = torch.max(torch.where(cand, thresholds, -torch.inf))
    max_recall = torch.where(any_ok, rmax, 0.0)
    best_threshold = torch.where((max_recall == 0.0) | ~any_ok, 1e6, tbest)
    return max_recall, best_threshold


class BinnedPrecisionRecallCurve(Metric):
    """Precision and recall at each threshold of a fixed grid, in constant memory.

    Args:
        num_classes: the classes (1 for binary input).
        thresholds: an int for that many thresholds evenly spaced in [0, 1],
            or a list or array of thresholds.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import BinnedPrecisionRecallCurve
        >>> preds = torch.tensor([0.1, 0.4, 0.35, 0.8])
        >>> target = torch.tensor([0, 0, 1, 1])
        >>> metric = BinnedPrecisionRecallCurve(num_classes=1, thresholds=5, device="cpu")
        >>> precision, recall, thresholds = metric(preds, target)
        >>> precision
        tensor([0.5000, 0.6667, 1.0000, 1.0000, 1.0000, 1.0000])
        >>> recall
        tensor([1.0000, 1.0000, 0.5000, 0.5000, 0.0000, 0.0000])
        >>> thresholds
        tensor([0.0000, 0.2500, 0.5000, 0.7500, 1.0000])
    """

    is_differentiable: Optional[bool] = False
    higher_is_better: Optional[bool] = None
    full_state_update: Optional[bool] = False

    def __init__(
        self,
        num_classes: int,
        thresholds: Union[int, Tensor, List[float], np.ndarray] = 100,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        if isinstance(thresholds, int):
            self.num_thresholds = thresholds
            self.thresholds = np.linspace(0, 1.0, thresholds, dtype=np.float32)
        elif thresholds is not None:
            if not isinstance(thresholds, (list, np.ndarray, Tensor)):
                raise ValueError("Expected argument `thresholds` to either be an integer, list of floats or a tensor")
            if isinstance(thresholds, Tensor):
                thresholds = thresholds.detach().cpu().numpy()
            self.thresholds = np.asarray(thresholds, dtype=np.float32)
            self.num_thresholds = self.thresholds.size
        self._device_thresholds: Dict[torch.device, Tensor] = {}

        for name in ("TPs", "FPs", "FNs"):
            self.add_state(
                name, default=torch.zeros((num_classes, self.num_thresholds), dtype=torch.float32), dist_reduce_fx="sum"
            )

    def _thresholds_on(self, device: torch.device) -> Tensor:
        if device not in self._device_thresholds:
            self._device_thresholds[device] = torch.from_numpy(self.thresholds).to(device)
        return self._device_thresholds[device]

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds = torch.as_tensor(preds, device=self.device)
        target = torch.as_tensor(target, device=self.device)
        if preds.ndim == target.ndim == 1:
            preds = preds.reshape(-1, 1)
            target = target.reshape(-1, 1)
        if preds.ndim == target.ndim + 1:
            target = to_onehot(target, num_classes=self.num_classes)

        t = (target == 1).to(torch.float32)  # (N, C)
        tps, fps, fns = binned_curve_counts(preds, t, self._thresholds_on(preds.device))
        self.TPs = self.TPs + tps
        self.FPs = self.FPs + fps
        self.FNs = self.FNs + fns

    def compute(self) -> Union[Tuple[Tensor, ...], Tuple[List[Tensor], ...]]:
        if self.TPs.shape[0] != self.num_classes:
            # (N, C) preds counted into a metric built for fewer classes: JAX's concatenate raises TypeError
            raise TypeError(
                f"Cannot concatenate the counts of {self.TPs.shape[0]} classes with the {self.num_classes} of the metric"
            )
        precisions = (self.TPs + METRIC_EPS) / (self.TPs + self.FPs + METRIC_EPS)
        recalls = self.TPs / (self.TPs + self.FNs + METRIC_EPS)
        ones = torch.ones((self.num_classes, 1), dtype=precisions.dtype, device=precisions.device)
        precisions = torch.cat([precisions, ones], dim=1)
        recalls = torch.cat([recalls, torch.zeros_like(ones)], dim=1)
        thresholds = self._thresholds_on(precisions.device)
        if self.num_classes == 1:
            return precisions[0, :], recalls[0, :], thresholds
        return list(precisions), list(recalls), [thresholds for _ in range(self.num_classes)]


class BinnedAveragePrecision(BinnedPrecisionRecallCurve):
    """Average precision from the binned curve, in constant memory.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import BinnedAveragePrecision
        >>> preds = torch.tensor([0.1, 0.4, 0.35, 0.8])
        >>> target = torch.tensor([0, 0, 1, 1])
        >>> metric = BinnedAveragePrecision(num_classes=1, thresholds=5, device="cpu")
        >>> metric(preds, target)
        tensor(0.8333)
    """

    def compute(self) -> Union[List[Tensor], Tensor]:
        precisions, recalls, _ = super().compute()
        return _average_precision_compute_with_precision_recall(precisions, recalls, self.num_classes, average=None)


class BinnedRecallAtFixedPrecision(BinnedPrecisionRecallCurve):
    """The highest recall, and its threshold, among the thresholds with precision >= ``min_precision``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import BinnedRecallAtFixedPrecision
        >>> preds = torch.tensor([0.1, 0.4, 0.35, 0.8])
        >>> target = torch.tensor([0, 0, 1, 1])
        >>> metric = BinnedRecallAtFixedPrecision(num_classes=1, min_precision=0.5, thresholds=5, device="cpu")
        >>> metric(preds, target)
        (tensor(1.0000), tensor(0.2500))
    """

    def __init__(
        self,
        num_classes: int,
        min_precision: float,
        thresholds: Union[int, Tensor, List[float], np.ndarray] = 100,
        **kwargs: Any,
    ) -> None:
        super().__init__(num_classes=num_classes, thresholds=thresholds, **kwargs)
        self.min_precision = min_precision

    def compute(self) -> Tuple[Tensor, Tensor]:
        precisions, recalls, thresholds = super().compute()
        if self.num_classes == 1:
            return _recall_at_precision(precisions, recalls, thresholds, self.min_precision)
        recalls_at_p = []
        thresholds_at_p = []
        for i in range(self.num_classes):
            r, t = _recall_at_precision(precisions[i], recalls[i], thresholds[i], self.min_precision)
            recalls_at_p.append(r)
            thresholds_at_p.append(t)
        return torch.stack(recalls_at_p), torch.stack(thresholds_at_p)


__all__ = ["BinnedPrecisionRecallCurve", "BinnedAveragePrecision", "BinnedRecallAtFixedPrecision"]
