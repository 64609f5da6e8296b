"""CalibrationError: the calibration error of the accumulated per-bin sums.

JAX counterpart: `metrics_tpu/classification/calibration_error.py`; reference
`src/torchmetrics/classification/calibration_error.py`. As in the JAX
package, the states are three per-bin sums, not the raw confidences: every
norm is a function of them, the bins are fixed, so the binning commutes with
batching, and the state stays ``(n_bins,)``. The sample and accuracy counts
are int32, exact to 2**31 samples a bin; the confidence sums are float32.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.calibration_error import (
    _bin_counts,
    _ce_from_bin_sums,
    _ce_update,
)
from metrics_tpu_torch.metric import Metric


class CalibrationError(Metric):
    """Expected (``l1``), maximum (``max``) or root-mean-square (``l2``) calibration error.

    Each update bins the top-1 confidences: one ``_bincount`` launch (the
    CUDA kernel on the card) counts the samples and the right predictions of
    every bin, and a float ``index_add_`` sums the confidences.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import CalibrationError
        >>> preds = torch.tensor([0.25, 0.35, 0.8, 0.9])
        >>> target = torch.tensor([0, 0, 1, 1])
        >>> metric = CalibrationError(n_bins=3, norm='l1', device="cpu")
        >>> round(float(metric(preds, target)), 4)
        0.225
    """

    is_differentiable: Optional[bool] = False
    higher_is_better: Optional[bool] = False
    full_state_update: Optional[bool] = False
    DISTANCES = {"l1", "l2", "max"}

    def __init__(self, n_bins: int = 15, norm: str = "l1", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if norm not in self.DISTANCES:
            raise ValueError(f"Norm {norm} is not supported. Please select from l1, l2, or max. ")
        if not isinstance(n_bins, int) or n_bins <= 0:
            raise ValueError(f"Expected argument `n_bins` to be a int larger than 0 but got {n_bins}")
        self.n_bins = n_bins
        self.norm = norm
        # the JAX module's boundaries (numpy's linspace); a buffer, so that `.to()` moves it
        boundaries = torch.from_numpy(np.linspace(0, 1, n_bins + 1, dtype=np.float32))
        self.register_buffer("bin_boundaries", boundaries.to(self.device), persistent=False)
        self.add_state("count_bin", torch.zeros(n_bins, dtype=torch.int32), dist_reduce_fx="sum")
        self.add_state("conf_bin", torch.zeros(n_bins, dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("acc_bin", torch.zeros(n_bins, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds = torch.as_tensor(preds, device=self.device)
        target = torch.as_tensor(target, device=self.device)
        confidences, accuracies = _ce_update(preds, target)
        count, conf, acc = _bin_counts(confidences, accuracies, self.bin_boundaries)
        self.count_bin = self.count_bin + count
        self.conf_bin = self.conf_bin + conf
        self.acc_bin = self.acc_bin + acc

    def compute(self) -> Tensor:
        # a compute before any update raises, as the raw-state formulation does; the
        # state-sum read runs only when no update was counted (a loaded state may have some)
        if self._update_count == 0 and int(torch.sum(self.count_bin)) == 0:
            raise ValueError("No samples to compute calibration error over; call `update` first")
        return _ce_from_bin_sums(self.count_bin, self.conf_bin, self.acc_bin, self.norm)


__all__ = ["CalibrationError"]
