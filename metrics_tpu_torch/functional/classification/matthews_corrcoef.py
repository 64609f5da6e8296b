"""Matthews correlation coefficient from the confusion matrix.

JAX counterpart: `metrics_tpu/functional/classification/matthews_corrcoef.py`
(reference `functional/classification/matthews_corrcoef.py`). The sums of the
int32 matrix are cast to float32 where the JAX package casts them, so the
float expressions are the same.
"""
from __future__ import annotations

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.confusion_matrix import _confusion_matrix_update


def _matthews_corrcoef_update(preds, target, num_classes: int, threshold: float = 0.5) -> Tensor:
    return _confusion_matrix_update(preds, target, num_classes, threshold)


def _matthews_corrcoef_compute(confmat: Tensor) -> Tensor:
    tk = confmat.sum(dim=1).to(torch.float32)
    pk = confmat.sum(dim=0).to(torch.float32)
    c = confmat.diagonal().sum().to(torch.float32)
    s = confmat.sum().to(torch.float32)
    cov_ytyp = c * s - torch.sum(tk * pk)
    cov_ypyp = s**2 - torch.sum(pk * pk)
    cov_ytyt = s**2 - torch.sum(tk * tk)
    denom = cov_ypyp * cov_ytyt
    zero = denom == 0
    return torch.where(zero, 0.0, cov_ytyp / torch.sqrt(torch.where(zero, 1.0, denom)))


def matthews_corrcoef(preds, target, num_classes: int, threshold: float = 0.5) -> Tensor:
    """Matthews correlation coefficient: a balanced correlation of predictions and targets.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import matthews_corrcoef
        >>> target = torch.tensor([1, 1, 0, 0])
        >>> preds = torch.tensor([0, 1, 0, 0])
        >>> matthews_corrcoef(preds, target, num_classes=2)
        tensor(0.5774)
    """
    confmat = _matthews_corrcoef_update(preds, target, num_classes, threshold)
    return _matthews_corrcoef_compute(confmat)


__all__ = ["matthews_corrcoef"]
