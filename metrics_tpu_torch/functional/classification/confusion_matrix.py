"""Confusion matrix: a bincount over label pairs.

JAX counterpart: `metrics_tpu/functional/classification/confusion_matrix.py`
(reference `functional/classification/confusion_matrix.py:25-120`). The pair
histogram goes through :func:`metrics_tpu_torch.utils.data._bincount`, which
on the card is the CUDA kernel of ``ops/histogram.py``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _check_broadcastable, _input_format_classification
from metrics_tpu_torch.utils.data import _bincount
from metrics_tpu_torch.utils.enums import DataType
from metrics_tpu_torch.utils.prints import rank_zero_warn


def _confusion_matrix_update(
    preds, target, num_classes: int, threshold: float = 0.5, multilabel: bool = False
) -> Tensor:
    preds = torch.as_tensor(preds)
    target = torch.as_tensor(target, device=preds.device)
    # integer labels: the one-hot width comes from num_classes, not from the data's maximum
    pass_nc = num_classes if (not preds.is_floating_point() and preds.ndim == target.ndim) else None
    preds, target, mode = _input_format_classification(preds, target, threshold, num_classes=pass_nc)
    if mode not in (DataType.BINARY, DataType.MULTILABEL):
        preds = preds.argmax(dim=1)
        target = target.argmax(dim=1)
    if multilabel:
        offsets = 4 * torch.arange(num_classes, device=preds.device)
        # inputs that are not (N, C) multilabel: raise JAX's exception type
        _check_broadcastable(tuple(preds.shape), tuple(offsets.shape))
        unique_mapping = ((2 * target + preds) + offsets).reshape(-1)
        return _bincount(unique_mapping, minlength=4 * num_classes).reshape(num_classes, 2, 2)
    unique_mapping = target.reshape(-1) * num_classes + preds.reshape(-1)
    return _bincount(unique_mapping, minlength=num_classes**2).reshape(num_classes, num_classes)


def _confusion_matrix_compute(confmat: Tensor, normalize: Optional[str] = None) -> Tensor:
    allowed_normalize = ("true", "pred", "all", "none", None)
    if normalize not in allowed_normalize:
        raise ValueError(f"Argument average needs to one of the following: {allowed_normalize}")
    if normalize is not None and normalize != "none":
        confmat = confmat.to(torch.float32)
        if normalize == "true":
            confmat = confmat / confmat.sum(dim=1, keepdim=True)
        elif normalize == "pred":
            confmat = confmat / confmat.sum(dim=0, keepdim=True)
        elif normalize == "all":
            confmat = confmat / confmat.sum()
        nan_mask = torch.isnan(confmat)
        if bool(nan_mask.any()):
            rank_zero_warn("nan values found in confusion matrix have been replaced with zeros.")
        confmat = confmat.masked_fill(nan_mask, 0.0)
    return confmat


def confusion_matrix(
    preds,
    target,
    num_classes: int,
    normalize: Optional[str] = None,
    threshold: float = 0.5,
    multilabel: bool = False,
) -> Tensor:
    """Confusion matrix ``(C, C)`` (or ``(C, 2, 2)`` for multilabel).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import confusion_matrix
        >>> target = torch.tensor([1, 1, 0, 0])
        >>> preds = torch.tensor([0, 1, 0, 0])
        >>> confusion_matrix(preds, target, num_classes=2)
        tensor([[2, 0],
                [1, 1]], dtype=torch.int32)
    """
    confmat = _confusion_matrix_update(preds, target, num_classes, threshold, multilabel)
    return _confusion_matrix_compute(confmat, normalize)


__all__ = ["confusion_matrix"]
