"""Confusion matrix: a bincount over label pairs.

JAX counterpart: `metrics_tpu/functional/classification/confusion_matrix.py`
(reference `functional/classification/confusion_matrix.py:25-120`). The pair
histogram goes through :func:`metrics_tpu_torch.utils.data._bincount`, which
on the card is the CUDA kernel of ``ops/histogram.py``. Non-empty multi-class
inputs give their class ids straight (``utils/checks._class_id_form``): the
labels the one-hot's arg-max would give, without the one-hot.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from metrics_tpu_torch.ops import telemetry as _telemetry
from metrics_tpu_torch.utils.checks import (
    _canonical_form,
    _check_broadcastable,
    _class_count,
    _class_id_form,
    _is_concrete,
    _takes_class_ids,
    _validated_classification,
)
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
    preds, target, case, stats = _validated_classification(preds, target, threshold, None, pass_nc, None, None)
    if _takes_class_ids(preds, target, case):
        # a label outside the classes takes class 0, as the one-hot's arg-max does
        n_cls, stats = _class_count(preds, target, pass_nc, stats)
        preds, target, _ = _class_id_form(preds, target, n_cls, stats, outside=0)
    else:
        preds, target, mode = _canonical_form(preds, target, case, threshold, None, pass_nc, None, stats)
        if mode not in (DataType.BINARY, DataType.MULTILABEL):  # an empty multi-class batch
            with _telemetry.trace_range("canonicalize"):
                preds = preds.argmax(dim=1)
                target = target.argmax(dim=1)
    if multilabel:
        offsets = 4 * torch.arange(num_classes, device=preds.device)
        # inputs that are not (N, C) multilabel: raise JAX's exception type
        _check_broadcastable(tuple(preds.shape), tuple(offsets.shape))
        unique_mapping = ((2 * target + preds) + offsets).reshape(-1)
        return _bincount(unique_mapping, minlength=4 * num_classes).reshape(num_classes, 2, 2)
    unique_mapping = torch.add(preds.reshape(-1), target.reshape(-1), alpha=num_classes)  # target * C + pred
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
        if _is_concrete(confmat) and bool(nan_mask.any()):  # under a transform JAX skips the warning too
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
