"""Hinge loss: binary, Crammer-Singer multi-class and one-vs-all.

JAX counterpart: `metrics_tpu/functional/classification/hinge.py:42-104`
(reference `functional/classification/hinge.py:75-155`). The margins come
from masked selects over the one-hot target, as in JAX, not from boolean
indexing.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _input_squeeze
from metrics_tpu_torch.utils.data import to_onehot
from metrics_tpu_torch.utils.enums import DataType, EnumStr


class MulticlassMode(EnumStr):
    """How a multi-class hinge loss takes its margin.

    Example:
        >>> from metrics_tpu_torch.functional.classification.hinge import MulticlassMode
        >>> MulticlassMode.from_str("one-vs-all") == MulticlassMode.ONE_VS_ALL
        True
    """

    CRAMMER_SINGER = "crammer-singer"
    ONE_VS_ALL = "one-vs-all"


def _check_shape_and_type_consistency_hinge(preds: Tensor, target: Tensor) -> DataType:
    if target.ndim > 1:
        raise ValueError(f"The `target` should be one dimensional, got `target` with shape={target.shape}.")
    if preds.ndim == 1:
        if preds.shape != target.shape:
            raise ValueError("The `preds` and `target` should have the same shape,")
        if not preds.is_floating_point():
            raise ValueError("The `preds` should be floats.")
        return DataType.BINARY
    if preds.ndim == 2:
        if preds.shape[0] != target.shape[0]:
            raise ValueError("The `preds` and `target` should have the same shape in the first dimension,")
        if not preds.is_floating_point():
            raise ValueError("The `preds` should be floats.")
        return DataType.MULTICLASS
    raise ValueError(f"The `preds` should be one or two dimensional, got `preds` with shape={preds.shape}.")


def _hinge_update(
    preds,
    target,
    squared: bool = False,
    multiclass_mode: Optional[Union[str, MulticlassMode]] = None,
) -> Tuple[Tensor, Tensor]:
    """The summed hinge measure of the batch and its int32 row count."""
    preds, target = _input_squeeze(preds, target)
    mode = _check_shape_and_type_consistency_hinge(preds, target)

    if mode == DataType.MULTICLASS:
        target_oh = to_onehot(target, max(2, preds.shape[1])).bool()

    if mode == DataType.MULTICLASS and (multiclass_mode is None or multiclass_mode == MulticlassMode.CRAMMER_SINGER):
        # margin: the true class's score less the best other class's
        true_score = torch.where(target_oh, preds, 0.0).sum(dim=1)
        other_max = torch.where(target_oh, float("-inf"), preds).max(dim=1).values
        margin = true_score - other_max
    elif mode == DataType.BINARY or multiclass_mode == MulticlassMode.ONE_VS_ALL:
        t = target.bool() if mode == DataType.BINARY else target_oh
        margin = torch.where(t, preds, -preds)
    else:
        raise ValueError(
            "The `multiclass_mode` should be either None / 'crammer-singer' / MulticlassMode.CRAMMER_SINGER"
            "(default) or 'one-vs-all' / MulticlassMode.ONE_VS_ALL,"
            f" got {multiclass_mode}."
        )

    measures = torch.clamp(1 - margin, min=0)
    if squared:
        measures = measures**2
    total = torch.tensor(target.shape[0], dtype=torch.int32, device=preds.device)
    return measures.sum(dim=0), total


def _hinge_compute(measure: Tensor, total: Tensor) -> Tensor:
    return measure / total


def hinge_loss(
    preds,
    target,
    squared: bool = False,
    multiclass_mode: Optional[Union[str, MulticlassMode]] = None,
) -> Tensor:
    """Mean hinge loss: one value for binary input, one a class for one-vs-all.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import hinge_loss
        >>> target = torch.tensor([0, 1, 1])
        >>> preds = torch.tensor([-2.2, 2.4, 0.1])
        >>> hinge_loss(preds, target)
        tensor(0.3000)
    """
    measure, total = _hinge_update(preds, target, squared=squared, multiclass_mode=multiclass_mode)
    return _hinge_compute(measure, total)


__all__ = ["hinge_loss", "MulticlassMode"]
