"""Area under the ROC curve: binary, multi-class, multi-label, and partial AUC.

JAX counterpart: `metrics_tpu/functional/classification/auroc.py` (the
layout transform `:21`, the update `:46`, the eager compute `:63`);
reference `src/torchmetrics/functional/classification/auroc.py:28-230`.

This is the eager path: a ROC curve per class, then its trapezoidal area.
Under a transform (``torch.func.vmap``, a CUDA-graph capture) the compute
takes the sort-based AUROC of :mod:`metrics_tpu_torch.ops.sorted_curves`, as
the JAX package does under ``jit``. The weighted average's class support
comes from ``_bincount``: the CUDA kernel on the card.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.auc import _auc_compute_without_check
from metrics_tpu_torch.functional.classification.roc import roc
from metrics_tpu_torch.utils.checks import _classification_case, _is_concrete
from metrics_tpu_torch.utils.data import _bincount
from metrics_tpu_torch.utils.enums import AverageMethod, DataType
from metrics_tpu_torch.utils.prints import rank_zero_warn


def _auroc_format(preds: Tensor, target: Tensor, mode: DataType) -> Tuple[Tensor, Tensor]:
    """The layout transform of ``mode`` alone: idempotent, and checks nothing.

    Binary rows of shapes ``(N,)`` and ``(M, 1)`` both become 1-D, so that
    buffered rows share their rank for the concatenation and the sync.
    """
    if mode == DataType.MULTIDIM_MULTICLASS:
        n_classes = preds.shape[1]
        preds = preds.transpose(0, 1).reshape(n_classes, -1).T
        target = target.reshape(-1)
    if mode == DataType.MULTILABEL and preds.ndim > 2:
        n_classes = preds.shape[1]
        preds = preds.transpose(0, 1).reshape(n_classes, -1).T
        target = target.transpose(0, 1).reshape(n_classes, -1).T
    if mode == DataType.BINARY:
        preds = preds.reshape(-1)
        target = target.reshape(-1)
    return preds, target


def _auroc_update(preds: Tensor, target: Tensor, format_tensors: bool = True) -> Tuple[Tensor, Tensor, DataType]:
    """Resolve the input case and, unless ``format_tensors`` is False, flatten the extra dims."""
    mode = _classification_case(preds, target)
    if format_tensors:
        preds, target = _auroc_format(preds, target, mode)
    return preds, target, mode


def _drop_unobserved_classes(preds: Tensor, target: Tensor, num_classes: int) -> Tuple[Tensor, Tensor, int]:
    """Multi-class weighted average: classes no target names leave the average, with a warning.

    The kept classes are renumbered in order, so each target becomes its
    class's rank among the observed ones.
    """
    observed = torch.zeros(num_classes, dtype=torch.bool, device=target.device)
    observed[torch.unique(target)] = True
    observed_host = observed.tolist()
    if all(observed_host):
        return preds, target, num_classes
    for c, seen in enumerate(observed_host):
        if not seen:
            rank_zero_warn(f"Class {c} had 0 observations, omitted from AUROC calculation", UserWarning)
    preds = preds[:, observed]
    target = (torch.cumsum(observed.to(torch.int64), dim=0) - 1)[target]
    num_classes = sum(observed_host)
    if num_classes == 1:
        raise ValueError("Found 1 non-empty class in `multiclass` AUROC calculation")
    return preds, target, num_classes


def _auroc_compute(
    preds: Tensor,
    target: Tensor,
    mode: DataType,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    average: Optional[str] = "macro",
    max_fpr: Optional[float] = None,
    sample_weights: Optional[Sequence] = None,
) -> Tensor:
    if mode == DataType.BINARY:
        num_classes = 1

    if not _is_concrete(preds, target):
        # under a transform (torch.func.vmap, a graph capture) the curve's length cannot depend on
        # the data: the exact AUROC is a scalar of a sort and midrank reductions, as JAX's traced path
        from metrics_tpu_torch.ops.sorted_curves import binary_auroc_sorted, multiclass_auroc_sorted

        if sample_weights is not None:
            raise ValueError("`sample_weights` are not supported for AUROC under a transform; compute eagerly")
        if max_fpr is not None:
            raise ValueError("`max_fpr` (partial AUC) is not supported for AUROC under a transform; compute eagerly")
        if mode == DataType.BINARY:
            pl = 1 if pos_label is None else pos_label
            # a single-class target: the eager path warns and returns 0.0, so the NaN maps to 0.0
            return torch.nan_to_num(binary_auroc_sorted(preds, target == pl), nan=0.0)
        if num_classes is None:
            raise ValueError("Detected multiclass/multilabel input but `num_classes` was not provided")
        if mode == DataType.MULTILABEL and average == AverageMethod.MICRO:
            return torch.nan_to_num(binary_auroc_sorted(preds.reshape(-1), target.reshape(-1)), nan=0.0)
        avg = "none" if average is None else getattr(average, "value", average)
        return multiclass_auroc_sorted(preds, target, num_classes, avg)

    if max_fpr is not None:
        if not isinstance(max_fpr, float) or not 0 < max_fpr <= 1:
            raise ValueError(f"`max_fpr` should be a float in range (0, 1], got: {max_fpr}")
        if mode != DataType.BINARY:
            raise ValueError(
                "Partial AUC computation not available in multilabel/multiclass setting,"
                f" 'max_fpr' must be set to `None`, received `{max_fpr}`."
            )

    if mode == DataType.MULTILABEL:
        if average == AverageMethod.MICRO:
            fpr, tpr, _ = roc(preds.reshape(-1), target.reshape(-1), 1, pos_label, sample_weights)
        elif num_classes:
            output = [
                roc(preds[:, i], target[:, i], num_classes=1, pos_label=1, sample_weights=sample_weights)
                for i in range(num_classes)
            ]
            fpr = [o[0] for o in output]
            tpr = [o[1] for o in output]
        else:
            raise ValueError("Detected input to be `multilabel` but you did not provide `num_classes` argument")
    else:
        if mode != DataType.BINARY:
            if num_classes is None:
                raise ValueError("Detected input to `multiclass` but you did not provide `num_classes` argument")
            if average == AverageMethod.WEIGHTED:
                preds, target, num_classes = _drop_unobserved_classes(preds, target, num_classes)
        fpr, tpr, _ = roc(preds, target, num_classes, pos_label, sample_weights)

    if max_fpr is None or max_fpr == 1:
        if mode == DataType.MULTILABEL and average == AverageMethod.MICRO:
            pass
        elif num_classes != 1:
            auc_scores = [_auc_compute_without_check(x, y, 1.0) for x, y in zip(fpr, tpr)]
            if average is None or average == AverageMethod.NONE:
                return torch.stack(auc_scores)
            if average == AverageMethod.MACRO:
                return torch.mean(torch.stack(auc_scores))
            if average == AverageMethod.WEIGHTED:
                if mode == DataType.MULTILABEL:
                    support = torch.sum(target, dim=0)
                else:
                    support = _bincount(target.reshape(-1), minlength=num_classes)
                return torch.sum(torch.stack(auc_scores) * support / support.sum())
            allowed_average = (AverageMethod.NONE.value, AverageMethod.MACRO.value, AverageMethod.WEIGHTED.value)
            raise ValueError(f"Argument `average` expected to be one of the following: {allowed_average} but got {average}")
        return _auc_compute_without_check(fpr, tpr, 1.0)

    # partial AUC with the McClish correction
    max_area = torch.tensor(max_fpr, dtype=torch.float32, device=fpr.device)
    stop = int(torch.searchsorted(fpr, max_area, right=True))
    # with no negative sample ``fpr`` is all zero and ``stop == len(fpr)``: the
    # upper read is clamped to the last point, as JAX's gather clamps, and the
    # interpolation gives NaN after roc's "No negative samples" warning
    hi = min(stop, fpr.shape[0] - 1)
    weight = (max_area - fpr[stop - 1]) / (fpr[hi] - fpr[stop - 1])
    interp_tpr = tpr[stop - 1] + weight * (tpr[hi] - tpr[stop - 1])
    tpr = torch.cat([tpr[:stop], interp_tpr.reshape(1)])
    fpr = torch.cat([fpr[:stop], max_area.reshape(1)])
    partial_auc = _auc_compute_without_check(fpr, tpr, 1.0)
    min_area = 0.5 * max_area**2
    return 0.5 * (1 + (partial_auc - min_area) / (max_area - min_area))


def auroc(
    preds: Tensor,
    target: Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    average: Optional[str] = "macro",
    max_fpr: Optional[float] = None,
    sample_weights: Optional[Sequence] = None,
) -> Tensor:
    """Area Under the ROC Curve.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import auroc
        >>> preds = torch.tensor([0.13, 0.26, 0.08, 0.19, 0.34])
        >>> target = torch.tensor([0, 0, 1, 1, 1])
        >>> auroc(preds, target, pos_label=1)
        tensor(0.5000)
    """
    preds, target, mode = _auroc_update(preds, target)
    return _auroc_compute(preds, target, mode, num_classes, pos_label, average, max_fpr, sample_weights)


__all__ = ["auroc"]
