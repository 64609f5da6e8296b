"""True/false positive/negative counts, the workhorse of the classification domain.

JAX counterpart: `metrics_tpu/functional/classification/stat_scores.py`
(reference `functional/classification/stat_scores.py`). As there,
contributions are computed elementwise and reduced with masked sums:
``ignore_index`` becomes a class-column mask and a negative ``ignore_index`` a
sample mask, so every shape is static and no count is read on the host.
Counts stay int32, as in the JAX package (torch's ``sum`` would widen them).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _input_format_classification
from metrics_tpu_torch.utils.enums import AverageMethod, DataType, MDMCAverageMethod


def _stat_scores(
    preds: Tensor,
    target: Tensor,
    reduce: Optional[str] = "micro",
    class_mask: Optional[Tensor] = None,
    sample_mask: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """tp/fp/tn/fn from canonical binary ``(N, C)`` / ``(N, C, X)`` tensors.

    Output shapes per reduce mode (reference `stat_scores.py:76-92`): micro ->
    scalar / ``(N,)``; macro -> ``(C,)`` / ``(N, C)``; samples -> ``(N,)`` /
    ``(N, X)``. ``class_mask``: bool ``(C,)``, classes left out of micro and
    samples sums. ``sample_mask``: bool ``(N,)`` or ``(N, X)``, samples left out.
    """
    p = preds.to(torch.int32)
    t = target.to(torch.int32)

    tp_e = p * t
    fp_e = p * (1 - t)
    tn_e = (1 - p) * (1 - t)
    fn_e = (1 - p) * t

    def _mask(x: Tensor) -> Tensor:
        if class_mask is not None:
            x = x * class_mask.to(torch.int32).reshape((1, -1) + (1,) * (x.ndim - 2))
        if sample_mask is not None:
            if sample_mask.ndim == 1:  # per sample (N,)
                x = x * sample_mask.to(torch.int32).reshape((-1,) + (1,) * (x.ndim - 1))
            else:  # per position (N, X) on (N, C, X) contributions
                x = x * sample_mask.to(torch.int32)[:, None, :]
        return x

    tp_e, fp_e, tn_e, fn_e = _mask(tp_e), _mask(fp_e), _mask(tn_e), _mask(fn_e)

    if preds.ndim < 2:
        # an empty batch leaves the inputs unformatted, with no class dim: jnp raises ValueError there
        raise ValueError(f"axis 1 is out of bounds for array of dimension {preds.ndim}")
    if reduce == "micro":
        dim = (0, 1) if preds.ndim == 2 else (1, 2)
    elif reduce == "macro":
        dim = 0 if preds.ndim == 2 else 2
    else:  # "samples"
        dim = 1

    return tuple(x.sum(dim=dim, dtype=torch.int32) for x in (tp_e, fp_e, tn_e, fn_e))


def _stat_scores_update(
    preds,
    target,
    reduce: Optional[str] = "micro",
    mdmc_reduce: Optional[str] = None,
    num_classes: Optional[int] = None,
    top_k: Optional[int] = None,
    threshold: float = 0.5,
    multiclass: Optional[bool] = None,
    ignore_index: Optional[int] = None,
    mode: Optional[DataType] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Canonicalise inputs and compute tp/fp/tn/fn (reference `:110-193`)."""
    sample_mask = None
    if ignore_index is not None and ignore_index < 0:
        # negative ignore label: mask those target positions out entirely
        # (the static-shape form of the reference's row dropping `:28-60`)
        target = torch.as_tensor(target)
        ignored = target == ignore_index
        sample_mask = (~ignored).reshape(target.shape[0], -1)
        if sample_mask.shape[1] == 1:
            sample_mask = sample_mask[:, 0]  # (N,) for flat targets
        target = target.masked_fill(ignored, 0)

    preds, target, _ = _input_format_classification(
        preds,
        target,
        threshold=threshold,
        num_classes=num_classes,
        multiclass=multiclass,
        top_k=top_k,
        ignore_index=ignore_index,
    )

    if ignore_index is not None and ignore_index >= preds.shape[1]:
        raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {preds.shape[1]} classes")
    if ignore_index is not None and preds.shape[1] == 1:
        raise ValueError("You can not use `ignore_index` with binary data.")

    if preds.ndim == 3:
        if not mdmc_reduce:
            raise ValueError(
                "When your inputs are multi-dimensional multi-class, you have to set the `mdmc_reduce` parameter"
            )
        if mdmc_reduce == "global":
            # (N, C, X) -> (N*X, C); the position mask flattens alongside
            n_cls = preds.shape[1]
            preds = preds.movedim(1, 2).reshape(-1, n_cls)
            target = target.movedim(1, 2).reshape(-1, n_cls)
            if sample_mask is not None:
                sample_mask = sample_mask.reshape(-1)

    class_mask = None
    if ignore_index is not None and ignore_index >= 0 and reduce != "macro":
        class_mask = torch.ones(preds.shape[1], dtype=torch.bool, device=preds.device)
        class_mask[ignore_index] = False

    tp, fp, tn, fn = _stat_scores(preds, target, reduce=reduce, class_mask=class_mask, sample_mask=sample_mask)

    if ignore_index is not None and ignore_index >= 0 and reduce == "macro":
        # flag the ignored class with -1 so downstream reduces skip it (reference `:186-191`)
        for x in (tp, fp, tn, fn):
            x[..., ignore_index] = -1

    return tp, fp, tn, fn


def _stat_scores_compute(tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor) -> Tensor:
    """Stack [tp, fp, tn, fn, support] along the last axis (reference `:196-228`)."""
    out = torch.stack([tp, fp, tn, fn, tp + fn], dim=-1)
    return out.masked_fill(out < 0, -1)


def _reduce_stat_scores(
    numerator: Tensor,
    denominator: Tensor,
    weights: Optional[Tensor],
    average: Optional[str],
    mdmc_average: Optional[str],
    zero_division: int = 0,
) -> Tensor:
    """Combine per-class/sample scores ``numerator/denominator`` (reference `:231-289`).

    Negative denominators flag ignored classes; zero denominators score as
    ``zero_division``.
    """
    numerator = numerator.to(torch.float32)
    denominator = denominator.to(torch.float32)
    zero_div_mask = denominator == 0
    ignore_mask = denominator < 0

    weights = torch.ones_like(denominator) if weights is None else weights.to(torch.float32)

    numerator = torch.where(zero_div_mask, float(zero_division), numerator)
    denominator = torch.where(zero_div_mask | ignore_mask, 1.0, denominator)
    weights = torch.where(ignore_mask, 0.0, weights)

    if average not in (AverageMethod.MICRO, AverageMethod.NONE, None):
        weights = weights / weights.sum(dim=-1, keepdim=True)

    scores = weights * (numerator / denominator)
    scores = torch.where(torch.isnan(scores), float(zero_division), scores)

    if mdmc_average == MDMCAverageMethod.SAMPLEWISE:
        scores = scores.mean(dim=0)
        ignore_mask = ignore_mask.sum(dim=0).bool()

    if average in (AverageMethod.NONE, None):
        return torch.where(ignore_mask, float("nan"), scores)
    return scores.sum()


def stat_scores(
    preds,
    target,
    reduce: str = "micro",
    mdmc_reduce: Optional[str] = None,
    num_classes: Optional[int] = None,
    top_k: Optional[int] = None,
    threshold: float = 0.5,
    multiclass: Optional[bool] = None,
    ignore_index: Optional[int] = None,
) -> Tensor:
    """Number of tp/fp/tn/fn (and support) per the selected reduction.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import stat_scores
        >>> preds  = torch.tensor([1, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> stat_scores(preds, target, reduce='micro')
        tensor([2, 2, 6, 2, 4], dtype=torch.int32)
    """
    if reduce not in ("micro", "macro", "samples"):
        raise ValueError(f"The `reduce` {reduce} is not valid.")
    if mdmc_reduce not in (None, "samplewise", "global"):
        raise ValueError(f"The `mdmc_reduce` {mdmc_reduce} is not valid.")
    if reduce == "macro" and (not num_classes or num_classes < 1):
        raise ValueError("When you set `reduce` as 'macro', you have to provide the number of classes.")
    if num_classes and ignore_index is not None and (not ignore_index < num_classes or num_classes == 1):
        raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {num_classes} classes")

    tp, fp, tn, fn = _stat_scores_update(
        preds,
        target,
        reduce=reduce,
        mdmc_reduce=mdmc_reduce,
        num_classes=num_classes,
        top_k=top_k,
        threshold=threshold,
        multiclass=multiclass,
        ignore_index=ignore_index,
    )
    return _stat_scores_compute(tp, fp, tn, fn)


__all__ = ["stat_scores", "_stat_scores", "_stat_scores_update", "_stat_scores_compute", "_reduce_stat_scores"]
