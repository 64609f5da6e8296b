"""True/false positive/negative counts, the workhorse of the classification domain.

JAX counterpart: `metrics_tpu/functional/classification/stat_scores.py`
(reference `functional/classification/stat_scores.py`). As there,
contributions are computed elementwise and reduced with masked sums:
``ignore_index`` becomes a class-column mask and a negative ``ignore_index`` a
sample mask, so every shape is static and no count is read on the host.
Counts stay int32, as in the JAX package (torch's ``sum`` would widen them).

Multi-class inputs reduced ``micro`` or ``macro`` over every position (no
top-k above 1, ``mdmc_reduce`` None or ``global``) skip the one-hot where its
histogram pays: every count is a function of the histogram ``M`` of
``(target, pred)`` class pairs, one pass of the bincount
(:func:`_stat_scores_from_ids`). The integers are those of the one-hot's
products.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.ops import telemetry as _telemetry
from metrics_tpu_torch.utils.checks import (
    ClassIds,
    _canonical_form,
    _class_count,
    _class_id_form,
    _takes_class_ids,
    _validated_classification,
)
from metrics_tpu_torch.utils.data import _bincount
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


_MAX_PAIR_BINS = 2**31 - 1  # the bincount's most bins


def _pair_histogram_pays(n_cls: int, positions: int) -> bool:
    """Whether the ``(C + 1)**2`` class-pair histogram of a batch of ``positions`` positions costs no more
    than the one-hot form, whose sides hold ``positions * C`` entries each."""
    return (n_cls + 1) ** 2 <= min(positions * n_cls, _MAX_PAIR_BINS)


def _stat_scores_from_ids(
    ids: ClassIds,
    reduce: Optional[str],
    ignored_class: Optional[int] = None,
    sample_mask: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """tp/fp/tn/fn of ``micro`` or ``macro`` over every position, from class ids.

    ``M[t, p]`` counts the positions of target class ``t`` and predicted class
    ``p``, over ``C + 1`` classes: id ``C`` is a label outside ``[0, C)``, which
    the one-hot leaves out of every class. For a class ``c < C``: tp = M[c, c],
    fp = colsum - M[c, c], fn = rowsum - M[c, c], tn = total - rowsum - colsum
    + M[c, c]. ``sample_mask`` sends left-out positions outside the bins;
    ``ignored_class`` leaves that class out of the micro sums.
    """
    n_cls = ids.num_classes
    pairs = torch.add(ids.preds, ids.target, alpha=n_cls + 1)  # t * (C + 1) + p
    if sample_mask is not None:
        pairs = torch.where(sample_mask.reshape(pairs.shape), pairs, -1)
    hist = _bincount(pairs, (n_cls + 1) ** 2).reshape(n_cls + 1, n_cls + 1)
    both = hist.diagonal()[:n_cls].clone()
    in_target = hist.sum(dim=1, dtype=torch.int32)[:n_cls]
    in_preds = hist.sum(dim=0, dtype=torch.int32)[:n_cls]
    total = hist.sum(dtype=torch.int32)
    counts = (both, in_preds - both, total - in_target - in_preds + both, in_target - both)
    if reduce != "micro":
        return counts
    if ignored_class is not None:
        kept = torch.ones(n_cls, dtype=torch.bool, device=hist.device)
        kept[ignored_class] = False
        counts = tuple(x * kept for x in counts)
    return tuple(x.sum(dtype=torch.int32) for x in counts)


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
    """Canonicalise inputs and compute tp/fp/tn/fn (reference `:110-193`).

    Multi-class inputs reduced over every position take the class ids
    (:func:`_stat_scores_from_ids`) where their histogram pays
    (:func:`_pair_histogram_pays`), any other input the one-hot.
    """
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

    preds, target, case, stats = _validated_classification(
        preds, target, threshold, top_k, num_classes, multiclass, ignore_index
    )
    ids = None
    if reduce in ("micro", "macro") and mdmc_reduce in (None, "global") and _takes_class_ids(
        preds, target, case, top_k, multiclass
    ):
        num_classes, stats = _class_count(preds, target, num_classes, stats)
        if _pair_histogram_pays(num_classes, target.numel()):
            # a label outside [0, C) takes the spare id C: the one-hot leaves it out of every class
            ids = _class_id_form(preds, target, num_classes, stats, outside=num_classes)
    if ids is None:
        preds, target, _ = _canonical_form(preds, target, case, threshold, top_k, num_classes, multiclass, stats)

    if ignore_index is not None:
        n_cls = preds.shape[1] if ids is None else ids.num_classes
        if ignore_index >= n_cls:
            raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {n_cls} classes")
        if n_cls == 1:
            raise ValueError("You can not use `ignore_index` with binary data.")

    if ids is None:
        tp, fp, tn, fn = _stat_scores_onehot(preds, target, reduce, mdmc_reduce, ignore_index, sample_mask)
    else:
        if ids.preds.ndim == 2 and not mdmc_reduce:
            raise ValueError(
                "When your inputs are multi-dimensional multi-class, you have to set the `mdmc_reduce` parameter"
            )
        with _telemetry.trace_range("stat-scores"):
            ignored_class = ignore_index if ignore_index is not None and ignore_index >= 0 else None
            tp, fp, tn, fn = _stat_scores_from_ids(ids, reduce, ignored_class, sample_mask)

    if ignore_index is not None and ignore_index >= 0 and reduce == "macro":
        # flag the ignored class with -1 so downstream reduces skip it (reference `:186-191`)
        for x in (tp, fp, tn, fn):
            x[..., ignore_index] = -1

    return tp, fp, tn, fn


@_telemetry.ranged("stat-scores")
def _stat_scores_onehot(
    preds: Tensor,
    target: Tensor,
    reduce: Optional[str],
    mdmc_reduce: Optional[str],
    ignore_index: Optional[int],
    sample_mask: Optional[Tensor],
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """tp/fp/tn/fn from the one-hot form ``(N, C)`` / ``(N, C, X)`` of both sides."""
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

    return _stat_scores(preds, target, reduce=reduce, class_mask=class_mask, sample_mask=sample_mask)


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


__all__ = [
    "stat_scores",
    "_stat_scores",
    "_stat_scores_from_ids",
    "_stat_scores_onehot",
    "_stat_scores_update",
    "_stat_scores_compute",
    "_reduce_stat_scores",
]
