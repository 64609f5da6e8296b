"""Retrieval metrics of one query's ``(preds, target)`` rows.

JAX counterpart: `metrics_tpu/functional/retrieval/kernels.py:45-288`
(reference `functional/retrieval/*.py`). Each function scores one query;
the module metrics of :mod:`metrics_tpu_torch.retrieval` score every query
of a stream at once. Documents are ranked by a stable descending sort of
the scores, as in JAX, so tied scores keep their input order; relevance is
binarised with ``> 0`` where JAX binarises it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _is_integer_dtype, _should_value_check


def _check_retrieval_functional_inputs(preds, target, allow_non_binary_target: bool = False) -> Tuple[Tensor, Tensor]:
    preds = torch.as_tensor(preds)
    t = torch.as_tensor(target, device=preds.device)
    if preds.shape != t.shape or preds.ndim != 1:
        raise ValueError("`preds` and `target` must be of the same shape and 1 dimensional")
    if not preds.is_floating_point():
        raise ValueError("`preds` must be a tensor of floats")
    if not (_is_integer_dtype(t.dtype) or t.dtype == torch.bool or t.is_floating_point()):
        raise ValueError("`target` must be a tensor of booleans, integers or floats")
    # float relevance is allowed: "binary" bounds the values to [0, 1], not the dtype.
    # The check reads the device once, when the validation mode asks for it
    if (
        not allow_non_binary_target
        and t.numel()
        and _should_value_check(preds, t, key_extra=("retrieval-functional",))
    ):
        tmin, tmax = torch.stack([t.min().to(torch.float32), t.max().to(torch.float32)]).tolist()
        if tmax > 1 or tmin < 0:
            raise ValueError("`target` must contain binary values")
    return preds.to(torch.float32), t


def _descending_order(preds: Tensor) -> Tensor:
    """A stable descending order of the scores, with JAX's sort semantics.

    The key is the negated score with every NaN made one positive NaN and
    ``-0.0`` made ``+0.0``, as ``jnp.sort`` canonicalises them: NaN scores
    go last, in input order, and ``±0.0`` tie, on the CPU's comparison sort
    and on the card's radix sort alike.
    """
    key = torch.where(torch.isnan(preds), float("nan"), -preds + 0.0)
    return torch.argsort(key, stable=True)


def _ranked(preds: Tensor, target: Tensor) -> Tensor:
    """The targets in descending score order, tied scores in input order."""
    return target[_descending_order(preds)]


def _resolve_k(n: int, k: Optional[int]) -> int:
    if k is None:
        return n
    if not isinstance(k, int) or k <= 0:
        raise ValueError("`k` has to be a positive integer or None")
    return min(k, n)


def retrieval_average_precision(preds: Tensor, target: Tensor) -> Tensor:
    """Average precision of one query: the mean of (hits so far / rank) at its relevant rows.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import retrieval_average_precision
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([True, False, True])
        >>> retrieval_average_precision(preds, target)
        tensor(0.8333)
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    # binarised with > 0: a fractional float relevance counts as a hit, not as a weight
    rel = (_ranked(preds, target) > 0).to(torch.float32)
    ranks = torch.arange(1, rel.shape[0] + 1, dtype=torch.float32, device=rel.device)
    precision_at_i = torch.cumsum(rel, dim=0) / ranks
    denom = torch.clamp(rel.sum(), min=1.0)
    return torch.where(rel.sum() > 0, (precision_at_i * rel).sum() / denom, 0.0)


def retrieval_reciprocal_rank(preds: Tensor, target: Tensor) -> Tensor:
    """1 / the rank of the first relevant document.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import retrieval_reciprocal_rank
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([False, True, False])
        >>> retrieval_reciprocal_rank(preds, target)
        tensor(0.5000)
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    rel = _ranked(preds, target).to(torch.float32)
    ranks = torch.arange(1, rel.shape[0] + 1, dtype=torch.float32, device=rel.device)
    first = torch.min(torch.where(rel > 0, ranks, float("inf")))
    return torch.where(torch.isfinite(first), 1.0 / first, 0.0)


def retrieval_precision(preds: Tensor, target: Tensor, k: Optional[int] = None, adaptive_k: bool = False) -> Tensor:
    """Relevant documents among the top k, divided by k itself.

    Only ``min(k, n)`` documents are examined, but the divisor stays ``k``
    unless ``adaptive_k`` caps it at the number of documents.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import retrieval_precision
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([True, False, True])
        >>> retrieval_precision(preds, target, k=2)
        tensor(0.5000)
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    if not isinstance(adaptive_k, bool):
        raise ValueError("`adaptive_k` has to be a boolean")
    n = preds.shape[0]
    if k is None or (adaptive_k and k > n):
        k = n
    if not (isinstance(k, int) and k > 0):
        raise ValueError("`k` has to be a positive integer or None")
    rel = _ranked(preds, target).to(torch.float32)
    return rel[: min(k, n)].sum() / k


def retrieval_recall(preds: Tensor, target: Tensor, k: Optional[int] = None) -> Tensor:
    """Share of the relevant documents found in the top k.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import retrieval_recall
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([True, False, True])
        >>> retrieval_recall(preds, target, k=2)
        tensor(0.5000)
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    kk = _resolve_k(preds.shape[0], k)
    rel = _ranked(preds, target).to(torch.float32)
    total = rel.sum()
    return torch.where(total > 0, rel[:kk].sum() / torch.clamp(total, min=1.0), 0.0)


def retrieval_fall_out(preds: Tensor, target: Tensor, k: Optional[int] = None) -> Tensor:
    """Share of the non-relevant documents retrieved in the top k.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import retrieval_fall_out
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([True, False, True])
        >>> retrieval_fall_out(preds, target, k=2)
        tensor(1.)
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    kk = _resolve_k(preds.shape[0], k)
    nonrel = 1.0 - _ranked(preds, target).to(torch.float32)
    total = nonrel.sum()
    return torch.where(total > 0, nonrel[:kk].sum() / torch.clamp(total, min=1.0), 0.0)


def retrieval_hit_rate(preds: Tensor, target: Tensor, k: Optional[int] = None) -> Tensor:
    """1.0 if a relevant document is in the top k, else 0.0.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import retrieval_hit_rate
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([True, False, True])
        >>> retrieval_hit_rate(preds, target, k=2)
        tensor(1.)
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    kk = _resolve_k(preds.shape[0], k)
    rel = _ranked(preds, target).to(torch.float32)
    return (rel[:kk].sum() > 0).to(torch.float32)


def retrieval_r_precision(preds: Tensor, target: Tensor) -> Tensor:
    """Precision at R, where R is the number of relevant documents.

    Graded float relevance is binarised with ``> 0`` for both R and the hits,
    as in JAX (the reference fails on float targets here).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import retrieval_r_precision
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([True, False, True])
        >>> retrieval_r_precision(preds, target)
        tensor(0.5000)
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    rel = (_ranked(preds, target) > 0).to(torch.float32)
    r = rel.sum().to(torch.int32)
    mask = torch.arange(rel.shape[0], device=rel.device) < r
    return torch.where(r > 0, (rel * mask).sum() / torch.clamp(r, min=1), 0.0)


def _dcg(ranked_gains: Tensor) -> Tensor:
    positions = torch.arange(2, ranked_gains.shape[0] + 2, dtype=torch.float32, device=ranked_gains.device)
    return (ranked_gains * (1.0 / torch.log2(positions))).sum()


def retrieval_normalized_dcg(preds: Tensor, target: Tensor, k: Optional[int] = None) -> Tensor:
    """NDCG at k with the log2 discount; the target may hold graded gains.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import retrieval_normalized_dcg
        >>> preds = torch.tensor([0.1, 0.2, 0.3, 4.0, 70.0])
        >>> target = torch.tensor([10, 0, 0, 1, 5])
        >>> retrieval_normalized_dcg(preds, target)
        tensor(0.6957)
    """
    preds, target = _check_retrieval_functional_inputs(preds, target, allow_non_binary_target=True)
    kk = _resolve_k(preds.shape[0], k)
    gains = _ranked(preds, target).to(torch.float32)[:kk]
    ideal_gains = torch.sort(target.to(torch.float32), descending=True).values[:kk]
    dcg = _dcg(gains)
    idcg = _dcg(ideal_gains)
    return torch.where(idcg > 0, dcg / torch.clamp(idcg, min=1e-12), 0.0)


def retrieval_precision_recall_curve(
    preds: Tensor, target: Tensor, max_k: Optional[int] = None, adaptive_k: bool = False
) -> Tuple[Tensor, Tensor, Tensor]:
    """(precision at k, recall at k, k) for k = 1 … ``max_k``.

    The output always has ``max_k`` entries: past the number of documents the
    hits stay flat, so precision decays as hits / k, unless ``adaptive_k``
    caps the divisor (and the reported k) at the number of documents.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import retrieval_precision_recall_curve
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([True, False, True])
        >>> precisions, recalls, top_k = retrieval_precision_recall_curve(preds, target, max_k=2)
        >>> precisions
        tensor([1.0000, 0.5000])
        >>> recalls
        tensor([0.5000, 0.5000])
        >>> top_k
        tensor([1, 2], dtype=torch.int32)
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    n = preds.shape[0]
    if not isinstance(adaptive_k, bool):
        raise ValueError("`adaptive_k` has to be a boolean")
    if max_k is None:
        max_k = n
    if not isinstance(max_k, int) or max_k <= 0:
        raise ValueError("`max_k` has to be a positive integer or None")

    topk = torch.arange(1, max_k + 1, dtype=torch.int32, device=preds.device)
    if adaptive_k and max_k > n:
        topk = torch.clamp(topk, max=n)

    rel = _ranked(preds, target).to(torch.float32)[: min(max_k, n)]
    rel = torch.cat([rel, rel.new_zeros(max(0, max_k - n))])
    cum_rel = torch.cumsum(rel, dim=0)
    precision = cum_rel / topk.to(torch.float32)
    total = target.to(torch.float32).sum()
    recall = torch.where(total > 0, cum_rel / torch.clamp(total, min=1.0), torch.zeros_like(cum_rel))
    precision = torch.where(total > 0, precision, torch.zeros_like(precision))
    return precision, recall, topk


__all__ = [
    "retrieval_average_precision",
    "retrieval_fall_out",
    "retrieval_hit_rate",
    "retrieval_normalized_dcg",
    "retrieval_precision",
    "retrieval_precision_recall_curve",
    "retrieval_r_precision",
    "retrieval_recall",
    "retrieval_reciprocal_rank",
]
