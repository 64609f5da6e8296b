"""Multi-label ranking metrics: coverage error, LRAP and label ranking loss.

JAX counterpart: `metrics_tpu/functional/classification/ranking.py`
(``coverage_error`` `:50`, ``label_ranking_average_precision`` `:96`,
``label_ranking_loss`` `:141`); reference
`functional/classification/ranking.py:20-242`.

LRAP ranks every label of a row against every other with one (N, L, L)
compare, as JAX does, in blocks of rows so that a block of the compare
stays under 256 MiB (at ImageNet width, 1000 × 1000 labels a row, the
whole compare would hold 1 GB as booleans, 4 GB as the int32 a sum casts
them to). Its counts are integers, so the blocks give the same bits. The ranking loss sorts twice; both sorts are stable, as
``jnp.argsort`` is, so rows with tied scores get JAX's loss.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _check_same_shape

# bytes of one block of the compare, held as int16 counts (int32 above 32767 labels)
LRAP_BLOCK_BYTES = 256 * 2**20


def _check_ranking_input(preds: Tensor, target: Tensor, sample_weight: Optional[Tensor] = None) -> None:
    if preds.ndim != 2 or target.ndim != 2:
        raise ValueError(
            f"Expected both predictions and target to be 2 dimensional but got {preds.ndim} and {target.ndim}"
        )
    _check_same_shape(preds, target)
    if not preds.is_floating_point():
        raise ValueError("Expected `preds` to be floats")
    if sample_weight is not None and sample_weight.ndim != 1:
        raise ValueError("Expected sample weights to be 1 dimensional")


def _weighted_total(values: Tensor, sample_weight: Optional[Tensor]) -> Tuple[Tensor, int, Optional[Tensor]]:
    if sample_weight is not None:
        values = values * sample_weight
        return values.sum(), values.shape[0], sample_weight.sum()
    return values.sum(), values.shape[0], None


def _ranking_compute(measure: Tensor, n_elements, sample_weight: Optional[Tensor] = None) -> Tensor:
    if sample_weight is not None:
        return torch.where(
            sample_weight != 0.0,
            measure / torch.where(sample_weight != 0, sample_weight, 1.0),
            measure / n_elements,
        )
    return measure / n_elements


def _coverage_error_update(
    preds: Tensor, target: Tensor, sample_weight: Optional[Tensor] = None
) -> Tuple[Tensor, int, Optional[Tensor]]:
    _check_ranking_input(preds, target, sample_weight)
    big = torch.abs(preds.min()) + 10
    preds_mod = preds + torch.where(target == 0, big, 0.0)
    preds_min = preds_mod.min(dim=1).values
    coverage = (preds >= preds_min[:, None]).sum(dim=1, dtype=torch.int32).to(torch.float32)
    return _weighted_total(coverage, sample_weight)



def coverage_error(preds: Tensor, target: Tensor, sample_weight: Optional[Tensor] = None) -> Tensor:
    """How far down the ranking one must go to cover every relevant label.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import coverage_error
        >>> preds = torch.tensor([[0.8, 0.1, 0.5], [0.2, 0.9, 0.6]])
        >>> target = torch.tensor([[1, 0, 1], [0, 1, 0]])
        >>> coverage_error(preds, target)
        tensor(1.5000)
    """
    coverage, n_elements, sample_weight = _coverage_error_update(preds, target, sample_weight)
    return _ranking_compute(coverage, n_elements, sample_weight)


def _lrap_rank_counts(preds: Tensor, relevant: Tensor) -> Tuple[Tensor, Tensor]:
    """For every label: how many labels, and how many relevant ones, score at least as high.

    ``geq[i, j, k] = preds[i, k] >= preds[i, j]``, counted over k (the
    max-tie convention), built a block of rows at a time. A sum of booleans
    first copies them to its count type, so the block is made in the
    narrowest type that holds a row's count (int16 up to 32767 labels), and
    the AND with the relevant labels is a product in place.
    """
    n, n_labels = preds.shape
    count_dtype = torch.int16 if n_labels <= torch.iinfo(torch.int16).max else torch.int32
    rows = max(1, LRAP_BLOCK_BYTES // max(1, count_dtype.itemsize * n_labels * n_labels))
    relevant = relevant.to(count_dtype)
    rank_all, rank_rel = [], []
    for lo in range(0, n, rows):
        p = preds[lo : lo + rows]
        geq = (p[:, None, :] >= p[:, :, None]).to(count_dtype)
        rank_all.append(geq.sum(dim=-1, dtype=count_dtype))
        rank_rel.append(geq.mul_(relevant[lo : lo + rows, None, :]).sum(dim=-1, dtype=count_dtype))
        del geq  # freed before the next block is built: one block alive at a time
    if not rank_all:
        empty = torch.zeros((0, n_labels), dtype=torch.int32, device=preds.device)
        return empty, empty
    return torch.cat(rank_all).to(torch.int32), torch.cat(rank_rel).to(torch.int32)


def _label_ranking_average_precision_update(
    preds: Tensor, target: Tensor, sample_weight: Optional[Tensor] = None
) -> Tuple[Tensor, int, Optional[Tensor]]:
    _check_ranking_input(preds, target, sample_weight)
    n_labels = preds.shape[1]
    relevant = target == 1
    rank_all, rank_rel = _lrap_rank_counts(preds, relevant)
    rank_all, rank_rel = rank_all.to(torch.float32), rank_rel.to(torch.float32)

    n_rel = relevant.sum(dim=1, dtype=torch.int32)
    per_label = torch.where(relevant, rank_rel / rank_all, 0.0)
    score_i = per_label.sum(dim=1) / torch.where(n_rel == 0, 1, n_rel)
    # a row whose labels are all, or none, relevant scores 1.0 (reference `:121-124`)
    score_i = torch.where((n_rel == 0) | (n_rel == n_labels), 1.0, score_i)
    return _weighted_total(score_i, sample_weight)



def label_ranking_average_precision(preds: Tensor, target: Tensor, sample_weight: Optional[Tensor] = None) -> Tensor:
    """The mean, over relevant labels, of (rank among relevant labels / rank among all).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import label_ranking_average_precision
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.80, 0.90]])
        >>> target = torch.tensor([[1, 0, 0], [0, 0, 1]])
        >>> label_ranking_average_precision(preds, target)
        tensor(1.)
    """
    score, n_elements, sample_weight = _label_ranking_average_precision_update(preds, target, sample_weight)
    return _ranking_compute(score, n_elements, sample_weight)


def _label_ranking_loss_update(
    preds: Tensor, target: Tensor, sample_weight: Optional[Tensor] = None
) -> Tuple[Tensor, int, Optional[Tensor]]:
    _check_ranking_input(preds, target, sample_weight)
    n_labels = preds.shape[1]
    relevant = target == 1
    n_relevant = relevant.sum(dim=1)

    # rows with no or every label relevant add no loss (masked, not dropped)
    valid = (n_relevant > 0) & (n_relevant < n_labels)

    inverse = torch.argsort(torch.argsort(preds, dim=1, stable=True), dim=1, stable=True)
    per_label_loss = ((n_labels - inverse) * relevant).to(torch.float32)
    correction = 0.5 * n_relevant * (n_relevant + 1)
    denom = n_relevant * (n_labels - n_relevant)
    loss = (per_label_loss.sum(dim=1) - correction) / torch.where(valid, denom, 1)
    loss = torch.where(valid, loss, 0.0)
    return _weighted_total(loss, sample_weight)



def label_ranking_loss(preds: Tensor, target: Tensor, sample_weight: Optional[Tensor] = None) -> Tensor:
    """The mean share of label pairs ranked the wrong way round.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import label_ranking_loss
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.80, 0.90]])
        >>> target = torch.tensor([[1, 0, 0], [0, 0, 1]])
        >>> label_ranking_loss(preds, target)
        tensor(0.)
    """
    loss, n_elements, sample_weight = _label_ranking_loss_update(preds, target, sample_weight)
    return _ranking_compute(loss, n_elements, sample_weight)


__all__ = ["coverage_error", "label_ranking_average_precision", "label_ranking_loss"]
