"""Correlations: Pearson (streaming, with the merge of several streams), Spearman and cosine.

JAX counterpart: `metrics_tpu/functional/regression/correlation.py`
(Pearson's streaming update `:21-45`, the merge ``_pearson_final_aggregation``
`:56`, here ``_pearson_merge``, which also gives the merged means, and
``_rank_data`` `:106`); reference
`functional/regression/{pearson,spearman,cosine_similarity}.py`.

Spearman's average-tie ranks come from one sort: its permutation places
each value, and the boundaries of the runs of equal sorted values give each
run its average position. NaN sorts last and all NaNs form one run, so the
ranks equal JAX's two ``searchsorted`` passes on every input, NaN included.
The ranks are float32: above 2**23 rows an average of two integer positions
is no longer exact, in either package.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _check_same_shape, _is_concrete
from metrics_tpu_torch.utils.compute import _l2_norm


# ----------------------------------------------------------------- pearson
def _pearson_corrcoef_update(
    preds: Tensor,
    target: Tensor,
    mean_x: Tensor,
    mean_y: Tensor,
    var_x: Tensor,
    var_y: Tensor,
    corr_xy: Tensor,
    n_prior: Tensor,
) -> Tuple[Tensor, ...]:
    """One step of the streaming moments (reference `pearson.py:20-60`)."""
    _check_same_shape(preds, target)
    preds = torch.squeeze(preds).to(torch.float32)
    target = torch.squeeze(target).to(torch.float32)
    if preds.ndim > 1 or target.ndim > 1:
        raise ValueError("Expected both predictions and target to be 1 dimensional tensors.")

    n_obs = preds.numel()
    mx_new = (n_prior * mean_x + preds.mean() * n_obs) / (n_prior + n_obs)
    my_new = (n_prior * mean_y + target.mean() * n_obs) / (n_prior + n_obs)
    n_new = n_prior + n_obs
    var_x = var_x + ((preds - mx_new) * (preds - mean_x)).sum()
    var_y = var_y + ((target - my_new) * (target - mean_y)).sum()
    corr_xy = corr_xy + ((preds - mx_new) * (target - mean_y)).sum()
    return mx_new, my_new, var_x, var_y, corr_xy, n_new


def _pearson_corrcoef_compute(var_x: Tensor, var_y: Tensor, corr_xy: Tensor, nb: Tensor) -> Tensor:
    var_x = var_x / (nb - 1)
    var_y = var_y / (nb - 1)
    corr_xy = corr_xy / (nb - 1)
    corrcoef = corr_xy / torch.sqrt(var_x * var_y)
    return torch.clamp(corrcoef, -1.0, 1.0)


def _pearson_merge(
    means_x: Sequence[Tensor],
    means_y: Sequence[Tensor],
    vars_x: Sequence[Tensor],
    vars_y: Sequence[Tensor],
    corrs_xy: Sequence[Tensor],
    nbs: Sequence[Tensor],
) -> Tuple[Tensor, ...]:
    """Merge the moments of several streams, one pair at a time (reference `regression/pearson.py:23-62`):
    the six moments of the streams taken together."""
    mx1, my1, vx1, vy1, cxy1, n1 = means_x[0], means_y[0], vars_x[0], vars_y[0], corrs_xy[0], nbs[0]
    for i in range(1, len(means_x)):
        mx2, my2, vx2, vy2, cxy2, n2 = means_x[i], means_y[i], vars_x[i], vars_y[i], corrs_xy[i], nbs[i]
        nb = n1 + n2
        mean_x = (n1 * mx1 + n2 * mx2) / nb
        mean_y = (n1 * my1 + n2 * my2) / nb

        element_x1 = (n1 + 1) * mean_x - n1 * mx1
        vx1 = vx1 + (element_x1 - mx1) * (element_x1 - mean_x) - (element_x1 - mean_x) ** 2
        element_x2 = (n2 + 1) * mean_x - n2 * mx2
        vx2 = vx2 + (element_x2 - mx2) * (element_x2 - mean_x) - (element_x2 - mean_x) ** 2
        var_x = vx1 + vx2

        element_y1 = (n1 + 1) * mean_y - n1 * my1
        vy1 = vy1 + (element_y1 - my1) * (element_y1 - mean_y) - (element_y1 - mean_y) ** 2
        element_y2 = (n2 + 1) * mean_y - n2 * my2
        vy2 = vy2 + (element_y2 - my2) * (element_y2 - mean_y) - (element_y2 - mean_y) ** 2
        var_y = vy1 + vy2

        cxy1 = cxy1 + (element_x1 - mx1) * (element_y1 - mean_y) - (element_x1 - mean_x) * (element_y1 - mean_y)
        cxy2 = cxy2 + (element_x2 - mx2) * (element_y2 - mean_y) - (element_x2 - mean_x) * (element_y2 - mean_y)
        corr_xy = cxy1 + cxy2

        mx1, my1, vx1, vy1, cxy1, n1 = mean_x, mean_y, var_x, var_y, corr_xy, nb
    return mx1, my1, vx1, vy1, cxy1, n1


def _pearson_final_aggregation(*moments: Sequence[Tensor]) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The merged ``(var_x, var_y, corr_xy, n_total)`` of several streams' moments (:func:`_pearson_merge`)."""
    return _pearson_merge(*moments)[2:]


def pearson_corrcoef(preds: Tensor, target: Tensor) -> Tensor:
    """Pearson correlation coefficient.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import pearson_corrcoef
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> pearson_corrcoef(preds, target)
        tensor(0.9849)
    """
    zero = torch.tensor(0.0, device=preds.device)
    _, _, var_x, var_y, corr_xy, nb = _pearson_corrcoef_update(preds, target, zero, zero, zero, zero, zero, zero)
    return _pearson_corrcoef_compute(var_x, var_y, corr_xy, nb)


# ---------------------------------------------------------------- spearman
def _rank_data(data: Tensor) -> Tensor:
    """1-based ranks of a 1-d tensor, ties given their average rank.

    One stable sort; a run of equal sorted values (every NaN equal to every
    other, ``-0.0`` equal to ``0.0``) spans positions ``[lower, upper)``, and
    each of its values ranks ``(lower + upper - 1) / 2 + 1``, the average of
    the JAX package's ``searchsorted`` left and right positions. A cumsum
    numbers the runs and ``nonzero_static`` lists their first positions (the
    unused tail filled with ``n``, the end of the last run), so nothing is read
    back to the host.
    """
    if data.ndim != 1:
        raise ValueError(f"Spearman ranks need a 1-d tensor of rows, got {data.ndim} dims (a single row squeezes to 0)")
    n = data.shape[0]
    sorted_data, perm = torch.sort(data, stable=True)
    same = (sorted_data[1:] == sorted_data[:-1]) | (torch.isnan(sorted_data[1:]) & torch.isnan(sorted_data[:-1]))
    # a run starts here; built out of place, since under torch.func.vmap `same` is batched
    starts = torch.cat([torch.ones(1, dtype=torch.bool, device=data.device), ~same])
    run = torch.cumsum(starts, 0) - 1
    if _is_concrete(starts):
        first = torch.nonzero_static(starts, size=n + 1, fill_value=n).squeeze(1)
    else:  # nonzero_static has no batching rule: each run's least position, the same list
        pos = torch.arange(n, device=data.device)
        first = torch.full((n + 1,), n, dtype=pos.dtype, device=data.device).scatter_reduce(0, run, pos, reduce="amin")
    ranks_sorted = (first[run] + first[run + 1] - 1) / 2.0 + 1.0
    return torch.zeros_like(ranks_sorted).scatter(0, perm, ranks_sorted)


def _spearman_corrcoef_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    if preds.dtype != target.dtype:
        raise TypeError(
            "Expected `preds` and `target` to have the same data type."
            f" Got preds: {preds.dtype} and target: {target.dtype}."
        )
    _check_same_shape(preds, target)
    preds = torch.squeeze(preds)
    target = torch.squeeze(target)
    if preds.ndim > 1 or target.ndim > 1:
        raise ValueError("Expected both predictions and target to be 1 dimensional tensors.")
    return preds, target


def _spearman_corrcoef_compute(preds: Tensor, target: Tensor, eps: float = 1e-6) -> Tensor:
    preds = _rank_data(preds.to(torch.float32))
    target = _rank_data(target.to(torch.float32))
    preds_diff = preds - preds.mean()
    target_diff = target - target.mean()
    cov = (preds_diff * target_diff).mean()
    preds_std = torch.sqrt((preds_diff * preds_diff).mean())
    target_std = torch.sqrt((target_diff * target_diff).mean())
    corrcoef = cov / (preds_std * target_std + eps)
    return torch.clamp(corrcoef, -1.0, 1.0)


def spearman_corrcoef(preds: Tensor, target: Tensor) -> Tensor:
    """Spearman rank correlation.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import spearman_corrcoef
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> spearman_corrcoef(preds, target)
        tensor(1.0000)
    """
    preds, target = _spearman_corrcoef_update(preds, target)
    return _spearman_corrcoef_compute(preds, target)


# ------------------------------------------------------------------ cosine
def _cosine_similarity_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    _check_same_shape(preds, target)
    return preds.to(torch.float32), target.to(torch.float32)


def _cosine_similarity_compute(preds: Tensor, target: Tensor, reduction: Optional[str] = "sum") -> Tensor:
    dot = (preds * target).sum(dim=-1)
    norm = _l2_norm(preds, dim=-1) * _l2_norm(target, dim=-1)
    similarity = dot / norm
    if reduction == "mean":
        return similarity.mean()
    if reduction == "sum":
        return similarity.sum()
    if reduction in ("none", None):
        return similarity
    raise ValueError(f"Expected reduction to be one of 'mean', 'sum', 'none' or None but got {reduction}")


def cosine_similarity(preds: Tensor, target: Tensor, reduction: Optional[str] = "sum") -> Tensor:
    """Cosine similarity of each pair of rows, reduced.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import cosine_similarity
        >>> target = torch.tensor([[0.0, 1.0], [1.0, 1.0]])
        >>> preds = torch.tensor([[0.0, 1.0], [0.0, 1.0]])
        >>> cosine_similarity(preds, target, 'mean')
        tensor(0.8536)
    """
    preds, target = _cosine_similarity_update(preds, target)
    return _cosine_similarity_compute(preds, target, reduction)


__all__ = ["pearson_corrcoef", "spearman_corrcoef", "cosine_similarity"]
