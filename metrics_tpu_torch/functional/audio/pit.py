"""Permutation-invariant training (PIT).

JAX counterpart: `metrics_tpu/functional/audio/pit.py` (``_permutation_table``
`:30`, ``_find_best_perm_exhaustive`` `:41`, ``_find_best_perm_lsa`` `:56`,
``permutation_invariant_training`` `:67`, ``pit_permutate`` `:108`): the
metric of every (target, prediction) speaker pair, ``[batch, target, pred]``
from ``spk**2`` calls of ``metric_func``, then the best assignment. Up to 7
speakers every permutation is scored in one gather, in ``itertools``' order,
and ``argmax``/``argmin`` take the first best, as in JAX; above 7 scipy's
``linear_sum_assignment`` runs on the host (one copy each way).

``best_perm`` is int64, PyTorch's index dtype (int32 in JAX); the permuted
speakers (:func:`pit_permutate`) are the same.
"""
from __future__ import annotations

from functools import lru_cache
from itertools import permutations
from typing import Any, Callable, Tuple

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.utils.imports import _SCIPY_AVAILABLE

# beyond this, the 8! permutations and more make the exhaustive gather unreasonable
_MAX_EXHAUSTIVE_SPK = 7


@lru_cache(maxsize=None)
def _permutation_table(spk_num: int) -> np.ndarray:
    """The [perm_num, spk] table of every permutation, in ``itertools.permutations`` order."""
    return np.asarray(list(permutations(range(spk_num))))


@lru_cache(maxsize=None)
def _permutation_table_on(spk_num: int, device: torch.device) -> Tensor:
    """The table as an int64 tensor on ``device``: one copy a process."""
    return torch.as_tensor(_permutation_table(spk_num), dtype=torch.int64, device=device)


def _find_best_perm_exhaustive(metric_mtx: Tensor, maximize: bool) -> Tuple[Tensor, Tensor]:
    """The exact assignment by scoring every permutation in one gather."""
    spk_num = metric_mtx.shape[-1]
    ps = _permutation_table_on(spk_num, metric_mtx.device)  # [perm_num, spk]
    # metric_of_ps[b, p] = mean_i mtx[b, i, ps[p, i]]
    gathered = metric_mtx[..., torch.arange(spk_num, device=metric_mtx.device)[None, :], ps]
    metric_of_ps = gathered.mean(dim=-1)
    best_idx = torch.argmax(metric_of_ps, dim=-1) if maximize else torch.argmin(metric_of_ps, dim=-1)
    best_metric = torch.gather(metric_of_ps, -1, best_idx[..., None])[..., 0]
    return best_metric, ps[best_idx]


def _find_best_perm_lsa(metric_mtx: Tensor, maximize: bool) -> Tuple[Tensor, Tensor]:
    """The Hungarian solve on the host, for many speakers."""
    from scipy.optimize import linear_sum_assignment

    mtx = metric_mtx.detach().cpu().numpy()
    perms = np.stack([linear_sum_assignment(m, maximize)[1] for m in mtx]) if len(mtx) else np.zeros((0, mtx.shape[-1]))
    best_perm = torch.as_tensor(perms, dtype=torch.int64, device=metric_mtx.device)
    best_metric = torch.gather(metric_mtx, 2, best_perm[:, :, None]).mean(dim=(-1, -2))
    return best_metric, best_perm


def permutation_invariant_training(
    preds: Tensor, target: Tensor, metric_func: Callable, eval_func: str = "max", **kwargs: Any
) -> Tuple[Tensor, Tensor]:
    """The metric of the best speaker assignment, and that assignment.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import (
        ...     permutation_invariant_training, scale_invariant_signal_distortion_ratio)
        >>> preds = torch.tensor([[[-0.0579,  0.3560, -0.9604], [-0.1719,  0.3205,  0.2951]]])
        >>> target = torch.tensor([[[ 1.0958, -0.1648,  0.5228], [-0.4100,  1.1942, -0.5103]]])
        >>> best_metric, best_perm = permutation_invariant_training(
        ...     preds, target, scale_invariant_signal_distortion_ratio, 'max')
        >>> round(float(best_metric[0]), 3)
        -5.109
        >>> best_perm
        tensor([[0, 1]])
    """
    if preds.shape[0:2] != target.shape[0:2]:
        raise RuntimeError(
            "Predictions and targets are expected to have the same shape at the batch and speaker dimensions"
        )
    if eval_func not in ("max", "min"):
        raise ValueError(f'eval_func can only be "max" or "min" but got {eval_func}')
    if target.ndim < 2:
        raise ValueError(f"Inputs must be of shape [batch, spk, ...], got {target.shape} and {preds.shape} instead")

    spk_num = target.shape[1]
    rows = []
    for target_idx in range(spk_num):
        row = [metric_func(preds[:, preds_idx, ...], target[:, target_idx, ...], **kwargs) for preds_idx in range(spk_num)]
        rows.append(torch.stack(row, dim=-1))
    metric_mtx = torch.stack(rows, dim=-2)  # [batch, target, pred]

    maximize = eval_func == "max"
    if spk_num <= _MAX_EXHAUSTIVE_SPK or not _SCIPY_AVAILABLE:
        return _find_best_perm_exhaustive(metric_mtx, maximize)
    return _find_best_perm_lsa(metric_mtx, maximize)


def pit_permutate(preds: Tensor, perm: Tensor) -> Tensor:
    """``preds``' speakers in the order ``perm`` gives.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import permutation_invariant_training, pit_permutate
        >>> preds = torch.tensor([[[1.0, 2.0], [3.0, 4.0]]])  # (batch, spk, time)
        >>> target = torch.tensor([[[3.0, 4.0], [1.0, 2.0]]])
        >>> def neg_l1(p, t):
        ...     return -(p - t).abs().mean(dim=-1)
        >>> best_metric, best_perm = permutation_invariant_training(preds, target, neg_l1, eval_func='max')
        >>> best_perm
        tensor([[1, 0]])
        >>> pit_permutate(preds, best_perm)
        tensor([[[3., 4.],
                 [1., 2.]]])
    """
    index = perm.to(torch.int64).reshape(perm.shape + (1,) * (preds.ndim - 2))
    return torch.gather(preds, 1, index.expand(perm.shape + preds.shape[2:]))


__all__ = ["permutation_invariant_training", "pit_permutate"]
