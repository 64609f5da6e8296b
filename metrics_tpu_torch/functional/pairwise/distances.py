"""Pairwise distance and similarity matrices of rows ``(N, d) x (M, d)``.

JAX counterpart: `metrics_tpu/functional/pairwise/distances.py` (reference
`functional/pairwise/{cosine,euclidean,linear,manhattan,helpers}.py`).

The products are ``torch.matmul``, as the JAX package computes them outside
any kernel of its own, in float32 at full precision (no TF32 on the card),
cosine included. Euclidean takes the ‖x‖² + ‖y‖² - 2x·y expansion, so it
cancels where two rows are close. Manhattan's (N, M, d) difference is built
a block of rows of ``x`` at a time, so that a block stays under 256 MiB
(4096 × 8192 × 768 would hold 103 GB); each entry's sum over d is the same.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.compute import _l2_norm, high_precision

# bytes of one block of Manhattan's (rows, M, d) float32 difference
MANHATTAN_BLOCK_BYTES = 256 * 2**20


def _check_pairwise_input(x, y: Optional[Tensor], zero_diagonal: Optional[bool]) -> Tuple[Tensor, Tensor, bool]:
    x = torch.as_tensor(x)
    if x.ndim != 2:
        raise ValueError(f"Expected argument `x` to be a 2D tensor of shape `[N, d]` but got {x.shape}")
    if y is not None:
        y = torch.as_tensor(y, device=x.device)
        if y.ndim != 2 or y.shape[1] != x.shape[1]:
            raise ValueError(
                "Expected argument `y` to be a 2D tensor of shape `[M, d]` where"
                f" `d` should be same as the last dimension of `x`, but got {y.shape}"
            )
        zero_diagonal = False if zero_diagonal is None else zero_diagonal
    else:
        y = x
        zero_diagonal = True if zero_diagonal is None else zero_diagonal
    return x.to(torch.float32), y.to(torch.float32), zero_diagonal


def _maybe_zero_diagonal(distance: Tensor, zero_diagonal: bool) -> Tensor:
    # ``distance`` is always a result of this module, never the caller's tensor: written in place
    if zero_diagonal:
        idx = torch.arange(min(distance.shape), device=distance.device)
        distance[idx, idx] = 0.0
    return distance


def _reduce_distance_matrix(distance: Tensor, reduction: Optional[str]) -> Tensor:
    if reduction == "mean":
        return distance.mean(dim=-1)
    if reduction == "sum":
        return distance.sum(dim=-1)
    if reduction in ("none", None):
        return distance
    raise ValueError(f"Expected reduction to be one of `['mean', 'sum', None]` but got {reduction}")


@high_precision
def pairwise_cosine_similarity(
    x: Tensor, y: Optional[Tensor] = None, reduction: Optional[str] = None, zero_diagonal: Optional[bool] = None
) -> Tensor:
    """Cosine similarity matrix ``sim[i, j] = x_i·y_j / (‖x_i‖ ‖y_j‖)``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import pairwise_cosine_similarity
        >>> x = torch.tensor([[2.0, 3.0], [3.0, 5.0], [5.0, 8.0]])
        >>> y = torch.tensor([[1.0, 0.0], [2.0, 1.0]])
        >>> pairwise_cosine_similarity(x, y)
        tensor([[0.5547, 0.8682],
                [0.5145, 0.8437],
                [0.5300, 0.8533]])
    """
    x, y, zero_diagonal = _check_pairwise_input(x, y, zero_diagonal)
    norm_x = _l2_norm(x, dim=1, keepdim=True)
    norm_y = _l2_norm(y, dim=1, keepdim=True)
    distance = (x / norm_x) @ (y / norm_y).T
    distance = _maybe_zero_diagonal(distance, zero_diagonal)
    return _reduce_distance_matrix(distance, reduction)


@high_precision
def pairwise_euclidean_distance(
    x: Tensor, y: Optional[Tensor] = None, reduction: Optional[str] = None, zero_diagonal: Optional[bool] = None
) -> Tensor:
    """Euclidean distance matrix, through the product expansion.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import pairwise_euclidean_distance
        >>> x = torch.tensor([[2.0, 3.0], [3.0, 5.0], [5.0, 8.0]])
        >>> y = torch.tensor([[1.0, 0.0], [2.0, 1.0]])
        >>> pairwise_euclidean_distance(x, y)
        tensor([[3.1623, 2.0000],
                [5.3852, 4.1231],
                [8.9443, 7.6158]])
    """
    x, y, zero_diagonal = _check_pairwise_input(x, y, zero_diagonal)
    x_norm = (x * x).sum(dim=1, keepdim=True)
    y_norm = (y * y).sum(dim=1)
    distance = x_norm + y_norm - 2 * x @ y.T
    distance = _maybe_zero_diagonal(distance, zero_diagonal)
    return _reduce_distance_matrix(torch.sqrt(torch.clamp(distance, min=0.0)), reduction)


@high_precision
def pairwise_linear_similarity(
    x: Tensor, y: Optional[Tensor] = None, reduction: Optional[str] = None, zero_diagonal: Optional[bool] = None
) -> Tensor:
    """Dot-product similarity matrix ``x @ y.T``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import pairwise_linear_similarity
        >>> x = torch.tensor([[2.0, 3.0], [3.0, 5.0], [5.0, 8.0]])
        >>> y = torch.tensor([[1.0, 0.0], [2.0, 1.0]])
        >>> pairwise_linear_similarity(x, y)
        tensor([[ 2.,  7.],
                [ 3., 11.],
                [ 5., 18.]])
    """
    x, y, zero_diagonal = _check_pairwise_input(x, y, zero_diagonal)
    distance = x @ y.T
    distance = _maybe_zero_diagonal(distance, zero_diagonal)
    return _reduce_distance_matrix(distance, reduction)


def _manhattan_rows(x: Tensor, y: Tensor) -> Tensor:
    """``|x_i - y_j|`` summed over d, a block of rows of ``x`` at a time."""
    out = torch.empty((x.shape[0], y.shape[0]), dtype=torch.float32, device=x.device)
    rows = max(1, MANHATTAN_BLOCK_BYTES // max(1, 4 * y.shape[0] * y.shape[1]))
    for lo in range(0, x.shape[0], rows):
        block = x[lo : lo + rows, None, :] - y[None, :, :]
        out[lo : lo + rows] = block.abs_().sum(dim=-1)
        del block  # freed before the next block is built: one block alive at a time
    return out


@high_precision
def pairwise_manhattan_distance(
    x: Tensor, y: Optional[Tensor] = None, reduction: Optional[str] = None, zero_diagonal: Optional[bool] = None
) -> Tensor:
    """L1 distance matrix.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import pairwise_manhattan_distance
        >>> x = torch.tensor([[2.0, 3.0], [3.0, 5.0], [5.0, 8.0]])
        >>> y = torch.tensor([[1.0, 0.0], [2.0, 1.0]])
        >>> pairwise_manhattan_distance(x, y)
        tensor([[ 4.,  2.],
                [ 7.,  5.],
                [12., 10.]])
    """
    x, y, zero_diagonal = _check_pairwise_input(x, y, zero_diagonal)
    distance = _manhattan_rows(x, y)
    distance = _maybe_zero_diagonal(distance, zero_diagonal)
    return _reduce_distance_matrix(distance, reduction)


__all__ = [
    "pairwise_cosine_similarity",
    "pairwise_euclidean_distance",
    "pairwise_linear_similarity",
    "pairwise_manhattan_distance",
]
