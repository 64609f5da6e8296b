"""Perplexity from next-token logits.

JAX counterpart: `metrics_tpu/functional/text/perplexity.py:15-66`: a
float32 log-softmax over the vocabulary, the target's log-probability gathered
at each position, multiplied by the mask of the positions that count (not a
``where``: a -inf log-probability at id 0 under an ignored position gives NaN
in both packages), and summed. Device work, with no host read.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor


def _dtype_name(x: Tensor) -> str:
    """The dtype as JAX names it in its messages ("int32", not "torch.int32")."""
    return str(x.dtype).replace("torch.", "")


def _check_perplexity_inputs(preds: Tensor, target: Tensor) -> None:
    if preds.ndim != 3:
        raise ValueError(
            "Input tensor `preds` is expected to have 3 dimensions, [batch_size, seq_len, vocab_size],"
            f" but got {preds.ndim}."
        )
    if target.ndim != 2:
        raise ValueError(
            f"Input tensor `target` is expected to have 2 dimensions, [batch_size, seq_len], but got {target.ndim}."
        )
    if tuple(preds.shape[:2]) != tuple(target.shape):
        raise ValueError(
            "Input tensors `preds` and `target` are expected to have equaling first two dimensions,"
            f" [batch_size, seq_len], but got {tuple(preds.shape[:2])} and {tuple(target.shape)}."
        )
    if not preds.is_floating_point():
        raise TypeError(
            "Input tensor `preds` is expected to be of a type one of the floating point types but got"
            f" {_dtype_name(preds)}."
        )
    if target.is_floating_point() or target.is_complex() or target.dtype == torch.bool:
        raise TypeError(f"Input tensor `target` is expected to be of integer type but got {_dtype_name(target)}.")


def _perplexity_update(preds: Tensor, target: Tensor, ignore_index: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """(minus the summed log-probability of the counted targets, their count), float32 on the inputs' device."""
    _check_perplexity_inputs(preds, target)
    probs = torch.log_softmax(preds.to(torch.float32), dim=-1)
    if ignore_index is not None:
        keep = target != ignore_index
        mask = keep.to(torch.float32)
        safe_target = torch.where(keep, target, torch.zeros_like(target))
    else:
        mask = torch.ones(target.shape, dtype=torch.float32, device=target.device)
        safe_target = target
    token_logprob = torch.gather(probs, -1, safe_target.to(torch.int64)[..., None])[..., 0]
    total_log_probs = -(token_logprob * mask).sum()
    count = mask.sum()
    return total_log_probs, count


def _perplexity_compute(total: Tensor, count: Tensor) -> Tensor:
    return torch.exp(total / count)


def perplexity(preds: Tensor, target: Tensor, ignore_index: Optional[int] = None) -> Tensor:
    """exp(mean negative log-likelihood) over the positions not ignored.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import perplexity
        >>> grid = torch.arange(2 * 8 * 5, dtype=torch.float32)
        >>> preds = (torch.sin(grid) * 0.5 + 0.5).reshape(2, 8, 5)
        >>> target = (torch.arange(2 * 8, dtype=torch.int32).reshape(2, 8) * 3) % 5
        >>> round(float(perplexity(preds, target, ignore_index=None)), 4)
        5.3981
    """
    total, count = _perplexity_update(preds, target, ignore_index)
    return _perplexity_compute(total, count)


__all__ = ["perplexity"]
