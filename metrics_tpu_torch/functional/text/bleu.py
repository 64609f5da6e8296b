"""BLEU.

JAX counterpart: `metrics_tpu/functional/text/bleu.py` (``_count_ngrams``
`:18`, ``_bleu_score_update`` `:25`, ``_bleu_score_compute`` `:68`,
``bleu_score`` `:100`). The update counts clipped n-gram matches on the host
and returns Python numbers; the compute is tensor math on the states' device,
in float32 as in JAX (counts exact up to 2**24).
"""
from __future__ import annotations

from collections import Counter
from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.functional.text.helper import _ngrams
from metrics_tpu_torch.metric import resolve_device


def _count_ngrams(tokens: Sequence, n_gram: int) -> Counter:
    counts: Counter = Counter()
    for n in range(1, n_gram + 1):
        counts.update(_ngrams(tokens, n))
    return counts


def _bleu_score_update(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    n_gram: int = 4,
    tokenizer: Callable[[str], Sequence[str]] = str.split,
) -> Tuple[List[float], List[float], int, int]:
    """(clipped matches by order, predicted n-grams by order, predicted length, closest reference length)."""
    target_corpus = [[tokenizer(t) for t in targets] for targets in target]
    preds_tokens = [tokenizer(p) for p in preds]
    p_len = 0
    t_len = 0
    num = [0.0] * n_gram
    den = [0.0] * n_gram
    for pred, targets in zip(preds_tokens, target_corpus):
        p_len += len(pred)
        # the closest reference length (ties go to the shorter)
        len_diffs = [(abs(len(t) - len(pred)), len(t)) for t in targets]
        t_len += min(len_diffs)[1]

        pred_counter = _count_ngrams(pred, n_gram)
        max_counter: Counter = Counter()
        for t in targets:
            max_counter |= _count_ngrams(t, n_gram)
        clipped = pred_counter & max_counter
        for ngram, count in clipped.items():
            num[len(ngram) - 1] += count
        for ngram, count in pred_counter.items():
            den[len(ngram) - 1] += count
    return num, den, p_len, t_len


def _bleu_stats(stats, n_gram: int, device) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The host statistics as float32 tensors on ``device`` in one copy: (numerator, denominator, preds_len, target_len)."""
    num, den, p_len, t_len = stats
    flat = torch.tensor([*num, *den, p_len, t_len], dtype=torch.float32, device=device)
    return flat[:n_gram], flat[n_gram : 2 * n_gram], flat[2 * n_gram], flat[2 * n_gram + 1]


def _bleu_score_compute(
    preds_len: Tensor,
    target_len: Tensor,
    numerator: Tensor,
    denominator: Tensor,
    n_gram: int = 4,
    weights: Union[Sequence[float], Tensor, None] = None,
    smooth: bool = False,
) -> Tensor:
    """Geometric mean of the n-gram precisions times the brevity penalty.

    An order with no match zeroes the score, smoothed or not.
    """
    if weights is None:
        weights = [1.0 / n_gram] * n_gram
    if not isinstance(weights, Tensor):
        weights = torch.tensor(weights, dtype=torch.float32, device=numerator.device)
    if smooth:
        precision_scores = (numerator + 1.0) / (denominator + 1.0)
        first = numerator[0] / torch.clamp(denominator[0], min=1e-12)
        precision_scores = torch.cat([first.reshape(1), precision_scores[1:]])
    else:
        precision_scores = numerator / torch.where(denominator == 0, torch.ones_like(denominator), denominator)
    safe = torch.where(precision_scores > 0, precision_scores, torch.full_like(precision_scores, 1e-30))
    geometric_mean = torch.exp(torch.sum(weights * torch.log(safe)))
    brevity_penalty = torch.where(
        preds_len > target_len,
        torch.ones_like(preds_len),
        torch.exp(1.0 - target_len / torch.clamp(preds_len, min=1e-12)),
    )
    bleu = brevity_penalty * geometric_mean
    return torch.where(torch.min(numerator) == 0.0, torch.zeros_like(bleu), bleu)


def bleu_score(
    preds: Union[str, Sequence[str]],
    target: Union[Sequence[str], Sequence[Sequence[str]]],
    n_gram: int = 4,
    smooth: bool = False,
    weights: Optional[Sequence[float]] = None,
    *,
    device=None,
) -> Tensor:
    """Corpus BLEU with whitespace tokenization.

    Example:
        >>> from metrics_tpu_torch.functional import bleu_score
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> bleu_score(preds, target, device="cpu")
        tensor(0.7598)
    """
    preds_ = [preds] if isinstance(preds, str) else preds
    target_ = [[tgt] if isinstance(tgt, str) else tgt for tgt in target]
    if len(preds_) != len(target_):
        raise ValueError(f"Corpus has different size {len(preds_)} != {len(target_)}")
    if weights is not None and len(weights) != n_gram:
        raise ValueError(f"List of weights has different weights than `n_gram`: {len(weights)} != {n_gram}")
    numerator, denominator, preds_len, target_len = _bleu_stats(
        _bleu_score_update(preds_, target_, n_gram), n_gram, resolve_device(device)
    )
    return _bleu_score_compute(preds_len, target_len, numerator, denominator, n_gram, weights, smooth)


__all__ = ["bleu_score"]
