"""The error-rate family: WER, CER, MER, WIL, WIP.

JAX counterpart: `metrics_tpu/functional/text/wer.py` (WER `:20-46`, CER, MER,
WIL and WIP `:54-141`). Each update counts on the host (edit distances from the
host text library) and returns Python numbers; the counts become float32, as
in JAX, exact up to 2**24. Strings carry no device, so the functional forms
take a keyword-only ``device`` (None: the card, see
:func:`metrics_tpu_torch.metric.resolve_device`).
"""
from __future__ import annotations

from typing import List, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.functional.text.helper import _edit_distances
from metrics_tpu_torch.metric import resolve_device


def _str_list(x: Union[str, List[str]]) -> List[str]:
    return [x] if isinstance(x, str) else list(x)


def _counts(values, device) -> Tensor:
    """Host counts as one float32 tensor on ``device``: one copy."""
    return torch.tensor(values, dtype=torch.float32, device=resolve_device(device))


def _wer_update(preds, target) -> Tuple[int, int]:
    """(word edits, reference words)."""
    preds, target = _str_list(preds), _str_list(target)
    pairs = [(p.split(), t.split()) for p, t in zip(preds, target)]
    errors = sum(_edit_distances(pairs))
    total = sum(len(t_tok) for _, t_tok in pairs)
    return errors, total


def _wer_compute(errors: Tensor, total: Tensor) -> Tensor:
    return errors / total


def word_error_rate(preds, target, *, device=None) -> Tensor:
    """WER = edit distance / reference length.

    Example:
        >>> from metrics_tpu_torch.functional import word_error_rate
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> word_error_rate(preds, target, device="cpu")
        tensor(0.5000)
    """
    errors, total = _counts(_wer_update(preds, target), device)
    return _wer_compute(errors, total)


def _cer_update(preds, target) -> Tuple[int, int]:
    """(character edits, reference characters)."""
    preds, target = _str_list(preds), _str_list(target)
    pairs = [(list(p), list(t)) for p, t in zip(preds, target)]
    errors = sum(_edit_distances(pairs))
    total = sum(len(t) for _, t in pairs)
    return errors, total


def char_error_rate(preds, target, *, device=None) -> Tensor:
    """CER = character edit distance / reference characters.

    Example:
        >>> from metrics_tpu_torch.functional import char_error_rate
        >>> char_error_rate(["this is the prediction"], ["this is the reference"], device="cpu")
        tensor(0.3810)
    """
    errors, total = _counts(_cer_update(preds, target), device)
    return errors / total


def _mer_update(preds, target) -> Tuple[int, int]:
    """(word edits, summed max(reference words, predicted words))."""
    preds, target = _str_list(preds), _str_list(target)
    pairs = [(p.split(), t.split()) for p, t in zip(preds, target)]
    errors = sum(_edit_distances(pairs))
    total = sum(max(len(t_tok), len(p_tok)) for p_tok, t_tok in pairs)
    return errors, total


def match_error_rate(preds, target, *, device=None) -> Tensor:
    """MER = edit distance / max(reference, prediction) length, accumulated.

    Example:
        >>> from metrics_tpu_torch.functional import match_error_rate
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> match_error_rate(preds, target, device="cpu")
        tensor(0.4444)
    """
    errors, total = _counts(_mer_update(preds, target), device)
    return errors / total


def _wil_wip_update(preds, target) -> Tuple[float, float, float]:
    """(hits, reference words, predicted words); hits = max(|t|, |p|) - edits a pair."""
    preds, target = _str_list(preds), _str_list(target)
    errors = 0.0
    target_total = 0.0
    preds_total = 0.0
    pairs = [(p.split(), t.split()) for p, t in zip(preds, target)]
    for (p_tok, t_tok), d in zip(pairs, _edit_distances(pairs)):
        errors += max(len(t_tok), len(p_tok)) - d
        target_total += len(t_tok)
        preds_total += len(p_tok)
    return errors, target_total, preds_total


def word_information_preserved(preds, target, *, device=None) -> Tensor:
    """WIP = (hits / reference words) * (hits / predicted words).

    Example:
        >>> from metrics_tpu_torch.functional import word_information_preserved
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> word_information_preserved(preds, target, device="cpu")
        tensor(0.3472)
    """
    hits, target_total, preds_total = _counts(_wil_wip_update(preds, target), device)
    return (hits / target_total) * (hits / preds_total)


def word_information_lost(preds, target, *, device=None) -> Tensor:
    """WIL = 1 - WIP.

    Example:
        >>> from metrics_tpu_torch.functional import word_information_lost
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> word_information_lost(preds, target, device="cpu")
        tensor(0.6528)
    """
    return 1.0 - word_information_preserved(preds, target, device=device)


__all__ = [
    "word_error_rate",
    "char_error_rate",
    "match_error_rate",
    "word_information_preserved",
    "word_information_lost",
]
