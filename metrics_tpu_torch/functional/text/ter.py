"""Translation Edit Rate (TER).

JAX counterpart: `metrics_tpu/functional/text/ter.py` (``_TercomTokenizer``
`:27`, ``_edit_distance_only`` `:91`, ``_edit_distance_with_alignment``
`:103`, ``_matching_spans`` `:150`, ``_apply_shift`` `:166`, ``_best_shift``
`:179`, ``_translation_edit_rate`` `:222`, ``_ter_update`` `:261`,
``_ter_compute`` `:290`, ``translation_edit_rate`` `:300`), after sacrebleu's
Tercom: tokenize, greedily apply the block shifts that lower the word edit
distance, and score ``(edits + shifts) / reference length``. Shift candidates
and their ranking follow Tercom (spans of at most 10 words, a capped number of
candidates, ranked by gain, length, then earliest positions). The shifts
compare interned ids, so the ids are the JAX package's. Host work; the edit
distances come from the host text library.
"""
from __future__ import annotations

import re
from functools import lru_cache
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.metric import resolve_device
from metrics_tpu_torch.ops import text_native

_MAX_SHIFT_SIZE = 10
_MAX_SHIFT_DIST = 50
_MAX_SHIFT_CANDIDATES = 1000


class _TercomTokenizer:
    """Tercom-style normalization (lowercase / general tokenize / strip punct)."""

    _ASIAN_PUNCT = r"([、。〈-】〔-〟｡-･・])"
    _FULL_WIDTH_PUNCT = r"([．，？：；！＂（）])"

    def __init__(
        self,
        normalize: bool = False,
        no_punctuation: bool = False,
        lowercase: bool = True,
        asian_support: bool = False,
    ) -> None:
        self.normalize = normalize
        self.no_punctuation = no_punctuation
        self.lowercase = lowercase
        self.asian_support = asian_support

    @lru_cache(maxsize=2**16)
    def __call__(self, sentence: str) -> str:
        if not sentence:
            return ""
        if self.lowercase:
            sentence = sentence.lower()
        if self.normalize:
            sentence = self._normalize_general(sentence)
            if self.asian_support:
                sentence = self._normalize_asian(sentence)
        if self.no_punctuation:
            sentence = re.sub(r"[\.,\?:;!\"\(\)]", "", sentence)
            if self.asian_support:
                sentence = re.sub(self._ASIAN_PUNCT, "", sentence)
                sentence = re.sub(self._FULL_WIDTH_PUNCT, "", sentence)
        return " ".join(sentence.split())

    @staticmethod
    def _normalize_general(sentence: str) -> str:
        sentence = f" {sentence} "
        for pattern, replacement in (
            (r"\n-", ""),
            (r"\n", " "),
            (r"&quot;", '"'),
            (r"&amp;", "&"),
            (r"&lt;", "<"),
            (r"&gt;", ">"),
            (r"([{-~[-` -&(-+:-@/])", r" \1 "),
            (r"'s ", r" 's "),
            (r"'s$", r" 's"),
            (r"([^0-9])([\.,])", r"\1 \2 "),
            (r"([\.,])([^0-9])", r" \1 \2"),
            (r"([0-9])(-)", r"\1 \2 "),
        ):
            sentence = re.sub(pattern, replacement, sentence)
        return sentence

    @classmethod
    def _normalize_asian(cls, sentence: str) -> str:
        for rng in (r"[一-鿿㐀-䶿]", r"[㇀-㇯⺀-⻿]", r"[㌀-㏿豈-﫿︰-﹏]", r"[㈀-㼢]"):
            sentence = re.sub(f"({rng})", r" \1 ", sentence)
        sentence = re.sub(cls._ASIAN_PUNCT, r" \1 ", sentence)
        sentence = re.sub(cls._FULL_WIDTH_PUNCT, r" \1 ", sentence)
        return sentence


def _edit_distance_only(pred: Sequence[int], ref: Sequence[int]) -> int:
    """Word edit distance without the backtrack (the shift search's gain loop), from the host library.
    ``ref`` is already an int32 array in the hot loop."""
    return text_native.levenshtein(np.asarray(pred, np.int32), np.asarray(ref, np.int32))


def _edit_distance_table_plain(pred: Sequence[int], ref: Sequence[int]) -> np.ndarray:
    """The edit-distance table by the Python program (`ter.py:117-124`): the library's plain version."""
    m, n = len(pred), len(ref)
    d = np.zeros((m + 1, n + 1), dtype=np.int32)
    d[:, 0] = np.arange(m + 1)
    d[0, :] = np.arange(n + 1)
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            cost = 0 if pred[i - 1] == ref[j - 1] else 1
            d[i, j] = min(d[i - 1, j] + 1, d[i, j - 1] + 1, d[i - 1, j - 1] + cost)
    return d


def _edit_distance_with_alignment(
    pred: List[int], ref: List[int]
) -> Tuple[int, Dict[int, int], List[int], List[int]]:
    """Word edit distance and the alignment of one optimal path (tokens are interned ids).

    Returns (distance, alignment ref_idx -> pred_idx, ref_errors, pred_errors),
    the error lists flagging positions a non-match operation touches. The
    table comes from the host library; the backtrack is O(m + n) Python.
    """
    m, n = len(pred), len(ref)
    d = text_native.levenshtein_matrix(np.asarray(pred, np.int32), np.asarray(ref, np.int32))

    alignments: Dict[int, int] = {}
    pred_errors = [0] * m
    ref_errors = [0] * n
    i, j = m, n
    while i > 0 or j > 0:
        if i > 0 and j > 0:
            cost = 0 if pred[i - 1] == ref[j - 1] else 1
            if d[i, j] == d[i - 1, j - 1] + cost:
                alignments[j - 1] = i - 1
                if cost:
                    pred_errors[i - 1] = 1
                    ref_errors[j - 1] = 1
                i, j = i - 1, j - 1
                continue
        if i > 0 and d[i, j] == d[i - 1, j] + 1:  # deletion from pred
            pred_errors[i - 1] = 1
            i -= 1
            continue
        # insertion
        ref_errors[j - 1] = 1
        j -= 1
    return int(d[m, n]), alignments, ref_errors, pred_errors


def _matching_spans(pred: List[int], ref: Sequence[int]) -> Iterator[Tuple[int, int, int]]:
    """(pred_start, ref_start, length) of equal word spans within shift range."""
    for pred_start in range(len(pred)):
        for ref_start in range(len(ref)):
            if abs(ref_start - pred_start) > _MAX_SHIFT_DIST:
                continue
            for length in range(1, _MAX_SHIFT_SIZE):
                if pred_start + length - 1 >= len(pred) or ref_start + length - 1 >= len(ref):
                    break
                if pred[pred_start + length - 1] != ref[ref_start + length - 1]:
                    break
                yield pred_start, ref_start, length
                if len(pred) == pred_start + length or len(ref) == ref_start + length:
                    break


def _apply_shift(words: List[int], start: int, length: int, target: int) -> List[int]:
    if target < start:
        return words[:target] + words[start : start + length] + words[target:start] + words[start + length :]
    if target > start + length:
        return words[:start] + words[start + length : target] + words[start : start + length] + words[target:]
    return (
        words[:start]
        + words[start + length : length + target]
        + words[start : start + length]
        + words[length + target :]
    )


def _best_shift(
    pred: List[int], ref: Sequence[int], checked_candidates: int
) -> Tuple[int, List[int], int]:
    """One round of Tercom shift search: returns (gain, shifted_words, n_checked)."""
    base_distance, alignments, ref_errors, pred_errors = _edit_distance_with_alignment(pred, ref)

    best: Optional[Tuple[int, int, int, int, List[int]]] = None
    for pred_start, ref_start, length in _matching_spans(pred, ref):
        # skip if the pred span is already fully correct, or the ref span
        # already matches, or the shift would land inside its own span
        if sum(pred_errors[pred_start : pred_start + length]) == 0:
            continue
        if sum(ref_errors[ref_start : ref_start + length]) == 0:
            continue
        if ref_start in alignments and pred_start <= alignments[ref_start] < pred_start + length:
            continue

        prev_idx = -1
        for offset in range(-1, length):
            if ref_start + offset == -1:
                idx = 0
            elif ref_start + offset in alignments:
                idx = alignments[ref_start + offset] + 1
            else:
                break
            if idx == prev_idx:
                continue
            prev_idx = idx

            shifted = _apply_shift(pred, pred_start, length, idx)
            gain = base_distance - _edit_distance_only(shifted, ref)
            candidate = (gain, length, -pred_start, -idx, shifted)
            checked_candidates += 1
            if best is None or candidate[:4] > best[:4]:
                best = candidate
        if checked_candidates >= _MAX_SHIFT_CANDIDATES:
            break

    if best is None:
        return 0, pred, checked_candidates
    return best[0], best[4], checked_candidates


def _translation_edit_rate(pred: List[str], ref: List[str]) -> float:
    """Minimum (shifts + edits) against one reference."""
    if len(ref) == 0:
        return 0.0
    # words interned to dense ids once: every comparison below runs on ints.
    # pred stays a list (shifts permute it); ref, the same for every
    # candidate, stays the int32 array
    pred_ids, ref = text_native.intern_ids(pred, ref)
    pred = pred_ids.tolist()
    num_shifts = 0
    checked = 0
    words = pred
    while True:
        gain, new_words, checked = _best_shift(words, ref, checked)
        if gain <= 0 or checked >= _MAX_SHIFT_CANDIDATES:
            break
        num_shifts += 1
        words = new_words
    edit_distance = _edit_distance_with_alignment(words, ref)[0]
    return float(num_shifts + edit_distance)


def _compute_sentence_statistics(
    pred_words: List[str], target_words: List[List[str]]
) -> Tuple[float, float]:
    """Best (lowest) edits over references + average reference length."""
    tgt_lengths = 0.0
    best_num_edits = float("inf")
    for tgt_words in target_words:
        num_edits = _translation_edit_rate(pred_words, tgt_words)
        tgt_lengths += len(tgt_words)
        if num_edits < best_num_edits:
            best_num_edits = num_edits
    avg_tgt_len = tgt_lengths / len(target_words)
    return best_num_edits, avg_tgt_len


def _ter_update(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    tokenizer: _TercomTokenizer,
    total_num_edits: float = 0.0,
    total_tgt_length: float = 0.0,
    sentence_ter: Optional[List[float]] = None,
) -> Tuple[float, float, Optional[List[float]]]:
    """Host sums of edits and reference lengths; each sentence's TER appended to ``sentence_ter`` as a float."""
    if isinstance(preds, str):
        preds = [preds]
    target = [[tgt] if isinstance(tgt, str) else tgt for tgt in target]
    if len(preds) != len(target):
        raise ValueError(f"Corpus has different size {len(preds)} != {len(target)}")
    for pred, tgts in zip(preds, target):
        tgt_words_ = [tokenizer(str(t).rstrip()).split() for t in tgts]
        pred_words_ = tokenizer(str(pred).rstrip()).split()
        num_edits, tgt_length = _compute_sentence_statistics(pred_words_, tgt_words_)
        total_num_edits += num_edits
        total_tgt_length += tgt_length
        if sentence_ter is not None:
            if tgt_length > 0:
                sentence_ter.append(num_edits / tgt_length)
            elif num_edits > 0:
                sentence_ter.append(1.0)
            else:
                sentence_ter.append(0.0)
    return total_num_edits, total_tgt_length, sentence_ter


def _ter_compute(total_num_edits: Tensor, total_tgt_length: Tensor) -> Tensor:
    return torch.where(
        total_tgt_length > 0,
        total_num_edits / torch.clamp(total_tgt_length, min=1e-12),
        (total_num_edits > 0).to(total_num_edits.dtype),
    )


def translation_edit_rate(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    normalize: bool = False,
    no_punctuation: bool = False,
    lowercase: bool = True,
    asian_support: bool = False,
    return_sentence_level_score: bool = False,
    *,
    device=None,
):
    """Corpus TER (optionally with sentence-level scores).

    Example:
        >>> from metrics_tpu_torch.functional import translation_edit_rate
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> translation_edit_rate(preds, target, device="cpu")
        tensor(0.1538)
    """
    if not isinstance(normalize, bool):
        raise ValueError(f"Expected argument `normalize` to be of type boolean but got {normalize}.")
    if not isinstance(no_punctuation, bool):
        raise ValueError(f"Expected argument `no_punctuation` to be of type boolean but got {no_punctuation}.")
    if not isinstance(lowercase, bool):
        raise ValueError(f"Expected argument `lowercase` to be of type boolean but got {lowercase}.")
    if not isinstance(asian_support, bool):
        raise ValueError(f"Expected argument `asian_support` to be of type boolean but got {asian_support}.")

    tokenizer = _TercomTokenizer(normalize, no_punctuation, lowercase, asian_support)
    sentence_ter: Optional[List[float]] = [] if return_sentence_level_score else None
    total_num_edits, total_tgt_length, sentence_ter = _ter_update(
        preds, target, tokenizer, 0.0, 0.0, sentence_ter
    )
    values = torch.tensor(
        [total_num_edits, total_tgt_length, *(sentence_ter or [])], dtype=torch.float32, device=resolve_device(device)
    )
    total_ter = _ter_compute(values[0], values[1])
    if sentence_ter is not None:
        return total_ter, list(values[2:].unbind())
    return total_ter


__all__ = ["translation_edit_rate"]
