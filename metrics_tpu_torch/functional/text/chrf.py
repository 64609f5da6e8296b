"""chrF and chrF++.

JAX counterpart: `metrics_tpu/functional/text/chrf.py:19-192`, following
sacrebleu's chrF: character n-grams (order 6) and optional word n-grams (order
2 gives chrF++), an F-beta per order averaged over the orders; with several
references the statistics of the best-scoring one are kept. Host work on
Python counters; the scores come back as float32 tensors in one copy.
"""
from __future__ import annotations

from collections import Counter, defaultdict
from typing import Dict, List, Sequence, Union

import torch

from metrics_tpu_torch.metric import resolve_device

_EPS_SMOOTHING = 1e-16


def _get_characters(sentence: str, whitespace: bool) -> List[str]:
    # without whitespace, edge whitespace is stripped and interior spaces
    # removed (reference `functional/text/chrf.py:81-93`: strip() + replace)
    if whitespace:
        return list(sentence)
    return list(sentence.strip().replace(" ", ""))


_PUNCTUATIONS = frozenset("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~")


def _separate_word_and_punctuation(word: str) -> List[str]:
    """At most ONE trailing-else-leading ASCII punctuation char splits off.

    The m-popovic/chrF rule sacrebleu and the reference implement
    (reference `functional/text/chrf.py:96-113`): single-char words are kept
    whole, a trailing punctuation char wins over a leading one, and the
    remainder is not re-split (``"well!!"`` -> ``["well!", "!"]``). Non-ASCII
    punctuation (e.g. ``。``) is NOT separated.
    """
    if len(word) == 1:
        return [word]
    if word[-1] in _PUNCTUATIONS:
        return [word[:-1], word[-1]]
    if word[0] in _PUNCTUATIONS:
        return [word[0], word[1:]]
    return [word]


def _get_words_and_punctuation(sentence: str) -> List[str]:
    out: List[str] = []
    for word in sentence.split():
        out.extend(_separate_word_and_punctuation(word))
    return out


def _ngram_counter(tokens: Sequence, n_order: int) -> Dict[int, Counter]:
    counts: Dict[int, Counter] = {n: Counter() for n in range(1, n_order + 1)}
    for n in range(1, n_order + 1):
        counts[n].update(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))
    return counts


def _totals(counts: Dict[int, Counter]) -> Dict[int, float]:
    return {n: float(sum(c.values())) for n, c in counts.items()}


def _matching(a: Dict[int, Counter], b: Dict[int, Counter]) -> Dict[int, float]:
    return {n: float(sum((a[n] & b[n]).values())) for n in a}


def _fscore_from_stats(
    matching_char: Dict[int, float],
    matching_word: Dict[int, float],
    hyp_char: Dict[int, float],
    hyp_word: Dict[int, float],
    ref_char: Dict[int, float],
    ref_word: Dict[int, float],
    n_order: float,
    beta: float,
) -> float:
    def _f(matching, ref, hyp):
        total = 0.0
        for n in matching:
            precision = matching[n] / hyp[n] if hyp[n] > 0 else 0.0
            recall = matching[n] / ref[n] if ref[n] > 0 else 0.0
            denom = max(beta**2 * precision + recall, _EPS_SMOOTHING)
            total += (1 + beta**2) * precision * recall / denom
        return total

    return (_f(matching_char, ref_char, hyp_char) + _f(matching_word, ref_word, hyp_word)) / n_order


def _sentence_stats(
    pred: str,
    targets: Sequence[str],
    n_char_order: int,
    n_word_order: int,
    beta: float,
    lowercase: bool,
    whitespace: bool,
):
    """Stats for the best-scoring reference of one sentence."""
    if lowercase:
        pred = pred.lower()
        targets = [t.lower() for t in targets]

    pred_char = _ngram_counter(_get_characters(pred, whitespace), n_char_order)
    pred_word = _ngram_counter(_get_words_and_punctuation(pred), n_word_order)
    hyp_char_tot, hyp_word_tot = _totals(pred_char), _totals(pred_word)
    n_order = float(n_char_order + n_word_order)

    best = None
    for tgt in targets:
        tgt_char = _ngram_counter(_get_characters(tgt, whitespace), n_char_order)
        tgt_word = _ngram_counter(_get_words_and_punctuation(tgt), n_word_order)
        m_char = _matching(pred_char, tgt_char)
        m_word = _matching(pred_word, tgt_word)
        ref_char_tot, ref_word_tot = _totals(tgt_char), _totals(tgt_word)
        score = _fscore_from_stats(
            m_char, m_word, hyp_char_tot, hyp_word_tot, ref_char_tot, ref_word_tot, n_order, beta
        )
        if best is None or score > best[0]:
            best = (score, m_char, m_word, ref_char_tot, ref_word_tot)
    return best, hyp_char_tot, hyp_word_tot


def chrf_score(
    preds: Union[str, Sequence[str]],
    target: Union[Sequence[str], Sequence[Sequence[str]]],
    n_char_order: int = 6,
    n_word_order: int = 2,
    beta: float = 2.0,
    lowercase: bool = False,
    whitespace: bool = False,
    return_sentence_level_score: bool = False,
    *,
    device=None,
):
    """Corpus chrF/chrF++ (``n_word_order=2`` gives chrF++; 0 gives chrF).

    Example:
        >>> from metrics_tpu_torch.functional import chrf_score
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> chrf_score(preds, target, device="cpu").round(decimals=4)
        tensor(0.8640)
    """
    if not isinstance(n_char_order, int) or n_char_order < 1:
        raise ValueError("Expected argument `n_char_order` to be an integer greater than or equal to 1.")
    if not isinstance(n_word_order, int) or n_word_order < 0:
        raise ValueError("Expected argument `n_word_order` to be an integer greater than or equal to 0.")
    if beta < 0:
        raise ValueError("Expected argument `beta` to be greater than 0.")

    preds_ = [preds] if isinstance(preds, str) else list(preds)
    target_ = [[t] if isinstance(t, str) else list(t) for t in target]
    if len(preds_) != len(target_):
        raise ValueError(f"Corpus has different size {len(preds_)} != {len(target_)}")

    n_order = float(n_char_order + n_word_order)
    tot_m_char: Dict[int, float] = defaultdict(float)
    tot_m_word: Dict[int, float] = defaultdict(float)
    tot_h_char: Dict[int, float] = defaultdict(float)
    tot_h_word: Dict[int, float] = defaultdict(float)
    tot_r_char: Dict[int, float] = defaultdict(float)
    tot_r_word: Dict[int, float] = defaultdict(float)
    sentence_scores: List[float] = []

    for i, (pred, targets) in enumerate(zip(preds_, target_)):
        if not targets:
            raise ValueError(f"Expected at least one reference sentence for prediction at index {i}, got none.")
        best, hyp_char_tot, hyp_word_tot = _sentence_stats(
            pred, targets, n_char_order, n_word_order, beta, lowercase, whitespace
        )
        score, m_char, m_word, ref_char_tot, ref_word_tot = best
        sentence_scores.append(score)
        for n in range(1, n_char_order + 1):
            tot_m_char[n] += m_char[n]
            tot_h_char[n] += hyp_char_tot[n]
            tot_r_char[n] += ref_char_tot[n]
        for n in range(1, n_word_order + 1):
            tot_m_word[n] += m_word[n]
            tot_h_word[n] += hyp_word_tot[n]
            tot_r_word[n] += ref_word_tot[n]

    corpus = _fscore_from_stats(
        dict(tot_m_char), dict(tot_m_word), dict(tot_h_char), dict(tot_h_word), dict(tot_r_char), dict(tot_r_word), n_order, beta
    )
    # the corpus score and the sentence scores in one copy to the device
    values = torch.tensor([corpus, *sentence_scores], dtype=torch.float32, device=resolve_device(device))
    if return_sentence_level_score:
        return values[0], list(values[1:].unbind())
    return values[0]


__all__ = ["chrf_score"]
