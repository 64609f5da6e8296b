"""ROUGE-1, ROUGE-2, ROUGE-L and ROUGE-Lsum.

JAX counterpart: `metrics_tpu/functional/text/rouge.py` (``_create_stemmer``
`:30`, ``_rouge_tokenize`` `:40`, ``_lcs_length`` `:77`, ``_rouge_l_score``
`:101`, ``_split_sentences`` `:106`, ``_rouge_lsum_score`` `:111`,
``_lcs_elements`` `:142`, ``_rouge_score_update`` `:169`,
``_rouge_score_compute`` `:213`, ``rouge_score`` `:226`), after the
``rouge_score`` package: lowercase, split on non-alphanumerics, an optional
Porter stemmer (nltk), per-sentence scores with ``accumulate="best"|"avg"``
over several references. Host work; ROUGE-L's LCS runs in the host text
library.
"""
from __future__ import annotations

import re
from collections import Counter
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.metric import resolve_device
from metrics_tpu_torch.ops import text_native
from metrics_tpu_torch.utils.imports import _NLTK_AVAILABLE

ALLOWED_ROUGE_KEYS = {
    "rouge1": 1,
    "rouge2": 2,
    "rougeL": "L",
    "rougeLsum": "Lsum",
}
ALLOWED_ACCUMULATE_VALUES = ("avg", "best")


def _create_stemmer(use_stemmer: bool):
    if not use_stemmer:
        return None
    if not _NLTK_AVAILABLE:
        raise ModuleNotFoundError("Stemmer requires the nltk package")
    import nltk

    return nltk.stem.porter.PorterStemmer()


def _rouge_tokenize(text: str, stemmer=None, normalizer=None, tokenizer=None) -> List[str]:
    """rouge_score tokenization: lowercase, split on non-alphanumerics.

    ``normalizer``/``tokenizer`` callables override the default regex steps
    (reference `functional/text/rouge.py:146-171`).
    """
    text = normalizer(text) if callable(normalizer) else re.sub(r"[^a-z0-9]+", " ", text.lower())
    tokens = list(tokenizer(text)) if callable(tokenizer) else re.split(r"\s+", text)
    if stemmer:
        tokens = [stemmer.stem(x) if len(x) > 3 else x for x in tokens]
    return [x for x in tokens if (isinstance(x, str) and len(x) > 0)]


def _pr_f(hits: int, pred_len: int, target_len: int) -> Dict[str, float]:
    # host floats: they reach the device once an update (module) or a call (functional)
    precision = hits / pred_len if pred_len > 0 else 0.0
    recall = hits / target_len if target_len > 0 else 0.0
    if precision + recall > 0:
        fmeasure = 2 * precision * recall / (precision + recall)
    else:
        fmeasure = 0.0
    return {"precision": precision, "recall": recall, "fmeasure": fmeasure}


def _rouge_n_score(pred: List[str], target: List[str], n_gram: int) -> Dict[str, float]:
    def _ngrams(tokens: List[str]) -> Counter:
        return Counter(tuple(tokens[i : i + n_gram]) for i in range(len(tokens) - n_gram + 1))

    pred_ngrams, target_ngrams = _ngrams(pred), _ngrams(target)
    pred_len = sum(pred_ngrams.values())
    target_len = sum(target_ngrams.values())
    hits = sum((pred_ngrams & target_ngrams).values())
    return _pr_f(hits, pred_len, target_len)


def _lcs_length(pred: List[str], target: List[str]) -> int:
    """Longest common subsequence length, from the host library."""
    if len(pred) == 0 or len(target) == 0:
        return 0
    a_ids, b_ids = text_native.intern_ids(pred, target)
    return text_native.lcs_length(a_ids, b_ids)


def _lcs_length_plain(pred: List[str], target: List[str]) -> int:
    """The same length by the rolling-row Python program (`rouge.py:77-99`): the library's plain version."""
    m, n = len(pred), len(target)
    if m == 0 or n == 0:
        return 0
    prev = np.zeros(n + 1, dtype=np.int32)
    for i in range(1, m + 1):
        curr = np.zeros(n + 1, dtype=np.int32)
        for j in range(1, n + 1):
            if pred[i - 1] == target[j - 1]:
                curr[j] = prev[j - 1] + 1
            else:
                curr[j] = max(prev[j], curr[j - 1])
        prev = curr
    return int(prev[n])


def _rouge_l_score(pred: List[str], target: List[str]) -> Dict[str, float]:
    lcs = _lcs_length(pred, target)
    return _pr_f(lcs, len(pred), len(target))


def _split_sentences(x: str) -> List[str]:
    """Sentence splitting for rougeLsum (newline convention of rouge_score)."""
    return [s for s in re.split(r"\n", x) if len(s) > 0]


def _rouge_lsum_score(pred: str, target: str, stemmer=None, normalizer=None, tokenizer=None) -> Dict[str, float]:
    """Summary-level LCS: union-LCS over sentence pairs (rouge_score convention)."""
    pred_sents = [_rouge_tokenize(s, stemmer, normalizer, tokenizer) for s in _split_sentences(pred)]
    target_sents = [_rouge_tokenize(s, stemmer, normalizer, tokenizer) for s in _split_sentences(target)]
    m = sum(map(len, target_sents))
    n = sum(map(len, pred_sents))
    if m == 0 or n == 0:
        return _pr_f(0, n, m)

    # union-LCS: for each target sentence, union of LCS token hits vs all pred sentences
    token_cnts_t = Counter()
    token_cnts_p = Counter()
    for s in target_sents:
        token_cnts_t.update(s)
    for s in pred_sents:
        token_cnts_p.update(s)
    hits = 0
    for t_sent in target_sents:
        lcs_union: set = set()
        for p_sent in pred_sents:
            lcs_ids = _lcs_elements(p_sent, t_sent)
            lcs_union |= set(lcs_ids)
        for tok_idx in lcs_union:
            tok = t_sent[tok_idx]
            if token_cnts_p[tok] > 0 and token_cnts_t[tok] > 0:
                hits += 1
                token_cnts_p[tok] -= 1
                token_cnts_t[tok] -= 1
    return _pr_f(hits, n, m)


def _lcs_elements(pred: List[str], target: List[str]) -> List[int]:
    """Indices (into target) of one LCS alignment.

    The JAX package's table and backtrack (`rouge.py:142-166`), on Python
    lists: the same table, without numpy's per-element indexing.
    """
    m, n = len(pred), len(target)
    if m == 0 or n == 0:
        return []
    table = [[0] * (n + 1)]
    for i in range(1, m + 1):
        up = table[-1]
        row = [0] * (n + 1)
        p = pred[i - 1]
        for j in range(1, n + 1):
            if p == target[j - 1]:
                row[j] = up[j - 1] + 1
            else:
                row[j] = up[j] if up[j] > row[j - 1] else row[j - 1]
        table.append(row)
    i, j = m, n
    ids = []
    while i > 0 and j > 0:
        if pred[i - 1] == target[j - 1]:
            ids.append(j - 1)
            i -= 1
            j -= 1
        elif table[i - 1][j] >= table[i][j - 1]:
            i -= 1
        else:
            j -= 1
    return ids[::-1]


def _rouge_score_update(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    rouge_keys_values: List,
    accumulate: str,
    stemmer=None,
    normalizer=None,
    tokenizer=None,
) -> Dict[Union[int, str], List[Dict[str, float]]]:
    results: Dict[Union[int, str], List[Dict[str, float]]] = {rk: [] for rk in rouge_keys_values}
    for pred_raw, target_raw_list in zip(preds, target):
        per_ref: List[Dict[Union[int, str], Dict[str, float]]] = []
        pred_tokens = _rouge_tokenize(pred_raw, stemmer, normalizer, tokenizer)
        for target_raw in target_raw_list:
            tgt_tokens = _rouge_tokenize(target_raw, stemmer, normalizer, tokenizer)
            scores_for_ref: Dict[Union[int, str], Dict[str, float]] = {}
            for rouge_key in rouge_keys_values:
                if isinstance(rouge_key, int):
                    score = _rouge_n_score(pred_tokens, tgt_tokens, rouge_key)
                elif rouge_key == "L":
                    score = _rouge_l_score(pred_tokens, tgt_tokens)
                else:  # Lsum
                    score = _rouge_lsum_score(pred_raw, target_raw, stemmer, normalizer, tokenizer)
                scores_for_ref[rouge_key] = score
            per_ref.append(scores_for_ref)

        if accumulate == "best":
            # best reference selected by the FIRST key's fmeasure, used for all
            # keys (reference `rouge.py:344-349` convention)
            first_key = rouge_keys_values[0]
            best = max(range(len(per_ref)), key=lambda i: float(per_ref[i][first_key]["fmeasure"]))
            for rouge_key in rouge_keys_values:
                results[rouge_key].append(per_ref[best][rouge_key])
        else:  # avg
            for rouge_key in rouge_keys_values:
                scores = [r[rouge_key] for r in per_ref]
                avg = {
                    k: sum(float(s[k]) for s in scores) / len(scores)
                    for k in ("precision", "recall", "fmeasure")
                }
                results[rouge_key].append(avg)
    return results


def _rouge_score_compute(sentence_results: Dict[str, List], device=None) -> Dict[str, Tensor]:
    """The mean of each key's sentence scores: module states, lists of (batch,) float32 tensors on ``device``."""
    out: Dict[str, Tensor] = {}
    for k, v in sentence_results.items():
        if isinstance(v, Tensor):  # a synced state gathered into one tensor
            out[k] = torch.mean(v.reshape(-1))
        elif not v:
            out[k] = torch.zeros((), dtype=torch.float32, device=device)
        else:
            out[k] = torch.mean(torch.cat([torch.atleast_1d(x) for x in v]))
    return out


def rouge_score(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str], Sequence[Sequence[str]]],
    accumulate: str = "best",
    use_stemmer: bool = False,
    normalizer: Optional[Callable[[str], str]] = None,
    tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
    rouge_keys: Union[str, Tuple[str, ...]] = ("rouge1", "rouge2", "rougeL", "rougeLsum"),
    *,
    device=None,
) -> Dict[str, Tensor]:
    """ROUGE score dict with ``{key}_{precision,recall,fmeasure}`` entries.

    Example:
        >>> from metrics_tpu_torch.functional import rouge_score
        >>> preds = "My name is John"
        >>> target = "Is your name John"
        >>> {k: round(float(v), 4) for k, v in rouge_score(preds, target, rouge_keys="rouge1", device="cpu").items()}
        {'rouge1_fmeasure': 0.75, 'rouge1_precision': 0.75, 'rouge1_recall': 0.75}
    """
    if accumulate not in ALLOWED_ACCUMULATE_VALUES:
        raise ValueError(
            f"Got unknown accumulate value {accumulate}. Expected to be one of {ALLOWED_ACCUMULATE_VALUES}"
        )
    stemmer = _create_stemmer(use_stemmer)
    if isinstance(rouge_keys, str):
        rouge_keys = (rouge_keys,)
    for key in rouge_keys:
        if key not in ALLOWED_ROUGE_KEYS:
            raise ValueError(f"Got unknown rouge key {key}. Expected to be one of {list(ALLOWED_ROUGE_KEYS)}")
    rouge_keys_values = [ALLOWED_ROUGE_KEYS[key] for key in rouge_keys]

    if isinstance(target, list) and all(isinstance(tgt, str) for tgt in target):
        target = [target] if isinstance(preds, str) else [[tgt] for tgt in target]
    if isinstance(preds, str):
        preds = [preds]
    if isinstance(target, str):
        target = [[target]]

    sentence_results = _rouge_score_update(
        preds, target, rouge_keys_values, accumulate, stemmer, normalizer, tokenizer
    )

    output: Dict[str, List[float]] = {
        f"rouge{rouge_key}_{tp}": [] for rouge_key in rouge_keys_values for tp in ("fmeasure", "precision", "recall")
    }
    for rouge_key, metrics in sentence_results.items():
        for metric in metrics:
            for tp, value in metric.items():
                output[f"rouge{rouge_key}_{tp}"].append(value)
    dev = resolve_device(device)
    values = torch.tensor(list(output.values()), dtype=torch.float32, device=dev)  # one copy: (keys, sentences)
    if values.shape[-1] == 0:
        return {k: torch.zeros((), dtype=torch.float32, device=dev) for k in output}
    return dict(zip(output, values.mean(dim=1).unbind()))


__all__ = ["rouge_score", "ALLOWED_ROUGE_KEYS"]
