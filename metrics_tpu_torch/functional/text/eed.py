"""Extended Edit Distance (EED).

JAX counterpart: `metrics_tpu/functional/text/eed.py` (``_eed_function``
`:23`, the preprocessors `:62-104`, ``_eed_update`` `:120` with its batch call
`:135-160`, ``_eed_compute`` `:163`, ``extended_edit_distance`` `:169`), after
Stanchev et al. 2019: a CDER-style alignment grid over characters with
insertion, deletion and substitution costs, a long jump at blanks (penalty
``alpha``) and a coverage penalty ``rho`` for positions visited again; the
en/ja preprocessing is the published one. The grid runs in the host text
library; ``_eed_function`` is its plain Python version.
"""
from __future__ import annotations

import re
import unicodedata
from math import inf
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.metric import resolve_device
from metrics_tpu_torch.ops import text_native


def _eed_function(
    hyp: str,
    ref: str,
    alpha: float = 2.0,
    rho: float = 0.3,
    deletion: float = 0.2,
    insertion: float = 1.0,
) -> float:
    """Score one (hypothesis, reference) character pair on the CDER grid: the Python program, the plain
    version of the host library's ``mt_eed_score`` (no metric calls it)."""
    hyp_len = len(hyp)
    number_of_visits = [-1] * (hyp_len + 1)
    row = [1.0] * (hyp_len + 1)
    row[0] = 0.0

    for w in range(1, len(ref) + 1):
        next_row = [inf] * (hyp_len + 1)
        next_row[0] = row[0] + 1.0
        ref_char = ref[w - 1]
        for i in range(1, hyp_len + 1):
            sub_cost = 0.0 if hyp[i - 1] == ref_char else 1.0
            next_row[i] = min(
                next_row[i - 1] + deletion,
                row[i - 1] + sub_cost,
                row[i] + insertion,
            )

        min_index = next_row.index(min(next_row))
        number_of_visits[min_index] += 1

        if ref_char == " ":  # long jump allowed at word boundaries
            jump = alpha + next_row[min_index]
            next_row = [min(x, jump) for x in next_row]

        row = next_row

    coverage = rho * sum(x if x >= 0 else 1 for x in number_of_visits)
    return min(1.0, (row[-1] + coverage) / (float(len(ref)) + coverage))


def _preprocess_en(sentence: str) -> str:
    """Published EED English preprocessing (punctuation spacing, abbreviations)."""
    if not isinstance(sentence, str):
        raise ValueError(f"Only strings allowed during preprocessing step, found {type(sentence)} instead")
    sentence = sentence.rstrip()
    for pattern, replacement in ((".", " ."), ("!", " !"), ("?", " ?"), (",", " ,")):
        sentence = sentence.replace(pattern, replacement)
    for pattern, replacement in (
        (r"\s+", r" "),
        (r"(\d) ([.,]) (\d)", r"\1\2\3"),
        (r"(Dr|Jr|Prof|Rev|Gen|Mr|Mt|Mrs|Ms) .", r"\1."),
    ):
        sentence = re.sub(pattern, replacement, sentence)
    for pattern, replacement in (("e . g .", "e.g."), ("i . e .", "i.e."), ("U . S .", "U.S.")):
        sentence = sentence.replace(pattern, replacement)
    return " " + sentence + " "


def _preprocess_ja(sentence: str) -> str:
    if not isinstance(sentence, str):
        raise ValueError(f"Only strings allowed during preprocessing step, found {type(sentence)} instead")
    return unicodedata.normalize("NFKC", sentence.rstrip())


def _preprocess_sentences(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    language: str,
) -> Tuple[Sequence[str], Sequence[Sequence[str]]]:
    if isinstance(preds, str):
        preds = [preds]
    target = [[tgt] if isinstance(tgt, str) else tgt for tgt in target]
    if len(preds) != len(target):
        raise ValueError(f"Corpus has different size {len(preds)} != {len(target)}")
    if language == "en":
        prep = _preprocess_en
    elif language == "ja":
        prep = _preprocess_ja
    else:
        raise ValueError(f"Expected argument `language` to either be `en` or `ja` but got {language}")
    return [prep(p) for p in preds], [[prep(t) for t in tgts] for tgts in target]


def _compute_sentence_statistics(
    preds_sentence: str,
    target_sentences: Sequence[str],
    alpha: float,
    rho: float,
    deletion: float,
    insertion: float,
) -> float:
    """The best (lowest) plain-program score over the references."""
    best_score = inf
    for reference in target_sentences:
        best_score = min(best_score, _eed_function(preds_sentence, reference, alpha, rho, deletion, insertion))
    return best_score


def _eed_update(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    language: str = "en",
    alpha: float = 2.0,
    rho: float = 0.3,
    deletion: float = 0.2,
    insertion: float = 1.0,
) -> np.ndarray:
    """Each sentence's best score over its references, float32 on the host.

    Every (hypothesis, reference) pair of the batch runs in one call into the
    host library (codepoints packed as CSR); the best of each sentence's
    references is a host reduction.
    """
    preds, target = _preprocess_sentences(preds, target, language)
    if 0 in (len(preds), len(target[0])):
        return np.zeros(0, dtype=np.float32)
    pair_sent: List[int] = []
    hyp_ids: List[np.ndarray] = []
    ref_ids: List[np.ndarray] = []
    for si, (hypothesis, target_sentences) in enumerate(zip(preds, target)):
        h = text_native.codepoints(hypothesis)
        for reference in target_sentences:
            pair_sent.append(si)
            hyp_ids.append(h)
            ref_ids.append(text_native.codepoints(reference))
    scores = text_native.eed_batch(hyp_ids, ref_ids, alpha, rho, deletion, insertion)
    best = np.full(len(preds), np.inf)
    np.minimum.at(best, np.asarray(pair_sent, dtype=np.int64), scores)
    return best.astype(np.float32)


def _eed_compute(sentence_level_scores: Tensor) -> Tensor:
    if sentence_level_scores.numel() == 0:
        return torch.zeros((), dtype=torch.float32, device=sentence_level_scores.device)
    return torch.mean(sentence_level_scores)


def extended_edit_distance(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    language: str = "en",
    return_sentence_level_score: bool = False,
    alpha: float = 2.0,
    rho: float = 0.3,
    deletion: float = 0.2,
    insertion: float = 1.0,
    *,
    device=None,
):
    """Corpus EED (lower is better, in [0, 1]).

    Example:
        >>> from metrics_tpu_torch.functional import extended_edit_distance
        >>> preds = ["this is the prediction", "here is an other sample"]
        >>> target = ["this is the reference", "here is another one"]
        >>> extended_edit_distance(preds, target, device="cpu")
        tensor(0.3078)
    """
    for param, name in ((alpha, "alpha"), (rho, "rho"), (deletion, "deletion"), (insertion, "insertion")):
        if not isinstance(param, float) or (isinstance(param, float) and param < 0):
            raise ValueError(f"Parameter `{name}` is expected to be a non-negative float.")

    scores = torch.from_numpy(_eed_update(preds, target, language, alpha, rho, deletion, insertion))
    scores = scores.to(resolve_device(device))  # one copy
    average = _eed_compute(scores)
    if return_sentence_level_score:
        return average, list(scores.unbind())
    return average


__all__ = ["extended_edit_distance"]
