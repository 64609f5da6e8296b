"""SQuAD exact match and F1.

JAX counterpart: `metrics_tpu/functional/text/squad.py:28-139`: the official
SQuAD v1 normalization (lowercase, strip punctuation, articles and extra
whitespace), the best over the gold answers. Host work; the sums reach the
device in one copy.
"""
from __future__ import annotations

import re
import string
from collections import Counter
from typing import Any, Callable, Dict, List, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.metric import resolve_device

PREDS_TYPE = Union[Dict[str, str], List[Dict[str, str]]]
TARGETS_TYPE = Union[Dict[str, Any], List[Dict[str, Any]]]


# the official SQuAD v1 evaluation script's normalization IS the metric
# definition, so the RULES below are fixed by that spec: lowercase, drop
# punctuation characters, blank out English articles, collapse whitespace
_ARTICLES = re.compile(r"\b(a|an|the)\b")
_DROP_PUNCT = str.maketrans("", "", string.punctuation)


def _normalize_text(s: str) -> str:
    """One-pass transcription of the SQuAD v1 answer normalization."""
    return " ".join(_ARTICLES.sub(" ", s.lower().translate(_DROP_PUNCT)).split())


def _get_tokens(s: str) -> List[str]:
    return _normalize_text(s).split() if s else []


def _compute_f1_score(predicted_answer: str, target_answer: str) -> float:
    target_tokens = _get_tokens(target_answer)
    predicted_tokens = _get_tokens(predicted_answer)
    if not target_tokens or not predicted_tokens:
        # spec edge: both empty counts as a match, one empty scores zero
        return float(target_tokens == predicted_tokens)
    overlap = sum((Counter(target_tokens) & Counter(predicted_tokens)).values())
    if overlap == 0:
        return 0.0
    # harmonic mean of token precision/recall, simplified: 2*o / (|p| + |t|)
    return 2.0 * overlap / (len(predicted_tokens) + len(target_tokens))


def _compute_exact_match_score(prediction: str, ground_truth: str) -> float:
    return float(_normalize_text(prediction) == _normalize_text(ground_truth))


def _metric_max_over_ground_truths(metric_fn: Callable, prediction: str, ground_truths: List[str]) -> float:
    return max(metric_fn(prediction, gt) for gt in ground_truths)


def _squad_input_check(preds: PREDS_TYPE, targets: TARGETS_TYPE) -> Tuple[Dict[str, str], List[Dict[str, Any]]]:
    if isinstance(preds, dict):
        preds = [preds]
    if isinstance(targets, dict):
        targets = [targets]
    for pred in preds:
        keys = pred.keys()
        if "prediction_text" not in keys or "id" not in keys:
            raise KeyError(
                "Expected keys in a single prediction are 'prediction_text' and 'id'."
                " Please make sure that 'prediction_text' maps to the answer string and 'id' maps to the key string."
            )
    for target in targets:
        keys = target.keys()
        if "answers" not in keys or "id" not in keys:
            raise KeyError(
                "Expected keys in a single target are 'answers' and 'id'."
                " Please make sure that 'answers' maps to the SQuAD format."
            )
        answers_keys = target["answers"].keys()
        if "text" not in answers_keys:
            raise KeyError(
                "Expected keys in a 'answers' are 'text'."
                " Please make sure that 'text' maps to a list of strings."
            )

    preds_dict = {p["id"]: p["prediction_text"] for p in preds}
    targets_list = [
        {"answers": [{"text": txt} for txt in t["answers"]["text"]], "id": t["id"]} for t in targets
    ]
    return preds_dict, [{"paragraphs": [{"qas": targets_list}]}]


def _squad_update_host(preds: Dict[str, str], target: List[Dict[str, Any]]) -> Tuple[float, float, int]:
    """Host sums: (F1, exact matches, questions), Python numbers."""
    f1 = 0.0
    exact_match = 0.0
    total = 0
    for article in target:
        for paragraph in article["paragraphs"]:
            for qa in paragraph["qas"]:
                total += 1
                if qa["id"] not in preds:
                    continue
                ground_truths = [x["text"] for x in qa["answers"]]
                pred = preds[qa["id"]]
                exact_match += _metric_max_over_ground_truths(_compute_exact_match_score, pred, ground_truths)
                f1 += _metric_max_over_ground_truths(_compute_f1_score, pred, ground_truths)
    return f1, exact_match, total


def _squad_update(preds: Dict[str, str], target: List[Dict[str, Any]], device=None) -> Tuple[Tensor, Tensor, Tensor]:
    """The host sums on ``device`` in one copy: F1 and exact matches float32, the count int32."""
    f1, exact_match, total = _squad_update_host(preds, target)
    sums = torch.tensor([f1, exact_match, total], dtype=torch.float64, device=resolve_device(device))
    return sums[0].to(torch.float32), sums[1].to(torch.float32), sums[2].to(torch.int32)


def _squad_compute(f1: Tensor, exact_match: Tensor, total: Tensor) -> Dict[str, Tensor]:
    return {"exact_match": 100.0 * exact_match / total, "f1": 100.0 * f1 / total}


def squad(preds: PREDS_TYPE, target: TARGETS_TYPE, *, device=None) -> Dict[str, Tensor]:
    """SQuAD v1 EM/F1.

    Example:
        >>> from metrics_tpu_torch.functional import squad
        >>> preds = [{"prediction_text": "1976", "id": "56e10a3be3433e1400422b22"}]
        >>> target = [{"answers": {"answer_start": [97], "text": ["1976"]}, "id": "56e10a3be3433e1400422b22"}]
        >>> {k: float(v) for k, v in squad(preds, target, device="cpu").items()}
        {'exact_match': 100.0, 'f1': 100.0}
    """
    preds_dict, target_list = _squad_input_check(preds, target)
    f1, exact_match, total = _squad_update(preds_dict, target_list, device)
    return _squad_compute(f1, exact_match, total)


__all__ = ["squad"]
