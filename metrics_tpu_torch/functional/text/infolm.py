"""InfoLM: information measures between masked-LM distributions.

JAX counterpart: `metrics_tpu/functional/text/infolm.py` (``_IMEnum`` `:23`,
``_InformationMeasure`` `:35`, ``_load_mlm`` `:108`,
``_sentence_distribution`` `:119`, ``infolm`` `:196`): each sentence becomes
an aggregated masked-LM token distribution (idf-weighted on request) and the
score is an information measure between the two sentences' distributions. The
hub path loads ``transformers.AutoModelForMaskedLM`` (PyTorch) and raises
``ModuleNotFoundError`` without ``transformers``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.metric import resolve_device
from metrics_tpu_torch.utils.compute import high_precision
from metrics_tpu_torch.utils.enums import EnumStr
from metrics_tpu_torch.utils.imports import _TRANSFORMERS_AVAILABLE


class _IMEnum(EnumStr):
    KL_DIVERGENCE = "kl_divergence"
    ALPHA_DIVERGENCE = "alpha_divergence"
    BETA_DIVERGENCE = "beta_divergence"
    AB_DIVERGENCE = "ab_divergence"
    RENYI_DIVERGENCE = "renyi_divergence"
    L1_DISTANCE = "l1_distance"
    L2_DISTANCE = "l2_distance"
    L_INFINITY_DISTANCE = "l_infinity_distance"
    FISHER_RAO_DISTANCE = "fisher_rao_distance"


class _InformationMeasure:
    """The nine measures, with their parameters checked (`infolm.py:35`)."""

    def __init__(
        self,
        information_measure: str,
        alpha: Optional[float] = None,
        beta: Optional[float] = None,
    ) -> None:
        measure = _IMEnum.from_str_or_raise(information_measure, "information_measure")
        self.measure = measure
        if measure in (_IMEnum.ALPHA_DIVERGENCE, _IMEnum.AB_DIVERGENCE, _IMEnum.RENYI_DIVERGENCE):
            if not isinstance(alpha, float):
                raise ValueError(f"Parameter `alpha` is expected to be a float for {measure.value}.")
            if measure == _IMEnum.ALPHA_DIVERGENCE and alpha in (0.0, 1.0):
                raise ValueError("Parameter `alpha` cannot be 0 or 1 for alpha divergence.")
        if measure in (_IMEnum.BETA_DIVERGENCE, _IMEnum.AB_DIVERGENCE):
            if not isinstance(beta, float):
                raise ValueError(f"Parameter `beta` is expected to be a float for {measure.value}.")
            if measure == _IMEnum.BETA_DIVERGENCE and beta in (0.0, -1.0):
                raise ValueError("Parameter `beta` cannot be 0 or -1 for beta divergence.")
        if measure == _IMEnum.AB_DIVERGENCE and (alpha + beta) == 0:
            raise ValueError("alpha + beta cannot be 0 for AB divergence.")
        self.alpha = alpha
        self.beta = beta

    def __call__(self, preds_distribution: Tensor, target_distribution: Tensor) -> Tensor:
        fn = getattr(self, f"_calculate_{self.measure.value}")
        return fn(preds_distribution, target_distribution)

    @staticmethod
    def _calculate_kl_divergence(p: Tensor, q: Tensor) -> Tensor:
        return torch.sum(p * (torch.log(torch.clamp(p, min=1e-12)) - torch.log(torch.clamp(q, min=1e-12))), dim=-1)

    def _calculate_alpha_divergence(self, p: Tensor, q: Tensor) -> Tensor:
        a = self.alpha
        return (1.0 / (a * (a - 1))) * (torch.sum(q**a * p ** (1 - a), dim=-1) - 1)

    def _calculate_beta_divergence(self, p: Tensor, q: Tensor) -> Tensor:
        b = self.beta
        term1 = torch.sum(p ** (b + 1), dim=-1) / (b * (b + 1))
        term2 = torch.sum(q ** (b + 1), dim=-1) / (b + 1)
        term3 = torch.sum(p * q**b, dim=-1) / b
        return term1 + term2 - term3

    def _calculate_ab_divergence(self, p: Tensor, q: Tensor) -> Tensor:
        a, b = self.alpha, self.beta
        x = torch.log(torch.clamp(torch.sum(q ** (a + b), dim=-1), min=1e-30)) / (b * (a + b))
        y = torch.log(torch.clamp(torch.sum(p ** (a + b), dim=-1), min=1e-30)) / (a * (a + b))
        z = torch.log(torch.clamp(torch.sum(q**a * p**b, dim=-1), min=1e-30)) / (a * b)
        return x + y - z

    def _calculate_renyi_divergence(self, p: Tensor, q: Tensor) -> Tensor:
        a = self.alpha
        return torch.log(torch.clamp(torch.sum(q**a * p ** (1 - a), dim=-1), min=1e-30)) / (a - 1)

    @staticmethod
    def _calculate_l1_distance(p: Tensor, q: Tensor) -> Tensor:
        return torch.sum(torch.abs(p - q), dim=-1)

    @staticmethod
    def _calculate_l2_distance(p: Tensor, q: Tensor) -> Tensor:
        return torch.sqrt(torch.sum((p - q) ** 2, dim=-1))

    @staticmethod
    def _calculate_l_infinity_distance(p: Tensor, q: Tensor) -> Tensor:
        return torch.amax(torch.abs(p - q), dim=-1)

    @staticmethod
    def _calculate_fisher_rao_distance(p: Tensor, q: Tensor) -> Tensor:
        return 2 * torch.arccos(torch.clamp(torch.sum(torch.sqrt(p * q), dim=-1), 0.0, 1.0))


def _load_mlm(model_name_or_path: str):
    """A hub tokenizer and ``transformers.AutoModelForMaskedLM`` (JAX: ``FlaxAutoModelForMaskedLM``)."""
    if not _TRANSFORMERS_AVAILABLE:
        raise ModuleNotFoundError("`infolm` metric requires the `transformers` package.")
    from transformers import AutoModelForMaskedLM, AutoTokenizer

    return AutoTokenizer.from_pretrained(model_name_or_path), AutoModelForMaskedLM.from_pretrained(model_name_or_path)


@high_precision
@torch.no_grad()
def _sentence_distribution(
    sentences: List[str],
    tokenizer,
    model,
    temperature: float,
    max_length: int,
    idf: bool,
    batch_size: int = 64,
    device: Optional[torch.device] = None,
) -> Tensor:
    """Each sentence's masked-LM distribution, aggregated over its positions: every position is
    masked in turn, its predicted token distribution kept, and the positions averaged (idf-weighted
    when asked). The forwards run ``batch_size`` sentences at a time on ``device``; the position loop
    stops at the longest real (unpadded) sequence, exactly, since padding weighs nothing."""
    enc = tokenizer(sentences, padding="max_length", max_length=max_length, truncation=True, return_tensors="np")
    input_ids = np.asarray(enc["input_ids"])
    attention_mask = np.asarray(enc["attention_mask"])
    batch, _ = input_ids.shape
    # special tokens ([CLS]/[SEP]/pad) weigh nothing: a sentence's distribution
    # averages over its real word positions
    special_ids = [
        tid
        for tid in (tokenizer.pad_token_id, tokenizer.sep_token_id, tokenizer.cls_token_id)
        if tid is not None
    ]
    token_mask = attention_mask.astype(bool) & ~np.isin(input_ids, special_ids)
    mask_token_id = tokenizer.mask_token_id

    if idf:
        num_docs = batch
        df: Dict[int, int] = {}
        for row, m in zip(input_ids, attention_mask):
            for tid in {t for t, mm in zip(row, m) if mm}:
                df[tid] = df.get(tid, 0) + 1
        idf_w = np.array(
            [[math.log((num_docs + 1) / (df.get(t, 0) + 1)) for t in row] for row in input_ids], dtype=np.float32
        )
    else:
        idf_w = np.ones_like(input_ids, dtype=np.float32)

    # a row whose weights are all zero (an empty sentence tokenizes to
    # specials only; under idf even its attention mask weighs zero) falls
    # back to uniform weights over its attended positions, so its
    # distribution stays a finite probability vector
    weights = idf_w * token_mask
    dead_rows = ~(weights > 0).any(axis=1)
    if dead_rows.any():
        weights = np.where(dead_rows[:, None], attention_mask.astype(np.float32), weights)
    # a forward only for the positions some row weighs
    real_positions = np.nonzero((weights > 0).any(axis=0))[0] if batch else np.zeros((0,), dtype=np.int64)

    chunks = []
    for start in range(0, batch, batch_size):
        ids_c = torch.as_tensor(input_ids[start : start + batch_size], device=device)
        am_c = torch.as_tensor(attention_mask[start : start + batch_size], device=device)
        distributions = []
        for pos in real_positions.tolist():
            masked = ids_c.clone()
            masked.select(1, pos).fill_(mask_token_id)  # fill_ with a Python number: no scalar tensor to read back
            logits = model(input_ids=masked, attention_mask=am_c).logits
            distributions.append(torch.softmax(logits[:, pos, :] / temperature, dim=-1))
        dist = torch.stack(distributions, dim=1)  # (b, positions, V)
        w = torch.as_tensor(weights[start : start + batch_size][:, real_positions], device=device)
        w = w / torch.clamp(w.sum(dim=1, keepdim=True), min=1e-12)
        chunks.append(torch.einsum("bl,blv->bv", w, dist))
    return torch.cat(chunks, dim=0)


def infolm(
    preds: Union[str, List[str]],
    target: Union[str, List[str]],
    model_name_or_path: str = "bert-base-uncased",
    temperature: float = 0.25,
    information_measure: str = "kl_divergence",
    idf: bool = True,
    alpha: Optional[float] = None,
    beta: Optional[float] = None,
    device: Optional[Any] = None,
    max_length: Optional[int] = None,
    batch_size: int = 64,
    num_threads: int = 0,
    verbose: bool = True,
    return_sentence_level_score: bool = False,
    model: Optional[Any] = None,
    user_tokenizer: Optional[Any] = None,
):
    """InfoLM score between predictions and references.

    Requires an MLM checkpoint reachable by ``transformers``, OR an explicit
    ``model`` + ``user_tokenizer`` pair: a PyTorch masked LM called as
    ``model(input_ids=..., attention_mask=...).logits`` and a tokenizer with
    the transformers call contract (``padding="max_length"``,
    ``truncation=True``, ``return_tensors="np"``). ``device`` is where the
    forwards' inputs go and the distributions and measures are computed
    (None: the card; a user ``model`` is not moved, a hub model is).
    ``num_threads``/``verbose`` are accepted for signature compatibility and
    unused.

    Example:
        >>> from metrics_tpu_torch.functional import infolm
        >>> preds = ["he read the book because he was interested in world history"]
        >>> target = ["he was interested in world history because he read the book"]
        >>> score = infolm(preds, target,
        ...     model_name_or_path="google/bert_uncased_L-2_H-128_A-2",
        ...     idf=False)  # doctest: +SKIP
        >>> round(float(score), 4)  # doctest: +SKIP
        -0.1784
    """
    del num_threads, verbose  # accepted for signature compatibility; see the docstring
    dev = resolve_device(device)
    preds = [preds] if isinstance(preds, str) else list(preds)
    target = [target] if isinstance(target, str) else list(target)
    if len(preds) != len(target):
        raise ValueError("Number of predicted and reference sentences must be the same!")
    if temperature <= 0:
        raise ValueError("Temperature must be strictly positive.")
    if (model is None) != (user_tokenizer is None):
        raise ValueError("Both `model` and `user_tokenizer` must be provided together (or neither).")

    measure = _InformationMeasure(information_measure, alpha, beta)
    if model is not None:
        tokenizer = user_tokenizer
    else:
        tokenizer, model = _load_mlm(model_name_or_path)
        model = model.to(dev).eval()
    if max_length is None:
        # reference default: model.config.max_length (`functional/text/infolm.py`);
        # cap the tokenizer fallback, which can be a sentinel like 1e30
        max_length = getattr(model.config, "max_length", None) or min(
            getattr(tokenizer, "model_max_length", 512) or 512, 512
        )

    preds_distribution = _sentence_distribution(preds, tokenizer, model, temperature, max_length, idf, batch_size, dev)
    target_distribution = _sentence_distribution(target, tokenizer, model, temperature, max_length, idf, batch_size, dev)
    scores = measure(preds_distribution, target_distribution)
    if return_sentence_level_score:
        return scores.mean(), scores
    return scores.mean()


__all__ = ["infolm", "_InformationMeasure"]
