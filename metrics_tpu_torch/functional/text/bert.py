"""BERTScore.

JAX counterpart: `metrics_tpu/functional/text/bert.py` (``_load_flax_model``
`:37`, ``_zero_special_tokens`` `:55`, ``_default_forward`` `:63`,
``_compute_idf`` `:92`, ``_token_scale`` `:102`, ``_prepare_embeddings``
`:120`, ``_greedy_layerwise_scores`` `:128`, ``_read_baseline_csv`` `:144`,
``_rescale_with_baseline`` `:159`, ``bert_score`` `:219`): tokenize, embed
with a transformer, then greedy cosine matching with optional idf weights and
baseline rescaling. [CLS] and the last real token ([SEP]) leave the mask;
embeddings are unit-normalised and masked; per-token weights (idf or 1) are
normalised per sentence; ``all_layers=True`` scores every hidden layer.

The hub path loads ``transformers.AutoModel`` (PyTorch) and raises
``ModuleNotFoundError`` without ``transformers``. A ``user_forward_fn``
``(list[str]) -> (embeddings (N, L, D), mask (N, L))`` takes any model; its
mask must cover a [CLS]-like first position and a [SEP]-like last real
position, which the matcher drops. The matching runs on the call's device
(a metric's own device for the module), in blocks of ``batch_size`` pairs,
with float32 products at full precision.
"""
from __future__ import annotations

import math
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.metric import resolve_device
from metrics_tpu_torch.utils.compute import _l2_norm, high_precision
from metrics_tpu_torch.utils.imports import _TRANSFORMERS_AVAILABLE
from metrics_tpu_torch.utils.prints import rank_zero_warn


def _load_model(model_name_or_path: str):
    """A hub tokenizer and ``transformers.AutoModel`` (JAX: ``_load_flax_model`` with ``FlaxAutoModel``)."""
    if not _TRANSFORMERS_AVAILABLE:
        raise ModuleNotFoundError(
            "`bert_score` metric with default models requires `transformers` package be installed."
        )
    from transformers import AutoModel, AutoTokenizer

    return AutoTokenizer.from_pretrained(model_name_or_path), AutoModel.from_pretrained(model_name_or_path)


def _zero_special_tokens(mask: Tensor) -> Tensor:
    """Zero the [CLS] column and each row's last real position ([SEP]); the last real position is
    ``argmax(cumsum(mask - 0.1))``, which is 0 on a row of padding only."""
    mask = mask.clone()
    mask.select(1, 0).fill_(0)
    sep_pos = torch.argmax(torch.cumsum(mask - 0.1, dim=-1), dim=-1)
    rows = torch.arange(mask.shape[0], device=mask.device)
    # a zero on the mask's device: an assigned Python number would go through a host scalar tensor
    return mask.index_put_((rows, sep_pos), torch.zeros((), dtype=mask.dtype, device=mask.device))


@torch.no_grad()
def _default_forward(
    enc: Dict[str, np.ndarray],
    model,
    num_layers: Optional[int],
    all_layers: bool,
    batch_size: int,
    device: torch.device,
) -> Tensor:
    """The (B, L, S, D) hidden-state stack of the tokenized input (L = 1 unless ``all_layers``).

    The model runs on ``device`` a batch at a time; the stacks gather on the
    host, as in JAX, and the matcher takes them back a block at a time.
    """
    n = enc["input_ids"].shape[0]
    stacks = []
    for start in range(0, n, batch_size):
        outputs = model(
            input_ids=torch.as_tensor(enc["input_ids"][start : start + batch_size], device=device),
            attention_mask=torch.as_tensor(enc["attention_mask"][start : start + batch_size], device=device),
            output_hidden_states=True,
        )
        if all_layers:
            stacks.append(torch.stack([h.cpu() for h in outputs.hidden_states], dim=1))
        else:
            stacks.append(outputs.hidden_states[num_layers if num_layers is not None else -1].cpu()[:, None])
    return torch.cat(stacks, dim=0)


def _as_float_tensor(x, device: torch.device) -> Tensor:
    """Embeddings on ``device``; float64 becomes float32, as a JAX array is made without x64."""
    x = torch.as_tensor(x, device=device)
    return x.to(torch.float32) if x.dtype == torch.float64 else x


def _as_mask_tensor(x, device: torch.device) -> Tensor:
    """A mask on ``device``; 64-bit integers and floats narrow to 32 bits, as a JAX array is made without x64."""
    x = torch.as_tensor(x, device=device)
    if x.dtype == torch.int64:
        return x.to(torch.int32)
    return x.to(torch.float32) if x.dtype == torch.float64 else x


def _compute_idf(corpus_token_ids: np.ndarray) -> Dict[int, float]:
    """Inverse document frequency over the (padded) target corpus rows —
    same counting as reference `helper_embedding_metric.py:230-247`."""
    num_docs = len(corpus_token_ids)
    df: Counter = Counter()
    for row_ids in corpus_token_ids:
        df.update(set(int(t) for t in row_ids))
    return {tid: math.log((num_docs + 1) / (cnt + 1)) for tid, cnt in df.items()}


def _token_scale(
    token_ids: Optional[np.ndarray],
    processed_mask: Tensor,
    idf_map: Optional[Dict[int, float]],
    idf_default: float,
) -> Tensor:
    """Per-token weights, (idf or 1) times the mask without the special tokens, normalised per sentence."""
    if idf_map is not None:
        idf_vals = torch.tensor(
            [[idf_map.get(int(tid), idf_default) for tid in row] for row in token_ids],
            dtype=torch.float32,
            device=processed_mask.device,
        )
        scale = idf_vals * processed_mask
    else:
        scale = processed_mask.to(torch.float32)
    return scale / scale.sum(dim=-1, keepdim=True)


def _prepare_embeddings(emb: Tensor, processed_mask: Tensor) -> Tensor:
    """Unit-normalise, then zero the masked and special positions: (B, L, S, D)."""
    emb = emb / torch.clamp(_l2_norm(emb, dim=-1, keepdim=True), min=1e-12)
    return emb * processed_mask[:, None, :, None]


@high_precision
def _greedy_layerwise_scores(
    pred_emb: Tensor,
    pred_scale: Tensor,
    target_emb: Tensor,
    target_scale: Tensor,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Greedy cosine matching per layer: (B, L, P, D) x (B, L, R, D) -> (L, B) precision, recall, F1.

    Float32 products at full precision (no TF32 on the card); a NaN F1 becomes 0.
    """
    sim = torch.einsum("blpd,blrd->blpr", pred_emb, target_emb)
    precision = torch.einsum("blp,bp->bl", sim.max(dim=3).values, pred_scale)
    recall = torch.einsum("blr,br->bl", sim.max(dim=2).values, target_scale)
    f1 = 2 * precision * recall / (precision + recall)
    f1 = torch.nan_to_num(f1, nan=0.0)
    return precision.T, recall.T, f1.T


def _read_baseline_csv(baseline_path: str) -> Tensor:
    """A bert_score baseline csv (a header, then ``layer,P,R,F`` rows) as the (n_layers, 3) P/R/F table."""
    import csv

    with open(baseline_path) as fname:
        rows = [[float(item) for item in row] for idx, row in enumerate(csv.reader(fname)) if idx > 0]
    if not rows:
        raise ValueError(f"Baseline file {baseline_path!r} contains no data rows")
    return torch.tensor(rows, dtype=torch.float32)[:, 1:]


def _rescale_with_baseline(
    precision: Tensor,
    recall: Tensor,
    f1: Tensor,
    baseline: Tensor,
    num_layers: Optional[int],
    all_layers: bool,
) -> Tuple[Tensor, Tensor, Tensor]:
    """(x - b) / (1 - b) per layer."""
    metrics = torch.stack([precision, recall, f1], dim=-1)  # (L, B, 3)
    baseline = baseline.to(metrics.device)
    if all_layers:
        if baseline.shape[0] != metrics.shape[0]:
            raise ValueError(
                f"Baseline has {baseline.shape[0]} layer rows but the model produced"
                f" {metrics.shape[0]} layers; `all_layers=True` rescaling needs one row per layer."
            )
        scale = baseline[:, None, :]
    else:
        layer_idx = -1 if num_layers is None else num_layers
        if not -baseline.shape[0] <= layer_idx < baseline.shape[0]:
            raise ValueError(
                f"num_layers={layer_idx} is out of range for the baseline file with"
                f" {baseline.shape[0]} layer rows."
            )
        scale = baseline[layer_idx]
    metrics = (metrics - scale) / (1 - scale)
    return metrics[..., 0], metrics[..., 1], metrics[..., 2]


def _get_hash(model_name_or_path: Optional[str], num_layers: Optional[int], idf: bool) -> str:
    """Same hash string as the original bert-score package (reference
    `functional/text/bert.py:160-163`)."""
    return f"{model_name_or_path}_L{num_layers}{'_idf' if idf else '_no-idf'}"


def _tokenize(sentences: Union[List[str], Dict[str, Any]], tokenizer, max_length: int) -> Dict[str, np.ndarray]:
    if isinstance(sentences, dict):
        return {
            "input_ids": np.asarray(sentences["input_ids"]),
            "attention_mask": np.asarray(sentences["attention_mask"]),
        }
    # pad to the corpus longest, not max_length: short-sentence corpora would
    # otherwise attend over (and stack hidden states for) 512 mostly-pad
    # positions — the reference trims per batch the same way (`_input_data_collator`)
    enc = tokenizer(
        sentences,
        padding="longest",
        max_length=max_length,
        truncation=True,
        return_tensors="np",
    )
    return {"input_ids": np.asarray(enc["input_ids"]), "attention_mask": np.asarray(enc["attention_mask"])}


def _to_output(precision: Tensor, recall: Tensor, f1: Tensor) -> Dict[str, Union[float, List[float], List[List[float]]]]:
    """Each (L, B) result as Python lists with the singleton dims squeezed (one layer: a flat list; one
    pair: a float); the three come to the host in one copy."""
    host = torch.stack([precision, recall, f1]).detach().cpu().numpy()
    return {key: host[i].squeeze().tolist() for i, key in enumerate(("precision", "recall", "f1"))}


def bert_score(
    preds: Union[str, List[str], Dict[str, Any]],
    target: Union[str, List[str], Dict[str, Any]],
    model_name_or_path: Optional[str] = None,
    num_layers: Optional[int] = None,
    all_layers: bool = False,
    model: Optional[Any] = None,
    user_tokenizer: Optional[Any] = None,
    user_forward_fn: Optional[Callable] = None,
    verbose: bool = False,
    idf: bool = False,
    device: Optional[Any] = None,
    max_length: int = 512,
    batch_size: int = 64,
    num_threads: int = 4,
    return_hash: bool = False,
    lang: str = "en",
    rescale_with_baseline: bool = False,
    baseline_path: Optional[str] = None,
    baseline_url: Optional[str] = None,
) -> Dict[str, Union[float, List[float], List[List[float]], str]]:
    """BERTScore precision/recall/f1 per sentence pair.

    Either pass ``model_name_or_path`` (uses ``transformers.AutoModel``) or a
    ``user_forward_fn(sentences) -> (embeddings, mask)`` for custom/offline
    embedding models. Like the reference's user-tokenizer contract, the
    returned mask must include a [CLS]-equivalent first position and a
    [SEP]-equivalent final real position: the matcher zeroes both before
    scoring, so a forward that emits only real words loses its first and last
    token. ``preds``/``target`` may also be pre-tokenized dicts of
    ``input_ids``/``attention_mask`` arrays (the reference's tensor-input path).

    With ``all_layers=True`` every hidden layer is scored and each result is a
    ``(n_layers, n_pairs)`` nested list, matching the reference/bert-score
    package layout. ``device`` is where the forward's inputs go and the
    matching runs (None: the card; a user ``model`` is not moved, a hub
    model is). ``num_threads``/``baseline_url`` are accepted for signature
    compatibility and unused: baselines load from ``baseline_path`` only.

    Example:
        >>> from metrics_tpu_torch.functional import bert_score
        >>> preds = ["hello there", "general kenobi"]
        >>> target = ["hello there", "master kenobi"]
        >>> score = bert_score(preds, target,
        ...     model_name_or_path="roberta-large")  # doctest: +SKIP
        >>> {k: [round(float(s), 3) for s in v] for k, v in score.items()}  # doctest: +SKIP
        {'precision': [1.0, 0.996], 'recall': [1.0, 0.996], 'f1': [1.0, 0.996]}
    """
    del num_threads, baseline_url  # accepted for signature compatibility; see the docstring
    dev = resolve_device(device)
    preds = [preds] if isinstance(preds, str) else preds if isinstance(preds, dict) else list(preds)
    target = [target] if isinstance(target, str) else target if isinstance(target, dict) else list(target)
    if isinstance(preds, list) and isinstance(target, list) and len(preds) != len(target):
        raise ValueError("Number of predicted and reference sentences must be the same!")
    if (model is None) != (user_tokenizer is None):
        # reference `functional/text/bert.py` validates the pair together
        raise ValueError("Both `model` and `user_tokenizer` must be provided together (or neither).")
    if all_layers and user_forward_fn is not None:
        raise ValueError("The option `all_layers=True` can be used only with default `transformers` models.")

    if isinstance(preds, list) and len(preds) == 0 and isinstance(target, list) and len(target) == 0:
        rank_zero_warn("Predictions and references are empty.")
        output_dict: Dict[str, Union[List[float], str]] = {"precision": [0.0], "recall": [0.0], "f1": [0.0]}
        if return_hash:
            output_dict["hash"] = _get_hash(model_name_or_path, num_layers, idf)
        return output_dict

    if user_forward_fn is not None:
        pred_emb, pred_mask = user_forward_fn(preds)
        target_emb, target_mask = user_forward_fn(target)
        pred_emb = _as_float_tensor(pred_emb, dev)[:, None]  # (B, 1, S, D)
        target_emb = _as_float_tensor(target_emb, dev)[:, None]
        pred_ids = target_ids = None
    else:
        name = model_name_or_path or "roberta-large"
        if model is not None:
            tokenizer, encoder = user_tokenizer, model
        else:
            tokenizer, encoder = _load_model(name)
            encoder = encoder.to(dev).eval()
        try:
            n_hidden = encoder.config.num_hidden_layers
            if num_layers and num_layers > n_hidden:
                raise ValueError(
                    f"num_layers={num_layers} is forbidden for {model_name_or_path}."
                    f" Please use num_layers <= {n_hidden}"
                )
        except AttributeError:
            rank_zero_warn("It was not possible to retrieve the parameter `num_layers` from the model specification.")
        pred_enc = _tokenize(preds, tokenizer, max_length)
        target_enc = _tokenize(target, tokenizer, max_length)
        if pred_enc["input_ids"].shape[0] != target_enc["input_ids"].shape[0]:
            raise ValueError("Number of predicted and reference sentences must be the same!")
        pred_emb = _default_forward(pred_enc, encoder, num_layers, all_layers, batch_size, dev)
        target_emb = _default_forward(target_enc, encoder, num_layers, all_layers, batch_size, dev)
        pred_mask, target_mask = pred_enc["attention_mask"], target_enc["attention_mask"]
        pred_ids, target_ids = pred_enc["input_ids"], target_enc["input_ids"]

    idf_map = None
    idf_default = 0.0
    if idf:
        if pred_ids is None or target_ids is None:
            raise ValueError("`idf=True` requires tokenized ids; not available with `user_forward_fn`.")
        # idf is computed on the reference corpus and shared with predictions
        idf_map = _compute_idf(target_ids)
        idf_default = math.log(len(target_ids) + 1)

    pred_processed = _zero_special_tokens(_as_mask_tensor(pred_mask, dev))
    target_processed = _zero_special_tokens(_as_mask_tensor(target_mask, dev))
    pred_scale = _token_scale(pred_ids, pred_processed, idf_map, idf_default)
    target_scale = _token_scale(target_ids, target_processed, idf_map, idf_default)

    # pairs matched a block of batch_size at a time: one (B, L, P, R) similarity
    # tensor for a whole corpus would not fit on the device
    n_pairs = pred_processed.shape[0]
    if n_pairs == 0:
        # zero-row tensor/dict inputs (the list early-out above covers lists)
        empty = torch.zeros((pred_emb.shape[1], 0), dtype=torch.float32)
        return {
            **_to_output(empty, empty, empty),
            **({"hash": _get_hash(model_name_or_path, num_layers, idf)} if return_hash else {}),
        }
    chunks = []
    for start in range(0, n_pairs, batch_size):
        sl = slice(start, start + batch_size)
        chunks.append(
            _greedy_layerwise_scores(
                _prepare_embeddings(pred_emb[sl].to(dev), pred_processed[sl]),
                pred_scale[sl],
                _prepare_embeddings(target_emb[sl].to(dev), target_processed[sl]),
                target_scale[sl],
            )
        )
    precision = torch.cat([c[0] for c in chunks], dim=1)
    recall = torch.cat([c[1] for c in chunks], dim=1)
    f1 = torch.cat([c[2] for c in chunks], dim=1)

    if rescale_with_baseline:
        if baseline_path is None:
            raise ValueError(
                "`rescale_with_baseline=True` requires `baseline_path` pointing to a local baseline"
                " csv (the bert_score format: header row, then `layer,P,R,F` rows — no downloads here)."
            )
        baseline = _read_baseline_csv(baseline_path)
        precision, recall, f1 = _rescale_with_baseline(precision, recall, f1, baseline, num_layers, all_layers)

    output_dict = _to_output(precision, recall, f1)
    if return_hash:
        output_dict["hash"] = _get_hash(model_name_or_path, num_layers, idf)
    return output_dict


__all__ = ["bert_score"]
