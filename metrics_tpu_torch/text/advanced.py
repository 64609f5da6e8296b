"""Text modules with list states or a model: ROUGE, chrF, TER, EED, BERTScore, InfoLM.

JAX counterpart: `metrics_tpu/text/advanced.py` (``_packed_bytes`` `:31`,
``ROUGEScore`` `:50`, ``CHRFScore`` `:130`, ``TranslationEditRate`` `:193`,
``ExtendedEditDistance`` `:245`, ``BERTScore`` `:304`, ``InfoLM`` `:397`).

chrF, BERTScore and InfoLM keep their sentences as packed uint8 ``cat``
states (:func:`metrics_tpu_torch.utils.data.pack_strings`), tensors on the
metric's device, so ``state_dict``, ``.to()`` and the coalesced sync treat
them as any other ``cat`` state. An update packs on the host and makes one
copy to the device; a ``compute()`` makes one copy of the concatenated bytes
back. ROUGE's per-sentence scores are lists of spec None, gathered row by row
by a sync, as in JAX.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.functional.text.bert import bert_score
from metrics_tpu_torch.functional.text.chrf import chrf_score
from metrics_tpu_torch.functional.text.eed import _eed_compute, _eed_update
from metrics_tpu_torch.functional.text.infolm import infolm
from metrics_tpu_torch.functional.text.rouge import (
    ALLOWED_ROUGE_KEYS,
    _create_stemmer,
    _rouge_score_compute,
    _rouge_score_update,
)
from metrics_tpu_torch.functional.text.ter import _TercomTokenizer, _ter_compute, _ter_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.data import (
    dim_zero_cat,
    pack_string_groups,
    pack_strings,
    unpack_string_groups,
    unpack_strings,
)


def _packed_bytes(state: Union[List[Tensor], Tensor]) -> Tensor:
    """A packed-string ``cat`` state as one uint8 tensor (a list before a sync, one tensor after it)."""
    if isinstance(state, (list, tuple)):
        if not state:
            return torch.zeros((0,), dtype=torch.uint8)
        return torch.cat(list(state))
    return state


def _append_packed(metric: Metric, first: np.ndarray, second: np.ndarray) -> None:
    """Append two packed arrays to ``preds_packed`` and ``target_packed`` with one copy to the device."""
    both = torch.from_numpy(np.concatenate([first, second])).to(metric.device)
    metric.preds_packed.append(both[: len(first)])
    metric.target_packed.append(both[len(first) :])


def _packed_to_host(preds_state, target_state) -> Tuple[np.ndarray, np.ndarray]:
    """Both packed states' bytes on the host, in one copy."""
    preds_bytes, target_bytes = _packed_bytes(preds_state), _packed_bytes(target_state)
    host = torch.cat([preds_bytes.reshape(-1), target_bytes.to(preds_bytes.device).reshape(-1)]).cpu().numpy()
    n = preds_bytes.numel()
    return host[:n], host[n:]


class ROUGEScore(Metric):
    """ROUGE-1/2/L/Lsum, accumulated per sentence.

    Example:
        >>> from metrics_tpu_torch import ROUGEScore
        >>> preds = 'My name is John'
        >>> target = 'Is your name John'
        >>> rouge = ROUGEScore(rouge_keys='rouge1', device="cpu")
        >>> {k: round(float(v), 4) for k, v in sorted(rouge(preds, target).items())}
        {'rouge1_fmeasure': 0.75, 'rouge1_precision': 0.75, 'rouge1_recall': 0.75}
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = True

    def __init__(
        self,
        use_stemmer: bool = False,
        normalizer: Optional[Callable[[str], str]] = None,
        tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
        accumulate: str = "best",
        rouge_keys: Union[str, Tuple[str, ...]] = ("rouge1", "rouge2", "rougeL", "rougeLsum"),
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if isinstance(rouge_keys, str):
            rouge_keys = (rouge_keys,)
        for key in rouge_keys:
            if key not in ALLOWED_ROUGE_KEYS:
                raise ValueError(f"Got unknown rouge key {key}. Expected to be one of {list(ALLOWED_ROUGE_KEYS)}")
        self.rouge_keys = rouge_keys
        self.rouge_keys_values = [ALLOWED_ROUGE_KEYS[key] for key in rouge_keys]
        self.stemmer = _create_stemmer(use_stemmer)
        self.normalizer = normalizer
        self.tokenizer = tokenizer
        self.accumulate = accumulate
        for rouge_key in self.rouge_keys:
            for score in ("fmeasure", "precision", "recall"):
                self.add_state(f"{rouge_key}_{score}", [], dist_reduce_fx=None)

    def update(self, preds, target) -> None:
        if isinstance(target, list) and all(isinstance(tgt, str) for tgt in target):
            target = [target] if isinstance(preds, str) else [[tgt] for tgt in target]
        if isinstance(preds, str):
            preds = [preds]
        if isinstance(target, str):
            target = [[target]]
        output = _rouge_score_update(
            preds, target, self.rouge_keys_values, self.accumulate, self.stemmer, self.normalizer, self.tokenizer
        )
        names, rows = [], []
        for rouge_key, metrics in output.items():
            if not metrics:
                continue
            for tp in ("fmeasure", "precision", "recall"):
                names.append(f"rouge{rouge_key}_{tp}")
                rows.append([float(metric[tp]) for metric in metrics])
        if not rows:
            return
        values = torch.tensor(rows, dtype=torch.float32, device=self.device)  # one copy: (keys x fields, batch)
        for name, row in zip(names, values.unbind()):
            getattr(self, name).append(row)

    def compute(self) -> Dict[str, Tensor]:
        update_output = {
            f"{rouge_key}_{score}": getattr(self, f"{rouge_key}_{score}")
            for rouge_key in self.rouge_keys
            for score in ("fmeasure", "precision", "recall")
        }
        return _rouge_score_compute(update_output, self.device)

    def __getstate__(self) -> Dict[str, Any]:
        state = super().__getstate__()
        state.pop("stemmer", None)  # an nltk stemmer may not pickle
        state["_use_stemmer"] = self.stemmer is not None
        return state

    def __setstate__(self, state: Dict[str, Any]) -> None:
        use_stemmer = state.pop("_use_stemmer", False)
        super().__setstate__(state)
        self.stemmer = _create_stemmer(use_stemmer)


class CHRFScore(Metric):
    """Corpus chrF/chrF++; its states are the packed sentence pairs, scored at ``compute()``.

    Example:
        >>> from metrics_tpu_torch import CHRFScore
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat']]
        >>> chrf = CHRFScore(device="cpu")
        >>> round(float(chrf(preds, target)), 4)
        0.4942
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = True

    def __init__(
        self,
        n_char_order: int = 6,
        n_word_order: int = 2,
        beta: float = 2.0,
        lowercase: bool = False,
        whitespace: bool = False,
        return_sentence_level_score: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.n_char_order = n_char_order
        self.n_word_order = n_word_order
        self.beta = beta
        self.lowercase = lowercase
        self.whitespace = whitespace
        self.return_sentence_level_score = return_sentence_level_score
        self.add_state("preds_packed", [], dist_reduce_fx="cat")
        self.add_state("target_packed", [], dist_reduce_fx="cat")

    def update(self, preds, target) -> None:
        preds_ = [preds] if isinstance(preds, str) else list(preds)
        target_ = [[t] if isinstance(t, str) else list(t) for t in target]
        if len(preds_) != len(target_):
            raise ValueError(f"Corpus has different size {len(preds_)} != {len(target_)}")
        _append_packed(self, pack_strings(preds_), pack_string_groups(target_))

    def compute(self):
        preds_bytes, target_bytes = _packed_to_host(self.preds_packed, self.target_packed)
        return chrf_score(
            unpack_strings(preds_bytes),
            unpack_string_groups(target_bytes),
            self.n_char_order,
            self.n_word_order,
            self.beta,
            self.lowercase,
            self.whitespace,
            self.return_sentence_level_score,
            device=self.device,
        )


class TranslationEditRate(Metric):
    """Corpus TER accumulated over batches.

    Example:
        >>> from metrics_tpu_torch import TranslationEditRate
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat']]
        >>> ter = TranslationEditRate(device="cpu")
        >>> round(float(ter(preds, target)), 4)
        0.4286
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False

    def __init__(
        self,
        normalize: bool = False,
        no_punctuation: bool = False,
        lowercase: bool = True,
        asian_support: bool = False,
        return_sentence_level_score: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.tokenizer = _TercomTokenizer(normalize, no_punctuation, lowercase, asian_support)
        self.return_sentence_level_score = return_sentence_level_score
        self.add_state("total_num_edits", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total_tgt_length", torch.tensor(0.0), dist_reduce_fx="sum")
        if return_sentence_level_score:
            self.add_state("sentence_ter", [], dist_reduce_fx="cat")

    def update(self, preds, target) -> None:
        sentences: Optional[List[float]] = [] if self.return_sentence_level_score else None
        num_edits, tgt_length, sentences = _ter_update(preds, target, self.tokenizer, 0.0, 0.0, sentences)
        values = torch.tensor([num_edits, tgt_length, *(sentences or [])], dtype=torch.float32, device=self.device)
        self.total_num_edits = self.total_num_edits + values[0]
        self.total_tgt_length = self.total_tgt_length + values[1]
        if sentences:
            self.sentence_ter.append(values[2:])

    def compute(self):
        ter = _ter_compute(self.total_num_edits, self.total_tgt_length)
        if self.return_sentence_level_score:
            return ter, dim_zero_cat(self.sentence_ter)
        return ter


class ExtendedEditDistance(Metric):
    """Corpus EED, accumulated per sentence.

    Example:
        >>> from metrics_tpu_torch import ExtendedEditDistance
        >>> preds = ['this is the prediction', 'here is an other sample']
        >>> target = ['this is the reference', 'here is another one']
        >>> eed = ExtendedEditDistance(device="cpu")
        >>> round(float(eed(preds, target)), 4)
        0.3078
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False

    def __init__(
        self,
        language: str = "en",
        return_sentence_level_score: bool = False,
        alpha: float = 2.0,
        rho: float = 0.3,
        deletion: float = 0.2,
        insertion: float = 1.0,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if language not in ("en", "ja"):
            raise ValueError(f"Expected argument `language` to either be `en` or `ja` but got {language}")
        self.language = language
        self.return_sentence_level_score = return_sentence_level_score
        for param, name in ((alpha, "alpha"), (rho, "rho"), (deletion, "deletion"), (insertion, "insertion")):
            if not isinstance(param, float) or (isinstance(param, float) and param < 0):
                raise ValueError(f"Parameter `{name}` is expected to be a non-negative float.")
        self.alpha = alpha
        self.rho = rho
        self.deletion = deletion
        self.insertion = insertion
        self.add_state("sentence_eed", [], dist_reduce_fx="cat")

    def update(self, preds, target) -> None:
        scores = _eed_update(preds, target, self.language, self.alpha, self.rho, self.deletion, self.insertion)
        if scores.size:
            self.sentence_eed.append(torch.from_numpy(scores).to(self.device))

    def compute(self):
        state = self.sentence_eed
        have_data = len(state) > 0 if isinstance(state, list) else state.numel() > 0
        if have_data:
            average = _eed_compute(dim_zero_cat(state))
        else:
            average = torch.zeros((), dtype=torch.float32, device=self.device)
        if self.return_sentence_level_score:
            return average, dim_zero_cat(state)
        return average


class BERTScore(Metric):
    """BERTScore over the accumulated sentence pairs.

    ``device`` is the metric's device (the ``Metric`` keyword): the states
    live there, and the forward's inputs and the matching go there.

    Example:
        >>> from metrics_tpu_torch import BERTScore
        >>> preds = ["hello there", "general kenobi"]
        >>> target = ["hello there", "master kenobi"]
        >>> bertscore = BERTScore(model_name_or_path="roberta-large")  # doctest: +SKIP
        >>> {k: [round(float(s), 3) for s in v]
        ...  for k, v in bertscore(preds, target).items()}  # doctest: +SKIP
        {'precision': [1.0, 0.996], 'recall': [1.0, 0.996], 'f1': [1.0, 0.996]}
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        model_name_or_path: Optional[str] = None,
        num_layers: Optional[int] = None,
        all_layers: bool = False,
        model: Optional[Any] = None,
        user_tokenizer: Optional[Any] = None,
        user_forward_fn: Optional[Any] = None,
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
        **kwargs: Any,
    ) -> None:
        super().__init__(device=device, **kwargs)
        self.model_name_or_path = model_name_or_path
        self.num_layers = num_layers
        self.all_layers = all_layers
        self.model = model
        self.user_tokenizer = user_tokenizer
        self.idf = idf
        self.user_forward_fn = user_forward_fn
        self.verbose = verbose
        self.max_length = max_length
        self.batch_size = batch_size
        self.num_threads = num_threads
        self.return_hash = return_hash
        self.lang = lang
        self.rescale_with_baseline = rescale_with_baseline
        self.baseline_path = baseline_path
        self.baseline_url = baseline_url
        self.add_state("preds_packed", [], dist_reduce_fx="cat")
        self.add_state("target_packed", [], dist_reduce_fx="cat")

    def update(self, preds, target) -> None:
        preds_ = [preds] if isinstance(preds, str) else list(preds)
        target_ = [target] if isinstance(target, str) else list(target)
        if len(preds_) != len(target_):
            raise ValueError("Number of predicted and reference sentences must be the same!")
        _append_packed(self, pack_strings(preds_), pack_strings(target_))

    def compute(self) -> Dict[str, List[float]]:
        preds_bytes, target_bytes = _packed_to_host(self.preds_packed, self.target_packed)
        return bert_score(
            unpack_strings(preds_bytes),
            unpack_strings(target_bytes),
            model_name_or_path=self.model_name_or_path,
            num_layers=self.num_layers,
            all_layers=self.all_layers,
            model=self.model,
            user_tokenizer=self.user_tokenizer,
            idf=self.idf,
            user_forward_fn=self.user_forward_fn,
            verbose=self.verbose,
            device=self.device,
            max_length=self.max_length,
            batch_size=self.batch_size,
            num_threads=self.num_threads,
            return_hash=self.return_hash,
            lang=self.lang,
            rescale_with_baseline=self.rescale_with_baseline,
            baseline_path=self.baseline_path,
            baseline_url=self.baseline_url,
        )


class InfoLM(Metric):
    """InfoLM over the accumulated sentence pairs.

    ``device`` is the metric's device (the ``Metric`` keyword): the states
    live there, and the forwards' inputs, the distributions and the measure
    go there.

    Example:
        >>> from metrics_tpu_torch import InfoLM
        >>> preds = ["he read the book because he was interested in world history"]
        >>> target = ["he was interested in world history because he read the book"]
        >>> infolm = InfoLM("google/bert_uncased_L-2_H-128_A-2", idf=False)  # doctest: +SKIP
        >>> round(float(infolm(preds, target)), 4)  # doctest: +SKIP
        -0.1784
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False

    def __init__(
        self,
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
        **kwargs: Any,
    ) -> None:
        super().__init__(device=device, **kwargs)
        del num_threads, verbose  # accepted for signature compatibility, unused
        self.model_name_or_path = model_name_or_path
        self.model = model
        self.user_tokenizer = user_tokenizer
        self.temperature = temperature
        self.information_measure = information_measure
        self.idf = idf
        self.alpha = alpha
        self.beta = beta
        self.max_length = max_length
        self.batch_size = batch_size
        self.return_sentence_level_score = return_sentence_level_score
        self.add_state("preds_packed", [], dist_reduce_fx="cat")
        self.add_state("target_packed", [], dist_reduce_fx="cat")

    def update(self, preds, target) -> None:
        preds_ = [preds] if isinstance(preds, str) else list(preds)
        target_ = [target] if isinstance(target, str) else list(target)
        if len(preds_) != len(target_):
            raise ValueError("Number of predicted and reference sentences must be the same!")
        _append_packed(self, pack_strings(preds_), pack_strings(target_))

    def compute(self):
        preds_bytes, target_bytes = _packed_to_host(self.preds_packed, self.target_packed)
        return infolm(
            unpack_strings(preds_bytes),
            unpack_strings(target_bytes),
            model_name_or_path=self.model_name_or_path,
            temperature=self.temperature,
            information_measure=self.information_measure,
            idf=self.idf,
            alpha=self.alpha,
            beta=self.beta,
            device=self.device,
            max_length=self.max_length,
            batch_size=self.batch_size,
            return_sentence_level_score=self.return_sentence_level_score,
            model=self.model,
            user_tokenizer=self.user_tokenizer,
        )


__all__ = ["ROUGEScore", "CHRFScore", "TranslationEditRate", "ExtendedEditDistance", "BERTScore", "InfoLM"]
