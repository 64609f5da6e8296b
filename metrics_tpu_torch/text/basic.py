"""Text modules with counter states: BLEU, SacreBLEU, the error-rate family, Perplexity, SQuAD.

JAX counterpart: `metrics_tpu/text/basic.py` (``BLEUScore`` `:29`,
``SacreBLEUScore`` `:72`, ``_ErrorRateMetric`` `:110` and its five
subclasses, ``Perplexity`` `:228`, ``SQuAD`` `:262`). An update counts on the
host and adds its counts to the states in one copy to the device; the count
states are float32 as in JAX (exact up to 2**24), SQuAD's ``total`` int32.

SQuAD adds each update's host sums to its states directly. JAX folds them in
at the next observation instead (``_host_pending_flush``, `basic.py:281-307`),
a part of its deferral plane, which the port does not have yet.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.functional.text.bleu import _bleu_score_compute, _bleu_score_update, _bleu_stats
from metrics_tpu_torch.functional.text.perplexity import _perplexity_compute, _perplexity_update
from metrics_tpu_torch.functional.text.sacre_bleu import _SacreBLEUTokenizer
from metrics_tpu_torch.functional.text.squad import _squad_compute, _squad_input_check, _squad_update_host
from metrics_tpu_torch.functional.text.wer import _cer_update, _mer_update, _wer_update, _wil_wip_update
from metrics_tpu_torch.metric import Metric


class BLEUScore(Metric):
    """Corpus BLEU accumulated over batches.

    Example:
        >>> from metrics_tpu_torch import BLEUScore
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> bleu = BLEUScore(device="cpu")
        >>> round(float(bleu(preds, target)), 4)
        0.7598
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = True

    def __init__(
        self, n_gram: int = 4, smooth: bool = False, weights: Optional[Sequence[float]] = None, **kwargs: Any
    ) -> None:
        super().__init__(**kwargs)
        self.n_gram = n_gram
        self.smooth = smooth
        if weights is not None and len(weights) != n_gram:
            raise ValueError(f"List of weights has different weights than `n_gram`: {len(weights)} != {n_gram}")
        self.weights = weights
        self.add_state("preds_len", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("target_len", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("numerator", torch.zeros(self.n_gram), dist_reduce_fx="sum")
        self.add_state("denominator", torch.zeros(self.n_gram), dist_reduce_fx="sum")

    def _tokenize_update(self, preds, target):
        preds_ = [preds] if isinstance(preds, str) else preds
        target_ = [[t] if isinstance(t, str) else t for t in target]
        return _bleu_score_update(preds_, target_, self.n_gram)

    def update(self, preds: Sequence[str], target: Sequence[Sequence[str]]) -> None:
        num, den, p_len, t_len = _bleu_stats(self._tokenize_update(preds, target), self.n_gram, self.device)
        self.numerator = self.numerator + num
        self.denominator = self.denominator + den
        self.preds_len = self.preds_len + p_len
        self.target_len = self.target_len + t_len

    def compute(self) -> Tensor:
        return _bleu_score_compute(
            self.preds_len, self.target_len, self.numerator, self.denominator, self.n_gram, self.weights, self.smooth
        )


class SacreBLEUScore(BLEUScore):
    """BLEU with sacrebleu's tokenizers.

    Example:
        >>> from metrics_tpu_torch import SacreBLEUScore
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> sacre_bleu = SacreBLEUScore(device="cpu")
        >>> round(float(sacre_bleu(preds, target)), 4)
        0.7598
    """

    def __init__(
        self,
        n_gram: int = 4,
        smooth: bool = False,
        tokenize: str = "13a",
        lowercase: bool = False,
        weights: Optional[Sequence[float]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(n_gram=n_gram, smooth=smooth, weights=weights, **kwargs)
        self.tokenizer = _SacreBLEUTokenizer(tokenize, lowercase)

    def _tokenize_update(self, preds, target):
        target_ = [[t] if isinstance(t, str) else t for t in target]
        return _bleu_score_update(list(preds), target_, self.n_gram, self.tokenizer)


class _ErrorRateMetric(Metric):
    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    _update_fn = None

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("errors", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds, target) -> None:
        errors, total = torch.tensor(type(self)._update_fn(preds, target), dtype=torch.float32, device=self.device)
        self.errors = self.errors + errors
        self.total = self.total + total

    def compute(self) -> Tensor:
        return self.errors / self.total


class WordErrorRate(_ErrorRateMetric):
    """WER accumulated over batches.

    Example:
        >>> from metrics_tpu_torch import WordErrorRate
        >>> preds = ['this is the prediction', 'there is an other sample']
        >>> target = ['this is the reference', 'there is another one']
        >>> wer = WordErrorRate(device="cpu")
        >>> round(float(wer(preds, target)), 4)
        0.5
    """

    _update_fn = staticmethod(_wer_update)


class CharErrorRate(_ErrorRateMetric):
    """CER accumulated over batches.

    Example:
        >>> from metrics_tpu_torch import CharErrorRate
        >>> preds = ['this is the prediction', 'there is an other sample']
        >>> target = ['this is the reference', 'there is another one']
        >>> cer = CharErrorRate(device="cpu")
        >>> round(float(cer(preds, target)), 4)
        0.3415
    """

    _update_fn = staticmethod(_cer_update)


class MatchErrorRate(_ErrorRateMetric):
    """MER accumulated over batches.

    Example:
        >>> from metrics_tpu_torch import MatchErrorRate
        >>> preds = ['this is the prediction', 'there is an other sample']
        >>> target = ['this is the reference', 'there is another one']
        >>> mer = MatchErrorRate(device="cpu")
        >>> round(float(mer(preds, target)), 4)
        0.4444
    """

    _update_fn = staticmethod(_mer_update)


class _WordInfoMetric(Metric):
    is_differentiable = False
    full_state_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("errors", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("target_total", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("preds_total", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds, target) -> None:
        hits, target_total, preds_total = torch.tensor(
            _wil_wip_update(preds, target), dtype=torch.float32, device=self.device
        )
        self.errors = self.errors + hits
        self.target_total = self.target_total + target_total
        self.preds_total = self.preds_total + preds_total


class WordInfoPreserved(_WordInfoMetric):
    """WIP accumulated over batches.

    Example:
        >>> from metrics_tpu_torch import WordInfoPreserved
        >>> preds = ['this is the prediction', 'there is an other sample']
        >>> target = ['this is the reference', 'there is another one']
        >>> wip = WordInfoPreserved(device="cpu")
        >>> round(float(wip(preds, target)), 4)
        0.3472
    """

    higher_is_better = True

    def compute(self) -> Tensor:
        return (self.errors / self.target_total) * (self.errors / self.preds_total)


class WordInfoLost(_WordInfoMetric):
    """WIL accumulated over batches.

    Example:
        >>> from metrics_tpu_torch import WordInfoLost
        >>> preds = ['this is the prediction', 'there is an other sample']
        >>> target = ['this is the reference', 'there is another one']
        >>> wil = WordInfoLost(device="cpu")
        >>> round(float(wil(preds, target)), 4)
        0.6528
    """

    higher_is_better = False

    def compute(self) -> Tensor:
        return 1.0 - (self.errors / self.target_total) * (self.errors / self.preds_total)


class Perplexity(Metric):
    """Perplexity over the accumulated negative log-likelihood of the tokens.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Perplexity
        >>> logits = torch.log(torch.tensor([[[0.75, 0.25], [0.25, 0.75]], [[0.6, 0.4], [0.9, 0.1]]]))
        >>> target = torch.tensor([[0, 1], [0, 0]])
        >>> perplexity = Perplexity(device="cpu")
        >>> round(float(perplexity(logits, target)), 4)
        1.347
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(self, ignore_index: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if ignore_index is not None and not isinstance(ignore_index, int):
            raise ValueError(f"Argument `ignore_index` expected to either be `None` or an `int` but got {ignore_index}")
        self.ignore_index = ignore_index
        self.add_state("total_log_probs", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("count", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        total, count = _perplexity_update(preds, target, self.ignore_index)
        self.total_log_probs = self.total_log_probs + total
        self.count = self.count + count

    def compute(self) -> Tensor:
        return _perplexity_compute(self.total_log_probs, self.count)


class SQuAD(Metric):
    """SQuAD v1 exact match and F1 accumulated over batches.

    Example:
        >>> from metrics_tpu_torch import SQuAD
        >>> preds = [{'prediction_text': '1976', 'id': '56e10a3be3433e1400422b22'}]
        >>> target = [{'answers': {'answer_start': [97], 'text': ['1976']}, 'id': '56e10a3be3433e1400422b22'}]
        >>> squad = SQuAD(device="cpu")
        >>> {k: round(float(v), 1) for k, v in sorted(squad(preds, target).items())}
        {'exact_match': 100.0, 'f1': 100.0}
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    # the host buffer (JAX `text/basic.py:281-344`): each update adds Python
    # numbers to ``_pending``, with no device work; the buffer folds into the
    # three states, in one copy, at the observation barrier (compute, sync,
    # state_dict, a copy, the journal: ``Metric._defer_barrier``)
    _pending: Optional[Tuple[float, float, int]] = None
    _has_host_pending_hook = True
    _has_update_lane_hook = True

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("f1_score", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("exact_match", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def _host_pending_flush(self) -> None:
        p = self._pending
        if p is not None:
            object.__setattr__(self, "_pending", None)
            sums = torch.tensor(p, dtype=torch.float64, device=self.device)
            self.f1_score = self.f1_score + sums[0].to(torch.float32)
            self.exact_match = self.exact_match + sums[1].to(torch.float32)
            self.total = self.total + sums[2].to(torch.int32)

    def _canonicalize_list_states(self) -> None:
        self._host_pending_flush()  # whatever observes the states one by one folds the buffer first

    def reset(self) -> None:
        object.__setattr__(self, "_pending", None)
        super().reset()

    def _add_pending(self, preds, target) -> None:
        f1, exact_match, total = _squad_update_host(*_squad_input_check(preds, target))
        p = self._pending or (0.0, 0.0, 0)
        object.__setattr__(self, "_pending", (p[0] + f1, p[1] + exact_match, p[2] + total))

    def update(self, preds, target) -> None:
        self._add_pending(preds, target)

    def _build_update_lane(self, args: tuple, kwargs: dict) -> Optional[Callable]:
        """The host fast lane: later updates skip the wrapper's bookkeeping and run
        the checks, the host scoring and the sums directly."""
        guard = self._lane_guard()

        def lane(largs: tuple, lkwargs: dict) -> bool:
            if lkwargs or len(largs) != 2 or not guard():
                return False
            self._add_pending(*largs)  # raises as the full path does on malformed input
            self._update_count += 1
            self._computed = None
            return True

        return lane

    def compute(self) -> Dict[str, Tensor]:
        return _squad_compute(self.f1_score, self.exact_match, self.total)


__all__ = [
    "BLEUScore",
    "SacreBLEUScore",
    "WordErrorRate",
    "CharErrorRate",
    "MatchErrorRate",
    "WordInfoPreserved",
    "WordInfoLost",
    "Perplexity",
    "SQuAD",
]
