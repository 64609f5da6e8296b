"""SacreBLEU: BLEU with sacrebleu's standard tokenizers.

JAX counterpart: `metrics_tpu/functional/text/sacre_bleu.py`
(``_SacreBLEUTokenizer`` `:22`, the tokenizers ``none``/``13a``/``zh``/
``intl``/``char`` `:19`, ``sacre_bleu_score`` `:103`). ``intl`` needs the
``regex`` package and raises ``ModuleNotFoundError`` without it.
"""
from __future__ import annotations

import re
from typing import Optional, Sequence

from torch import Tensor

from metrics_tpu_torch.functional.text.bleu import _bleu_score_compute, _bleu_score_update, _bleu_stats
from metrics_tpu_torch.metric import resolve_device
from metrics_tpu_torch.utils.imports import _REGEX_AVAILABLE

AVAILABLE_TOKENIZERS = ("none", "13a", "zh", "intl", "char")


class _SacreBLEUTokenizer:
    """The standard sacrebleu tokenizers as regex pipelines."""

    _REGEX_13A = [
        (re.compile(r"<skipped>"), ""),
        (re.compile(r"-\n"), ""),
        (re.compile(r"\n"), " "),
        (re.compile(r"&quot;"), '"'),
        (re.compile(r"&amp;"), "&"),
        (re.compile(r"&lt;"), "<"),
        (re.compile(r"&gt;"), ">"),
    ]
    _REGEX_13A_TOK = [
        (re.compile(r"([\{-\~\[-\` -\&\(-\+\:-\@\/])"), r" \1 "),
        (re.compile(r"([^0-9])([\.,])"), r"\1 \2 "),
        (re.compile(r"([\.,])([^0-9])"), r" \1 \2"),
        (re.compile(r"([0-9])(-)"), r"\1 \2 "),
    ]

    def __init__(self, tokenize: str = "13a", lowercase: bool = False) -> None:
        if tokenize not in AVAILABLE_TOKENIZERS:
            raise ValueError(f"Argument `tokenize` expected to be one of {AVAILABLE_TOKENIZERS} but got {tokenize}.")
        if tokenize in ("intl", "ja") and not _REGEX_AVAILABLE:
            raise ModuleNotFoundError(f"`{tokenize}` tokenization requires that `regex` is installed.")
        self.tokenize_name = tokenize
        self.lowercase = lowercase

    def __call__(self, line: str):
        tokenized = getattr(self, f"_tokenize_{self.tokenize_name}")(line)
        if self.lowercase:
            tokenized = tokenized.lower()
        return tokenized.split()

    @classmethod
    def _tokenize_none(cls, line: str) -> str:
        return line

    @classmethod
    def _tokenize_13a(cls, line: str) -> str:
        for pattern, replacement in cls._REGEX_13A:
            line = pattern.sub(replacement, line)
        line = " " + line + " "
        for pattern, replacement in cls._REGEX_13A_TOK:
            line = pattern.sub(replacement, line)
        return " ".join(line.split())

    @classmethod
    def _tokenize_char(cls, line: str) -> str:
        return " ".join(char for char in line.strip())

    @classmethod
    def _tokenize_zh(cls, line: str) -> str:
        """CJK ideographs split into characters; the rest 13a-tokenized."""
        out = []
        for char in line.strip():
            cp = ord(char)
            is_cjk = (
                0x4E00 <= cp <= 0x9FFF
                or 0x3400 <= cp <= 0x4DBF
                or 0x20000 <= cp <= 0x2A6DF
                or 0xF900 <= cp <= 0xFAFF
                or 0x2F800 <= cp <= 0x2FA1F
            )
            out.append(f" {char} " if is_cjk else char)
        return cls._tokenize_13a("".join(out))

    @classmethod
    def _tokenize_intl(cls, line: str) -> str:
        """Unicode-aware separation of punctuation and symbols (``regex``)."""
        import regex

        line = regex.sub(r"(\P{N})(\p{P})", r"\1 \2 ", line)
        line = regex.sub(r"(\p{P})(\P{N})", r" \1 \2", line)
        line = regex.sub(r"(\p{S})", r" \1 ", line)
        return " ".join(line.split())


def sacre_bleu_score(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    n_gram: int = 4,
    smooth: bool = False,
    weights: Optional[Sequence[float]] = None,
    tokenize: str = "13a",
    lowercase: bool = False,
    *,
    device=None,
) -> Tensor:
    """BLEU with sacrebleu tokenization.

    Example:
        >>> from metrics_tpu_torch.functional import sacre_bleu_score
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> sacre_bleu_score(preds, target, device="cpu")
        tensor(0.7598)
    """
    if len(preds) != len(target):
        raise ValueError(f"Corpus has different size {len(preds)} != {len(target)}")
    if weights is not None and len(weights) != n_gram:
        raise ValueError(f"List of weights has different weights than `n_gram`: {len(weights)} != {n_gram}")
    tokenizer = _SacreBLEUTokenizer(tokenize, lowercase)
    stats = _bleu_score_update(
        list(preds), [[t] if isinstance(t, str) else list(t) for t in target], n_gram, tokenizer
    )
    numerator, denominator, preds_len, target_len = _bleu_stats(stats, n_gram, resolve_device(device))
    return _bleu_score_compute(preds_len, target_len, numerator, denominator, n_gram, weights, smooth)


__all__ = ["sacre_bleu_score", "_SacreBLEUTokenizer", "AVAILABLE_TOKENIZERS"]
