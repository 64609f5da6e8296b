"""Text module metrics (JAX counterpart: `metrics_tpu/text`)."""
from metrics_tpu_torch.text.advanced import (
    BERTScore,
    CHRFScore,
    ExtendedEditDistance,
    InfoLM,
    ROUGEScore,
    TranslationEditRate,
)
from metrics_tpu_torch.text.basic import (
    BLEUScore,
    CharErrorRate,
    MatchErrorRate,
    Perplexity,
    SacreBLEUScore,
    SQuAD,
    WordErrorRate,
    WordInfoLost,
    WordInfoPreserved,
)

__all__ = [
    "BERTScore",
    "BLEUScore",
    "CharErrorRate",
    "CHRFScore",
    "ExtendedEditDistance",
    "InfoLM",
    "MatchErrorRate",
    "Perplexity",
    "ROUGEScore",
    "SacreBLEUScore",
    "SQuAD",
    "TranslationEditRate",
    "WordErrorRate",
    "WordInfoLost",
    "WordInfoPreserved",
]
