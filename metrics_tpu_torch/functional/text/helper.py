"""Host text helpers: tokenization and edit distance.

JAX counterpart: `metrics_tpu/functional/text/helper.py` (``_edit_distance``
`:21`, ``_edit_distance_matrix`` `:43`, ``_edit_distances`` `:60`,
``_tokenize_sentence`` `:76`, ``_ngrams`` `:80`). Strings are host work in
both packages: the tokens are interned to int32 ids and the dynamic programs
run in the host text library (:mod:`metrics_tpu_torch.ops.text_native`),
which builds or raises. The plain Python programs below are the same
functions, kept as the tests' reference; no metric calls them.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from metrics_tpu_torch.ops import text_native


def _edit_distance(prediction_tokens: Sequence, reference_tokens: Sequence) -> int:
    """Levenshtein distance of two token sequences (the host library)."""
    m, n = len(prediction_tokens), len(reference_tokens)
    if m == 0:
        return n
    if n == 0:
        return m
    a_ids, b_ids = text_native.intern_ids(prediction_tokens, reference_tokens)
    return text_native.levenshtein(a_ids, b_ids)


def _edit_distance_matrix(prediction_tokens: Sequence, reference_tokens: Sequence) -> np.ndarray:
    """The full Levenshtein table (TER's shift search reads it)."""
    a_ids, b_ids = text_native.intern_ids(prediction_tokens, reference_tokens)
    return text_native.levenshtein_matrix(a_ids, b_ids)


def _edit_distances(pairs: Sequence[Tuple[Sequence, Sequence]]) -> List[int]:
    """Levenshtein distance of every (prediction, reference) pair, all in one call into the library."""
    if not pairs:
        return []
    ids = text_native.intern_ids(*(s for pair in pairs for s in pair))
    return [int(v) for v in text_native.levenshtein_batch(ids[0::2], ids[1::2])]


def _edit_distance_plain(prediction_tokens: Sequence, reference_tokens: Sequence) -> int:
    """The same distance by the rolling-row program in Python (`helper.py:21-40`)."""
    m, n = len(prediction_tokens), len(reference_tokens)
    if m == 0:
        return n
    if n == 0:
        return m
    a_ids, b_ids = text_native.intern_ids(prediction_tokens, reference_tokens)
    prev = np.arange(n + 1, dtype=np.int32)
    for i in range(1, m + 1):
        curr = np.empty(n + 1, dtype=np.int32)
        curr[0] = i
        sub_cost = (b_ids != a_ids[i - 1]).astype(np.int32)
        for j in range(1, n + 1):
            curr[j] = min(prev[j] + 1, curr[j - 1] + 1, prev[j - 1] + sub_cost[j - 1])
        prev = curr
    return int(prev[n])


def _edit_distance_matrix_plain(prediction_tokens: Sequence, reference_tokens: Sequence) -> np.ndarray:
    """The same table by the Python program (`helper.py:43-57`)."""
    m, n = len(prediction_tokens), len(reference_tokens)
    a_ids, b_ids = text_native.intern_ids(prediction_tokens, reference_tokens)
    d = np.zeros((m + 1, n + 1), dtype=np.int32)
    d[:, 0] = np.arange(m + 1)
    d[0, :] = np.arange(n + 1)
    for i in range(1, m + 1):
        sub_cost = (b_ids != a_ids[i - 1]).astype(np.int32)
        for j in range(1, n + 1):
            d[i, j] = min(d[i - 1, j] + 1, d[i, j - 1] + 1, d[i - 1, j - 1] + sub_cost[j - 1])
    return d


def _tokenize_sentence(text: str) -> List[str]:
    return text.split()


def _ngrams(tokens: Sequence, n: int) -> List[Tuple]:
    return [tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1)]


__all__ = ["_edit_distance", "_edit_distances", "_edit_distance_matrix", "_tokenize_sentence", "_ngrams"]
