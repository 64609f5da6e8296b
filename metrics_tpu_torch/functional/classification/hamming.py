"""Hamming distance.

JAX counterpart: `metrics_tpu/functional/classification/hamming.py` (reference
`functional/classification/hamming.py`). The count of correct labels is
int32, as in the JAX package: torch's ``sum`` would widen it to int64, and an
int32 state plus an int64 tensor becomes int64.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _input_format_classification


def _hamming_distance_update(preds, target, threshold: float = 0.5) -> Tuple[Tensor, int]:
    preds, target, _ = _input_format_classification(preds, target, threshold=threshold)
    correct = (preds == target).sum(dtype=torch.int32)
    return correct, preds.numel()


def _hamming_distance_compute(correct: Tensor, total: Union[int, Tensor]) -> Tensor:
    return 1 - correct.to(torch.float32) / total


def hamming_distance(preds, target, threshold: float = 0.5) -> Tensor:
    """Share of wrongly predicted labels.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import hamming_distance
        >>> target = torch.tensor([[0, 1], [1, 1]])
        >>> preds = torch.tensor([[0, 1], [0, 1]])
        >>> hamming_distance(preds, target)
        tensor(0.2500)
    """
    correct, total = _hamming_distance_update(preds, target, threshold)
    return _hamming_distance_compute(correct, total)


__all__ = ["hamming_distance"]
