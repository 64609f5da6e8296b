"""Inputs of ``data["kind"] == "binary_scores"``: one evaluation set of scored rows with click labels.

``make_inputs`` makes ``rows_per_epoch`` rows: Bernoulli(``positive_rate``) int64 labels and float32 scores
``sigmoid(randn + logit_signal * label + logit_shift)`` rounded to multiples of ``1 / score_quantum``, so
that long tie runs form as in a served model's low-precision scores.

``epoch_steps`` cuts the set into consecutive batches of ``traffic["batch"]`` rows (views, as a validation
set is reused every epoch), the last one partial.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from generate import Step, seeded_generator


def make_inputs(data: Dict, traffic: Dict, seed: int, device) -> List[Step]:
    """The evaluation set, as one step: (scores float32, labels int64), ``data["rows_per_epoch"]`` rows each."""
    device = torch.device(device)
    g = seeded_generator(seed, device)
    n = data["rows_per_epoch"]
    labels = (torch.rand(n, generator=g, device=device) < data["positive_rate"]).to(torch.int64)
    logits = torch.randn(n, generator=g, device=device)
    logits += data["logit_signal"] * labels + data["logit_shift"]
    q = data["score_quantum"]
    scores = torch.round(torch.sigmoid(logits) * q) / q
    return [(scores, labels)]


def epoch_steps(data: Dict, traffic: Dict, inputs: List[Step]) -> List[Step]:
    """Consecutive batches of ``traffic["batch"]`` rows of the one evaluation set."""
    scores, labels = inputs[0]
    return list(zip(torch.split(scores, traffic["batch"]), torch.split(labels, traffic["batch"])))
