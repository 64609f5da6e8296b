"""The yardstick's own arithmetic: the published peaks of the card, the least bytes a step must move,
and the percentile and spread rules. Nothing here reads the program; the byte counts follow from the
inputs the benchmark made, whatever implements the work."""
from __future__ import annotations

import math
import statistics
from typing import Iterable, List, Sequence, Tuple

import torch

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "fp32_flops_per_s": 67e12, "memory_bytes": 80e9},
}
DEFAULT_PEAKS = PEAKS["NVIDIA H100 80GB HBM3"]


def peaks(kind: str) -> dict:
    """The peaks of a card by its name; an unlisted card is held to the H100's."""
    return PEAKS.get(kind, DEFAULT_PEAKS)


def tensor_bytes(x) -> int:
    """Bytes of a tensor, or of every tensor in a list or tuple."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(tensor_bytes(v) for v in x)
    return 0


def step_bytes(step: Tuple[torch.Tensor, torch.Tensor], state_bytes: int) -> int:
    """An update's least traffic: its inputs read once and the suite's states written once."""
    return tensor_bytes(step) + state_bytes


def compute_bytes(epoch: Sequence[Tuple[torch.Tensor, torch.Tensor]], n_values: int) -> int:
    """A compute's least traffic: every buffered row read once and each value (float32) written once."""
    return sum(tensor_bytes(s) for s in epoch) + 4 * n_values


def roofline_share(least_bytes: float, device_s: float, bytes_per_s: float) -> float:
    """Percent of the memory roofline: the least time for ``least_bytes`` over the device time taken."""
    return 100.0 * (least_bytes / bytes_per_s) / device_s


def p95(values: Iterable[float]) -> float:
    """The nearest-rank 95th percentile of every value."""
    ordered = sorted(values)
    if not ordered:
        raise ValueError("no values")
    return ordered[max(0, math.ceil(0.95 * len(ordered)) - 1)]


def spread(values: List[float]) -> float:
    """Distance between the first and third quartile (Python's ``statistics.quantiles``) over the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
