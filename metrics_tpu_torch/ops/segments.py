"""Reductions over contiguous segments of sorted, dense group ids.

JAX counterpart: `metrics_tpu/ops/segments.py`. The retrieval metrics sort
their rows by query id once (:mod:`metrics_tpu_torch.retrieval.base`); every
per-query quantity is then a reduction over segments. Every helper assumes
``segment_ids`` sorted ascending and dense in ``[0, num_segments)``.

- ``segment_count`` counts the ids with :func:`metrics_tpu_torch.utils.data._bincount`:
  on the card, the hand-written CUDA bincount kernel (its shared-memory path
  up to 32768 segments, its global path above).
- ``segment_cumsum`` is a segmented scan: ⌈log2 R⌉ passes of a flag-reset
  add over R rows (Hillis-Steele), each pass adding only within a group. It
  is never the global cumsum less each group's offset, which loses float32
  precision for the groups late in a long stream (each value the difference
  of two large prefix sums).
- ``segment_sum`` and ``segment_max`` of floats are ``torch.segment_reduce``
  over the counts, with no float atomics: two calls on the same rows give
  the same bits, on the card too (``index_add_`` of floats would not).
  Integers take a scatter, whose result does not depend on its order.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from metrics_tpu_torch.utils.data import _bincount


def segment_count(segment_ids: Tensor, num_segments: int) -> Tensor:
    """Number of rows in each segment, int32 (the bincount kernel on the card)."""
    return _bincount(segment_ids, minlength=num_segments)


def _reduce(data: Tensor, segment_ids: Tensor, num_segments: int, how: str, counts: Optional[Tensor]) -> Tensor:
    if not data.is_floating_point():
        # integer sums and maxima do not depend on the order of the atomics
        lowest = 0 if how == "sum" else torch.iinfo(data.dtype).min
        out = torch.full((num_segments,) + data.shape[1:], lowest, dtype=data.dtype, device=data.device)
        index = segment_ids.reshape((-1,) + (1,) * (data.ndim - 1)).expand_as(data)
        return out.scatter_reduce_(0, index, data, "sum" if how == "sum" else "amax")
    if counts is None:
        counts = segment_count(segment_ids, num_segments)
    initial = 0.0 if how == "sum" else float("-inf")
    return torch.segment_reduce(data, how, lengths=counts.to(torch.int64), initial=initial)


def segment_sum(data: Tensor, segment_ids: Tensor, num_segments: int, counts: Optional[Tensor] = None) -> Tensor:
    """Sum of ``data`` per segment; 0 for an empty segment."""
    return _reduce(data, segment_ids, num_segments, "sum", counts)


def segment_max(data: Tensor, segment_ids: Tensor, num_segments: int, counts: Optional[Tensor] = None) -> Tensor:
    """Largest value per segment; the dtype's lowest value for an empty segment, as in JAX."""
    return _reduce(data, segment_ids, num_segments, "max", counts)


def segment_starts(segment_ids: Tensor, num_segments: int, counts: Optional[Tensor] = None) -> Tensor:
    """Index of each segment's first row: the exclusive cumsum of the counts."""
    if counts is None:
        counts = segment_count(segment_ids, num_segments)
    return torch.cumsum(counts, dim=0, dtype=counts.dtype) - counts


def segment_ranks(segment_ids: Tensor, num_segments: int, starts: Optional[Tensor] = None) -> Tensor:
    """1-based rank of every row within its segment, int32."""
    if starts is None:
        starts = segment_starts(segment_ids, num_segments)
    rows = torch.arange(segment_ids.shape[0], dtype=torch.int32, device=segment_ids.device)
    return rows - starts[segment_ids].to(torch.int32) + 1


def segment_cumsum(data: Tensor, segment_ids: Tensor, num_segments: int) -> Tensor:
    """Inclusive cumsum of ``data`` that restarts at every segment's first row.

    A log-step segmented scan: after the pass of width ``s`` each row holds
    the sum of the up to ``2s`` rows ending at it, cut at its segment's first
    row, and a flag says whether that cut was reached. So no pass adds
    across a boundary, and no value is the difference of two prefix sums.
    """
    del num_segments  # the boundaries come from the ids
    n = data.shape[0]
    if n == 0:
        return data
    flags = torch.ones(n, dtype=torch.bool, device=data.device)
    flags[1:] = segment_ids[1:] != segment_ids[:-1]
    values = data
    shift = 1
    while shift < n:
        head = values[:shift]
        tail = torch.where(flags[shift:], values[shift:], values[:-shift] + values[shift:])
        values = torch.cat([head, tail])
        flags = torch.cat([flags[:shift], flags[shift:] | flags[:-shift]])
        shift *= 2
    return values


__all__ = [
    "segment_sum",
    "segment_max",
    "segment_count",
    "segment_starts",
    "segment_ranks",
    "segment_cumsum",
]
