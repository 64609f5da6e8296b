"""Binned-curve counts: a compare, then one contraction.

JAX counterpart: `metrics_tpu/ops/binned.py` (``binned_curve_counts`` `:40`,
the reference formulation ``_binned_onehot_matmul`` `:67`)::

    TP[c, t] = sum_n target[n, c] * (preds[n, c] >= thr[t])

as ``einsum('nc,nct->ct')`` over the (N, C, T) compare tensor, under
:func:`~metrics_tpu_torch.utils.compute.high_precision`, so that float32
products are not rounded to TF32 on the card (TF32 happens to be exact for
0/1 operands; the setting holds for every caller alike).

This is XLA-written in the JAX package, not a TPU kernel, so it ports as
torch ops. At ImageNet width one update compares N = 1000 rows, C = 1000
classes and T = 100 thresholds: 10**8 elements, 400 MB as float32. The
compare tensor is built as a (C, N, T) block and viewed as (N, C, T), so the
batched product that ``torch.einsum`` lowers to reads it without a copy, and
it is built for at most :data:`CHUNK_BYTES` of thresholds at a time. With
0/1 targets every sum is exact below 2**24 rows, so the chunks give the same
counts as one pass.

The JAX package's bucketize formulations are autotuner variants here as there
(``binned.py:40-135``; :mod:`metrics_tpu_torch.ops.autotune`): sort the
thresholds, bucket each score by how many thresholds lie at or below it, count
a per-(bucket, class) histogram of the targets and of all scores, and recover
the ``>=`` counts as a reversed cumulative sum, O(N*C*log T + C*T) work
instead of the compare's O(N*C*T). ``segment_sum`` counts both histograms
with :func:`~metrics_tpu_torch.ops.histogram.fused_bincount` over ``(T + 1) *
C`` bins with float32 weights: on the card the hand-written kernel, 101,000
bins at ImageNet width. ``scatter_add`` counts them with ``index_add_``. Sums
of 0/1 values below 2**24 a bin are exact in float32 in any order, so for
0/1 targets the contract is bit for bit; fractional targets are not exact,
and the sweep's check disqualifies both there. A NaN score lies above every
threshold in the sort order that buckets it, and below all of them for the
compare: the variants count it where the reference does not, as JAX's do, and
the sweep disqualifies them on such inputs. With ``METRICS_TPU_AUTOTUNE`` off
the compare always runs.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.ops import autotune as _autotune
from metrics_tpu_torch.utils.compute import high_precision

#: The most bytes of float32 compare tensor built at one time.
CHUNK_BYTES = 256 * 2**20


@high_precision
def binned_curve_counts(preds: Tensor, target: Tensor, thresholds: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-threshold TP, FP and FN counts of a batch.

    Args:
        preds: ``(N, C)`` float scores.
        target: ``(N, C)`` 0/1 labels.
        thresholds: ``(T,)`` threshold grid.

    Returns:
        ``(TPs, FPs, FNs)``, each ``(C, T)`` float32, where
        ``TPs[c, t] = sum_n target[n, c] * (preds[n, c] >= thresholds[t])``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops.binned import binned_curve_counts
        >>> preds = torch.tensor([[0.1], [0.4], [0.35], [0.8]])
        >>> target = torch.tensor([[0.0], [0.0], [1.0], [1.0]])
        >>> binned_curve_counts(preds, target, torch.tensor([0.0, 0.5, 1.0]))
        (tensor([[2., 1., 0.]]), tensor([[2., 0., 0.]]), tensor([[0., 1., 2.]]))
    """
    preds = torch.as_tensor(preds).to(torch.float32)
    target = torch.as_tensor(target, device=preds.device).to(torch.float32)
    thresholds = torch.as_tensor(thresholds, device=preds.device).to(torch.float32)
    variant = _autotune.dispatch("binned_counts", (preds, target, thresholds))
    if variant == "scatter_add":
        return _binned_bucketize(preds, target, thresholds, via_segment_sum=False)
    if variant == "segment_sum":
        return _binned_bucketize(preds, target, thresholds, via_segment_sum=True)
    return _binned_onehot_matmul(preds, target, thresholds)


def threshold_chunk(n: int, c: int, t: int) -> int:
    """Thresholds per pass: as many as keep the (N, C, chunk) float32 compare within :data:`CHUNK_BYTES`."""
    return max(1, min(t, CHUNK_BYTES // max(1, 4 * n * c)))


def _binned_onehot_matmul(preds: Tensor, target: Tensor, thresholds: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """The reference formulation: compare, then ``einsum('nc,nct->ct')``, a chunk of thresholds at a time."""
    n, c = preds.shape
    t = thresholds.shape[0]
    step = threshold_chunk(n, c, t)
    preds_cn = preds.T[:, :, None]  # (C, N, 1)
    chunks = [_chunk_counts(preds_cn, target, thresholds[lo : lo + step]) for lo in range(0, t, step)]
    tps = torch.cat([tp for tp, _ in chunks], dim=1)
    ge_total = torch.cat([ge for _, ge in chunks], dim=1)
    pos_total = target.sum(dim=0)[:, None]  # (C, 1)
    return tps, ge_total - tps, pos_total - tps


def _chunk_counts(preds_cn: Tensor, target: Tensor, thr: Tensor) -> Tuple[Tensor, Tensor]:
    """TP and >= counts of one chunk of thresholds; its compare tensor is freed on return."""
    # (C, N, T') in memory, (N, C, T') as the einsum sees it: the batched product over C
    # that the einsum lowers to reads each class's (N, T') block as it lies, with no copy
    ge = (preds_cn >= thr[None, None, :]).to(torch.float32).permute(1, 0, 2)
    return torch.einsum("nc,nct->ct", target, ge), torch.einsum("nct->ct", ge)


def _bucket_ids(preds: Tensor, sorted_thr: Tensor) -> Tensor:
    """How many of the ascending thresholds each score lies at or above, in the total order
    of a sort (NaN above everything, as JAX's ``searchsorted`` orders it): a NaN score
    lies above every threshold, a NaN threshold above every score that is not NaN."""
    t = sorted_thr.shape[0]
    nan_thr = torch.isnan(sorted_thr)
    # NaN thresholds sort last; as +inf they count for a score of +inf only, which the correction takes out
    bounded = torch.where(nan_thr, torch.full_like(sorted_thr, float("inf")), sorted_thr)
    flat = preds.reshape(-1).contiguous()
    idx = torch.searchsorted(bounded, flat, right=True)
    idx = idx - (flat == float("inf")).to(idx.dtype) * nan_thr.sum().to(idx.dtype)
    return torch.where(torch.isnan(flat), torch.full_like(idx, t), idx)


@high_precision
def _binned_bucketize(preds: Tensor, target: Tensor, thresholds: Tensor, *, via_segment_sum: bool
                      ) -> Tuple[Tensor, Tensor, Tensor]:
    """The bucketize formulation (JAX's ``_binned_bucketize``): a per-(bucket, class)
    histogram of the targets and of all scores, then reversed cumulative sums. The
    thresholds are sorted and the counts mapped back, so any grid matches the compare."""
    from metrics_tpu_torch.ops import histogram as _histogram

    n, c = preds.shape
    t = thresholds.shape[0]
    order = torch.argsort(thresholds, stable=True)
    idx = _bucket_ids(preds, thresholds[order]).reshape(n, c)
    flat = (idx * c + torch.arange(c, device=idx.device, dtype=idx.dtype)[None, :]).reshape(-1)
    weights = target.reshape(-1).contiguous()
    ones = torch.ones_like(weights)
    bins = (t + 1) * c
    if via_segment_sum:
        tp_hist = _histogram.fused_bincount(flat, bins, weights)
        all_hist = _histogram.fused_bincount(flat, bins, ones)
    else:
        tp_hist = torch.zeros(bins, dtype=torch.float32, device=preds.device).index_add_(0, flat, weights)
        all_hist = torch.zeros(bins, dtype=torch.float32, device=preds.device).index_add_(0, flat, ones)
    # preds >= sorted_thr[j] <=> bucket > j: a suffix sum over buckets j + 1 .. T
    tp_ge = torch.flip(torch.cumsum(torch.flip(tp_hist.reshape(t + 1, c), [0]), 0), [0])[1:]
    all_ge = torch.flip(torch.cumsum(torch.flip(all_hist.reshape(t + 1, c), [0]), 0), [0])[1:]
    inv = torch.argsort(order)  # back to the caller's threshold order
    tps = tp_ge[inv].T.contiguous()
    ge_total = all_ge[inv].T.contiguous()
    pos_total = target.sum(dim=0)[:, None]  # (C, 1)
    return tps, ge_total - tps, pos_total - tps


def _binned_scatter_add(preds: Tensor, target: Tensor, thresholds: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    return _binned_bucketize(preds, target, thresholds, via_segment_sum=False)


def _binned_segment_sum(preds: Tensor, target: Tensor, thresholds: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    return _binned_bucketize(preds, target, thresholds, via_segment_sum=True)


# Bit-exact contract (tolerance None): every formulation sums the same 0/1 terms, and float32
# integer sums below 2**24 do not depend on their order.
_autotune.register_variant("binned_counts", "onehot_matmul", _binned_onehot_matmul, reference=True)
_autotune.register_variant("binned_counts", "scatter_add", _binned_scatter_add)
_autotune.register_variant("binned_counts", "segment_sum", _binned_segment_sum)


__all__ = ["binned_curve_counts"]
