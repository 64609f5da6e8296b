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

The JAX package's bucketize variants (``scatter_add``, ``segment_sum``) are
not ported: they belong with the autotuner.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

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


__all__ = ["binned_curve_counts"]
