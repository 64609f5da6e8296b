"""RetrievalMetric: every query of a stream scored at once.

JAX counterpart: `metrics_tpu/retrieval/base.py` (``GroupedRows``,
``group_rows`` `:103-127`, ``_canonicalize_list_states`` `:246`); reference
`retrieval/base.py:27-146`. ``update`` buffers raw ``(indexes, preds,
target)`` rows; ``compute`` sorts them once by (query, descending score)
and scores every query with the segment reductions of
:mod:`metrics_tpu_torch.ops.segments`, whatever the number of queries.
``segment_count`` there launches the CUDA bincount kernel on the card.

The JAX package's host fast lane (``_build_update_lane``) belongs to its
dispatch engine and is not ported.
"""
from __future__ import annotations

from abc import abstractmethod
from dataclasses import dataclass
from typing import Any, Optional

import torch
from torch import Tensor

from metrics_tpu_torch.functional.retrieval.kernels import _descending_order
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.ops.segments import segment_count, segment_cumsum, segment_ranks, segment_starts, segment_sum
from metrics_tpu_torch.utils.checks import _check_retrieval_metadata
from metrics_tpu_torch.utils.data import _keep_if_same, dim_zero_cat_ravel


@dataclass(frozen=True)
class GroupedRows:
    """Every row sorted by (query id, descending score), with per-row and per-group statistics.

    ``seg`` is the dense group id of each sorted row; within a group the rows
    are in descending score order, so ``ranks`` and ``cumrel`` give top-k
    statistics directly and ``idx_at(kv)`` is the row of rank ``kv``.
    """

    num_groups: int
    seg: Tensor  # (R,) int64, ascending
    preds: Tensor  # (R,) float32, descending within a group
    rel: Tensor  # (R,) float32 relevance (graded allowed)
    ranks: Tensor  # (R,) int32, 1-based rank within the group
    cumrel: Tensor  # (R,) float32 inclusive cumsum of rel within the group
    counts: Tensor  # (G,) int32 rows per group
    starts: Tensor  # (G,) int32 first row of each group
    n_pos: Tensor  # (G,) float32 sum of rel per group

    def _memo(self, name: str, make: Any) -> Tensor:
        cached = self.__dict__.get(name)
        if cached is None:
            cached = make()
            object.__setattr__(self, name, cached)
        return cached

    def idx_at(self, kv: Tensor) -> Tensor:
        """The row of rank ``kv``, clamped to ``[1, count]``, in each group."""
        return self.starts + torch.minimum(torch.clamp(kv, min=1), self.counts) - 1

    def rel_bin(self) -> Tensor:
        """Relevance binarised with ``> 0``: a graded target counts as a hit for AP, MRR and R-precision."""
        return self._memo("_rel_bin", lambda: (self.rel > 0).to(torch.float32))

    def cum_bin(self) -> Tensor:
        """Inclusive cumsum of the binarised relevance within each group."""
        return self._memo("_cum_bin", lambda: segment_cumsum(self.rel_bin(), self.seg, self.num_groups))

    def n_hits(self) -> Tensor:
        """Binarised hits per group."""
        return self._memo("_n_hits", lambda: segment_sum(self.rel_bin(), self.seg, self.num_groups, self.counts))

    def n_neg(self) -> Tensor:
        """Non-relevance per group, as 1 - relevance (a graded target adds partial non-relevance)."""
        return self._memo("_n_neg", lambda: segment_sum(1.0 - self.rel, self.seg, self.num_groups, self.counts))

    def k_eff(self, k: Optional[int]) -> Tensor:
        """``min(k, count)`` per group; the count when ``k`` is None."""
        return self.counts if k is None else torch.clamp(self.counts, max=k)


def group_rows(indexes: Tensor, preds: Tensor, target: Tensor) -> GroupedRows:
    """Sort the rows by (query, descending score) and take the segment statistics."""
    uniques, seg_raw = torch.unique(indexes, return_inverse=True)
    g = int(uniques.shape[0])
    # a two-pass stable lexsort: the secondary key (score, descending) first, then the group
    order1 = _descending_order(preds)
    order2 = torch.argsort(seg_raw[order1], stable=True)
    perm = order1[order2]

    seg = seg_raw[perm]
    rel = target[perm].to(torch.float32)
    counts = segment_count(seg, g)
    starts = segment_starts(seg, g, counts=counts)
    return GroupedRows(
        num_groups=g,
        seg=seg,
        preds=preds[perm].to(torch.float32),
        rel=rel,
        ranks=segment_ranks(seg, g, starts=starts),
        cumrel=segment_cumsum(rel, seg, g),
        counts=counts,
        starts=starts,
        n_pos=segment_sum(rel, seg, g, counts),
    )


class RetrievalMetric(Metric):
    """Base of the retrieval metrics, scored per query.

    Args:
        empty_target_action: what a query with no relevant document (no
            non-relevant one for fall-out) scores: ``"neg"`` 0, ``"pos"`` 1,
            ``"skip"`` leaves it out, ``"error"`` raises (one host read).
        ignore_index: rows whose target equals it are dropped.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import RetrievalMRR
        >>> metric = RetrievalMRR(device="cpu")
        >>> metric.update(torch.tensor([0.3, 0.7, 0.4]), torch.tensor([0, 1, 1]), torch.tensor([0, 0, 1]))
        >>> metric.compute()
        tensor(1.)
    """

    is_differentiable: Optional[bool] = False
    higher_is_better: Optional[bool] = True
    full_state_update: Optional[bool] = False
    allow_non_binary_target: bool = False
    # which side's absence makes a query empty: positives for most metrics, negatives for fall-out
    _empty_when_no: str = "pos"

    def __init__(self, empty_target_action: str = "neg", ignore_index: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        # as in JAX: compute() leaves a synced metric synced
        self._should_unsync = False

        empty_target_action_options = ("error", "skip", "neg", "pos")
        if empty_target_action not in empty_target_action_options:
            raise ValueError(f"Argument `empty_target_action` received a wrong value `{empty_target_action}`.")
        self.empty_target_action = empty_target_action
        if ignore_index is not None and not isinstance(ignore_index, int):
            raise ValueError("Argument `ignore_index` must be an integer or None.")
        self.ignore_index = ignore_index

        self.add_state("indexes", default=[], dist_reduce_fx=None)
        self.add_state("preds", default=[], dist_reduce_fx=None)
        self.add_state("target", default=[], dist_reduce_fx=None)

    def update(self, preds: Tensor, target: Tensor, indexes: Tensor) -> None:
        """Check one batch of rows and buffer them raw.

        Flattening, casting and dropping ignored rows wait until the rows are
        observed (``compute``, the sync, ``state_dict``), so an update makes
        no device operation beyond the value checks of the validation mode.
        """
        if indexes is None:
            raise ValueError("Argument `indexes` cannot be None")
        indexes, preds, target = (torch.as_tensor(v, device=self.device) for v in (indexes, preds, target))
        indexes, preds, target = _check_retrieval_metadata(
            preds=preds,
            target=target,
            indexes=indexes,
            allow_non_binary_target=self.allow_non_binary_target,
            ignore_index=self.ignore_index,
        )
        self.indexes.append(indexes)
        self.preds.append(preds)
        self.target.append(target)

    def _canonicalize_list_states(self) -> None:
        """Flatten, cast and filter the buffered rows in place; idempotent.

        A canonical row is 1-D: float32 scores, float32 or int32 targets by
        their family, int32 indexes (int64 kept), rows whose target is
        ``ignore_index`` dropped. With ``ignore_index`` set, telling whether a
        row holds an ignored target reads the device once a row.
        """
        if not isinstance(self.indexes, list):
            return
        for i in range(len(self.indexes)):
            idx, p, t = self.indexes[i], self.preds[i], self.target[i]
            ci, cp, ct = idx.reshape(-1), p.reshape(-1).to(torch.float32), t.reshape(-1)
            if self.ignore_index is not None:
                valid = ct != self.ignore_index
                if not bool(valid.all()):
                    ci, cp, ct = ci[valid], cp[valid], ct[valid]
            ct = ct.to(torch.float32) if ct.is_floating_point() else ct.to(torch.int32)
            if ci.dtype != torch.int64:
                ci = ci.to(torch.int32)
            self.indexes[i] = _keep_if_same(idx, ci)
            self.preds[i] = _keep_if_same(p, cp)
            self.target[i] = _keep_if_same(t, ct)

    def _grouped_state(self) -> Optional[GroupedRows]:
        if not len(self.indexes):
            return None
        # one concatenation per state canonicalises every row at once
        indexes = dim_zero_cat_ravel(self.indexes)
        preds = dim_zero_cat_ravel(self.preds).to(torch.float32)
        target = dim_zero_cat_ravel(self.target)
        if self.ignore_index is not None:
            valid = target != self.ignore_index
            indexes, preds, target = indexes[valid], preds[valid], target[valid]
        if indexes.numel() == 0:
            return None
        return group_rows(indexes, preds, target)

    def _group_valid(self, ctx: GroupedRows) -> Tensor:
        if self._empty_when_no == "neg":
            return ctx.n_neg() > 0
        return ctx.n_pos > 0

    def _apply_empty_action(self, values: Tensor, valid: Tensor) -> Tensor:
        """The mean over groups under ``empty_target_action``; ``values`` is (G,) or (G, K)."""
        side = "positive" if self._empty_when_no == "pos" else "negative"
        if self.empty_target_action == "error" and bool(torch.any(~valid)):
            raise ValueError(f"`compute` method was provided with a query with no {side} target.")
        mask = valid.reshape((-1,) + (1,) * (values.ndim - 1))
        if self.empty_target_action == "skip":
            n = torch.clamp(valid.sum(), min=1)
            summed = torch.where(mask, values, 0.0).sum(dim=0) / n
            return torch.where(valid.any(), summed, torch.zeros_like(summed))
        fill = {"pos": 1.0, "neg": 0.0, "error": 0.0}[self.empty_target_action]
        return torch.where(mask, values, fill).mean(dim=0)

    def compute(self) -> Tensor:
        ctx = self._grouped_state()
        if ctx is None:
            return torch.tensor(0.0, device=self.device)
        values = self._segment_metric(ctx)
        return self._apply_empty_action(values, self._group_valid(ctx))

    @abstractmethod
    def _segment_metric(self, ctx: GroupedRows) -> Tensor:
        """Score every query group at once: ``(num_groups,)``."""


__all__ = ["RetrievalMetric", "GroupedRows", "group_rows"]
