"""The retrieval metrics, each scoring every query at once over the grouped rows.

JAX counterpart: `metrics_tpu/retrieval/metrics.py`; reference
`retrieval/{average_precision,reciprocal_rank,precision,recall,fall_out,hit_rate,ndcg,
r_precision,precision_recall_curve,recall_at_precision}.py`. Each
``_segment_metric`` scores every query group over the rows that
:func:`metrics_tpu_torch.retrieval.base.group_rows` sorted; the formulas are
those of the one-query functions in
:mod:`metrics_tpu_torch.functional.retrieval.kernels`.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.ops.segments import segment_cumsum, segment_max, segment_sum
from metrics_tpu_torch.retrieval.base import GroupedRows, RetrievalMetric

_EXAMPLE_ROWS = """
        >>> import torch
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])"""


class RetrievalMAP(RetrievalMetric):
    __doc__ = f"""Mean average precision over queries.

    Example:{_EXAMPLE_ROWS}
        >>> from metrics_tpu_torch import RetrievalMAP
        >>> metric = RetrievalMAP(device="cpu")
        >>> round(float(metric(preds, target, indexes=indexes)), 4)
        0.7917
    """

    def _segment_metric(self, ctx: GroupedRows) -> Tensor:
        # AP = Σ hit · (hits so far / rank) / hits, the hits binarised with > 0
        terms = ctx.rel_bin() * ctx.cum_bin() / ctx.ranks.to(torch.float32)
        ap_sum = segment_sum(terms, ctx.seg, ctx.num_groups, ctx.counts)
        n_hits = ctx.n_hits()
        return torch.where(n_hits > 0, ap_sum / torch.clamp(n_hits, min=1.0), 0.0)


class RetrievalMRR(RetrievalMetric):
    __doc__ = f"""Mean reciprocal rank over queries.

    Example:{_EXAMPLE_ROWS}
        >>> from metrics_tpu_torch import RetrievalMRR
        >>> metric = RetrievalMRR(device="cpu")
        >>> round(float(metric(preds, target, indexes=indexes)), 4)
        0.75
    """

    def _segment_metric(self, ctx: GroupedRows) -> Tensor:
        # the first relevant row has the largest 1/rank among the relevant rows
        rr = torch.where(ctx.rel_bin() > 0, 1.0 / ctx.ranks.to(torch.float32), 0.0)
        return torch.clamp(segment_max(rr, ctx.seg, ctx.num_groups, ctx.counts), min=0.0)


class _RetrievalKMetric(RetrievalMetric):
    def __init__(
        self, empty_target_action: str = "neg", ignore_index: Optional[int] = None, k: Optional[int] = None, **kwargs: Any
    ) -> None:
        super().__init__(empty_target_action=empty_target_action, ignore_index=ignore_index, **kwargs)
        if (k is not None) and not (isinstance(k, int) and k > 0):
            raise ValueError("`k` has to be a positive integer or None")
        self.k = k


class RetrievalPrecision(_RetrievalKMetric):
    __doc__ = f"""Mean precision at k over queries.

    The divisor is ``k`` itself, also for a query with fewer documents;
    ``adaptive_k`` caps it at the query's number of documents.

    Example:{_EXAMPLE_ROWS}
        >>> from metrics_tpu_torch import RetrievalPrecision
        >>> metric = RetrievalPrecision(k=2, device="cpu")
        >>> round(float(metric(preds, target, indexes=indexes)), 4)
        0.5
    """

    def __init__(
        self,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        k: Optional[int] = None,
        adaptive_k: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(empty_target_action=empty_target_action, ignore_index=ignore_index, k=k, **kwargs)
        if not isinstance(adaptive_k, bool):
            raise ValueError("`adaptive_k` has to be a boolean")
        self.adaptive_k = adaptive_k

    def _segment_metric(self, ctx: GroupedRows) -> Tensor:
        examined = ctx.k_eff(self.k)
        divisor = examined if self.k is None or self.adaptive_k else torch.full_like(examined, self.k)
        return ctx.cumrel[ctx.idx_at(examined)] / divisor.to(torch.float32)


class RetrievalRecall(_RetrievalKMetric):
    __doc__ = f"""Mean recall at k over queries.

    Example:{_EXAMPLE_ROWS}
        >>> from metrics_tpu_torch import RetrievalRecall
        >>> metric = RetrievalRecall(k=2, device="cpu")
        >>> round(float(metric(preds, target, indexes=indexes)), 4)
        0.75
    """

    def _segment_metric(self, ctx: GroupedRows) -> Tensor:
        found = ctx.cumrel[ctx.idx_at(ctx.k_eff(self.k))]
        return torch.where(ctx.n_pos > 0, found / torch.clamp(ctx.n_pos, min=1.0), 0.0)


class RetrievalFallOut(_RetrievalKMetric):
    __doc__ = f"""Mean fall-out at k over queries.

    A query with no non-relevant document is the empty one here, and the
    default ``empty_target_action`` is ``"pos"``, the pessimistic value of
    this lower-is-better metric (reference `retrieval/fall_out.py:78`).

    Example:{_EXAMPLE_ROWS}
        >>> from metrics_tpu_torch import RetrievalFallOut
        >>> metric = RetrievalFallOut(k=2, device="cpu")
        >>> round(float(metric(preds, target, indexes=indexes)), 4)
        0.5
    """

    higher_is_better = False
    _empty_when_no = "neg"

    def __init__(
        self, empty_target_action: str = "pos", ignore_index: Optional[int] = None, k: Optional[int] = None, **kwargs: Any
    ) -> None:
        super().__init__(empty_target_action=empty_target_action, ignore_index=ignore_index, k=k, **kwargs)

    def _segment_metric(self, ctx: GroupedRows) -> Tensor:
        # 1 - relevance, as n_neg counts it
        cum_nonrel = segment_cumsum(1.0 - ctx.rel, ctx.seg, ctx.num_groups)
        n_neg = ctx.n_neg()
        found = cum_nonrel[ctx.idx_at(ctx.k_eff(self.k))]
        return torch.where(n_neg > 0, found / torch.clamp(n_neg, min=1.0), 0.0)


class RetrievalHitRate(_RetrievalKMetric):
    __doc__ = f"""Mean hit rate at k over queries.

    Example:{_EXAMPLE_ROWS}
        >>> from metrics_tpu_torch import RetrievalHitRate
        >>> metric = RetrievalHitRate(k=2, device="cpu")
        >>> round(float(metric(preds, target, indexes=indexes)), 4)
        1.0
    """

    def _segment_metric(self, ctx: GroupedRows) -> Tensor:
        return (ctx.cumrel[ctx.idx_at(ctx.k_eff(self.k))] > 0).to(torch.float32)


class RetrievalNormalizedDCG(_RetrievalKMetric):
    __doc__ = f"""Mean NDCG at k over queries; the targets may hold graded gains.

    Example:{_EXAMPLE_ROWS}
        >>> from metrics_tpu_torch import RetrievalNormalizedDCG
        >>> metric = RetrievalNormalizedDCG(device="cpu")
        >>> round(float(metric(preds, target, indexes=indexes)), 4)
        0.8467
    """

    allow_non_binary_target = True

    def _segment_metric(self, ctx: GroupedRows) -> Tensor:
        kv = ctx.k_eff(self.k)
        discount = 1.0 / torch.log2(ctx.ranks.to(torch.float32) + 1.0)
        dcg = segment_cumsum(ctx.rel * discount, ctx.seg, ctx.num_groups)[ctx.idx_at(kv)]
        # the ideal order: the rows sorted again by (group, descending gain)
        order1 = torch.argsort(-ctx.rel, stable=True)
        order2 = torch.argsort(ctx.seg[order1], stable=True)
        ideal = ctx.rel[order1][order2]
        idcg = segment_cumsum(ideal * discount, ctx.seg, ctx.num_groups)[ctx.idx_at(kv)]
        return torch.where(idcg > 0, dcg / torch.clamp(idcg, min=1e-12), 0.0)


class RetrievalRPrecision(RetrievalMetric):
    __doc__ = f"""Mean R-precision over queries: the precision at R, the number of relevant documents.

    Example:{_EXAMPLE_ROWS}
        >>> from metrics_tpu_torch import RetrievalRPrecision
        >>> metric = RetrievalRPrecision(device="cpu")
        >>> round(float(metric(preds, target, indexes=indexes)), 4)
        0.75
    """

    def _segment_metric(self, ctx: GroupedRows) -> Tensor:
        # graded relevance binarised with > 0 for R and the hits, as in AP and MRR
        r = ctx.n_hits().to(torch.int32)
        found = ctx.cum_bin()[ctx.idx_at(r)]
        return torch.where(r > 0, found / torch.clamp(r, min=1).to(torch.float32), 0.0)


class RetrievalPrecisionRecallCurve(RetrievalMetric):
    __doc__ = f"""Precision and recall at k = 1 … ``max_k``, averaged over queries.

    A query shorter than ``max_k`` repeats its last hit count (the rank read
    is clamped to the query's length).

    Example:{_EXAMPLE_ROWS}
        >>> from metrics_tpu_torch import RetrievalPrecisionRecallCurve
        >>> metric = RetrievalPrecisionRecallCurve(max_k=2, device="cpu")
        >>> precisions, recalls, top_k = metric(preds, target, indexes=indexes)
        >>> precisions
        tensor([0.5000, 0.5000])
        >>> recalls
        tensor([0.5000, 0.7500])
        >>> top_k
        tensor([1, 2], dtype=torch.int32)
    """

    higher_is_better = None

    def __init__(
        self,
        max_k: Optional[int] = None,
        adaptive_k: bool = False,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(empty_target_action=empty_target_action, ignore_index=ignore_index, **kwargs)
        if max_k is not None and not (isinstance(max_k, int) and max_k > 0):
            raise ValueError("`max_k` has to be a positive integer or None")
        if not isinstance(adaptive_k, bool):
            raise ValueError("`adaptive_k` has to be a boolean")
        self.max_k = max_k
        self.adaptive_k = adaptive_k

    def _segment_metric(self, ctx: GroupedRows) -> Tensor:  # pragma: no cover - compute is overridden
        raise NotImplementedError

    def compute(self) -> Tuple[Tensor, Tensor, Tensor]:
        ctx = self._grouped_state()
        max_k = self.max_k or (int(ctx.counts.max()) if ctx is not None else 1)
        top_k = torch.arange(1, max_k + 1, dtype=torch.int32, device=self.device)
        if ctx is None:
            zeros = torch.zeros(max_k, device=self.device)
            return zeros, zeros.clone(), top_k

        ks = top_k[None, :]  # (1, K)
        kv = torch.minimum(ks, ctx.counts[:, None])  # (G, K): the rank examined, clamped
        cumrel_k = ctx.cumrel[ctx.starts[:, None] + kv - 1]  # hits stay flat past a group's length
        # the divisor is k (precision decays past n) unless adaptive_k caps it at n
        divisor = kv if self.adaptive_k else ks.expand_as(kv)
        precisions = cumrel_k / divisor.to(torch.float32)
        recalls = torch.where(
            (ctx.n_pos > 0)[:, None], cumrel_k / torch.clamp(ctx.n_pos, min=1.0)[:, None], 0.0
        )
        valid = self._group_valid(ctx)
        return self._apply_empty_action(precisions, valid), self._apply_empty_action(recalls, valid), top_k


class RetrievalRecallAtFixedPrecision(RetrievalPrecisionRecallCurve):
    __doc__ = f"""The highest recall at k whose precision at k reaches ``min_precision``, and that k.

    Example:{_EXAMPLE_ROWS}
        >>> from metrics_tpu_torch import RetrievalRecallAtFixedPrecision
        >>> metric = RetrievalRecallAtFixedPrecision(min_precision=0.3, device="cpu")
        >>> recall, top_k = metric(preds, target, indexes=indexes)
        >>> recall
        tensor(1.)
        >>> top_k
        tensor(4, dtype=torch.int32)
    """

    def __init__(
        self,
        min_precision: float = 0.0,
        max_k: Optional[int] = None,
        adaptive_k: bool = False,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            max_k=max_k, adaptive_k=adaptive_k, empty_target_action=empty_target_action, ignore_index=ignore_index, **kwargs
        )
        if not isinstance(min_precision, float) or not 0.0 <= min_precision <= 1.0:
            raise ValueError("`min_precision` has to be a float between 0 and 1")
        self.min_precision = min_precision

    def compute(self) -> Tuple[Tensor, Tensor]:
        precisions, recalls, top_k = super().compute()
        ok = precisions >= self.min_precision
        rec = torch.where(ok, recalls, float("-inf"))
        rmax = torch.max(rec)
        any_ok = torch.isfinite(rmax)
        # the reference's max over (recall, k) pairs: the largest k among ties, and
        # max_k whenever the best recall is 0 (`retrieval/precision_recall_curve.py:43-52`)
        kbest = torch.max(torch.where(ok & (rec == rmax), top_k, torch.iinfo(torch.int32).min))
        best_recall = torch.where(any_ok, rmax, 0.0)
        best_k = torch.where(any_ok & (best_recall > 0.0), kbest, torch.max(top_k))
        return best_recall, best_k


__all__ = [
    "RetrievalMAP",
    "RetrievalMRR",
    "RetrievalPrecision",
    "RetrievalRecall",
    "RetrievalFallOut",
    "RetrievalHitRate",
    "RetrievalNormalizedDCG",
    "RetrievalRPrecision",
    "RetrievalPrecisionRecallCurve",
    "RetrievalRecallAtFixedPrecision",
]
