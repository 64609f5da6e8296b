"""StatScores module metric.

JAX counterpart: `metrics_tpu/classification/stat_scores.py` (reference
`classification/stat_scores.py:155-260`): int32 "sum" states for the micro
and macro reduces, list "cat" states for the samplewise ones.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.stat_scores import _stat_scores_compute, _stat_scores_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.enums import AverageMethod, MDMCAverageMethod


class StatScores(Metric):
    """Accumulates tp/fp/tn/fn; ``compute`` returns ``[..., 5]`` with the support.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import StatScores
        >>> preds = torch.tensor([1, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> stat_scores = StatScores(reduce='micro', device="cpu")
        >>> stat_scores(preds, target)
        tensor([2, 2, 6, 2, 4], dtype=torch.int32)
    """

    is_differentiable: Optional[bool] = False
    higher_is_better: Optional[bool] = None
    full_state_update: Optional[bool] = False

    def __init__(
        self,
        threshold: float = 0.5,
        top_k: Optional[int] = None,
        reduce: str = "micro",
        num_classes: Optional[int] = None,
        ignore_index: Optional[int] = None,
        mdmc_reduce: Optional[str] = None,
        multiclass: Optional[bool] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)

        self.reduce = reduce
        self.mdmc_reduce = mdmc_reduce
        self.num_classes = num_classes
        self.threshold = threshold
        self.multiclass = multiclass
        self.ignore_index = ignore_index
        self.top_k = top_k

        if reduce not in ("micro", "macro", "samples"):
            raise ValueError(f"The `reduce` {reduce} is not valid.")
        if mdmc_reduce not in (None, "samplewise", "global"):
            raise ValueError(f"The `mdmc_reduce` {mdmc_reduce} is not valid.")
        if reduce == "macro" and (not num_classes or num_classes < 1):
            raise ValueError("When you set `reduce` as 'macro', you have to provide the number of classes.")
        if num_classes and ignore_index is not None and (not ignore_index < num_classes or num_classes == 1):
            raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {num_classes} classes")

        if mdmc_reduce != "samplewise" and reduce != "samples":
            shape = () if reduce == "micro" else (num_classes,)
            for s in ("tp", "fp", "tn", "fn"):
                self.add_state(s, default=torch.zeros(shape, dtype=torch.int32), dist_reduce_fx="sum")
        else:
            for s in ("tp", "fp", "tn", "fn"):
                self.add_state(s, default=[], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        tp, fp, tn, fn = _stat_scores_update(
            preds,
            target,
            reduce=self.reduce,
            mdmc_reduce=self.mdmc_reduce,
            threshold=self.threshold,
            num_classes=self.num_classes,
            top_k=self.top_k,
            multiclass=self.multiclass,
            ignore_index=self.ignore_index,
        )
        if self.reduce != AverageMethod.SAMPLES and self.mdmc_reduce != MDMCAverageMethod.SAMPLEWISE:
            self.tp = self.tp + tp
            self.fp = self.fp + fp
            self.tn = self.tn + tn
            self.fn = self.fn + fn
        else:
            self.tp.append(tp)
            self.fp.append(fp)
            self.tn.append(tn)
            self.fn.append(fn)

    def _get_final_stats(self) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
        return tuple(
            torch.cat([torch.atleast_1d(v) for v in s]) if isinstance(s, list) else s
            for s in (self.tp, self.fp, self.tn, self.fn)
        )

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._get_final_stats()
        return _stat_scores_compute(tp, fp, tn, fn)


__all__ = ["StatScores"]
