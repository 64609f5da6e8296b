"""Moment and correlation metrics: CosineSimilarity, ExplainedVariance, R2Score,
PearsonCorrCoef, SpearmanCorrCoef and TweedieDevianceScore.

JAX counterpart: `metrics_tpu/regression/advanced.py`; reference
`regression/{explained_variance,r2,pearson,spearman,cosine_similarity,tweedie_deviance}.py`.

``PearsonCorrCoef`` declares its six moments with ``dist_reduce_fx=None``: a
sync stacks every process's moments, and ``compute()`` merges the stack
(`advanced.py:218-226`). CosineSimilarity and SpearmanCorrCoef buffer raw
rows and cast or flatten them when the rows are observed
(:meth:`Metric._canonicalize_list_states`), as the curve metrics do.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch import Tensor

from metrics_tpu_torch.functional.regression.correlation import (
    _cosine_similarity_compute,
    _pearson_corrcoef_compute,
    _pearson_corrcoef_update,
    _pearson_final_aggregation,
    _pearson_merge,
    _spearman_corrcoef_compute,
)
from metrics_tpu_torch.functional.regression.moments import (
    _explained_variance_compute,
    _explained_variance_update,
    _r2_score_compute,
    _r2_score_update,
    _tweedie_deviance_score_compute,
    _tweedie_deviance_score_update,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.data import _keep_if_same, dim_zero_cat, dim_zero_cat_ravel

_MULTIOUTPUTS = ("raw_values", "uniform_average", "variance_weighted")


class CosineSimilarity(Metric):
    """Cosine similarity of every pair of rows seen, reduced.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import CosineSimilarity
        >>> preds = torch.tensor([[2.0, 0.0], [1.0, 1.0]])
        >>> target = torch.tensor([[1.0, 0.0], [1.0, 0.0]])
        >>> cosine_similarity = CosineSimilarity(reduction='mean', device="cpu")
        >>> round(float(cosine_similarity(preds, target)), 4)
        0.8536
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = True

    def __init__(self, reduction: str = "sum", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        allowed_reduction = ("sum", "mean", "none", None)
        if reduction not in allowed_reduction:
            raise ValueError(f"Expected argument `reduction` to be one of {allowed_reduction} but got {reduction}")
        self.reduction = reduction
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("target", [], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        # the rows are buffered raw; the float32 cast waits until they are observed
        preds = torch.as_tensor(preds, device=self.device)
        target = torch.as_tensor(target, device=self.device)
        _check_same_shape(preds, target)
        self.preds.append(preds)
        self.target.append(target)

    def _canonicalize_list_states(self) -> None:
        if not isinstance(self.preds, list):
            return  # after a sync the "cat" reduction left one canonical tensor
        for i in range(len(self.preds)):
            self.preds[i] = self.preds[i].to(torch.float32)
            self.target[i] = self.target[i].to(torch.float32)

    def compute(self) -> Tensor:
        preds = dim_zero_cat(self.preds).to(torch.float32)
        target = dim_zero_cat(self.target).to(torch.float32)
        return _cosine_similarity_compute(preds, target, self.reduction)


class ExplainedVariance(Metric):
    """Explained variance, from running sums.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import ExplainedVariance
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> explained_variance = ExplainedVariance(device="cpu")
        >>> round(float(explained_variance(preds, target)), 4)
        0.9572
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    def __init__(self, multioutput: str = "uniform_average", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if multioutput not in _MULTIOUTPUTS:
            raise ValueError(f"Invalid input to argument `multioutput`. Choose one of the following: {_MULTIOUTPUTS}")
        self.multioutput = multioutput
        for name in ("sum_error", "sum_squared_error", "sum_target", "sum_squared_target", "n_obs"):
            self.add_state(name, default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds = torch.as_tensor(preds, device=self.device)
        target = torch.as_tensor(target, device=self.device)
        n_obs, sum_error, sum_squared_error, sum_target, sum_squared_target = _explained_variance_update(preds, target)
        self.n_obs = self.n_obs + n_obs
        self.sum_error = self.sum_error + sum_error
        self.sum_squared_error = self.sum_squared_error + sum_squared_error
        self.sum_target = self.sum_target + sum_target
        self.sum_squared_target = self.sum_squared_target + sum_squared_target

    def compute(self) -> Tensor:
        return _explained_variance_compute(
            self.n_obs,
            self.sum_error,
            self.sum_squared_error,
            self.sum_target,
            self.sum_squared_target,
            self.multioutput,
        )


class R2Score(Metric):
    """R², from running sums; adjusted, and one value an output, on request.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import R2Score
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> r2score = R2Score(device="cpu")
        >>> round(float(r2score(preds, target)), 4)
        0.9486
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    def __init__(
        self, num_outputs: int = 1, adjusted: int = 0, multioutput: str = "uniform_average", **kwargs: Any
    ) -> None:
        super().__init__(**kwargs)
        self.num_outputs = num_outputs
        if adjusted < 0 or not isinstance(adjusted, int):
            raise ValueError("`adjusted` parameter should be an integer larger or equal to 0.")
        self.adjusted = adjusted
        if multioutput not in _MULTIOUTPUTS:
            raise ValueError(f"Invalid input to argument `multioutput`. Choose one of the following: {_MULTIOUTPUTS}")
        self.multioutput = multioutput

        shape = () if num_outputs == 1 else (num_outputs,)
        self.add_state("sum_squared_error", default=torch.zeros(shape), dist_reduce_fx="sum")
        self.add_state("sum_error", default=torch.zeros(shape), dist_reduce_fx="sum")
        self.add_state("residual", default=torch.zeros(shape), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds = torch.as_tensor(preds, device=self.device)
        target = torch.as_tensor(target, device=self.device)
        sum_squared_obs, sum_obs, rss, n_obs = _r2_score_update(preds, target)
        self.sum_squared_error = self.sum_squared_error + sum_squared_obs
        self.sum_error = self.sum_error + sum_obs
        self.residual = self.residual + rss
        self.total = self.total + n_obs

    def compute(self) -> Tensor:
        return _r2_score_compute(
            self.sum_squared_error, self.sum_error, self.residual, self.total, self.adjusted, self.multioutput
        )


_PEARSON_MOMENTS = ("mean_x", "mean_y", "var_x", "var_y", "corr_xy", "n_total")


class PearsonCorrCoef(Metric):
    """Pearson correlation from streaming moments, merged across processes after a sync.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import PearsonCorrCoef
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> pearson = PearsonCorrCoef(device="cpu")
        >>> round(float(pearson(preds, target)), 4)
        0.9849
    """

    is_differentiable = True
    higher_is_better = None
    full_state_update = True

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        # dist_reduce_fx=None: a sync stacks every process's moments; compute merges them
        for name in _PEARSON_MOMENTS:
            self.add_state(name, default=torch.tensor(0.0), dist_reduce_fx=None)

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds = torch.as_tensor(preds, device=self.device)
        target = torch.as_tensor(target, device=self.device)
        self.mean_x, self.mean_y, self.var_x, self.var_y, self.corr_xy, self.n_total = _pearson_corrcoef_update(
            preds, target, self.mean_x, self.mean_y, self.var_x, self.var_y, self.corr_xy, self.n_total
        )

    def _merge_stacked(self, stacked: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """The moments, each stacked one stream a row, merged into one stream's (a sharded update's merge)."""
        return dict(zip(_PEARSON_MOMENTS, _pearson_merge(*(stacked[k] for k in _PEARSON_MOMENTS))))

    def compute(self) -> Tensor:
        if self.var_x.ndim > 0 and self.var_x.shape[0] > 1:
            # synced: one row of moments a process, merged pairwise
            var_x, var_y, corr_xy, n_total = _pearson_final_aggregation(
                self.mean_x, self.mean_y, self.var_x, self.var_y, self.corr_xy, self.n_total
            )
        else:
            var_x, var_y, corr_xy, n_total = self.var_x, self.var_y, self.corr_xy, self.n_total
        return _pearson_corrcoef_compute(var_x, var_y, corr_xy, n_total)


class SpearmanCorrCoef(Metric):
    """Spearman rank correlation of every row seen.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import SpearmanCorrCoef
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> spearman = SpearmanCorrCoef(device="cpu")
        >>> round(float(spearman(preds, target)), 4)
        1.0
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("target", [], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        # the checks read shapes and dtypes only; the rows are flattened when observed
        preds = torch.as_tensor(preds, device=self.device)
        target = torch.as_tensor(target, device=self.device)
        if preds.dtype != target.dtype:
            raise TypeError(
                "Expected `preds` and `target` to have the same data type."
                f" Got preds: {preds.dtype} and target: {target.dtype}."
            )
        _check_same_shape(preds, target)
        if len([d for d in preds.shape if d != 1]) > 1:
            raise ValueError("Expected both predictions and target to be 1 dimensional tensors.")
        self.preds.append(preds)
        self.target.append(target)

    def _canonicalize_list_states(self) -> None:
        if not isinstance(self.preds, list):
            return  # after a sync the "cat" reduction left one canonical tensor
        for i in range(len(self.preds)):
            self.preds[i] = _keep_if_same(self.preds[i], self.preds[i].reshape(-1))
            self.target[i] = _keep_if_same(self.target[i], self.target[i].reshape(-1))

    def compute(self) -> Tensor:
        return _spearman_corrcoef_compute(dim_zero_cat_ravel(self.preds), dim_zero_cat_ravel(self.target))


class TweedieDevianceScore(Metric):
    """Mean Tweedie deviance of the distribution family with this ``power``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import TweedieDevianceScore
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, 0.5, 2.0, 7.0])
        >>> deviance_score = TweedieDevianceScore(power=0, device="cpu")
        >>> round(float(deviance_score(preds, target)), 4)
        0.375
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(self, power: float = 0.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if 0 < power < 1:
            raise ValueError(f"Deviance Score is not defined for power={power}.")
        self.power = power
        self.add_state("sum_deviance_score", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("num_observations", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, targets: Tensor) -> None:
        preds = torch.as_tensor(preds, device=self.device)
        targets = torch.as_tensor(targets, device=self.device)
        sum_deviance_score, num_observations = _tweedie_deviance_score_update(preds, targets, self.power)
        self.sum_deviance_score = self.sum_deviance_score + sum_deviance_score
        self.num_observations = self.num_observations + num_observations

    def compute(self) -> Tensor:
        return _tweedie_deviance_score_compute(self.sum_deviance_score, self.num_observations)


__all__ = [
    "CosineSimilarity",
    "ExplainedVariance",
    "R2Score",
    "PearsonCorrCoef",
    "SpearmanCorrCoef",
    "TweedieDevianceScore",
]
