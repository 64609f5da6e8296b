"""Moment sums: explained variance, R² and the Tweedie deviance.

JAX counterpart: `metrics_tpu/functional/regression/moments.py` (reference
`functional/regression/{explained_variance,r2,tweedie_deviance}.py`). Every
state is a running sum.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _check_same_shape, _is_concrete, _should_value_check
from metrics_tpu_torch.utils.compute import _safe_xlogy
from metrics_tpu_torch.utils.prints import rank_zero_warn


# ------------------------------------------------------------ explained var
def _explained_variance_update(preds: Tensor, target: Tensor) -> Tuple[int, Tensor, Tensor, Tensor, Tensor]:
    _check_same_shape(preds, target)
    n_obs = preds.shape[0]
    diff = target - preds
    return (
        n_obs,
        torch.sum(diff, dim=0),
        torch.sum(diff * diff, dim=0),
        torch.sum(target, dim=0),
        torch.sum(target * target, dim=0),
    )


def _explained_variance_compute(
    n_obs: Union[int, Tensor],
    sum_error: Tensor,
    sum_squared_error: Tensor,
    sum_target: Tensor,
    sum_squared_target: Tensor,
    multioutput: str = "uniform_average",
) -> Tensor:
    diff_avg = sum_error / n_obs
    numerator = sum_squared_error / n_obs - diff_avg * diff_avg
    target_avg = sum_target / n_obs
    denominator = sum_squared_target / n_obs - target_avg * target_avg

    nonzero_numerator = numerator != 0
    nonzero_denominator = denominator != 0
    valid_score = nonzero_numerator & nonzero_denominator
    output_scores = torch.ones_like(diff_avg)
    output_scores = torch.where(valid_score, 1.0 - numerator / torch.where(valid_score, denominator, 1.0), output_scores)
    output_scores = torch.where(nonzero_numerator & ~nonzero_denominator, 0.0, output_scores)

    if multioutput == "raw_values":
        return output_scores
    if multioutput == "uniform_average":
        return torch.mean(output_scores)
    if multioutput == "variance_weighted":
        denom_sum = torch.sum(denominator)
        return torch.sum(denominator / denom_sum * output_scores)
    raise ValueError(
        "Argument `multioutput` must be one of 'raw_values', 'uniform_average' or 'variance_weighted',"
        f" got {multioutput}"
    )


def explained_variance(preds: Tensor, target: Tensor, multioutput: str = "uniform_average") -> Tensor:
    """Explained variance, 1 - Var(y - ŷ) / Var(y).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import explained_variance
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> explained_variance(preds, target)
        tensor(0.9572)
    """
    return _explained_variance_compute(*_explained_variance_update(preds, target), multioutput=multioutput)


# --------------------------------------------------------------------- r2
def _r2_score_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor, Tensor, int]:
    _check_same_shape(preds, target)
    if preds.ndim > 2:
        raise ValueError(
            "Expected both prediction and target to be 1D or 2D tensors,"
            f" but received tensors with dimension {preds.shape}"
        )
    sum_obs = torch.sum(target, dim=0)
    sum_squared_obs = torch.sum(target * target, dim=0)
    residual = torch.sum((target - preds) ** 2, dim=0)
    return sum_squared_obs, sum_obs, residual, target.shape[0]


def _r2_score_compute(
    sum_squared_obs: Tensor,
    sum_obs: Tensor,
    rss: Tensor,
    n_obs: Union[int, Tensor],
    adjusted: int = 0,
    multioutput: str = "uniform_average",
) -> Tensor:
    # one host read, as in JAX; none under a transform, where JAX's tracer skips the checks
    n = int(n_obs) if _is_concrete(n_obs) else None
    if n is not None and n < 2:
        raise ValueError("Needs at least two samples to calculate r2 score.")

    mean_obs = sum_obs / n_obs
    tss = sum_squared_obs - sum_obs * mean_obs
    raw_scores = 1 - (rss / tss)

    if multioutput == "raw_values":
        r2 = raw_scores
    elif multioutput == "uniform_average":
        r2 = torch.mean(raw_scores)
    elif multioutput == "variance_weighted":
        tss_sum = torch.sum(tss)
        r2 = torch.sum(tss / tss_sum * raw_scores)
    else:
        raise ValueError(
            "Argument `multioutput` must be either `raw_values`, `uniform_average` or `variance_weighted`."
            f" Received {multioutput}."
        )

    if adjusted < 0 or not isinstance(adjusted, int):
        raise ValueError("`adjusted` parameter should be an integer larger or equal to 0.")

    if adjusted != 0:
        if n is not None and adjusted > n - 1:
            rank_zero_warn(
                "More independent regressions than data points in adjusted r2 score. Falls back to standard r2 score.",
                UserWarning,
            )
        elif n is not None and adjusted == n - 1:
            rank_zero_warn("Division by zero in adjusted r2 score. Falls back to standard r2 score.", UserWarning)
        else:
            r2 = 1 - (1 - r2) * (n_obs - 1) / (n_obs - adjusted - 1)
    return r2


def r2_score(preds: Tensor, target: Tensor, adjusted: int = 0, multioutput: str = "uniform_average") -> Tensor:
    """R², the coefficient of determination (adjusted with ``adjusted`` regressors).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import r2_score
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> r2_score(preds, target)
        tensor(0.9486)
    """
    sum_squared_obs, sum_obs, rss, n_obs = _r2_score_update(preds, target)
    return _r2_score_compute(sum_squared_obs, sum_obs, rss, n_obs, adjusted, multioutput)


# ----------------------------------------------------------------- tweedie
def _tweedie_deviance_score_update(preds: Tensor, targets: Tensor, power: float = 0.0) -> Tuple[Tensor, Tensor]:
    _check_same_shape(preds, targets)
    preds = preds.to(torch.float32)
    targets = targets.to(torch.float32)

    if 0 < power < 1:
        raise ValueError(f"Deviance Score is not defined for power={power}.")

    # the domain checks read values: one fused read, when the validation mode asks for it
    check = _should_value_check(preds, targets, key_extra=("tweedie", power))

    def _domain_flags() -> list:
        return torch.stack([torch.any(preds <= 0), torch.any(targets < 0), torch.any(targets <= 0)]).tolist()

    if power == 0:
        deviance_score = (targets - preds) ** 2
    elif power == 1:
        if check:
            flags = _domain_flags()
            if flags[0] or flags[1]:
                raise ValueError(
                    f"For power={power}, 'preds' has to be strictly positive and 'targets' cannot be negative."
                )
        deviance_score = 2 * (_safe_xlogy(targets, targets / preds) + preds - targets)
    elif power == 2:
        if check:
            flags = _domain_flags()
            if flags[0] or flags[2]:
                raise ValueError(f"For power={power}, both 'preds' and 'targets' have to be strictly positive.")
        deviance_score = 2 * (torch.log(preds / targets) + targets / preds - 1)
    else:
        if check:
            flags = _domain_flags()
            if power < 0:
                if flags[0]:
                    raise ValueError(f"For power={power}, 'preds' has to be strictly positive.")
            elif 1 < power < 2:
                if flags[0] or flags[1]:
                    raise ValueError(
                        f"For power={power}, 'preds' has to be strictly positive and 'targets' cannot be negative."
                    )
            elif flags[0] or flags[2]:
                raise ValueError(f"For power={power}, both 'preds' and 'targets' have to be strictly positive.")

        term_1 = torch.clamp(targets, min=0) ** (2 - power) / ((1 - power) * (2 - power))
        term_2 = targets * preds ** (1 - power) / (1 - power)
        term_3 = preds ** (2 - power) / (2 - power)
        deviance_score = 2 * (term_1 - term_2 + term_3)

    return torch.sum(deviance_score), torch.tensor(targets.numel(), dtype=torch.int32, device=targets.device)


def _tweedie_deviance_score_compute(sum_deviance_score: Tensor, num_observations: Tensor) -> Tensor:
    return sum_deviance_score / num_observations


def tweedie_deviance_score(preds: Tensor, targets: Tensor, power: float = 0.0) -> Tensor:
    """Mean Tweedie deviance of the distribution family with this ``power``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import tweedie_deviance_score
        >>> targets = torch.tensor([1.0, 2.0, 3.0, 4.0])
        >>> preds = torch.tensor([4.0, 3.0, 2.0, 1.0])
        >>> tweedie_deviance_score(preds, targets, power=2)
        tensor(1.2083)
    """
    sum_deviance_score, num_observations = _tweedie_deviance_score_update(preds, targets, power)
    return _tweedie_deviance_score_compute(sum_deviance_score, num_observations)


__all__ = ["explained_variance", "r2_score", "tweedie_deviance_score"]
