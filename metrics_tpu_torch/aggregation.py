"""Stream aggregation metrics: Max, Min, Sum, Cat and Mean.

JAX counterpart: `metrics_tpu/aggregation.py` (reference
`src/torchmetrics/aggregation.py`). The NaN strategies are the JAX
package's:

- ``"error"``, ``"warn"``, ``"ignore"`` or a float to impute.
- Whether NaNs are present is a host read of the device (``bool(isnan(x).any())``),
  so it follows the validation mode (``utils/checks.py``): ``"full"`` reads
  every update, ``"first"`` the first of each input signature, ``"off"`` none.
- Where no read is made, ``"ignore"`` and ``"warn"`` mask NaNs with the
  reduction's neutral value (``_nan_neutral``) and a weight of 0, which gives
  the same values as removing them; ``"warn"`` then does not warn. ``"error"``
  keeps the NaN, so it shows in the result.
- ``"ignore"`` never reads the device: the Sum/Mean/Max/Min aggregators mask,
  and ``CatMetric`` drops NaNs from the concatenation in ``compute``.

The JAX package's dispatch machinery (the update lane, tracer branches) has
no counterpart in the port's ``Metric``.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.checks import _should_value_check
from metrics_tpu_torch.utils.prints import rank_zero_warn


class BaseAggregator(Metric):
    """Base for simple stream aggregators.

    Args:
        fn: the state's reduction (``"sum"``, ``"max"``, ``"min"``, ``"cat"``).
        default_value: the state's initial value.
        nan_strategy: ``"error"``, ``"warn"``, ``"ignore"`` or a float to impute.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.aggregation import BaseAggregator
        >>> class Count(BaseAggregator):
        ...     def __init__(self, **kwargs):
        ...         super().__init__("sum", torch.tensor(0.0), nan_strategy="ignore", **kwargs)
        ...     def update(self, value):
        ...         value, _ = self._cast_and_nan_check_input(value)
        ...         self.value = self.value + (value != 0).sum()
        >>> metric = Count(device="cpu")
        >>> metric.update(torch.tensor([1.0, float("nan"), 0.0, 2.0]))
        >>> metric.compute()
        tensor(2.)
    """

    full_state_update: Optional[bool] = False
    #: what a NaN is replaced with where it is masked and not removed: the
    #: identity of the subclass's reduction
    _nan_neutral: float = 0.0
    #: True where the state keeps the values themselves (CatMetric): masking
    #: is not removal there
    _keeps_raw_values: bool = False

    def __init__(
        self,
        fn: Union[Callable, str],
        default_value: Union[Tensor, list],
        nan_strategy: Union[str, float] = "error",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        allowed = ("error", "warn", "ignore")
        if not (nan_strategy in allowed or isinstance(nan_strategy, (int, float))):
            raise ValueError(
                f"Arg `nan_strategy` should either be a float or one of {allowed} but got {nan_strategy}"
            )
        self.nan_strategy = nan_strategy
        self.add_state("value", default=default_value, dist_reduce_fx=fn)

    def _cast_and_nan_check_input(
        self,
        x: Union[float, Tensor],
        weight: Optional[Union[float, Tensor]] = None,
        force_value_check: Optional[bool] = None,
    ) -> Tuple[Tensor, Optional[Tensor]]:
        """Cast to the state's float dtype on the metric's device and apply the
        NaN strategy to the values and the weights. Returns both flattened."""
        state_dtype = self.value.dtype if isinstance(self.value, Tensor) else torch.float32
        acc_dtype = state_dtype if state_dtype.is_floating_point else torch.float32
        x = torch.as_tensor(x, dtype=acc_dtype, device=self.device)
        if weight is not None:
            weight = torch.as_tensor(weight, dtype=acc_dtype, device=self.device).broadcast_to(x.shape)

        def nan_mask() -> Tensor:
            return torch.isnan(x) if weight is None else torch.isnan(x) | torch.isnan(weight)

        def masked() -> Tuple[Tensor, Optional[Tensor]]:
            nans = nan_mask()
            return x.masked_fill(nans, self._nan_neutral), None if weight is None else weight.masked_fill(nans, 0.0)

        if isinstance(self.nan_strategy, str):
            if self.nan_strategy == "ignore" and not self._keeps_raw_values:
                x, weight = masked()
            elif (
                force_value_check
                if force_value_check is not None
                else _should_value_check(x, x if weight is None else weight, key_extra=("agg-nan", self.nan_strategy))
            ):
                nans = nan_mask()
                if bool(nans.any()):
                    if self.nan_strategy == "error":
                        raise RuntimeError("Encounted `nan` values in tensor")
                    if self.nan_strategy == "warn":
                        rank_zero_warn("Encounted `nan` values in tensor. Will be removed.", UserWarning)
                    x = x[~nans]
                    if weight is not None:
                        weight = weight[~nans]
            elif self.nan_strategy == "warn" and not self._keeps_raw_values:
                x, weight = masked()
            # "error" with the check off keeps the NaN: it shows in the result
        else:
            x = x.masked_fill(torch.isnan(x), float(self.nan_strategy))
            if weight is not None:
                weight = weight.masked_fill(torch.isnan(weight), float(self.nan_strategy))
        return x.reshape(-1), None if weight is None else weight.reshape(-1)

    def compute(self) -> Tensor:
        return self.value


class MaxMetric(BaseAggregator):
    """Running maximum.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MaxMetric
        >>> metric = MaxMetric(device="cpu")
        >>> metric.update(1.0)
        >>> metric.update(torch.tensor([2.0, 3.0]))
        >>> metric.compute()
        tensor(3.)
    """

    _nan_neutral = float("-inf")

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("max", torch.tensor(-float("inf")), nan_strategy, **kwargs)

    def update(self, value: Union[float, Tensor]) -> None:
        value, _ = self._cast_and_nan_check_input(value)
        if value.numel():  # every value may have been removed
            self.value = torch.maximum(self.value, value.max())


class MinMetric(BaseAggregator):
    """Running minimum.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MinMetric
        >>> metric = MinMetric(device="cpu")
        >>> metric.update(1.0)
        >>> metric.update(torch.tensor([2.0, 3.0]))
        >>> metric.compute()
        tensor(1.)
    """

    _nan_neutral = float("inf")

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("min", torch.tensor(float("inf")), nan_strategy, **kwargs)

    def update(self, value: Union[float, Tensor]) -> None:
        value, _ = self._cast_and_nan_check_input(value)
        if value.numel():
            self.value = torch.minimum(self.value, value.min())


class SumMetric(BaseAggregator):
    """Running sum.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import SumMetric
        >>> metric = SumMetric(device="cpu")
        >>> metric.update(1.0)
        >>> metric.update(torch.tensor([2.0, 3.0]))
        >>> metric.compute()
        tensor(6.)
    """

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("sum", torch.tensor(0.0), nan_strategy, **kwargs)

    def update(self, value: Union[float, Tensor]) -> None:
        value, _ = self._cast_and_nan_check_input(value)
        self.value = self.value + value.sum()


class CatMetric(BaseAggregator):
    """Concatenation of every value seen.

    Each update appends its values, flattened and cast to float32. Where the
    NaN check did not run (``"ignore"``, or a validation mode that skipped
    it), NaNs are appended and ``compute`` drops them under ``"ignore"`` and
    ``"warn"``; the values equal those of removal at update time.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import CatMetric
        >>> metric = CatMetric(device="cpu")
        >>> metric.update(1.0)
        >>> metric.update(torch.tensor([2.0, 3.0]))
        >>> metric.compute()
        tensor([1., 2., 3.])
    """

    _keeps_raw_values = True

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("cat", [], nan_strategy, **kwargs)

    def update(self, value: Union[float, Tensor]) -> None:
        value = torch.as_tensor(value, dtype=torch.float32, device=self.device)
        needs_check = not isinstance(self.nan_strategy, str) or (
            self.nan_strategy != "ignore"
            and _should_value_check(value, value, key_extra=("agg-nan", self.nan_strategy))
        )
        if needs_check:
            value, _ = self._cast_and_nan_check_input(value, force_value_check=True)
        if value.numel():
            self.value.append(value.reshape(-1))

    def compute(self) -> Union[Tensor, list]:
        out = self.value
        if isinstance(out, list) and out:  # rows loaded from elsewhere may be of any shape and dtype
            out = torch.cat([v.reshape(-1) for v in out]).to(torch.float32)
        if self.nan_strategy in ("ignore", "warn") and isinstance(out, Tensor) and out.numel():
            out = out[~torch.isnan(out)]
        return out


class MeanMetric(BaseAggregator):
    """Weighted running mean.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MeanMetric
        >>> metric = MeanMetric(device="cpu")
        >>> metric.update(1.0)
        >>> metric.update(torch.tensor([2.0, 3.0]))
        >>> metric.compute()
        tensor(2.)
    """

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("sum", torch.tensor(0.0), nan_strategy, **kwargs)
        self.add_state("weight", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, value: Union[float, Tensor], weight: Union[float, Tensor] = 1.0) -> None:
        value, weight = self._cast_and_nan_check_input(value, weight)
        self.value = self.value + (value * weight).sum()
        self.weight = self.weight + weight.sum()

    def compute(self) -> Tensor:
        return self.value / self.weight


__all__ = ["BaseAggregator", "MaxMetric", "MinMetric", "SumMetric", "CatMetric", "MeanMetric"]
