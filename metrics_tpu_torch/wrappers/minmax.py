"""MinMaxMetric: the running minimum and maximum of a wrapped metric's value.

JAX counterpart: `metrics_tpu/wrappers/minmax.py:16` (``forward`` `:67`,
``compute`` `:179`); reference `wrappers/minmax.py:23-102`.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import Tensor

from metrics_tpu_torch.metric import Metric


class MinMaxMetric(Metric):
    """Returns ``{raw, max, min}`` of the base metric's value over the ``compute()`` calls.

    Each ``compute()`` moves the extrema to the value it computes, and ``forward``
    computes the batch value, so it moves them too. The extrema are buffers, not
    states: ``reset`` keeps them, as in JAX and the reference. As there, the
    wrapper has no states of its own, so the forward's reset empties the wrapped
    metric and restores nothing: after a ``forward`` it holds only that batch.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Accuracy, MinMaxMetric
        >>> metric = MinMaxMetric(Accuracy(device="cpu"))
        >>> _ = metric(torch.tensor([1, 1, 0, 0]), torch.tensor([1, 0, 0, 0]))
        >>> _ = metric(torch.tensor([1, 0, 0, 0]), torch.tensor([1, 0, 0, 0]))
        >>> {k: round(float(v), 4) for k, v in metric.compute().items()}
        {'raw': 1.0, 'max': 1.0, 'min': 0.75}
    """

    full_state_update: Optional[bool] = True

    def __init__(self, base_metric: Metric, **kwargs: Any) -> None:
        if not isinstance(base_metric, Metric):
            raise ValueError(
                f"Expected base metric to be an instance of `metrics_tpu_torch.Metric` but received {base_metric}"
            )
        kwargs.setdefault("device", base_metric.device)
        super().__init__(**kwargs)
        self._base_metric = base_metric
        self.register_buffer("min_val", torch.tensor(float("inf"), device=self.device), persistent=False)
        self.register_buffer("max_val", torch.tensor(float("-inf"), device=self.device), persistent=False)

    def update(self, *args: Any, **kwargs: Any) -> None:
        self._base_metric.update(*args, **kwargs)

    def compute(self) -> Dict[str, Tensor]:
        val = self._base_metric.compute()
        if not self._is_suitable_val(val):
            raise RuntimeError(f"Returned value from base metric should be a float or scalar tensor, but got {val}.")
        val32 = torch.as_tensor(val, dtype=torch.float32, device=self.device)
        self.max_val = torch.where(self.max_val > val32, self.max_val, val32)
        self.min_val = torch.where(self.min_val < val32, self.min_val, val32)
        return {"raw": torch.as_tensor(val), "max": self.max_val, "min": self.min_val}

    def reset(self) -> None:
        super().reset()
        self._base_metric.reset()

    @staticmethod
    def _is_suitable_val(val: Any) -> bool:
        if isinstance(val, (int, float)):
            return True
        if isinstance(val, Tensor):
            return val.numel() == 1
        return False


__all__ = ["MinMaxMetric"]
