"""ClasswiseWrapper: split a per-class result into a dict keyed by class.

JAX counterpart: `metrics_tpu/wrappers/classwise.py:14` (``as_functions``
`:57`); reference `wrappers/classwise.py:8-78`.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from torch import Tensor

from metrics_tpu_torch.metric import Metric


class ClasswiseWrapper(Metric):
    """Wraps a per-class metric and returns ``{name_class: value}``.

    The wrapper holds no states of its own; its device defaults to the wrapped metric's.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Accuracy, ClasswiseWrapper
        >>> metric = ClasswiseWrapper(Accuracy(num_classes=3, average=None, device="cpu"))
        >>> metric.update(torch.tensor([0, 2, 1, 2]), torch.tensor([0, 1, 1, 2]))
        >>> {k: round(float(v), 4) for k, v in metric.compute().items()}
        {'accuracy_0': 1.0, 'accuracy_1': 0.5, 'accuracy_2': 1.0}
    """

    full_state_update: Optional[bool] = True

    def __init__(self, metric: Metric, labels: Optional[List[str]] = None, **kwargs: Any) -> None:
        if not isinstance(metric, Metric):
            raise ValueError(f"Expected argument `metric` to be an instance of `metrics_tpu_torch.Metric` but got {metric}")
        if labels is not None and not (isinstance(labels, list) and all(isinstance(lab, str) for lab in labels)):
            raise ValueError(f"Expected argument `labels` to either be `None` or a list of strings but got {labels}")
        kwargs.setdefault("device", metric.device)
        super().__init__(**kwargs)
        self.metric = metric
        self.labels = labels

    def _convert(self, x: Tensor) -> Dict[str, Tensor]:
        name = self.metric.__class__.__name__.lower()
        if self.labels is None:
            return {f"{name}_{i}": val for i, val in enumerate(x)}
        return {f"{name}_{lab}": val for lab, val in zip(self.labels, x)}

    def update(self, *args: Any, **kwargs: Any) -> None:
        self.metric.update(*args, **kwargs)

    def compute(self) -> Dict[str, Tensor]:
        return self._convert(self.metric.compute())

    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, Tensor]:
        return self._convert(self.metric(*args, **kwargs))

    def reset(self) -> None:
        self.metric.reset()

    def as_functions(self) -> tuple:
        """The pure export: the wrapped metric's functions, its compute labelled per
        class (the wrapper holds no states of its own)."""
        init, update_fn, child_compute = self.metric.as_functions()

        def compute_fn(state, axis_name=None):
            return self._convert(child_compute(state, axis_name=axis_name))

        return init, update_fn, compute_fn


__all__ = ["ClasswiseWrapper"]
