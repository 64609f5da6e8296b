"""MultioutputWrapper: one clone of a metric for each output column.

JAX counterpart: `metrics_tpu/wrappers/multioutput.py:39` (``_get_nan_indices``
`:28`, ``_get_args_kwargs_by_output`` `:79`); reference
`wrappers/multioutput.py:24-145`. The one-program column fan-out of the JAX
package (`wrappers/_fanout.py`) is not ported: every update runs the eager
column loop.
"""
from __future__ import annotations

from copy import deepcopy
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
from torch import Tensor, nn

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.data import apply_to_collection


def _get_nan_indices(*tensors: Tensor) -> Tensor:
    """Rows holding a NaN in any of ``tensors``."""
    if len(tensors) == 0:
        raise ValueError("Must pass at least one tensor as argument")
    nan_idxs = torch.zeros(len(tensors[0]), dtype=torch.bool, device=tensors[0].device)
    for tensor in tensors:
        nan_idxs = nan_idxs | torch.isnan(tensor.reshape(len(tensor), -1)).any(dim=1)
    return nan_idxs


class MultioutputWrapper(Metric):
    """Evaluate one metric per output column and return the list of values.

    With ``remove_nans`` a row whose column slice holds a NaN is left out of
    that column's update. Which rows those are is data, so an update reads the
    masks of every column on the host, all in one read.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MultioutputWrapper, R2Score
        >>> preds = torch.tensor([[1.0, 10.0], [2.0, 20.0], [3.0, 30.0]])
        >>> target = torch.tensor([[1.0, 12.0], [2.0, 21.0], [3.5, 29.0]])
        >>> r2 = MultioutputWrapper(R2Score(device="cpu"), num_outputs=2)
        >>> [round(float(v), 4) for v in r2(preds, target)]
        [0.9211, 0.9585]
    """

    is_differentiable = False
    full_state_update: Optional[bool] = True

    def __init__(
        self,
        base_metric: Metric,
        num_outputs: int,
        output_dim: int = -1,
        remove_nans: bool = True,
        squeeze_outputs: bool = True,
        **kwargs: Any,
    ) -> None:
        kwargs.setdefault("device", base_metric.device)
        super().__init__(**kwargs)
        self.metrics = nn.ModuleList([deepcopy(base_metric) for _ in range(num_outputs)])
        self.output_dim = output_dim
        self.remove_nans = remove_nans
        self.squeeze_outputs = squeeze_outputs

    def _get_args_kwargs_by_output(self, *args: Tensor, **kwargs: Tensor) -> List[Tuple[list, dict]]:
        per_column: List[Tuple[list, dict]] = []
        masks: List[Optional[Tensor]] = []
        for i in range(len(self.metrics)):
            selected_args = apply_to_collection(args, Tensor, torch.narrow, self.output_dim, i, 1)
            selected_kwargs = apply_to_collection(kwargs, Tensor, torch.narrow, self.output_dim, i, 1)
            tensors = list(selected_args) + list(selected_kwargs.values())
            masks.append(_get_nan_indices(*tensors) if self.remove_nans and tensors else None)
            per_column.append((list(selected_args), dict(selected_kwargs)))

        # which rows to drop is data: one host read for every column's mask, and
        # no gather at all for a column without a NaN (the common case)
        host_masks = None
        if any(m is not None for m in masks):
            host_masks = torch.stack([m for m in masks if m is not None]).cpu().numpy()

        args_kwargs_by_output = []
        mask_pos = 0
        for (selected_args, selected_kwargs), mask in zip(per_column, masks):
            if mask is not None:
                host_mask = host_masks[mask_pos]
                mask_pos += 1
                if host_mask.any():
                    keep = torch.from_numpy(np.flatnonzero(~host_mask))
                    selected_args = [arg[keep.to(arg.device)] for arg in selected_args]
                    selected_kwargs = {k: v[keep.to(v.device)] for k, v in selected_kwargs.items()}
            if self.squeeze_outputs:
                selected_args = [arg.squeeze(self.output_dim) for arg in selected_args]
                selected_kwargs = {k: v.squeeze(self.output_dim) for k, v in selected_kwargs.items()}
            args_kwargs_by_output.append((selected_args, selected_kwargs))
        return args_kwargs_by_output

    def update(self, *args: Any, **kwargs: Any) -> None:
        for metric, (selected_args, selected_kwargs) in zip(self.metrics, self._get_args_kwargs_by_output(*args, **kwargs)):
            metric.update(*selected_args, **selected_kwargs)

    def compute(self) -> List[Tensor]:
        return [m.compute() for m in self.metrics]

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        results = [
            metric(*selected_args, **selected_kwargs)
            for metric, (selected_args, selected_kwargs) in zip(self.metrics, self._get_args_kwargs_by_output(*args, **kwargs))
        ]
        if results[0] is None:
            return None
        return results

    def reset(self) -> None:
        for metric in self.metrics:
            metric.reset()
        super().reset()


__all__ = ["MultioutputWrapper"]
