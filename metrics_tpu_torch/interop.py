"""Carry accumulated state across from the JAX package.

A metric here holds no weights, only accumulator states, so carrying a
model across becomes carrying state: a JAX metric's ``metric_state`` (or its
``state_dict()``), as numpy arrays, is loaded into the port's metric of the
same configuration, and both then ``compute()`` the same value. This module
takes plain numpy arrays and imports nothing of the JAX package.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from metrics_tpu_torch.classification.ranking import _RankingBase
from metrics_tpu_torch.collections import MetricCollection
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.enums import DataType


def _to_tensor(value: Any, like: torch.Tensor) -> torch.Tensor:
    tensor = torch.from_numpy(np.array(value, copy=True)).to(like.device)
    # a scalar default takes any shape: updates broadcast it (ExplainedVariance's
    # per-output sums), and a sync stacks it (PearsonCorrCoef's moments, one a process)
    if tensor.dtype != like.dtype or (like.ndim > 0 and tensor.shape != like.shape):
        raise ValueError(
            f"state of dtype {tensor.dtype} and shape {tuple(tensor.shape)} does not fit a state of"
            f" dtype {like.dtype} and shape {tuple(like.shape)}"
        )
    return tensor


def _load_metric(metric: Metric, state: Mapping[str, Any], update_count: int, mode: Optional[str]) -> None:
    missing = [name for name in metric._defaults if name not in state]
    if missing:
        raise KeyError(f"state for {type(metric).__name__} lacks {missing}")
    for name, default in metric._defaults.items():
        value = state[name]
        if isinstance(default, list):
            setattr(metric, name, [torch.from_numpy(np.array(v, copy=True)).to(metric.device) for v in value])
        else:
            try:
                setattr(metric, name, _to_tensor(value, default))
            except ValueError as err:
                raise ValueError(f"{type(metric).__name__}.{name}: {err}") from None
    metric._update_count = update_count
    metric._computed = None
    if mode is not None and hasattr(metric, "mode"):
        metric.mode = DataType(mode)
    if isinstance(metric, _RankingBase):
        # whether sample weights were passed is no state; a summed weight of 0 computes the
        # same value either way, so a non-zero sum is the whole answer
        metric._weighted = bool(metric.sample_weight != 0)


def load_reference_state(
    metric: Any,
    state: Mapping[str, Any],
    *,
    update_count: int = 1,
    mode: Optional[str] = None,
) -> None:
    """Load a JAX metric's accumulated state into ``metric``.

    Args:
        metric: a :class:`Metric`, or a :class:`MetricCollection` whose
            members are loaded one by one.
        state: for a metric, state name -> numpy array (a list of arrays for
            list states), as the JAX metric's ``metric_state`` gives it. For
            a collection, member name -> such a dict, or the flat
            ``"member.state"`` keys of the JAX collection's ``state_dict()``.
            Dtypes must match the port's states; shapes too, but for states
            whose default is a scalar (the moments that updates broadcast
            or a sync stacks). A ranking metric counts as weighted when its
            summed ``sample_weight`` is not 0.
        update_count: the number of updates the state accumulated (read by
            "mean" states and by the warning for a compute before any update).
        mode: the input case the JAX ``Accuracy`` resolved on its first update
            (its ``mode``, e.g. ``"multi-class"``); set on members that have one.

    Example:
        >>> import numpy as np
        >>> from metrics_tpu_torch import ConfusionMatrix
        >>> from metrics_tpu_torch.interop import load_reference_state
        >>> confmat = ConfusionMatrix(num_classes=2, device="cpu")
        >>> load_reference_state(confmat, {"confmat": np.array([[3, 1], [0, 2]], dtype=np.int32)})
        >>> confmat.compute()
        tensor([[3, 1],
                [0, 2]], dtype=torch.int32)
    """
    if isinstance(metric, MetricCollection):
        for name, member in metric.items(keep_base=True, copy_state=False):
            if isinstance(state.get(name), Mapping):
                member_state: Dict[str, Any] = dict(state[name])
            else:
                member_state = {k[len(name) + 1 :]: v for k, v in state.items() if k.startswith(name + ".")}
            _load_metric(member, member_state, update_count, mode)
        # the next update re-derives the compute groups from the loaded states
        metric._groups_checked = False
        if metric._enable_compute_groups:
            metric._init_compute_groups()
        return
    if not isinstance(metric, Metric):
        raise TypeError(f"expected a Metric or a MetricCollection, got {type(metric).__name__}")
    _load_metric(metric, state, update_count, mode)


__all__ = ["load_reference_state"]
