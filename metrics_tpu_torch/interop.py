"""Carry accumulated state, and the networks' weights, across from the JAX package.

A metric holds accumulator states, so carrying a metric across is carrying
state: a JAX metric's ``metric_state`` (or its
``state_dict()``), as numpy arrays, is loaded into the port's metric of the
same configuration, and both then ``compute()`` the same value. Wrapper
trees and compositions load child by child, under the names the JAX
package's ``_named_child_metrics`` gives them (``metrics.3``, ``metric_a``,
``_base_metric``), which are the port's ``state_dict`` prefixes too. The
model-backed metrics' networks carry their weights across with
:func:`inception_state_from_flax` and :func:`lpips_state_from_flax`. This
module takes plain numpy arrays and imports nothing of the JAX package.
"""
from __future__ import annotations

from copy import deepcopy
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from metrics_tpu_torch.classification.ranking import _RankingBase
from metrics_tpu_torch.collections import MetricCollection
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.models.inception import INCEPTION_CONVERTER, InceptionV3
from metrics_tpu_torch.models.lpips import _BACKBONES, LPIPSNet, lpips_converter
from metrics_tpu_torch.models.manifest import meta_module, state_from_flax
from metrics_tpu_torch.utils.enums import DataType
from metrics_tpu_torch.wrappers.tracker import MetricTracker


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


def _child_state(state: Mapping[str, Any], name: str) -> Dict[str, Any]:
    """The part of ``state`` under ``name``: a nested dict, or the flat ``"name.key"`` entries."""
    if isinstance(state.get(name), Mapping):
        return dict(state[name])
    return {k[len(name) + 1 :]: v for k, v in state.items() if k.startswith(name + ".")}


def _load_metric(metric: Metric, state: Mapping[str, Any], update_count: int, mode: Optional[str]) -> None:
    metric._defer_barrier()  # queued calls run first: a later flush must not write over the loaded states
    for name, child in metric._named_child_metrics():
        _load_metric(child, _child_state(state, name), update_count, mode)
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
    state: Any,
    *,
    update_count: int = 1,
    mode: Optional[str] = None,
) -> None:
    """Load a JAX metric's accumulated state into ``metric``.

    Args:
        metric: a :class:`Metric` (a wrapper or a composition loads each child
            metric too), a :class:`MetricCollection` whose members are loaded
            one by one, or a :class:`MetricTracker`.
        state: for a metric, state name -> numpy array (a list of arrays for
            list states, such as an image metric's buffered rows), as the JAX
            metric's ``metric_state`` gives it; a child's states under its
            name, nested (``{"metrics.3": {...}}``) or flat (``"metrics.3.tp"``,
            the keys of the JAX wrapper's ``state_dict()`` after
            ``persistent(True)``). For a collection, member name -> such a
            dict, or the flat ``"member.state"`` keys of the JAX collection's
            ``state_dict()``. For a tracker, a sequence with one such state for
            each step (the JAX tracker's steps), which replaces its history.
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
    if isinstance(metric, MetricTracker):
        if not isinstance(state, Sequence):
            raise TypeError(f"a tracker loads a sequence of step states, got {type(state).__name__}")
        history = []
        for step_state in state:
            step = deepcopy(metric._base_metric)
            step.reset()
            load_reference_state(step, step_state, update_count=update_count, mode=mode)
            history.append(step)
        metric._history = history
        metric._increment_called = bool(history)
        return
    if isinstance(metric, MetricCollection):
        for name, member in metric.items(keep_base=True, copy_state=False):
            _load_metric(member, _child_state(state, name), update_count, mode)
        # the next update re-derives the compute groups from the loaded states
        metric._groups_checked = False
        if metric._enable_compute_groups:
            metric._init_compute_groups()
        return
    if not isinstance(metric, Metric):
        raise TypeError(f"expected a Metric or a MetricCollection, got {type(metric).__name__}")
    _load_metric(metric, state, update_count, mode)


def inception_state_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port ``InceptionV3``'s ``state_dict`` (CPU tensors) from the JAX package's weights.

    ``params`` is the Flax variables tree as numpy arrays (``{"params": ...,
    "batch_stats": ...}``, nested) or the flat ``"a/b/c"`` keys of the ``.npz``
    that ``tools/convert_inception_weights.py`` writes. It is checked against
    the manifest first: a missing, extra or mis-shaped key raises
    ``ValueError`` naming it and the converter command. Kernels move from
    Flax's HWIO and (in, out) to OIHW and (out, in); ``fc_bias`` becomes
    ``fc.bias``; BatchNorm's ``scale``/``bias`` and ``batch_stats`` become
    ``bn.weight``/``bn.bias`` and the running mean and variance.
    """
    return state_from_flax(params, meta_module(InceptionV3), INCEPTION_CONVERTER)


def lpips_state_from_flax(params: Mapping[str, Any], net_type: str) -> Dict[str, torch.Tensor]:
    """The port ``LPIPSNet(net_type)``'s ``state_dict`` (CPU tensors) from the JAX package's weights
    (the Flax variables tree, or the flat keys of ``tools/convert_lpips_weights.py``'s ``.npz``),
    checked against the manifest as :func:`inception_state_from_flax` is."""
    if net_type not in _BACKBONES:
        raise ValueError(f"Argument `net_type` must be one of {tuple(_BACKBONES)}, but got {net_type}.")
    return state_from_flax(params, meta_module(LPIPSNet, net_type), lpips_converter(net_type))


def _tree_to_torch(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, Mapping):
        return {k: _tree_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to_torch(v, device) for v in tree]
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def funcstate_from_reference(states_np: Mapping[str, Any], epoch: int, *, device: Any = None) -> Any:
    """A JAX functional state tree, given as numpy arrays, as the port's
    :class:`~metrics_tpu_torch.functional_core.FuncState` (each array copied to
    ``device``, the card unless one is given; lists of arrays stay lists).

    ``states_np`` is the JAX ``FuncState``'s ``states`` with every leaf passed
    through ``np.asarray``: ``{state: array}`` for a metric, ``{member:
    {state: array}}`` for a collection.

    Example:
        >>> import numpy as np
        >>> from metrics_tpu_torch import SumMetric
        >>> from metrics_tpu_torch.interop import funcstate_from_reference
        >>> state = funcstate_from_reference({"value": np.array(4.0, np.float32)}, epoch=1, device="cpu")
        >>> float(SumMetric(device="cpu").apply_compute(state))
        4.0
    """
    from metrics_tpu_torch.functional_core import FuncState
    from metrics_tpu_torch.metric import resolve_device

    return FuncState(_tree_to_torch(states_np, resolve_device(device)), epoch)


def arena_from_reference(content: Mapping[str, Any], template: Any, **kwargs: Any) -> Any:
    """A JAX ``MetricArena``'s content, given as numpy arrays, as the port's
    :class:`~metrics_tpu_torch.arena.MetricArena` over ``template`` (a Metric or
    MetricCollection of the same configuration, on the device the arena is to
    use). Both arenas then go on alike: the same ids, cohorts and window ring.

    ``content`` holds ``capacity`` and ``slab`` (the arena's ``capacity`` and
    ``slab_size``), ``stacked`` (the fused lane's ``{flat name: array}``, with
    JAX's member separator) or ``rows`` (the row lane's per-tenant trees, None
    for a free id), ``live``, ``counts``, ``cohorts``, ``free``,
    ``watermark``, ``closes`` and ``ring`` (the window ring's ``(close id,
    {cohort: {"states", "count"}})`` slots); ``kwargs`` go to the constructor
    (``name``, ``cohort``, ``window_slots``, ``journal_path``).
    """
    from metrics_tpu_torch.arena import MetricArena

    arena = MetricArena(template, int(content["capacity"]), slab=int(content["slab"]), **kwargs)
    if arena.capacity != int(content["capacity"]):
        raise ValueError(f"a capacity of {content['capacity']} is no slab bucket of slab {content['slab']}")
    device = arena.device
    if arena.fused:
        arena._stacked = {name: _to_tensor(content["stacked"][name], leaf) for name, leaf in arena._stacked.items()}
    else:
        arena._rows = [None if row is None else _tree_to_torch(row, device) for row in content["rows"]]
    arena._live = np.array(content["live"], dtype=bool)
    arena._counts = np.array(content["counts"], dtype=np.int64)
    arena._cohorts = np.array(list(content["cohorts"]), dtype=object)
    arena._free = [int(i) for i in content["free"]]
    arena._watermark = int(content["watermark"])
    arena._closes = int(content.get("closes", 0))
    arena._ring.clear()
    for close_id, slot in content.get("ring", ()):
        arena._ring.append((int(close_id), deepcopy(slot)))
    return arena


__all__ = [
    "arena_from_reference",
    "funcstate_from_reference",
    "inception_state_from_flax",
    "load_reference_state",
    "lpips_state_from_flax",
]
