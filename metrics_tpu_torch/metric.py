"""The ``Metric`` base class.

JAX counterpart: `metrics_tpu/metric.py` (``add_state`` `:343-373`, the
wrapped update `:429` and compute `:2315`, the reduce-state forward
`:1771-1829`, ``reset`` `:2450`, ``clone`` `:2539`, ``state_dict`` /
``persistent`` `:2576-2620`); reference `src/torchmetrics/metric.py`.

As in TorchMetrics, a metric is an ``nn.Module``: tensor states are plain
attributes that move with ``.to()``, and ``state_dict()`` holds the states
marked persistent. Updates rebind states to new tensors instead of writing
into them, so a snapshot is a dict of references, as in the JAX package.

Left for later slices of the port: the dispatch engine and fused programs,
deferred dispatch, ``update_many``/``forward_many``, the fault ladders,
telemetry, the state journal, ``as_functions`` and ``CompositionalMetric``,
and state sync across processes (``compute()`` raises while a process group
of more than one rank is live).
"""
from __future__ import annotations

import copy
import functools
import inspect
from abc import ABC, abstractmethod
from typing import Any, Callable, Dict, List, Optional, Union

import torch
from torch import Tensor, nn

from metrics_tpu_torch.utils import checks as _checks
from metrics_tpu_torch.utils.data import _flatten, dim_zero_cat, dim_zero_max, dim_zero_mean, dim_zero_min, dim_zero_sum
from metrics_tpu_torch.utils.exceptions import MetricsUserError
from metrics_tpu_torch.utils.prints import rank_zero_warn

_REDUCTIONS: Dict[str, Callable] = {
    "sum": dim_zero_sum,
    "mean": dim_zero_mean,
    "max": dim_zero_max,
    "min": dim_zero_min,
    "cat": dim_zero_cat,
}


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """The device a metric's states live on: ``device``, or the card when it is None.

    Never falls back to the CPU: with no device given and no CUDA device
    present it raises, and the caller asks for ``device="cpu"`` explicitly.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise MetricsUserError(
            "metrics_tpu_torch runs on a CUDA device by default, and none is available;"
            " pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


def _raise_if_distributed() -> None:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        raise NotImplementedError(
            f"compute() across {dist.get_world_size()} processes needs state sync, which"
            " metrics_tpu_torch does not have yet (ROADMAP.md, Queue 1, 'State sync');"
            " it refuses to serve a value from this process's states alone"
        )


def _squeeze_scalar(value: Any) -> Any:
    """Squeeze 1-element results to scalars like reference `metric.py:531-532`."""
    if isinstance(value, Tensor) and value.ndim == 1 and value.shape[0] == 1:
        return value.squeeze()
    return value


class Metric(nn.Module, ABC):
    """Base class for all metrics.

    Subclasses implement :meth:`update` and :meth:`compute` and declare their
    accumulator states with :meth:`add_state`. A state is a tensor with a
    reduction (``"sum" | "mean" | "max" | "min"`` or a callable), or a list of
    tensors with ``"cat"`` or ``None``.

    Args:
        device: where the states live. ``None`` means the current CUDA device,
            and raises when there is none; pass ``"cpu"`` to run on the CPU.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Metric
        >>> class CountPositives(Metric):
        ...     full_state_update = False
        ...     def __init__(self, **kwargs):
        ...         super().__init__(**kwargs)
        ...         self.add_state("count", default=torch.tensor(0), dist_reduce_fx="sum")
        ...     def update(self, x):
        ...         self.count = self.count + (x > 0).sum()
        ...     def compute(self):
        ...         return self.count
        >>> metric = CountPositives(device="cpu")
        >>> metric(torch.tensor([1.0, -2.0, 3.0]))
        tensor(2)
        >>> metric.update(torch.tensor([5.0]))
        >>> metric.compute()
        tensor(3)
    """

    is_differentiable: Optional[bool] = None
    higher_is_better: Optional[bool] = None
    full_state_update: Optional[bool] = None

    def __init__(self, *, device: Union[str, torch.device, None] = None, **kwargs: Any) -> None:
        super().__init__()
        if kwargs:
            raise ValueError(f"Unexpected keyword arguments: {sorted(kwargs)}")
        self._device = resolve_device(device)
        self._defaults: Dict[str, Union[Tensor, list]] = {}
        self._reductions: Dict[str, Optional[Callable]] = {}
        self._reduction_specs: Dict[str, Optional[str]] = {}
        self._persistent: Dict[str, bool] = {}

        self._update_count = 0
        self._computed: Any = None
        self._forward_cache: Any = None
        self._to_sync = True  # False while forward computes a batch value

        self.update: Callable = self._wrap_update(self.update)  # type: ignore[method-assign]
        self.compute: Callable = self._wrap_compute(self.compute)  # type: ignore[method-assign]

    @property
    def device(self) -> torch.device:
        return self._device

    # ------------------------------------------------------------------ state
    def add_state(
        self,
        name: str,
        default: Union[Tensor, list],
        dist_reduce_fx: Union[str, Callable, None] = None,
        persistent: bool = False,
    ) -> None:
        """Register an accumulator state (reference ``add_state`` `metric.py:158-226`)."""
        if not name.isidentifier():
            raise ValueError(f"Argument `name` must be a valid python identifier, got {name!r}")
        if isinstance(default, list):
            if default:
                raise ValueError("State defaults of list kind must be empty lists")
        elif isinstance(default, Tensor):
            default = default.detach().to(self._device)
        else:
            raise ValueError(f"State default must be a tensor or an empty list, got {type(default)}")
        if isinstance(dist_reduce_fx, str):
            spec = dist_reduce_fx.lower()
            if spec not in _REDUCTIONS:
                raise ValueError(
                    f"`dist_reduce_fx` must be one of {sorted(_REDUCTIONS)}, a callable, or None; got {dist_reduce_fx!r}"
                )
            fn: Optional[Callable] = _REDUCTIONS[spec]
        elif callable(dist_reduce_fx):
            spec, fn = "custom", dist_reduce_fx
        elif dist_reduce_fx is None:
            spec, fn = None, None
        else:
            raise ValueError(f"`dist_reduce_fx` must be a string, callable, or None, got {type(dist_reduce_fx)}")
        self._defaults[name] = default
        self._reductions[name] = fn
        self._reduction_specs[name] = spec
        self._persistent[name] = persistent
        setattr(self, name, [] if isinstance(default, list) else default.clone())

    @property
    def update_called(self) -> bool:
        """Whether ``update``/``forward`` has been called since the last reset."""
        return self._update_count > 0

    @property
    def update_count(self) -> int:
        return self._update_count

    @property
    def metric_state(self) -> Dict[str, Any]:
        """Current states by name (tensor, or list of tensors)."""
        return {name: getattr(self, name) for name in self._defaults}

    def _state_snapshot(self) -> Dict[str, Any]:
        # states are rebound, never written into: references are a snapshot;
        # lists are copied because list states are appended to
        return {k: (list(v) if isinstance(v, list) else v) for k, v in self.metric_state.items()}

    def _restore_state(self, state: Dict[str, Any]) -> None:
        for name, value in state.items():
            setattr(self, name, list(value) if isinstance(value, list) else value)

    # ----------------------------------------------------------------- update
    @abstractmethod
    def update(self, *args: Any, **kwargs: Any) -> None:
        """Accumulate batch statistics into the metric state."""

    @abstractmethod
    def compute(self) -> Any:
        """Finalise the accumulated state into the metric value."""

    def _wrap_update(self, update: Callable) -> Callable:
        @functools.wraps(update)
        def wrapped(*args: Any, **kwargs: Any) -> None:
            self._computed = None
            self._update_count += 1
            prev_owner = _checks._check_owner
            _checks._check_owner = self  # "first"-mode memory is kept per instance
            try:
                with torch.no_grad():
                    update(*args, **kwargs)
            finally:
                _checks._check_owner = prev_owner

        return wrapped

    def _wrap_compute(self, compute: Callable) -> Callable:
        @functools.wraps(compute)
        def wrapped(*args: Any, **kwargs: Any) -> Any:
            if self._to_sync:
                _raise_if_distributed()
            if self._update_count == 0:
                rank_zero_warn(
                    f"The ``compute`` method of metric {self.__class__.__name__} was called before the ``update``"
                    " method which may lead to errors, as metric states have not yet been updated.",
                    UserWarning,
                )
            if self._computed is not None:
                return self._computed
            with torch.no_grad():
                self._computed = _squeeze_scalar(compute(*args, **kwargs))
            return self._computed

        return wrapped

    # ---------------------------------------------------------------- forward
    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """Compute the metric on the batch AND accumulate it into the state.

        Returns the batch value (reference ``forward`` `metric.py:228-247`).
        """
        if self.full_state_update or self.full_state_update is None:
            self._forward_cache = self._forward_full_state_update(*args, **kwargs)
        else:
            self._forward_cache = self._forward_reduce_state_update(*args, **kwargs)
        return self._forward_cache

    def _forward_full_state_update(self, *args: Any, **kwargs: Any) -> Any:
        """Two updates: for metrics whose update reads the state it accumulates into."""
        entry_state = self._state_snapshot()
        entry_count = self._update_count
        try:
            self.update(*args, **kwargs)
            update_count = self._update_count
            self._to_sync = False
            cache = self._state_snapshot()
            self.reset()
            self.update(*args, **kwargs)
            batch_val = self.compute()
            self._restore_state(cache)
            self._update_count = update_count
        except Exception:
            # a bad batch must not corrupt the accumulated history
            self._restore_state(entry_state)
            self._update_count = entry_count
            raise
        finally:
            self._to_sync = True
            self._computed = None
        return batch_val

    def _forward_reduce_state_update(self, *args: Any, **kwargs: Any) -> Any:
        """One update on a reset state, its batch value, then a merge into the old state."""
        global_state = self._state_snapshot()
        update_count = self._update_count
        self.reset()
        self._to_sync = False
        try:
            self.update(*args, **kwargs)
            batch_val = self.compute()
            self._update_count = update_count + 1
            self._reduce_states(global_state)
        except Exception:
            self._restore_state(global_state)
            self._update_count = update_count
            raise
        finally:
            self._to_sync = True
            self._computed = None
        return batch_val

    def _reduce_states(self, incoming_state: Dict[str, Any]) -> None:
        """Merge an incoming state into the current one (reference `metric.py:327-354`)."""
        for name in self._defaults:
            local = getattr(self, name)
            incoming = incoming_state[name]
            spec = self._reduction_specs[name]
            if spec == "sum":
                reduced = incoming + local
            elif spec == "mean":
                reduced = ((self._update_count - 1) * incoming + local) / self._update_count
            elif spec == "max":
                reduced = torch.maximum(incoming, local)
            elif spec == "min":
                reduced = torch.minimum(incoming, local)
            elif spec == "cat":
                reduced = incoming + local if isinstance(incoming, list) else torch.cat([incoming, local])
            elif spec is None and isinstance(incoming, list):
                reduced = _flatten([incoming, local])
            elif spec is None:
                reduced = torch.stack([incoming, local])
            else:  # custom callable
                reduced = self._reductions[name](torch.stack([incoming, local]))
            setattr(self, name, reduced)

    # ------------------------------------------------------------- lifecycle
    def reset(self) -> None:
        """Reset every state to its default (reference `metric.py:547-562`)."""
        self._update_count = 0
        self._forward_cache = None
        self._computed = None
        for name, default in self._defaults.items():
            setattr(self, name, [] if isinstance(default, list) else default.clone())

    def clone(self) -> "Metric":
        """An independent deep copy, states included."""
        return copy.deepcopy(self)

    def __getstate__(self) -> Dict[str, Any]:
        # the wrapped bound methods close over this instance: re-wrapped on restore
        return {k: v for k, v in self.__dict__.items() if k not in ("update", "compute")}

    def __setstate__(self, state: Dict[str, Any]) -> None:
        super().__setstate__(state)
        self.update = self._wrap_update(type(self).update.__get__(self))  # type: ignore[method-assign]
        self.compute = self._wrap_compute(type(self).compute.__get__(self))  # type: ignore[method-assign]

    def __setattr__(self, name: str, value: Any) -> None:
        if name in ("higher_is_better", "is_differentiable", "full_state_update"):
            raise RuntimeError(f"Can't change const `{name}`.")
        super().__setattr__(name, value)

    def _apply(self, fn: Callable, recurse: bool = True) -> "Metric":
        """``.to()``, ``.cuda()``, ``.double()`` and kin reach the states and their defaults too."""
        super()._apply(fn, recurse)
        for name, default in self._defaults.items():
            value = getattr(self, name)
            if isinstance(default, Tensor):
                self._defaults[name] = fn(default)
            if isinstance(value, Tensor):
                setattr(self, name, fn(value))
            else:
                setattr(self, name, [fn(v) for v in value])
        self._device = fn(torch.zeros(0, device=self._device)).device
        self._computed = None
        return self

    # -------------------------------------------------------- serialization
    def _save_to_state_dict(self, destination: Dict[str, Any], prefix: str, keep_vars: bool) -> None:
        super()._save_to_state_dict(destination, prefix, keep_vars)
        for name in self._defaults:
            if not self._persistent[name]:
                continue
            value = getattr(self, name)
            if isinstance(value, list):
                destination[prefix + name] = [v if keep_vars else v.detach() for v in value]
            else:
                destination[prefix + name] = value if keep_vars else value.detach()

    def _load_from_state_dict(
        self,
        state_dict: Dict[str, Any],
        prefix: str,
        local_metadata: Dict[str, Any],
        strict: bool,
        missing_keys: List[str],
        unexpected_keys: List[str],
        error_msgs: List[str],
    ) -> None:
        for name in self._defaults:
            key = prefix + name
            if key in state_dict:
                value = state_dict.pop(key)
                if isinstance(value, list):
                    setattr(self, name, [v.detach().clone().to(self._device) for v in value])
                else:
                    setattr(self, name, value.detach().clone().to(self._device))
            elif strict and self._persistent[name]:
                missing_keys.append(key)
        self._computed = None
        super()._load_from_state_dict(
            state_dict, prefix, local_metadata, strict, missing_keys, unexpected_keys, error_msgs
        )

    def persistent(self, mode: bool = False) -> None:
        """Set whether every state is saved by ``state_dict()`` (reference `metric.py:657-660`)."""
        for name in self._persistent:
            self._persistent[name] = mode
        for child in self.children():
            if isinstance(child, Metric):
                child.persistent(mode)

    # ------------------------------------------------------------- plumbing
    def _filter_kwargs(self, **kwargs: Any) -> Dict[str, Any]:
        """Keep only the kwargs this metric's update accepts (reference `metric.py:702-722`)."""
        params = inspect.signature(type(self).update).parameters
        if any(p.kind == inspect.Parameter.VAR_KEYWORD for p in params.values()):
            return kwargs
        return {
            k: v for k, v in kwargs.items() if k in params and params[k].kind != inspect.Parameter.VAR_POSITIONAL
        }


__all__ = ["Metric", "resolve_device"]
