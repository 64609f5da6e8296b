"""The ``Metric`` base class.

JAX counterpart: `metrics_tpu/metric.py` (``add_state`` `:343-373`, the
wrapped update `:429` and compute `:2315`, the reduce-state forward
`:1771-1829`, ``reset`` `:2450`, ``clone`` `:2539`, ``state_dict`` /
``persistent`` `:2576-2620`); reference `src/torchmetrics/metric.py`.

As in TorchMetrics, a metric is an ``nn.Module``: tensor states are plain
attributes that move with ``.to()``, and ``state_dict()`` holds the states
marked persistent. Updates rebind states to new tensors instead of writing
into them, so a snapshot is a dict of references, as in the JAX package.

State sync across processes (`metrics_tpu/metric.py` ``_sync_dist``
`:1841`, ``_sync_coalesced`` `:1857`, ``sync`` `:1928`, ``unsync`` `:2174`,
``sync_context`` `:2221`): ``compute()`` syncs the states across the process
group, computes, and restores the local states. A metric syncs through the
coalesced protocol (:mod:`metrics_tpu_torch.parallel.bucketing`, one
payload collective) unless it brings its own ``dist_sync_fn``, which takes
the per-state protocol.

Child metrics (wrappers, compositions; JAX ``_named_child_metrics``
`:2556`): a metric held by another is a registered ``nn.Module`` child, and a
fleet of them an ``nn.ModuleList``. :meth:`Metric._named_child_metrics` reads
that registration in its order, and sync (``_sync_children``), ``persistent``,
``state_dict`` and ``.to()`` all walk it, so a child that syncs is also saved
and moved. The operators (`metric.py:2793-2890`) build a
:class:`CompositionalMetric`; metrics hash by identity (`:2731`).

Faults and the journal (`metrics_tpu/metric.py` ``_sync_coalesced``
`:1857`, ``_sync_note_clean`` `:1921`, ``save_state``/``load_state``
`:2281-2315`): a coalesced sync whose pack or unpack fails demotes the
metric's ``sync-pack`` ladder lane and replays the per-state protocol; clean
per-state syncs re-promote it. A failed sync is classified in the fault
counters and leaves the local states intact. :meth:`Metric.save_state` and
:meth:`Metric.load_state` write and read the tree's states as one record of
the crash-consistent journal (:mod:`metrics_tpu_torch.ops.journal`).

The sync planes beyond the core (`metrics_tpu/metric.py` `:105-180`,
``sync`` `:1928`, ``sync_async`` `:2021`, ``sync_health`` `:2240`, the
compute wrapper `:2315-2440`): a sync first forces every asynchronous sync
in flight; a sync over the whole world stamps ``_last_good_sync_step`` on
every node of the tree. With ``METRICS_TPU_SYNC_DEGRADED`` set, a sync that
fails past its retries (a transport fault, a timeout, a fenced epoch; never
a configuration fault) demotes the metric's ``sync-degrade`` lane, and
``compute()`` serves the local value (``local``), or the merge over the
surviving ranks while peers are declared dead (``quorum``), until clean
serves reach the recovery edge and the full sync is tried again.
:meth:`Metric.sync_async` dispatches the sync and returns a
:class:`~metrics_tpu_torch.parallel.sync.SyncFuture`; ``compute()`` forces a
pending one, and ``reset()`` cancels it.

``compute_on_cpu`` (`metrics_tpu/metric.py` `:249-285`, `:590`, `:629-680`):
after each update the list states' rows move to host memory (one copy a
row; a failed move demotes the metric's ``host`` ladder lane, fault site
``host-offload``, and the rows stay on the device until clean updates
re-promote it). ``sync()`` and ``compute()`` bring the rows back to the
metric's device first (NCCL gathers no CPU tensors), merge and compute
there, and leave the host rows in place again afterwards. ``forward``
computes its batch value with the offload off.

The dispatch engine (`metrics_tpu/metric.py` `:421-1230`, `:1441-1700`;
:mod:`metrics_tpu_torch.ops.engine`): under validation modes other than
``full``, once an input signature has passed one eager call, a metric whose
states are all tensors merged by sum, mean, max or min enqueues later
``update`` and reduce-path ``forward`` calls (``forward`` returns a
:class:`~metrics_tpu_torch.ops.engine.LazyValue`). The queue copies the
inputs, holds the states out of ``__dict__`` and flushes, in enqueue order,
when anything observes them (:meth:`Metric._defer_barrier`: a state read,
``compute``, ``sync``, ``reset``, ``state_dict``, a copy or pickle, ``.to()``,
the journal). A flush runs the queued calls through the metric's own eager
step, chunk by chunk; a failed flush replays the rest eagerly and turns
deferral off for the instance. :meth:`Metric.update_many` and
:meth:`Metric.forward_many` take a leading steps axis and run as n calls would.
The port's eager update is its single-step program: there is no fused
single-step tier. Append-only metrics bind a host lane at the first validated
update of a signature (:meth:`Metric._build_update_lane`).

The functional core (`metrics_tpu/metric.py` `:2472-2535`, `:2695-2712`,
`:2907`; :mod:`metrics_tpu_torch.functional_core`): :meth:`Metric.as_functions`
exports ``(init, update, compute)`` as pure functions over a state dict, built
from the same ``_inner_update``/``_inner_compute`` bodies the stateful API
runs; :meth:`Metric.init`, :meth:`Metric.apply_update` and
:meth:`Metric.apply_compute` run them over an epoch-stamped
:class:`~metrics_tpu_torch.functional_core.FuncState` (under
``torch.func.vmap`` and inside a CUDA-graph capture), and
:meth:`Metric.host_handoff` lands a tree back into the shell. A change of a
public hyperparameter bumps ``_fused_version``, which the fused wrapper
programs watch.
"""
from __future__ import annotations

import copy
import functools
import inspect
from abc import ABC, abstractmethod
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import Tensor, nn

from metrics_tpu_torch.ops import engine as _engine
from metrics_tpu_torch.ops import faults as _faults
from metrics_tpu_torch.ops import telemetry as _telemetry
from metrics_tpu_torch.parallel import bucketing as _bucketing
from metrics_tpu_torch.parallel import sync as _psync
from metrics_tpu_torch.parallel.reductions import resolve_reduction
from metrics_tpu_torch.parallel.sync import gather_all_tensors
from metrics_tpu_torch.utils import checks as _checks
from metrics_tpu_torch.utils.data import _flatten, apply_to_collection, dim_zero_cat
from metrics_tpu_torch.utils.exceptions import MetricsUserError, SyncConfigFault, SyncFault
from metrics_tpu_torch.utils.prints import rank_zero_warn


#: What ``sync()``, ``compute()`` and a suite's ``compute()`` ask, by default, before they sync: more than
#: one process. Looked up at each call, so a caller may replace it, as the JAX package's tests replace its
#: ``metric._dist_available``, to make a world of one sync (its gather is the identity).
_dist_available = _psync.distributed_available


def _distributed_available() -> bool:
    return _dist_available()


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


_STACKABLE_SCALARS = (bool, int, float, complex)
_UNSET = object()  # an attribute that is absent, as against one set to None
_STATIC_ATTR_SCALARS = (int, float, bool, str, bytes, type(None))


def _is_static_value(value: Any) -> bool:
    """A plain python value (or a tuple or frozenset of them): what an update may
    infer from shapes and leave on the instance for ``compute``."""
    if isinstance(value, _STATIC_ATTR_SCALARS):
        return True
    if isinstance(value, (tuple, frozenset)):
        return all(_is_static_value(v) for v in value)
    return False


def _propagate_static_attrs(src: "Metric", dst: "Metric") -> None:
    """Copy update-inferred static hyperparameters from ``src`` to ``dst`` (JAX `metric.py:2907`).

    Several metrics infer a hyperparameter from their first batch and keep it
    for ``compute`` (``mode`` on Accuracy, ``num_classes`` on the curves). Only
    public, non-state attributes holding plain python values are copied; the
    names are cached on ``src`` by its public-key tuple, the values read anew."""
    public_keys = tuple(k for k in src.__dict__ if not k.startswith("_"))
    cache = src.__dict__.get("_static_attr_names")
    if cache is None or cache[0] != public_keys:
        state_names = set(src._reduction_specs)
        cache = (public_keys, tuple(k for k in public_keys if k not in state_names))
        object.__setattr__(src, "_static_attr_names", cache)
    for name in cache[1]:
        value = src.__dict__.get(name, _UNSET)
        if value is _UNSET or not _is_static_value(value):
            continue
        old = dst.__dict__.get(name, _UNSET)
        if type(old) is not type(value) or old != value:
            object.__setattr__(dst, name, value)


def _call_leaves(tree: Any, out: list) -> bool:
    """Collect a call's leaves into ``out``; False when one cannot be queued
    (a string, a host object): only tensors, arrays and scalars can."""
    if isinstance(tree, (Tensor, np.ndarray, np.generic, *_STACKABLE_SCALARS)) or tree is None:
        out.append(tree)
        return True
    if isinstance(tree, (list, tuple)):
        return all(_call_leaves(v, out) for v in tree)
    if isinstance(tree, dict):
        return all(_call_leaves(v, out) for v in tree.values())
    return False


def _deferrable_call(args: tuple, kwargs: dict) -> bool:
    """Whether a call may enqueue: every leaf a tensor, an array or a scalar,
    and at least one tensor or array (JAX ``_leaves_jittable`` and
    ``_defer_stackable``)."""
    leaves: list = []
    return _call_leaves((args, kwargs), leaves) and any(hasattr(v, "shape") for v in leaves)


def _forward_signature(args: tuple, kwargs: dict) -> tuple:
    """A call's input signature: shapes, dtypes and devices of its tensors, the
    values of its other leaves (long reprs by their hash)."""

    def leaf(a: Any) -> Any:
        if isinstance(a, Tensor):
            return (tuple(a.shape), a.dtype, a.device)
        if hasattr(a, "shape") and hasattr(a, "dtype"):
            return (tuple(a.shape), a.dtype)
        if isinstance(a, (list, tuple)):
            return (type(a).__name__,) + tuple(leaf(v) for v in a)
        if isinstance(a, dict):
            return ("dict",) + tuple((k, leaf(v)) for k, v in sorted(a.items()))
        r = repr(a)
        return r if len(r) <= 64 else hash(r)

    return tuple(leaf(a) for a in args) + tuple((k, leaf(v)) for k, v in sorted(kwargs.items()))


def _index_leaves(tree: Any, i: int) -> Any:
    """Step ``i`` of a chunked call: tensors and arrays of at least one dimension
    are indexed on their leading axis, everything else passes through."""
    if hasattr(tree, "shape") and getattr(tree, "ndim", 0) >= 1:
        return tree[i]
    if isinstance(tree, (list, tuple)):
        return type(tree)(_index_leaves(v, i) for v in tree)
    if isinstance(tree, dict):
        return {k: _index_leaves(v, i) for k, v in tree.items()}
    return tree


def _chunk_steps(args: tuple, kwargs: dict) -> List[Tuple[tuple, dict]]:
    """The per-step calls of an ``update_many``/``forward_many`` chunk (views, no copies)."""
    leaves: list = []
    _call_leaves((args, kwargs), leaves)
    chunked = [v for v in leaves if hasattr(v, "shape") and getattr(v, "ndim", 0) >= 1]
    if not chunked:
        raise ValueError("update_many/forward_many need at least one array argument with a leading steps axis")
    lengths = {int(v.shape[0]) for v in chunked}
    if lengths == {0}:
        raise ValueError("update_many/forward_many got a zero-length steps axis (empty chunk)")
    if len(lengths) != 1:
        raise ValueError(
            "All chunked (ndim>=1) arguments must share the same leading steps-axis length; got lengths"
            f" {sorted(lengths)}. Pass per-chunk constants as python scalars or 0-d tensors."
        )
    return [_index_leaves((args, kwargs), i) for i in range(lengths.pop())]


def _stack_values(values: List[Any]) -> Any:
    """Per-step values stacked along a new leading axis (dicts key by key)."""
    first = values[0]
    if isinstance(first, dict):
        return {k: _stack_values([v[k] for v in values]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack_values([v[i] for v in values]) for i in range(len(first)))
    return torch.stack([torch.as_tensor(v) for v in values])


def _metric_many_step(metric: "Metric", steps: List[Tuple[tuple, dict]], count0: int, with_values: bool) -> list:
    """The step program of a metric's queue and of ``update_many``/``forward_many``:
    each call through the metric's own eager step, with the update count each
    step saw on the per-call path. Takes the metric as an argument, so that
    the cached program keeps no instance alive."""
    values = []
    for j, (a, k) in enumerate(steps):
        if with_values:
            object.__setattr__(metric, "_update_count", count0 + j)
            values.append(metric._forward_reduce_state_update(*a, **k))
        else:
            object.__setattr__(metric, "_update_count", count0 + j + 1)
            metric._update_step(a, k)
    return values


def _build_metric_many():
    return _metric_many_step


def _squeeze_scalar(value: Any) -> Any:
    """Squeeze 1-element results to scalars like reference `metric.py:531-532`."""
    if isinstance(value, Tensor) and value.ndim == 1 and value.shape[0] == 1:
        return value.squeeze()
    return value


def _degradable_sync_failure(exc: BaseException) -> bool:
    """Whether a failed sync may drop to the degraded tier: a transport fault,
    a timeout or a fenced epoch may; a configuration fault never does."""
    return isinstance(exc, SyncFault) and not isinstance(exc, SyncConfigFault)


def _note_degraded_serve(owner: Any) -> None:
    """Count one local-only value served while ``owner``'s ``sync-degrade`` lane is down."""
    object.__setattr__(owner, "_degraded_serves", owner.__dict__.get("_degraded_serves", 0) + 1)
    _psync.note_degraded_serve("local")
    if _telemetry.armed:
        _telemetry.emit("sync-degrade-serve", owner, "sync", attrs={"serves": owner.__dict__["_degraded_serves"]})


def _note_quorum_serve(owner: Any, survivors: List[int]) -> None:
    """Count one value merged over the surviving ranks while ``owner``'s ``sync-degrade`` lane is down."""
    object.__setattr__(owner, "_quorum_serves", owner.__dict__.get("_quorum_serves", 0) + 1)
    _psync.note_degraded_serve("quorum")
    if _telemetry.armed:
        _telemetry.emit(
            "sync-quorum-serve", owner, "sync",
            attrs={"serves": owner.__dict__["_quorum_serves"], "epoch": _psync.world_epoch(),
                   "survivors": list(survivors)},
        )


def _enter_degraded(owner: Any, exc: BaseException, tier: str = "local") -> None:
    """Demote ``owner``'s ``sync-degrade`` lane (the failure was counted where
    it was raised), stamp the onset for ``sync_health()`` and warn once."""
    serves = (
        "the surviving-QUORUM aggregate (the subgroup of ranks still alive; local-only if no quorum is known)"
        if tier == "quorum"
        else "the LOCAL-ONLY value"
    )
    _faults.demote(
        owner,
        "sync-degrade",
        exc,
        default_domain="sync",
        tier="eager",
        site="sync-degrade",
        count=False,
        warn=(
            f"Distributed sync failed for `{type(owner).__name__}` and METRICS_TPU_SYNC_DEGRADED={tier} is set: "
            f"compute() now serves {serves} (staleness metadata in sync_health()) until the sync-degrade lane's "
            "recovery edge re-probes the transport."
        ),
    )
    object.__setattr__(owner, "_degraded_since_step", _faults.current_step())


def _stamp_last_good(nodes: List[Any], step: int) -> None:
    """A sync over the whole world: every node's last good step, and no degradation onset."""
    for n in nodes:
        object.__setattr__(n, "_last_good_sync_step", step)
        if n.__dict__.get("_degraded_since_step") is not None:
            object.__setattr__(n, "_degraded_since_step", None)


def _inflight_block(fut: Any) -> Optional[Dict[str, Any]]:
    if fut is None:
        return None
    return {"age_steps": fut.age_steps(), "dispatch_epoch": fut.dispatch_epoch, "dispatch_step": fut.dispatch_step,
            "quant_tier": fut.quant_tier, "done": fut.done()}


def _fault_domain_counts() -> Dict[str, int]:
    counts: Dict[str, int] = {}
    for entry in _faults.fault_stats()["failure_log"]:
        counts[entry["domain"]] = counts.get(entry["domain"], 0) + 1
    return counts


class Metric(nn.Module, ABC):
    """Base class for all metrics.

    Subclasses implement :meth:`update` and :meth:`compute` and declare their
    accumulator states with :meth:`add_state`. A state is a tensor with a
    reduction (``"sum" | "mean" | "max" | "min"`` or a callable), or a list of
    tensors with ``"cat"`` or ``None``.

    Args:
        device: where the states live. ``None`` means the current CUDA device,
            and raises when there is none; pass ``"cpu"`` to run on the CPU.
        compute_on_cpu: move the list states' rows to host memory after each
            update, to free device memory; ``sync()`` and ``compute()`` bring
            them back to ``device`` first.
        dist_sync_on_step: sync the batch state across processes in ``forward``.
        process_group: the ``torch.distributed.ProcessGroup`` to sync over;
            None means the default group.
        dist_sync_fn: a gather ``fn(tensor, group=...) -> list of tensors`` to
            sync with, state by state, in place of the coalesced protocol.
        sync_on_compute: sync the states across processes in ``compute()``.

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
    # the merge of this metric's states of reduction None, each stacked one contribution a row
    # ({name: stacked} -> {name: merged}), which a sharded update under a data-parallel batch takes
    # (parallel/sharding.py); None: the metric has none
    _merge_stacked: Optional[Callable[[Dict[str, Tensor]], Dict[str, Tensor]]] = None

    # the dispatch engine: an open queue holds the states out of __dict__;
    # _defer_ok is the instance's health (a failed flush turns it off until the
    # "defer" ladder lane re-promotes), _many_ok the batched API's; while
    # _defer_suspended is set nothing enqueues (a flush, a chunk or an eager
    # forward is running the metric's own steps)
    _defer_pending: Optional["_engine.PendingQueue"] = None
    _defer_ok: bool = True
    _defer_suspended: bool = False
    _many_ok: bool = True
    _fused_seen_signatures: Optional[dict] = None
    _FUSED_SIG_CAP = 4096
    _fusable_cached: Optional[bool] = None
    # the host fast lane: a closure bound at the first validated update of a
    # signature, by the metrics that define _build_update_lane
    _update_lane: Optional[Callable] = None
    _has_update_lane_hook: bool = False
    # set by the metrics that keep host sums between observations (SQuAD)
    _has_host_pending_hook: bool = False
    # bumped by every change of a public hyperparameter (__setattr__): the fused
    # wrapper programs (wrappers/_fanout.py) rebuild when a version they baked moves
    _fused_version: int = 0

    def __init__(
        self,
        *,
        device: Union[str, torch.device, None] = None,
        compute_on_cpu: bool = False,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        sync_on_compute: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__()
        if kwargs:
            raise ValueError(f"Unexpected keyword arguments: {sorted(kwargs)}")
        if not isinstance(compute_on_cpu, bool):
            raise ValueError(f"Expected `compute_on_cpu` to be a bool, got {compute_on_cpu}")
        if not isinstance(dist_sync_on_step, bool):
            raise ValueError(f"Expected `dist_sync_on_step` to be a bool, got {dist_sync_on_step}")
        if dist_sync_fn is not None and not callable(dist_sync_fn):
            raise ValueError(f"Expected `dist_sync_fn` to be callable or None, got {dist_sync_fn}")
        if not isinstance(sync_on_compute, bool):
            raise ValueError(f"Expected `sync_on_compute` to be a bool, got {sync_on_compute}")
        self.compute_on_cpu = compute_on_cpu
        self.dist_sync_on_step = dist_sync_on_step
        self.process_group = _psync.check_group(process_group)
        self.dist_sync_fn = dist_sync_fn
        self.sync_on_compute = sync_on_compute
        self._device = resolve_device(device)
        self._defaults: Dict[str, Union[Tensor, list]] = {}
        self._reductions: Dict[str, Optional[Callable]] = {}
        self._reduction_specs: Dict[str, Optional[str]] = {}
        self._persistent: Dict[str, bool] = {}

        self._update_count = 0
        self._computed: Any = None
        self._forward_cache: Any = None
        self._is_synced = False
        self._cache: Optional[Dict[str, Any]] = None  # the local states while synced
        self._to_sync = sync_on_compute  # forward sets dist_sync_on_step while it computes a batch value
        self._should_unsync = True  # False while forward computes a batch value

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
        spec, fn = resolve_reduction(dist_reduce_fx)
        self._defaults[name] = default
        self._reductions[name] = fn
        self._reduction_specs[name] = spec
        self._persistent[name] = persistent
        object.__setattr__(self, "_fusable_cached", None)
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
        """Current states by name (tensor, or list of tensors). An observation:
        pending deferred calls flush first."""
        self._defer_barrier()
        return {name: getattr(self, name) for name in self._defaults}

    def _state_snapshot(self) -> Dict[str, Any]:
        # states are rebound, never written into: references are a snapshot;
        # lists are copied because list states are appended to
        return {k: (list(v) if isinstance(v, list) else v) for k, v in self.metric_state.items()}

    def _restore_state(self, state: Dict[str, Any]) -> None:
        for name, value in state.items():
            setattr(self, name, list(value) if isinstance(value, list) else value)

    def _canonicalize_list_states(self) -> None:
        """Bring buffered list-state rows to their canonical per-row form, in place.

        A metric that buffers raw input rows (the curve metrics) leaves the
        layout transform out of ``update`` and runs it after concatenation in
        ``compute``. Whatever observes the rows one by one needs them
        canonical first: the sync (rows of one state must share their rank
        to be concatenated and gathered), ``state_dict`` and pickling. Those
        paths call this hook; an override must be idempotent. The base class
        buffers nothing raw (JAX counterpart `metrics_tpu/metric.py:404`).
        """

    # ----------------------------------------------------------------- update
    @abstractmethod
    def update(self, *args: Any, **kwargs: Any) -> None:
        """Accumulate batch statistics into the metric state."""

    @abstractmethod
    def compute(self) -> Any:
        """Finalise the accumulated state into the metric value."""

    def _wrap_update(self, update: Callable) -> Callable:
        object.__setattr__(self, "_inner_update", update)

        @functools.wraps(update)
        def wrapped(*args: Any, **kwargs: Any) -> None:
            # the host fast lane: False for anything it did not bind (a new
            # signature, a mode change); compute_on_cpu bypasses it, its offload must run
            lane = self._update_lane
            if lane is not None and not self.compute_on_cpu and lane(args, kwargs):
                if _telemetry.armed:
                    _telemetry.emit("host-lane", self, "host")
                return
            self._computed = None
            self._update_count += 1
            mode = _checks._get_validation_mode()
            signature = self._defer_signature("__update__", args, kwargs, mode)
            if signature is not None and signature in self._fused_seen_signatures:
                if self._defer_ok and _engine.defer_enabled():
                    self._defer_enqueue("update", signature, args, kwargs)
                    return
                signature = None  # recorded already
            self._update_step(args, kwargs)
            if signature is not None:
                self._record_fused_signature(signature)  # only once the eager call validated it
            if self.compute_on_cpu:
                if self._move_list_states_to_host():
                    return
            elif self._has_update_lane_hook and mode != "full":
                self._install_update_lane(args, kwargs)
            self._fault_note_clean()  # a clean update: a step toward every demoted lane's recovery edge

        return wrapped

    def _update_step(self, args: tuple, kwargs: dict) -> None:
        """One call of the metric's own update, as the wrapped update runs it."""
        prev_owner = _checks._check_owner
        _checks._check_owner = self  # "first"-mode memory is kept per instance
        try:
            with torch.no_grad():
                self._inner_update(*args, **kwargs)
        finally:
            _checks._check_owner = prev_owner

    # host offload health: its own ladder lane, a failed move keeps the rows on the device
    _host_offload_ok: bool = True

    def _move_list_states_to_host(self) -> bool:
        """Move every list state's rows to host memory (``compute_on_cpu``).

        Staged: every row is copied before any state is set, so a failure
        leaves no state half moved. A failure (fault site ``host-offload``)
        demotes the ``host`` lane: the rows stay on the device and clean
        updates re-promote it. Returns True when this call demoted the lane."""
        if not self._host_offload_ok:
            return False
        try:
            if _faults.armed:
                _faults.maybe_fail("host-offload")
            moved = {name: [v.cpu() for v in getattr(self, name)]
                     for name in self._defaults if isinstance(getattr(self, name), list)}
        except Exception as exc:  # noqa: BLE001 - classified; the states untouched
            _faults.demote(
                self,
                "host",
                exc,
                default_domain="host",
                site="host-offload",
                warn=(
                    f"Host offload (compute_on_cpu) for `{type(self).__name__}` raised {type(exc).__name__}: {exc}."
                    " Keeping list states on device for this instance; the degradation ladder re-probes the"
                    " offload after clean steps."
                ),
            )
            self._host_offload_ok = False
            return True
        for name, rows in moved.items():
            setattr(self, name, rows)
        return False

    def _fault_note_clean(self, n: int = 1) -> None:
        """``n`` clean steps for every demoted lane; the lanes whose recovery edge fires are promoted
        (JAX `metric.py:783`). One dict lookup when no lane was ever demoted."""
        ladders = self.__dict__.get("_fault_ladders")
        if not ladders:
            return
        for lane, lad in list(ladders.items()):
            if lad.demoted and lad.note_clean(n):
                lad.promote()
                if lane == "host":
                    self._host_offload_ok = True
                elif lane == "defer":
                    object.__setattr__(self, "_defer_ok", True)
                elif lane == "many":
                    object.__setattr__(self, "_many_ok", True)
                elif lane.startswith("fanout:"):  # a wrapper's clone program re-probes
                    _, ok_attr, program_attr = lane.split(":", 2)
                    object.__setattr__(self, ok_attr, True)
                    object.__setattr__(self, program_attr, None)

    def _lift_host_rows(self) -> None:
        """Bring list-state rows held on the host (``compute_on_cpu``) back to this
        metric's device, for a sync or a compute there."""
        if not self.compute_on_cpu or self._device.type == "cpu":
            return
        for name in self._defaults:
            value = getattr(self, name)
            if isinstance(value, list) and any(v.device != self._device for v in value):
                setattr(self, name, [v.to(self._device) for v in value])

    # ------------------------------------------------------ deferred dispatch
    def _fusable_states(self) -> bool:
        """Every state a tensor merged by sum, mean, max or min (JAX `metric.py:1236`):
        the metrics whose calls may enqueue. Cached; ``add_state`` clears it."""
        cached = self._fusable_cached
        if cached is None:
            cached = bool(self._defaults) and all(
                not isinstance(default, list) and self._reduction_specs[name] in ("sum", "mean", "max", "min")
                for name, default in self._defaults.items()
            )
            object.__setattr__(self, "_fusable_cached", cached)
        return cached

    def _defer_signature(self, tag: str, args: tuple, kwargs: dict, mode: str) -> Optional[tuple]:
        """The signature under which this call may enqueue once it has run eagerly, or None."""
        if mode == "full" or self._defer_suspended or not self._fusable_states() or not _deferrable_call(args, kwargs):
            return None
        if self._fused_seen_signatures is None:
            object.__setattr__(self, "_fused_seen_signatures", {})
        return (tag, _forward_signature(args, kwargs))

    def _record_fused_signature(self, signature: tuple) -> None:
        """Record a signature that passed one eager call; the oldest goes past the cap."""
        seen = self._fused_seen_signatures
        seen[signature] = None
        while len(seen) > self._FUSED_SIG_CAP:
            seen.pop(next(iter(seen)))

    def _defer_barrier(self) -> None:
        """Flush a pending queue, then fold host sums (:meth:`_host_pending_flush`):
        the one hook every surface that observes the states goes through."""
        q = self.__dict__.get("_defer_pending")
        if q is not None:
            q.flush()
        if self._has_host_pending_hook:
            self._host_pending_flush()

    def _host_pending_flush(self) -> None:
        """Hook: fold the host sums kept between observations into the states
        (SQuAD). Runs at every observation; must be idempotent."""

    def __getattr__(self, name: str) -> Any:
        # reached only for a name missing from __dict__: a state held by an open
        # queue flushes it (a flush replaying eagerly may open another: bounded)
        d = self.__dict__
        for _ in range(8):
            q = d.get("_defer_pending")
            if q is None or not q.has_state(self, name):
                break
            q.flush()
            if name in d:
                return d[name]
        return super().__getattr__(name)

    def _suspend_deferral(self) -> bool:
        """Stop enqueues while the metric runs its own steps; returns the flag to put back."""
        prev = self._defer_suspended
        object.__setattr__(self, "_defer_suspended", True)
        return prev

    def _defer_enqueue(self, kind: str, signature: tuple, args: tuple, kwargs: dict) -> Optional[_engine.LazyValue]:
        """Enqueue one ``update`` (count already taken by the wrapper) or reduce-path
        ``forward`` call (a :class:`~metrics_tpu_torch.ops.engine.LazyValue` back).
        A queue of another kind or signature flushes first: calls stay in order."""
        q = self.__dict__.get("_defer_pending")
        if q is not None and not q.matches(kind, signature):
            q.flush()
            q = None
        if q is None:
            q = _engine.PendingQueue(kind, signature, self._flush_queue)
            q.meta = self._update_count - (kind == "update")  # the count before the queue's first call
            q.adopt(self, self._defaults)
        handle = _engine.LazyValue(q) if kind == "forward" else None
        q.enqueue(args, kwargs, handle)
        if handle is not None:
            self._update_count += 1
            self._is_synced = False
            self._should_unsync = True
            self._to_sync = self.sync_on_compute
            self._computed = None
        if q.should_flush():
            q.flush()
        return handle

    def _many_program(self, with_values: bool) -> _engine.Executable:
        """This metric's step program for chunks of calls, acquired once per instance."""
        programs = self.__dict__.get("_many_programs")
        if programs is None:
            programs = {}
            object.__setattr__(self, "_many_programs", programs)
        exe = programs.get(with_values)
        if exe is None:
            exe = programs[with_values] = _engine.acquire(self, "many", _build_metric_many, extra_key=(with_values,))
        return exe

    def _flush_queue(self, q: _engine.PendingQueue) -> None:
        """Run a pending queue in :func:`~metrics_tpu_torch.ops.engine.pow2_chunks`
        chunks through the step program. Each step is the per-call path's own
        step, so the states equal it bit for bit. A chunk that fails is undone
        and the rest replays eagerly on the same tensors; deferral stays off for
        this instance until its ``defer`` ladder lane re-promotes."""
        entries, handles, with_values = q.entries, q.handles, q.kind == "forward"
        count0, count_now = q.meta, self._update_count
        forward_cache = self.__dict__.get("_forward_cache")
        q.release()
        applied, snap = 0, None
        suspended = self._suspend_deferral()
        try:
            try:
                program = self._many_program(with_values)
                for index, n in enumerate(_engine.pow2_chunks(len(entries))):
                    snap = self._state_snapshot()
                    if _faults.armed:
                        _faults.maybe_fail("flush-chunk", index=index)
                    values = program.run(self, (entries[applied:applied + n], count0 + applied, with_values))
                    for j, value in enumerate(values):
                        handles[applied + j]._set_value(value)
                    applied += n
            except Exception as exc:  # noqa: BLE001 - the chunk undone, the rest replayed eagerly
                if snap is not None:
                    self._restore_state(snap)
                object.__setattr__(self, "_defer_ok", False)
                _faults.demote(
                    self,
                    "defer",
                    exc,
                    tier="chunked",
                    site="deferred-flush",
                    warn=(
                        f"Deferred {q.kind} flush for `{type(self).__name__}` raised {type(exc).__name__}: {exc}."
                        " Replaying the queue eagerly and disabling deferred dispatch for this instance; the"
                        " degradation ladder re-probes deferral after clean steps."
                    ),
                )
                _engine.note_deferred_flush(fallback=True)
                for j in range(applied, len(entries)):
                    try:
                        values = _metric_many_step(self, entries[j:j + 1], count0 + j, with_values)
                    except Exception:
                        # the calls after the failing one never ran: their counts go
                        object.__setattr__(self, "_update_count", count_now - (len(entries) - j - 1))
                        raise
                    if with_values:
                        handles[j]._set_value(values[0])
            else:
                _engine.note_deferred_flush()
                self._fault_note_clean(len(entries))
            object.__setattr__(self, "_update_count", count_now)
        finally:
            object.__setattr__(self, "_defer_suspended", suspended)
            object.__setattr__(self, "_forward_cache", forward_cache)

    # ---------------------------------------------------------- batched steps
    def update_many(self, *args: Any, **kwargs: Any) -> None:
        """``n`` updates in one call: every tensor argument carries a leading steps
        axis, and ``update_many(preds, target)`` with shapes ``(n, *batch)`` equals
        ``n`` calls ``update(preds[i], target[i])``. Scalars and 0-d tensors pass
        to every step. Pending deferred calls apply first.

        Example:
            >>> import torch
            >>> from metrics_tpu_torch import SumMetric
            >>> m = SumMetric(device="cpu")
            >>> m.update_many(torch.tensor([[1.0, 2.0], [3.0, 4.0]]))
            >>> m.compute()
            tensor(10.)
        """
        self._run_many(False, args, kwargs)

    def forward_many(self, *args: Any, **kwargs: Any) -> Any:
        """``forward`` over a chunk of steps: the per-step batch values, stacked on a
        leading axis (``forward_many(p, t)[i]`` is what ``forward(p[i], t[i])``
        returns at that step)."""
        return self._run_many(True, args, kwargs)

    def _run_many(self, with_values: bool, args: tuple, kwargs: dict) -> Any:
        self._defer_barrier()  # a chunk applies after the calls already queued
        if self._is_synced:
            raise MetricsUserError(
                "The Metric shouldn't be synced when performing `forward_many`/`update_many`. "
                "HINT: Did you forget to call `unsync()`?"
            )
        steps = _chunk_steps(args, kwargs)
        eligible = (
            self._many_ok
            and _checks._get_validation_mode() != "full"
            and self._fusable_states()
            and not (self.full_state_update or self.full_state_update is None or self.dist_sync_on_step)
            and type(self).forward is Metric.forward  # a forward of its own defines its own steps
            and _deferrable_call(args, kwargs)
        )
        if not eligible:
            return self._run_many_eager(with_values, steps)
        if self._fused_seen_signatures is None:
            object.__setattr__(self, "_fused_seen_signatures", {})
        signature = ("__many__", with_values, _forward_signature(args, kwargs))
        if signature not in self._fused_seen_signatures:
            # a chunk signature's first sight runs call by call, fully validated
            result = self._run_many_eager(with_values, steps)
            self._record_fused_signature(signature)
            return result
        count0, snap = self._update_count, self._state_snapshot()
        suspended = self._suspend_deferral()
        try:
            values = self._many_program(with_values).run(self, (steps, count0, with_values))
        except Exception as exc:  # noqa: BLE001 - undone, then call by call (raises if the input is bad)
            self._restore_state(snap)
            object.__setattr__(self, "_update_count", count0)
            object.__setattr__(self, "_defer_suspended", suspended)
            result = self._run_many_eager(with_values, steps)
            _faults.demote(
                self,
                "many",
                exc,
                tier="chunked",
                site="batched-many",
                warn=(
                    f"Batched-step program for `{type(self).__name__}` raised {type(exc).__name__}: {exc}."
                    " Falling back to per-step eager forwards for this instance's batched API; recoverable"
                    " failures re-probe after clean steps."
                ),
            )
            object.__setattr__(self, "_many_ok", False)
            return result
        finally:
            object.__setattr__(self, "_defer_suspended", suspended)
        n = len(steps)
        self._update_count = count0 + n
        self._is_synced = False
        self._should_unsync = True
        self._to_sync = self.sync_on_compute
        self._computed = None
        self._fault_note_clean(n)
        if not with_values:
            return None
        self._forward_cache = values[-1]  # as n forward calls leave it
        return _stack_values(values)

    def _run_many_eager(self, with_values: bool, steps: List[Tuple[tuple, dict]]) -> Any:
        values = []
        suspended = self._suspend_deferral()
        try:
            for a, k in steps:
                if with_values:
                    values.append(self.forward(*a, **k))
                else:
                    self.update(*a, **k)
        finally:
            object.__setattr__(self, "_defer_suspended", suspended)
        return _stack_values(values) if with_values else None

    # ------------------------------------------------------- host fast lane
    def _build_update_lane(self, args: tuple, kwargs: dict) -> Optional[Callable]:
        """Hook: a closure for the steady-state updates of the just-validated
        ``(args, kwargs)`` signature, or None. It takes ``(args, kwargs)`` and
        returns True when it handled the update (count and cache included),
        False to fall through to the full path. The append-only metrics
        (CatMetric, retrieval, the raw-row curves) define it."""
        return None

    def _install_update_lane(self, args: tuple, kwargs: dict) -> None:
        try:
            lane = self._build_update_lane(args, kwargs)
        except Exception:  # noqa: BLE001 - a lane is a shortcut, never a failure
            lane = None
        if lane is not None:
            object.__setattr__(self, "_update_lane", lane)

    def _lane_guard(self) -> Callable[[], bool]:
        """A lane's validity check: a validation-mode change (any
        ``set_validation_mode`` call) drops every lane, so that ``full`` checks
        every call again."""
        generation = _checks._cache_generation

        def still_valid() -> bool:
            if _checks._cache_generation != generation:
                object.__setattr__(self, "_update_lane", None)
                return False
            return True

        return still_valid

    def _wrap_compute(self, compute: Callable) -> Callable:
        @functools.wraps(compute)
        def wrapped(*args: Any, **kwargs: Any) -> Any:
            if self._update_count == 0:
                rank_zero_warn(
                    f"The ``compute`` method of metric {self.__class__.__name__} was called before the ``update``"
                    " method which may lead to errors, as metric states have not yet been updated.",
                    UserWarning,
                )
            if self._computed is not None:
                return self._computed
            self._defer_barrier()
            # compute() forces an in-flight sync; a fault there takes the degraded tier a blocking sync's would
            pending = self.__dict__.get("_pending_sync")
            forced_async = False
            if pending is not None:
                pending_tier = _psync.sync_degraded_tier()
                try:
                    pending.wait()
                    _psync._bump("sync_async_auto_forces")
                    forced_async = self._is_synced
                except Exception as exc:  # noqa: BLE001 - degradable sync faults only
                    if not (pending_tier is not None and _degradable_sync_failure(exc) and not self._is_synced):
                        raise
                    _enter_degraded(self, exc, pending_tier)
            should_sync = self._to_sync
            # while the sync-degrade lane is down: the local value, or the survivors' merge;
            # each serve is a clean step, and the recovery edge tries the full world on this call
            degraded_tier = _psync.sync_degraded_tier() if should_sync else None
            quorum_group: Optional[List[int]] = None
            if degraded_tier is not None:
                lad = self.__dict__.get("_fault_ladders", {}).get("sync-degrade")
                if lad is not None and lad.demoted:
                    if lad.note_clean():
                        lad.promote()
                    else:
                        quorum_group = _psync.surviving_members() if degraded_tier == "quorum" else None
                        if quorum_group is None:
                            should_sync = False
                            _note_degraded_serve(self)

            def _compute_under_sync(do_sync: bool, group: Optional[List[int]] = None) -> Any:
                # synced for this call only: the local states come back on exit
                with self.sync_context(dist_sync_fn=self.dist_sync_fn, process_group=group, should_sync=do_sync,
                                       should_unsync=self._should_unsync):
                    with torch.no_grad():
                        self._computed = _squeeze_scalar(compute(*args, **kwargs))
                return self._computed

            host_rows = self._state_snapshot() if self.compute_on_cpu else None
            self._lift_host_rows()
            try:
                try:
                    value = _compute_under_sync(should_sync, quorum_group)
                    if quorum_group is not None:
                        _note_quorum_serve(self, quorum_group)
                    if forced_async and self._should_unsync and self._is_synced:
                        self.unsync()  # as the blocking auto-sync leaves it: the local states back
                    return value
                except Exception as exc:  # noqa: BLE001 - only degradable sync faults are served
                    if not (degraded_tier is not None and should_sync and _degradable_sync_failure(exc)
                            and not self._is_synced):
                        raise
                    _enter_degraded(self, exc, degraded_tier)
                    if quorum_group is None and degraded_tier == "quorum":
                        survivors = _psync.surviving_members()
                        if survivors is not None:
                            try:
                                value = _compute_under_sync(True, survivors)
                                _note_quorum_serve(self, survivors)
                                return value
                            except Exception as exc2:  # noqa: BLE001 - degradable only
                                if not (_degradable_sync_failure(exc2) and not self._is_synced):
                                    raise
                                _enter_degraded(self, exc2, degraded_tier)
                    _note_degraded_serve(self)
                    return _compute_under_sync(False)
            finally:
                if host_rows is not None and not self._is_synced:
                    self._restore_state(host_rows)

        return wrapped

    # ---------------------------------------------------------------- forward
    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """Compute the metric on the batch AND accumulate it into the state.

        Returns the batch value (reference ``forward`` `metric.py:228-247`).
        With ``dist_sync_on_step`` the batch value is synced across processes.
        """
        if self._is_synced:
            raise MetricsUserError(
                "The Metric shouldn't be synced when performing `forward`. HINT: Did you forget to call `unsync()`?"
            )
        if self.full_state_update or self.full_state_update is None or self.dist_sync_on_step:
            self._forward_cache = self._forward_full_state_update(*args, **kwargs)
        else:
            self._forward_cache = self._forward_reduce_state_update(*args, **kwargs)
        return self._forward_cache

    def _forward_full_state_update(self, *args: Any, **kwargs: Any) -> Any:
        """Two updates: for metrics whose update reads the state it accumulates into."""
        entry_state = self._state_snapshot()
        entry_count = self._update_count
        compute_on_cpu = self.compute_on_cpu
        suspended = self._suspend_deferral()  # the batch value's updates run now
        try:
            self.update(*args, **kwargs)
            update_count = self._update_count
            self._to_sync = self.dist_sync_on_step
            self._should_unsync = False
            self.compute_on_cpu = False  # the batch value's rows stay where they are made
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
            self._is_synced = False
            self._cache = None
            self._should_unsync = True
            self._to_sync = self.sync_on_compute
            self._computed = None
            self.compute_on_cpu = compute_on_cpu
            object.__setattr__(self, "_defer_suspended", suspended)
        return batch_val

    def _forward_reduce_state_update(self, *args: Any, **kwargs: Any) -> Any:
        """One update on a reset state, its batch value, then a merge into the old state.

        Once a signature has run here eagerly, later calls of it enqueue and
        return a :class:`~metrics_tpu_torch.ops.engine.LazyValue` (see the module
        docstring)."""
        signature = self._defer_signature("__forward__", args, kwargs, _checks._get_validation_mode())
        if signature is not None and signature in self._fused_seen_signatures:
            if self._defer_ok and _engine.defer_enabled():
                return self._defer_enqueue("forward", signature, args, kwargs)
            signature = None  # recorded already
        global_state = self._state_snapshot()
        update_count = self._update_count
        self.reset()
        self._to_sync = self.dist_sync_on_step
        self._should_unsync = False
        compute_on_cpu, self.compute_on_cpu = self.compute_on_cpu, False
        suspended = self._suspend_deferral()
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
            self._is_synced = False
            self._cache = None
            self._should_unsync = True
            self._to_sync = self.sync_on_compute
            self._computed = None
            self.compute_on_cpu = compute_on_cpu
            object.__setattr__(self, "_defer_suspended", suspended)
        if signature is not None:
            self._record_fused_signature(signature)
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

    # ------------------------------------------------------------------- sync
    def _named_child_metrics(self) -> List[Tuple[str, "Metric"]]:
        """(dotted name, child) for every child metric, in registration order.

        A child is a ``Metric`` registered as a submodule, or one in a
        registered ``nn.ModuleList`` (named ``"list.i"``). The names are the
        ``state_dict`` prefixes. Registration order is the same in every
        process that built the same tree, so the coalesced sync's layout is too.
        """
        out: List[Tuple[str, Metric]] = []
        for name, child in self.named_children():
            if isinstance(child, Metric):
                out.append((name, child))
            elif isinstance(child, nn.ModuleList):
                out.extend((f"{name}.{i}", m) for i, m in enumerate(child) if isinstance(m, Metric))
        return out

    def _sync_children(self) -> List["Metric"]:
        """Child metrics whose states sync with this one's (JAX `metric.py:1832`)."""
        return [child for _, child in self._named_child_metrics()]

    def _sync_dist(self, dist_sync_fn: Callable = gather_all_tensors, process_group: Optional[Any] = None) -> None:
        """The per-state protocol: one ``dist_sync_fn`` call per tensor, then each state reduced."""
        input_dict = {name: getattr(self, name) for name in self._reductions}
        for name, spec in self._reduction_specs.items():
            value = input_dict[name]
            # a `cat` list goes as one tensor, at least 1-d (every process gathers the same ndim)
            if spec == "cat" and isinstance(value, list) and value:
                input_dict[name] = [dim_zero_cat(value) if len(value) > 1 else torch.atleast_1d(value[0])]
        group = process_group if process_group is not None else self.process_group
        output_dict = apply_to_collection(input_dict, Tensor, dist_sync_fn, group=group)
        _bucketing.apply_gathered_states(self, output_dict)

    def _sync_coalesced(self, dist_sync_fn: Callable, process_group: Optional[Any]) -> bool:
        """Sync this metric's tree with the coalesced protocol; False when it
        takes the per-state protocol instead (a custom gather, states that
        cannot be packed, a demoted ``sync-pack`` lane, or a pack or unpack
        failure, which demotes the lane). Children are marked synced with
        their own snapshots. A failed collective raises to the caller."""
        if dist_sync_fn is not gather_all_tensors:
            return False
        if not _bucketing.coalesce_enabled():
            return False
        lad = self.__dict__.get("_fault_ladders", {}).get("sync-pack")
        if lad is not None and lad.demoted:
            return False  # clean per-state syncs advance the recovery edge
        nodes = _bucketing.tree_nodes(self)
        if any(n._is_synced for n in nodes[1:]):
            return False
        if process_group is None and any(n.process_group is not self.process_group for n in nodes[1:]):
            return False  # each child gathers over its own group
        if not _bucketing.coalescible(nodes):
            return False
        snaps = []
        for n in nodes[1:]:
            n._defer_barrier()
            n._canonicalize_list_states()
            snaps.append((n, n._state_snapshot()))
        group = process_group if process_group is not None else self.process_group
        try:
            _bucketing.coalesced_sync_nodes(nodes, group=group, owner=self)
        except _bucketing.CoalesceError as err:
            if not _bucketing.should_fallback(err):
                # one process alone cannot switch protocols in a live world: raise classified
                for n, snap in snaps:
                    n._restore_state(snap)
                raise err.original from err
            _bucketing.handle_coalesce_failure(
                self,
                snaps,
                err,
                warn=(
                    f"Coalesced sync failed for {type(self).__name__}; falling back to the"
                    " per-state gather protocol (bit-exact, one collective pair per state)."
                ),
            )
            return False
        except Exception:
            for n, snap in snaps:
                n._restore_state(snap)
            raise
        for n, snap in snaps:
            n._cache = snap
            n._is_synced = True
        return True

    def _sync_note_clean(self) -> None:
        """One clean per-state sync: a step toward the ``sync-pack`` lane's recovery edge."""
        lad = self.__dict__.get("_fault_ladders", {}).get("sync-pack")
        if lad is not None and lad.demoted and lad.note_clean():
            lad.promote()

    def sync(
        self,
        dist_sync_fn: Optional[Callable] = None,
        process_group: Optional[Any] = None,
        should_sync: bool = True,
        distributed_available: Optional[Callable] = _distributed_available,
    ) -> None:
        """Replace the local states with their reduction across processes (reference `metric.py:416-450`).

        A no-op unless ``distributed_available()`` is true: by default, while
        more than one process is in the default group. Pass
        ``distributed_available=lambda: True`` to sync a world of one. On any
        failure the local states are restored, the failure is counted in its
        fault domain, and it is raised.
        """
        if should_sync and self.__dict__.get("_pending_sync") is not None:
            raise MetricsUserError(
                "A sync is already in flight for this Metric (sync_async); force it with wait() or compute() before"
                " syncing again."
            )
        if should_sync:
            # collectives pair by issue order: other owners' syncs in flight land before this one packs
            _psync.drain_inflight()
        if self._is_synced and should_sync:
            raise MetricsUserError("The Metric has already been synced.")
        is_distributed = distributed_available() if callable(distributed_available) else None
        if not should_sync or not is_distributed:
            return
        if dist_sync_fn is None:
            dist_sync_fn = self.dist_sync_fn or gather_all_tensors
        group = process_group if process_group is not None else self.process_group
        if isinstance(group, (list, tuple)):
            _psync.validate_group_live(group)  # a list of ranks (the quorum tier's survivors)
        self._defer_barrier()
        self._canonicalize_list_states()
        self._cache = self._state_snapshot()
        self._lift_host_rows()  # the snapshot keeps the host rows for unsync
        try:
            if not self._sync_coalesced(dist_sync_fn, process_group):
                self._sync_dist(dist_sync_fn, process_group=process_group)
                for child in self._sync_children():
                    child.sync(dist_sync_fn, process_group, should_sync, distributed_available)
                self._sync_note_clean()
            self._is_synced = True
        except Exception as exc:
            # a failed sync leaves the local states intact: no state half-reduced
            self._restore_state(self._cache)
            self._cache = None
            self._is_synced = False
            for child in self._sync_children():
                if child._is_synced:
                    child.unsync()
            _faults.note_fault(_faults.classify(exc, "sync"), site="sync", owner=self, error=exc)
            raise
        # a sync over the whole world is the tree's last good sync; a subgroup's (the quorum
        # tier's) stamps nothing: its values still leave out the dead ranks
        if _psync.is_full_world_group(group):
            _stamp_last_good(_bucketing.tree_nodes(self), _faults.tick())

    def sync_async(
        self,
        dist_sync_fn: Optional[Callable] = None,
        process_group: Optional[Any] = None,
        should_sync: bool = True,
        distributed_available: Optional[Callable] = _distributed_available,
    ) -> Optional["_psync.SyncFuture"]:
        """Dispatch this metric tree's sync without waiting for it.

        The packed payload collective runs on the dispatcher thread while the
        caller goes on updating; the pack is a copy of the states at dispatch.
        Returns a :class:`~metrics_tpu_torch.parallel.sync.SyncFuture`: force it
        with ``wait()``, or let ``compute()`` force it. The forced states are
        those a blocking sync at dispatch would give; updates made in flight
        stay local and come back with ``unsync()``. The force checks the epoch
        fence again: a future from a world that changed raises
        :class:`EpochFault`. None when there is nothing to sync. A tree the
        packed protocol cannot carry (a custom gather, a demoted ``sync-pack``
        lane, states it cannot pack) syncs blocking here and returns a
        completed future."""
        if self.__dict__.get("_pending_sync") is not None:
            raise MetricsUserError(
                "A sync is already in flight for this Metric; force it with wait() or compute() before"
                " dispatching another."
            )
        if self._is_synced and should_sync:
            raise MetricsUserError("The Metric has already been synced.")
        is_distributed = distributed_available() if callable(distributed_available) else None
        if not should_sync or not is_distributed:
            return None
        resolved_fn = dist_sync_fn or self.dist_sync_fn or gather_all_tensors
        lad = self.__dict__.get("_fault_ladders", {}).get("sync-pack")
        nodes = _bucketing.tree_nodes(self)
        group = process_group if process_group is not None else self.process_group
        eligible = (
            resolved_fn is gather_all_tensors
            and _bucketing.coalesce_enabled()
            and not (lad is not None and lad.demoted)
            and not any(n._is_synced or n.compute_on_cpu for n in nodes)  # host rows sync blocking
            and (process_group is not None or not any(n.process_group is not self.process_group for n in nodes[1:]))
        )
        if eligible:
            for n in nodes:
                n._defer_barrier()
                n._canonicalize_list_states()
            eligible = _bucketing.coalescible(nodes)

        def _blocking_fallback() -> "_psync.SyncFuture":
            # registered like a live future, so that compute() unsyncs after serving
            _psync._bump("sync_async_fallbacks")
            self.sync(dist_sync_fn=dist_sync_fn, process_group=process_group, should_sync=should_sync,
                      distributed_available=distributed_available)
            done_fut = _psync.SyncFuture.completed(self)
            object.__setattr__(self, "_pending_sync", done_fut)
            return done_fut

        if not eligible:
            return _blocking_fallback()
        try:
            disp = _bucketing.dispatch_coalesced_sync(nodes, group=group, owner=self)
        except _bucketing.CoalesceError as err:
            if not _bucketing.should_fallback(err):
                _faults.note_fault(_faults.classify(err.original, "sync"), site="sync", owner=self, error=err.original)
                raise err.original from err
            _bucketing.handle_coalesce_failure(
                self, [(n, n._state_snapshot()) for n in nodes], err,
                warn=(f"Async coalesced sync failed at dispatch for {type(self).__name__}; the blocking per-state"
                      " protocol runs instead (bit-exact)."),
            )
            return _blocking_fallback()
        if disp is None:
            return _psync.SyncFuture.completed(self)

        def _force() -> None:
            object.__setattr__(self, "_pending_sync", None)
            try:
                snaps = _bucketing.force_coalesced_sync(disp)
            except _bucketing.CoalesceError as err:
                if not _bucketing.should_fallback(err):
                    _faults.note_fault(_faults.classify(err.original, "sync"), site="sync", owner=self,
                                       error=err.original)
                    raise err.original from err
                _bucketing.handle_coalesce_failure(
                    self, [(n, n._state_snapshot()) for n in nodes], err,
                    warn=(f"Async coalesced sync failed at force for {type(self).__name__}; replaying the"
                          " blocking per-state protocol (bit-exact)."),
                )
                self.sync(dist_sync_fn=dist_sync_fn, process_group=process_group, should_sync=True,
                          distributed_available=distributed_available)
                return
            except Exception as exc:
                _faults.note_fault(_faults.classify(exc, "sync"), site="sync", owner=self, error=exc)
                raise
            # the states from just before the apply (updates made in flight) become the unsync caches
            for n, snap in snaps:
                n._cache = snap
                n._is_synced = True
            if _psync.is_full_world_group(group):
                _stamp_last_good(nodes, _faults.tick())

        fut = _psync.SyncFuture(self, _force, done=disp.done, quant_tier=disp.ctx.quant_tier)
        object.__setattr__(self, "_pending_sync", fut)
        return fut

    def unsync(self, should_unsync: bool = True) -> None:
        """Restore the local states from before :meth:`sync` (reference `metric.py:452-472`)."""
        if not should_unsync:
            return
        fut = self.__dict__.get("_pending_sync")
        if fut is not None and (fut._forced or fut._cancelled):
            object.__setattr__(self, "_pending_sync", None)  # a spent future must not block the next sync
        if not self._is_synced:
            raise MetricsUserError("The Metric has already been un-synced.")
        if self._cache is None:
            raise MetricsUserError("The internal cache should exist to unsync the Metric.")
        self._restore_state(self._cache)
        self._is_synced = False
        self._cache = None
        for child in self._sync_children():
            if child._is_synced:
                child.unsync(should_unsync)

    class _SyncContext:
        def __init__(self, metric: "Metric", should_unsync: bool = True, **kwargs: Any) -> None:
            self.metric = metric
            self.kwargs = kwargs
            self.should_unsync = should_unsync
            self._presynced = False

        def __enter__(self) -> "Metric":
            # syncs in flight land first: a member computing while its collection's sync is in
            # flight then finds itself synced by the suite's rows
            if self.kwargs.get("should_sync", True):
                _psync.drain_inflight()
            # a metric synced before (by its collection's suite sync) computes on
            # the synced states and leaves the unsync to whoever synced it
            self._presynced = self.metric._is_synced
            if not self._presynced:
                self.metric.sync(**self.kwargs)
            return self.metric

        def __exit__(self, *exc: Any) -> None:
            self.metric.unsync(should_unsync=self.should_unsync and self.metric._is_synced and not self._presynced)

    def sync_context(
        self,
        dist_sync_fn: Optional[Callable] = None,
        process_group: Optional[Any] = None,
        should_sync: bool = True,
        should_unsync: bool = True,
        distributed_available: Optional[Callable] = _distributed_available,
    ) -> "Metric._SyncContext":
        """Context manager: sync on enter, restore the local states on exit."""
        return Metric._SyncContext(
            self,
            should_unsync=should_unsync,
            dist_sync_fn=dist_sync_fn,
            process_group=process_group,
            should_sync=should_sync,
            distributed_available=distributed_available,
        )

    def sync_health(self) -> Dict[str, Any]:
        """How stale this metric's distributed value may be: whether it serves
        a degraded value, the tier, the world epoch, the monotonic step of the
        last sync over the whole world (None before any) and of the
        degradation's onset, the serves of each tier, the sync in flight (its
        age, dispatch epoch and step, quantization tier, whether it landed)
        and the failure log's faults by domain."""
        lad = self.__dict__.get("_fault_ladders", {}).get("sync-degrade")
        return {
            "degraded": bool(lad is not None and lad.demoted),
            "degraded_tier": _psync.sync_degraded_tier(),
            "epoch": _psync.world_epoch(),
            "last_good_sync_step": self.__dict__.get("_last_good_sync_step"),
            "degraded_since_step": self.__dict__.get("_degraded_since_step"),
            "degraded_serves": self.__dict__.get("_degraded_serves", 0),
            "quorum_serves": self.__dict__.get("_quorum_serves", 0),
            "inflight": _inflight_block(self.__dict__.get("_pending_sync")),
            "fault_domain_counts": _fault_domain_counts(),
        }

    # ---------------------------------------------------------------- journal
    def save_state(self, path: str) -> int:
        """Save this metric tree's states to the crash-consistent journal at
        ``path`` (one CRC-checked record, written atomically into a ring of
        generations; :mod:`metrics_tpu_torch.ops.journal`). Returns the
        record's bytes. One device-to-host copy.

        Example:
            >>> import os, tempfile, torch
            >>> from metrics_tpu_torch import SumMetric
            >>> path = os.path.join(tempfile.mkdtemp(), "sum.journal")
            >>> m = SumMetric(device="cpu")
            >>> m.update(torch.tensor([1.0, 2.0]))
            >>> m.save_state(path) > 0
            True
            >>> fresh = SumMetric(device="cpu")
            >>> fresh.load_state(path)
            0
            >>> fresh.compute()
            tensor(3.)
        """
        from metrics_tpu_torch.ops import journal as _journal

        return _journal.save_nodes(self, _bucketing.tree_nodes(self), path)

    def load_state(self, path: str) -> int:
        """Restore this metric tree from the newest good generation of the journal
        at ``path``, onto this metric's device; returns the generation restored
        (0 the newest). A bad generation is counted, warned once and skipped
        for the one before it; the restore is all or nothing."""
        from metrics_tpu_torch.ops import journal as _journal

        return _journal.load_nodes(self, _bucketing.tree_nodes(self), path)

    def _journal_extra(self) -> Optional[Dict[str, Any]]:
        """JSON-serialisable host state, beyond the states and public scalar
        attributes, that a restore needs to behave as the saved instance
        would (a sampler's generator). Default: nothing."""
        return None

    def _journal_restore_extra(self, extra: Dict[str, Any]) -> None:
        """Apply what :meth:`_journal_extra` recorded. Default: nothing."""

    # ------------------------------------------------------------- lifecycle
    def reset(self) -> None:
        """Reset every state to its default (reference `metric.py:547-562`). Pending
        deferred calls flush first, so their forward values stay what they were. A
        sync in flight is cancelled: its rows must not land on the reset states."""
        self._defer_barrier()
        fut = self.__dict__.get("_pending_sync")
        if fut is not None:
            fut.cancel()
            object.__setattr__(self, "_pending_sync", None)
        self._update_count = 0
        self._forward_cache = None
        self._computed = None
        self._is_synced = False
        self._cache = None
        for name, default in self._defaults.items():
            setattr(self, name, [] if isinstance(default, list) else default.clone())

    def clone(self) -> "Metric":
        """An independent deep copy, states included."""
        return copy.deepcopy(self)

    # bound to this instance, or engine machinery: rebuilt on restore, or at first use
    _UNPICKLED = ("update", "compute", "_inner_update", "_pending_sync", "_defer_pending", "_update_lane",
                  "_many_programs", "_funcore_export")

    def __getstate__(self) -> Dict[str, Any]:
        # a copy or a pickle observes the states: pending calls flush first; rows are canonical, as in a checkpoint
        self._defer_barrier()
        self._canonicalize_list_states()
        return {k: v for k, v in self.__dict__.items() if k not in self._UNPICKLED}

    def __setstate__(self, state: Dict[str, Any]) -> None:
        super().__setstate__(state)
        self.update = self._wrap_update(type(self).update.__get__(self))  # type: ignore[method-assign]
        self.compute = self._wrap_compute(type(self).compute.__get__(self))  # type: ignore[method-assign]

    def __setattr__(self, name: str, value: Any) -> None:
        if name in ("higher_is_better", "is_differentiable", "full_state_update"):
            raise RuntimeError(f"Can't change const `{name}`.")
        # the queued calls were enqueued under the old hyperparameters and states: they
        # run before a public attribute or a held state changes (JAX `metric.py:2664-2672`)
        q = self.__dict__.get("_defer_pending")
        if q is not None and (not name.startswith("_") or q.has_state(self, name)):
            q.flush()
        if (
            not name.startswith("_")
            and name not in self.__dict__.get("_defaults", ())
            and name not in ("update", "compute", "compute_on_cpu")
        ):
            # a hyperparameter change moves the version the fused programs baked
            # (JAX `metric.py:2680-2712`); the same python scalar again is no change
            old = self.__dict__.get(name, _UNSET)
            unchanged = (
                old is not _UNSET
                and isinstance(value, _STATIC_ATTR_SCALARS)
                and type(old) is type(value)
                and (old is value or old == value)
            )
            if not unchanged:
                object.__setattr__(self, "_fused_version", self.__dict__.get("_fused_version", 0) + 1)
        super().__setattr__(name, value)

    # ------------------------------------------------------ functional export
    def as_functions(self) -> tuple:
        """Export ``(init, update, compute)`` as pure functions over the state dict::

            init, update_fn, compute_fn = metric.as_functions()
            state = update_fn(init(), preds, target)       # vmap or capture it freely
            value = compute_fn(state, axis_name=group)     # one functional collective a state

        The functions run the metric's own update and compute bodies on a
        private template (:mod:`metrics_tpu_torch.functional_core`), cached per
        configuration fingerprint."""
        from metrics_tpu_torch import functional_core as _funcore

        return _funcore.metric_functions(self)

    def init(self) -> Any:
        """A fresh epoch-stamped state tree (:class:`~metrics_tpu_torch.functional_core.FuncState`)."""
        from metrics_tpu_torch import functional_core as _funcore

        return _funcore.init(self)

    def apply_update(self, state: Any, *args: Any, **kwargs: Any) -> Any:
        """Pure update over an explicit state tree (:func:`~metrics_tpu_torch.functional_core.apply_update`)."""
        from metrics_tpu_torch import functional_core as _funcore

        return _funcore.apply_update(self, state, *args, **kwargs)

    def apply_compute(self, state: Any, *, axis_name: Optional[Any] = None) -> Any:
        """Pure compute; with ``axis_name`` one functional collective a state
        (:func:`~metrics_tpu_torch.functional_core.apply_compute`)."""
        from metrics_tpu_torch import functional_core as _funcore

        return _funcore.apply_compute(self, state, axis_name=axis_name)

    def host_handoff(self, state: Any, *, merged: bool = True) -> "Metric":
        """Land a functional state tree back into this metric without a second merge
        (:func:`~metrics_tpu_torch.functional_core.host_handoff`)."""
        from metrics_tpu_torch import functional_core as _funcore

        return _funcore.host_handoff(self, state, merged=merged)

    def _inner_compute(self) -> Any:
        return _squeeze_scalar(self.compute.__wrapped__())  # type: ignore[attr-defined]

    def _bare_clone(self) -> "Metric":
        """A reset deep copy: the pure functions' template."""
        m = copy.deepcopy(self)
        m.reset()
        return m

    def _apply(self, fn: Callable, recurse: bool = True) -> "Metric":
        """``.to()``, ``.cuda()``, ``.double()`` and kin reach the states and their defaults too.

        Child metrics are submodules, so ``nn.Module._apply`` reaches them (and
        buffers such as a composition's scalar operand) first. Pending deferred
        calls flush first, on the device they were queued on."""
        self._defer_barrier()
        super()._apply(fn, recurse)
        for name, default in self._defaults.items():
            value = getattr(self, name)
            if isinstance(default, Tensor):
                self._defaults[name] = fn(default)
            if isinstance(value, Tensor):
                setattr(self, name, fn(value))
            else:
                setattr(self, name, [fn(v) for v in value])
        if self._cache is not None:
            self._cache = {k: [fn(v) for v in c] if isinstance(c, list) else fn(c) for k, c in self._cache.items()}
        self._device = fn(torch.zeros(0, device=self._device)).device
        self._computed = None
        return self

    # -------------------------------------------------------- serialization
    def _save_to_state_dict(self, destination: Dict[str, Any], prefix: str, keep_vars: bool) -> None:
        super()._save_to_state_dict(destination, prefix, keep_vars)
        self._defer_barrier()
        self._canonicalize_list_states()
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
        self._defer_barrier()  # queued calls run first: a later flush must not write over the loaded states
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

    def load_state_dict(self, state_dict: Any, strict: bool = True, assign: bool = False, *, prefix: str = "") -> Any:
        """``torch.nn.Module.load_state_dict``, plus the JAX package's ``prefix``: only the keys
        under ``prefix`` are read, with the prefix stripped (``state_dict(prefix=...)`` writes them)."""
        if prefix:
            state_dict = {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}
        return super().load_state_dict(state_dict, strict=strict, assign=assign)

    def to_device(self, device: Any) -> "Metric":
        """Move the states (and their defaults, and child metrics) to ``device``: ``.to(device)``."""
        return self.to(device)

    def astype(self, dtype: torch.dtype) -> "Metric":
        """Cast the floating-point states (and their defaults) to ``dtype``; integer states stay."""
        return self._apply(lambda t: t.to(dtype) if t.is_floating_point() else t)

    def type(self, dst_type: Optional[torch.dtype] = None, *, dtype: Optional[torch.dtype] = None) -> "Metric":  # type: ignore[override]
        """Cast the floating-point states: torch's ``dst_type``, or the JAX package's ``dtype``."""
        if (dst_type is None) == (dtype is None):
            raise TypeError("type() takes one of `dst_type` or `dtype`")
        return self.astype(dtype if dtype is not None else dst_type)

    def float(self) -> "Metric":
        return self.astype(torch.float32)

    def double(self) -> "Metric":
        return self.astype(torch.float64)

    def half(self) -> "Metric":
        return self.astype(torch.float16)

    def bfloat16(self) -> "Metric":
        return self.astype(torch.bfloat16)

    def persistent(self, mode: bool = False) -> None:
        """Set whether every state is saved by ``state_dict()`` (reference `metric.py:657-660`)."""
        for name in self._persistent:
            self._persistent[name] = mode
        for _, child in self._named_child_metrics():
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

    # ------------------------------------------------------- composition ops
    def __hash__(self) -> int:
        # by identity, as in JAX (`metric.py:2731`): ``__eq__`` composes, and an
        # nn.Module must stay hashable (``named_modules`` keeps a set)
        return hash((self.__class__.__name__, id(self)))

    # ``__getitem__`` composes, so the old iteration protocol would never end:
    # a metric is not iterable
    __iter__ = None  # type: ignore[assignment]

    def __add__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(_op_add, self, other)

    def __radd__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(_op_add, other, self)

    def __sub__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(_op_sub, self, other)

    def __rsub__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(_op_sub, other, self)

    def __mul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(_op_mul, self, other)

    def __rmul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(_op_mul, other, self)

    def __truediv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(_op_div, self, other)

    def __rtruediv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(_op_div, other, self)

    def __floordiv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(_op_floordiv, self, other)

    def __rfloordiv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(_op_floordiv, other, self)

    def __mod__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(_op_mod, self, other)

    def __rmod__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(_op_mod, other, self)

    def __pow__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(_op_pow, self, other)

    def __rpow__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(_op_pow, other, self)

    def __matmul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(_op_matmul, self, other)

    def __rmatmul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(_op_matmul, other, self)

    def __and__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(_op_and, self, other)

    def __rand__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(_op_and, other, self)

    def __or__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(_op_or, self, other)

    def __ror__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(_op_or, other, self)

    def __xor__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(_op_xor, self, other)

    def __rxor__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(_op_xor, other, self)

    def __eq__(self, other: Any) -> "CompositionalMetric":  # type: ignore[override]
        return CompositionalMetric(_op_eq, self, other)

    def __ne__(self, other: Any) -> "CompositionalMetric":  # type: ignore[override]
        return CompositionalMetric(_op_ne, self, other)

    def __lt__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(_op_lt, self, other)

    def __le__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(_op_le, self, other)

    def __gt__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(_op_gt, self, other)

    def __ge__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(_op_ge, self, other)

    def __abs__(self) -> "CompositionalMetric":
        return CompositionalMetric(_op_abs, self, None)

    def __neg__(self) -> "CompositionalMetric":
        return CompositionalMetric(_neg, self, None)

    def __pos__(self) -> "CompositionalMetric":
        # abs, as in JAX and the reference
        return CompositionalMetric(_op_abs, self, None)

    def __invert__(self) -> "CompositionalMetric":
        return CompositionalMetric(_op_not, self, None)

    def __getitem__(self, idx: Any) -> "CompositionalMetric":
        return CompositionalMetric(functools.partial(_op_getitem, idx=idx), self, None)


# The operators are named module-level functions so that a composition pickles
# (JAX `metric.py:2944-3025`).
def _op_add(a, b):
    return torch.add(a, b)


def _op_sub(a, b):
    return torch.sub(a, b)


def _op_mul(a, b):
    return torch.mul(a, b)


def _op_div(a, b):
    return torch.true_divide(a, b)


def _op_floordiv(a, b):
    return torch.floor_divide(a, b)


def _op_mod(a, b):
    return torch.remainder(a, b)


def _op_pow(a, b):
    return torch.pow(a, b)


def _op_matmul(a, b):
    return torch.matmul(a, b)


def _op_and(a, b):
    return torch.bitwise_and(a, b)


def _op_or(a, b):
    return torch.bitwise_or(a, b)


def _op_xor(a, b):
    return torch.bitwise_xor(a, b)


def _op_eq(a, b):
    return torch.eq(a, b)


def _op_ne(a, b):
    return torch.ne(a, b)


def _op_lt(a, b):
    return torch.lt(a, b)


def _op_le(a, b):
    return torch.le(a, b)


def _op_gt(a, b):
    return torch.gt(a, b)


def _op_ge(a, b):
    return torch.ge(a, b)


def _op_abs(x):
    return torch.abs(x)


def _op_not(x):
    return torch.logical_not(x)


def _op_getitem(x, idx):
    return x[idx]


def _neg(x: Tensor) -> Tensor:
    return -torch.abs(x)


# a composition's operand as JAX's ``jnp.asarray`` makes it without x64: 32-bit
_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32}


def _operand(value: Any, device: torch.device) -> Optional[Tensor]:
    if value is None:
        return None
    tensor = torch.as_tensor(value, device=device)
    return tensor.to(_NARROW[tensor.dtype]) if tensor.dtype in _NARROW else tensor


class CompositionalMetric(Metric):
    """Lazy arithmetic composition of metrics (JAX `metric.py:3035-3124`).

    It holds no states of its own: ``update``, ``forward`` and ``reset`` go to
    the metric operands (kwargs filtered per update signature), and ``compute``
    applies the operator to their values, with no cache or sync of its own (each
    operand syncs in its own ``compute()``). A scalar or tensor operand becomes a
    32-bit tensor on the composition's device (a buffer, so it follows ``.to()``).
    The device defaults to the first metric operand's.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MeanMetric, SumMetric
        >>> ratio = MeanMetric(device="cpu") / SumMetric(device="cpu")
        >>> type(ratio).__name__
        'CompositionalMetric'
        >>> ratio.update(torch.tensor([2.0, 4.0]))
        >>> ratio.compute()
        tensor(0.5000)
    """

    full_state_update: Optional[bool] = True

    def __init__(
        self,
        operator: Callable,
        metric_a: Union[Metric, float, int, Tensor, None],
        metric_b: Union[Metric, float, int, Tensor, None],
        **kwargs: Any,
    ) -> None:
        operand = next((m for m in (metric_a, metric_b) if isinstance(m, Metric)), None)
        if operand is not None:
            kwargs.setdefault("device", operand.device)
        super().__init__(**kwargs)
        self.op = operator
        for name, value in (("metric_a", metric_a), ("metric_b", metric_b)):
            if isinstance(value, Metric) or value is None:
                setattr(self, name, value)
            else:
                self.register_buffer(name, _operand(value, self.device), persistent=False)

    def _sync_dist(self, dist_sync_fn: Optional[Callable] = None, process_group: Optional[Any] = None) -> None:
        pass  # no states of its own: the operands sync through _sync_children

    def update(self, *args: Any, **kwargs: Any) -> None:
        if isinstance(self.metric_a, Metric):
            self.metric_a.update(*args, **self.metric_a._filter_kwargs(**kwargs))
        if isinstance(self.metric_b, Metric):
            self.metric_b.update(*args, **self.metric_b._filter_kwargs(**kwargs))

    def compute(self) -> Any:
        val_a = self.metric_a.compute() if isinstance(self.metric_a, Metric) else self.metric_a
        val_b = self.metric_b.compute() if isinstance(self.metric_b, Metric) else self.metric_b
        if val_b is None:
            return self.op(val_a)
        return self.op(val_a, val_b)

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        val_a = (
            self.metric_a(*args, **self.metric_a._filter_kwargs(**kwargs))
            if isinstance(self.metric_a, Metric)
            else self.metric_a
        )
        val_b = (
            self.metric_b(*args, **self.metric_b._filter_kwargs(**kwargs))
            if isinstance(self.metric_b, Metric)
            else self.metric_b
        )
        if val_a is None:
            self._forward_cache = None
        elif val_b is None:
            # a unary operator when no second operand was given; None when that operand returned None
            self._forward_cache = None if isinstance(self.metric_b, Metric) else self.op(val_a)
        else:
            self._forward_cache = self.op(val_a, val_b)
        return self._forward_cache

    def reset(self) -> None:
        if isinstance(self.metric_a, Metric):
            self.metric_a.reset()
        if isinstance(self.metric_b, Metric):
            self.metric_b.reset()

    def __repr__(self) -> str:
        op = self.op.__name__ if hasattr(self.op, "__name__") else self.op
        return f"{self.__class__.__name__}(\n  {op}(\n    {self.metric_a!r},\n    {self.metric_b!r}\n  )\n)"

    def _wrap_compute(self, compute: Callable) -> Callable:
        # no cache and no sync of its own: the operands' computes have both
        return compute

    def _inner_compute(self) -> Any:
        # compute is not wrapped: the operands' own wrapped computes run inside it
        return _squeeze_scalar(self.compute())

    def as_functions(self) -> tuple:
        # no states of its own: the base export would compute on reset operands
        raise NotImplementedError(
            "CompositionalMetric holds no states of its own; export each component's "
            "as_functions() and compose the computed values instead."
        )


__all__ = ["CompositionalMetric", "Metric", "resolve_device"]
