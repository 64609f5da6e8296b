"""The functional core: metric state as an explicit, epoch-stamped tree.

JAX counterpart: `metrics_tpu/functional_core.py`. State lives as a tree the
caller owns: ``init() -> state``, ``apply_update(state, *batch) -> state``,
``apply_compute(state) -> value``. The functions are pure, so they run under
``torch.func.vmap`` (a stack of states, one update each: the fan-out in
:mod:`metrics_tpu_torch.wrappers._fanout`) and inside a CUDA-graph capture
(no value is read on the host: the value checks skip under either, see
:func:`metrics_tpu_torch.utils.checks._is_concrete`)::

    state = suite.init()                                  # FuncState, epoch-stamped
    state = suite.apply_update(state, preds, target)      # per-process partial states
    value = suite.apply_compute(state, axis_name=group)   # one functional collective a state
    suite.host_handoff(state)                             # back into the stateful shell

The contracts, as in the JAX package:

- **One code path.** The functions run the metric's own ``_inner_update`` and
  ``_inner_compute`` bodies, the ones the stateful API dispatches, on a
  private template of the metric's configuration.
- **The epoch in the tree.** :class:`FuncState` is a ``torch.utils._pytree``
  node whose epoch is its static context: a membership transition changes the
  tree spec, and :func:`host_handoff` raises :class:`EpochFault` for a stale
  stamp before anything lands.
- **One hand-back seam.** :func:`host_handoff` flushes the shell's pending
  calls, cancels a sync in flight, lands the tree and, for a merged tree,
  marks it synced, so that ``compute()`` issues no collective.

The export is cached on the owner per configuration fingerprint
(``__getstate__`` drops it); ``funcore_stats()`` counts builds, hits and API
events. Where JAX re-runs the update on a deep copy of the template every
call, the port runs it on the template itself and puts back, after the call,
everything but the update-inferred static hyperparameters, so that a hot loop
copies no module. A nested call on a template in use takes a deep copy, as
JAX does. ``jax.ensure_compile_time_eval`` has no
counterpart: a template is built from the owner's concrete defaults even
when the first export happens inside ``torch.func.vmap``.

A state tree of DTensors (:func:`metrics_tpu_torch.parallel.sharding.shard_states`)
updates shard by shard and is gathered whole for a compute
(:mod:`metrics_tpu_torch.parallel.sharding`); :func:`state_shardings_for`
infers each leaf's placement.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from metrics_tpu_torch.metric import Metric, _is_static_value, _propagate_static_attrs
from metrics_tpu_torch.ops import telemetry as _telemetry
from metrics_tpu_torch.parallel import sharding as _sharding
from metrics_tpu_torch.parallel import sync as _psync

_EXPORT_CACHE_ATTR = "_funcore_export"

_counters: Dict[str, int] = {
    # export builds (template copies) against fingerprint hits: N apply_update
    # calls on one configuration build ONE template
    "funcore_exports": 0,
    "funcore_export_hits": 0,
    # API calls (host-visible)
    "funcore_inits": 0,
    "funcore_updates": 0,
    "funcore_computes": 0,
    # the hand-back seam
    "funcore_handoffs": 0,
    "funcore_handoff_nodes": 0,
    "funcore_handoff_sync_cancels": 0,
}


def funcore_stats() -> Dict[str, int]:
    """The functional core's counters (folded into ``engine_stats()``).

    Example:
        >>> from metrics_tpu_torch import funcore_stats
        >>> funcore_stats()["funcore_updates"] >= 0
        True
    """
    return dict(_counters)


def _reset_funcore_counters() -> None:
    for key in _counters:
        _counters[key] = 0


_telemetry.register_reset("funcore", _reset_funcore_counters)


# ------------------------------------------------------------------ FuncState
class FuncState:
    """An epoch-stamped functional state tree.

    ``states`` is the plain tree (``{state_name: leaf}`` for a Metric,
    ``{metric_name: {state_name: leaf}}`` for a collection); ``epoch`` is the
    :func:`metrics_tpu_torch.parallel.sync.world_epoch` stamp, the node's
    static context in ``torch.utils._pytree``: two trees of different epochs
    have different specs, and :func:`host_handoff` raises ``EpochFault`` for a
    stale one.

    Example:
        >>> from metrics_tpu_torch import MeanMetric
        >>> state = MeanMetric(device="cpu").init()
        >>> type(state).__name__
        'FuncState'
        >>> state.with_epoch(state.epoch + 1).epoch == state.epoch + 1
        True
    """

    __slots__ = ("states", "epoch")

    def __init__(self, states: Any, epoch: int) -> None:
        self.states = states
        self.epoch = int(epoch)

    def with_epoch(self, epoch: int) -> "FuncState":
        """The same state tree restamped (an explicit re-entry after a fence)."""
        return FuncState(self.states, epoch)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"FuncState(epoch={self.epoch}, states={list(self.states)!r})"


pytree.register_pytree_node(
    FuncState,
    lambda s: ([s.states], s.epoch),
    lambda children, epoch: FuncState(children[0], epoch),
    serialized_type_name="metrics_tpu_torch.functional_core.FuncState",
)


def _unwrap(state: Any) -> Tuple[Any, Optional[int]]:
    if isinstance(state, FuncState):
        return state.states, state.epoch
    return state, None


def _rewrap(states: Any, template: Any) -> Any:
    if isinstance(template, FuncState):
        return FuncState(states, template.epoch)
    return states


# ------------------------------------------------------------- metric exports
@contextlib.contextmanager
def _borrowed(template: Any) -> Iterator[Any]:
    """The template to run one pure call on; afterwards every attribute is put
    back but the update-inferred static hyperparameters, so the call leaves what
    a run on a fresh copy would (JAX `functional_core.py:160-166`). A call
    nested in another on the same template runs on a deep copy."""
    if template.__dict__.get("_funcore_busy"):
        m = template._bare_clone()
        yield m
        _propagate_static_attrs(m, template)
        return
    before = dict(template.__dict__)
    object.__setattr__(template, "_funcore_busy", True)
    try:
        yield template
    finally:
        d = template.__dict__
        static = {}
        states = template._defaults
        for key in list(d):
            if key.startswith("_") or key in states:
                continue
            value = d[key]
            if value is not before.get(key) and _is_static_value(value):
                static[key] = value
        d.clear()
        d.update(before)
        d.update(static)


def _build_metric_functions(metric: Any) -> Tuple[Callable, Callable, Callable]:
    """``(init, update, compute)`` pure functions for one Metric, over a reset
    template of its configuration."""
    from metrics_tpu_torch.parallel.collectives import merge_pytree

    if not metric._defaults and metric._named_child_metrics():
        # a wrapper with no states of its own: the base export would be an
        # empty state dict and an update that drops every child's update
        raise NotImplementedError(
            f"{type(metric).__name__} holds its state in child metrics; the base export would produce an "
            "empty state dict and a no-op update. Export the wrapped metric's as_functions() directly, or "
            "use a wrapper that provides its own export (ClasswiseWrapper; "
            "MultioutputWrapper(remove_nans=False))."
        )
    template = metric._bare_clone()

    def init() -> Dict[str, Any]:
        # fresh copies, never the template's defaults themselves
        return {k: ([] if isinstance(v, list) else v.clone()) for k, v in template._defaults.items()}

    def update_fn(state: Dict[str, Any], *args: Any, **kwargs: Any) -> Dict[str, Any]:
        with _borrowed(template) as m:
            m._restore_state(state)
            with torch.no_grad():
                m._inner_update(*args, **kwargs)
            return m._state_snapshot()

    def compute_fn(state: Dict[str, Any], axis_name: Optional[Any] = None) -> Any:
        with _borrowed(template) as m:
            if axis_name is not None:
                custom = {k: fn for k, fn in m._reductions.items() if m._reduction_specs[k] == "custom"}
                state = merge_pytree(state, m._reduction_specs, axis_name, custom)
            m._restore_state(state)
            with torch.no_grad():
                return m._inner_compute()

    return init, update_fn, compute_fn


def _build_collection_functions(collection: Any) -> Tuple[Callable, Callable, Callable]:
    """The collection lift: one ``{metric_name: state}`` tree, one update over
    the whole suite (each member's kwargs filtered), one compute with the
    collection's flatten and prefix naming. Where JAX's lift builds every
    member's base export (`functional_core.py:195`), so that a ClasswiseWrapper
    member fails and a MinMaxMetric member fails with another message than
    its own (the two cases of JAX's `tests/wrappers/test_as_functions.py`
    that fail), a member's own ``as_functions`` is used here."""
    from metrics_tpu_torch.utils.data import _flatten_dict

    items = list(collection._modules.items())
    # a member with an export of its own (ClasswiseWrapper, MultioutputWrapper) or a refusal of its own
    # (MinMaxMetric, BootStrapper) is taken at its word, as JAX's wrapper tests hold
    fns = {name: m.as_functions() if type(m).as_functions is not Metric.as_functions else metric_functions(m)
           for name, m in items}
    filters = {name: m._filter_kwargs for name, m in items}
    set_name = collection._set_name

    def init() -> Dict[str, Any]:
        return {name: f[0]() for name, f in fns.items()}

    def update(states: Dict[str, Any], *args: Any, **kwargs: Any) -> Dict[str, Any]:
        return {name: fns[name][1](states[name], *args, **(filters[name](**kwargs) if kwargs else {})) for name in fns}

    def compute(states: Dict[str, Any], axis_name: Optional[Any] = None) -> Dict[str, Any]:
        res = {name: fns[name][2](states[name], axis_name=axis_name) for name in fns}
        res = _flatten_dict(res)
        return {set_name(k): v for k, v in res.items()}

    return init, update, compute


def _is_collection(owner: Any) -> bool:
    from metrics_tpu_torch.collections import MetricCollection

    return isinstance(owner, MetricCollection)


def _export_key(owner: Any) -> tuple:
    from metrics_tpu_torch.ops.engine import config_fingerprint

    if _is_collection(owner):
        # the members' registration, not items(): a key reads no state
        return tuple((name, config_fingerprint(m)) for name, m in owner._modules.items())
    return config_fingerprint(owner)


def metric_functions(owner: Any) -> Tuple[Callable, Callable, Callable]:
    """The cached ``(init, update, compute)`` export of a Metric or
    MetricCollection, keyed by configuration fingerprint: a hot loop builds
    the template once (the cache rides the instance; pickling and copies drop it)."""
    key = _export_key(owner)
    cached = owner.__dict__.get(_EXPORT_CACHE_ATTR)
    if cached is not None and cached[0] == key:
        _counters["funcore_export_hits"] += 1
        return cached[1]
    fns = _build_collection_functions(owner) if _is_collection(owner) else _build_metric_functions(owner)
    object.__setattr__(owner, _EXPORT_CACHE_ATTR, (key, fns))
    _counters["funcore_exports"] += 1
    return fns


# ------------------------------------------------------------------ the API
def init(owner: Any) -> FuncState:
    """A fresh state tree for ``owner`` (Metric or MetricCollection), stamped
    with the live world epoch."""
    init_fn, _, _ = metric_functions(owner)
    _counters["funcore_inits"] += 1
    return FuncState(init_fn(), _psync.world_epoch())


def apply_update(owner: Any, state: Any, *args: Any, **kwargs: Any) -> Any:
    """Pure update: ``state`` in, the next ``state`` out, nothing else touched.

    Takes a :class:`FuncState` (its epoch carried through) or a bare state
    tree (the ``as_functions()`` shape) and returns the same kind.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MeanMetric, apply_update, apply_compute
        >>> m = MeanMetric(device="cpu")
        >>> state = apply_update(m, m.init(), torch.tensor([1.0, 3.0]))
        >>> float(apply_compute(m, state))
        2.0
    """
    init_fn, update_fn, _ = metric_functions(owner)
    states, _ = _unwrap(state)
    _counters["funcore_updates"] += 1
    if _sharding.has_sharded_states(states):  # DTensor states: merged shard by shard
        return _rewrap(_sharding.sharded_update(update_fn, init_fn, _sharding._spec_tree(owner), states, args, kwargs), state)
    return _rewrap(update_fn(states, *args, **kwargs), state)


def apply_compute(owner: Any, state: Any, *, axis_name: Optional[Any] = None) -> Any:
    """Pure compute. With ``axis_name`` (a ``ProcessGroup``, a one-dimensional
    ``DeviceMesh`` or a ``(DeviceMesh, dim_name)`` pair) every state merges by
    its spec with one functional collective and nothing is read on the host
    (:func:`metrics_tpu_torch.parallel.collectives.merge_pytree`).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import SumMetric, apply_update, apply_compute
        >>> m = SumMetric(device="cpu")
        >>> state = apply_update(m, m.init(), torch.tensor([2.0, 5.0]))
        >>> float(apply_compute(m, state))
        7.0
    """
    _, _, compute_fn = metric_functions(owner)
    states, _ = _unwrap(state)
    _counters["funcore_computes"] += 1
    if _sharding.has_sharded_states(states):
        states = _sharding.full_states(states)
    return compute_fn(states, axis_name=axis_name)


def state_shardings_for(owner: Any, state: Any, mesh: Any, axis_name: Optional[str] = None) -> Any:
    """Per-leaf :class:`~metrics_tpu_torch.parallel.sharding.NamedSharding` inference for a
    functional state tree (:func:`metrics_tpu_torch.parallel.sharding.infer_state_shardings`),
    per member for a collection."""
    states, _ = _unwrap(state)
    specs = _sharding._spec_tree(owner)
    if _is_collection(owner):
        out = {name: _sharding.infer_state_shardings(states[name], mesh, specs[name], axis_name=axis_name)
               for name in states}
    else:
        out = _sharding.infer_state_shardings(states, mesh, specs, axis_name=axis_name)
    return _rewrap(out, state)


# ------------------------------------------------------------------ hand-back
def host_handoff(owner: Any, state: Any, *, merged: bool = True) -> Any:
    """Land a functional state tree back into the stateful shell; returns ``owner``.

    For each shell node: flush its pending deferred calls (they would land on
    top of the tree), cancel a sync in flight (its rows describe the old
    states), restore the tree and, when ``merged`` (the tree came through an
    ``apply_compute`` merge, or the world is one process), mark the node
    synced with the tree as its snapshot, so that ``compute()`` serves it
    without a collective and ``unsync()`` restores the same tree. A
    :class:`FuncState` is fenced first: a stamp behind the live epoch raises
    ``EpochFault`` (site ``funcore-handoff``) and nothing lands; restamp with
    :meth:`FuncState.with_epoch` to land it anyway.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MeanMetric, apply_update, host_handoff
        >>> m = MeanMetric(device="cpu")
        >>> state = apply_update(m, m.init(), torch.tensor([2.0, 4.0]))
        >>> float(host_handoff(m, state).compute())
        3.0
    """
    states, epoch = _unwrap(state)
    if _is_collection(owner):
        nodes = [(m, states[name]) for name, m in owner.items(keep_base=True, copy_state=False)]
    else:
        nodes = [(owner, states)]
    for m, _ in nodes:
        m._defer_barrier()
    if epoch is not None:
        _psync.check_epoch(epoch, site="funcore-handoff", owner=owner)
    for m, s in nodes:
        fut = m.__dict__.get("_pending_sync")
        if fut is not None:
            fut.cancel()
            object.__setattr__(m, "_pending_sync", None)
            _counters["funcore_handoff_sync_cancels"] += 1
        m._restore_state({k: (list(v) if isinstance(v, list) else v) for k, v in s.items()})
        m._computed = None
        m._update_count = max(int(m._update_count), 1)
        if merged:
            m._is_synced = True
            m._cache = m._state_snapshot()
        else:
            m._is_synced = False
            m._cache = None
    _counters["funcore_handoffs"] += 1
    _counters["funcore_handoff_nodes"] += len(nodes)
    if _telemetry.armed:
        _telemetry.emit("funcore-handoff", owner, "sync",
                        attrs={"nodes": len(nodes), "merged": bool(merged), "epoch": epoch})
    return owner


__all__ = [
    "FuncState",
    "apply_compute",
    "apply_update",
    "funcore_stats",
    "host_handoff",
    "init",
    "metric_functions",
    "state_shardings_for",
]
