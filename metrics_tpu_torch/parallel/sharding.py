"""Shard metric state itself over a device mesh: DTensor placements for the state tree.

JAX counterpart: `metrics_tpu/parallel/sharding.py` (``state_shardings`` `:34`,
``shard_states`` `:65`, ``_first_divisible_spec`` `:82`, ``infer_state_pspecs``
`:93`, ``infer_state_shardings`` `:138`). Besides replicated state and a
gather, a state can be partitioned itself: a ``(num_classes, thresholds)``
binned-curve state or a stat-scores class vector split over the class axis, so
that each process holds ``1/n`` of it.

A spec reads as JAX's: :class:`PartitionSpec` names, for each tensor dim, the
mesh dim that splits it (``PartitionSpec("c", None)``: dim 0 over mesh dim
``"c"``), and ``PartitionSpec()`` replicates. :class:`NamedSharding` pairs a
spec with a ``DeviceMesh`` and gives its DTensor ``placements`` (``Shard(d)``
or ``Replicate()`` per mesh dim)::

    init, update, compute = metric.as_functions()
    states = shard_states(init(), mesh, {"TPs": PartitionSpec("c", None), ...})
    states = metric.apply_update(states, preds, target)   # stays class-sharded

**How an update meets a sharded state.** XLA propagates a state's sharding
through ``state + counts`` over a global batch; torch's DTensor has no sharding
rule for most of the ops a metric's update runs (the bincount among them), and
refuses a mix of ``DTensor`` and ``Tensor`` operands. So :func:`sharded_update`
runs the metric's own update on plain tensors, with each DTensor state swapped
for its ``init()``, which gives this process's contribution at the state's full
shape, and merges it into each shard by the state's reduction (``sum`` adds,
``max``/``min`` take extrema: the merge the sync plane does).

What the batch is decides what is reduced. A batch argument that is a DTensor
is a global array, as in JAX: on a mesh dim where it is ``Replicate()`` every
process holds the same rows, and on one where it is ``Shard(0)`` each holds its
own. A plain tensor is this process's own rows, as in data-parallel training,
so a plain batch is split on every mesh dim. Over the mesh dims where the batch
is split the contributions are partial; a ``Partial`` DTensor redistributed to
the state's placements sums (or takes extrema of) them: one reduce-scatter for
a ``Shard`` dim, one all-reduce for a ``Replicate`` one, as XLA's psum over
``dp`` in JAX's ``dp x c`` case. Each process then holds its slice of the
global contribution; nothing is gathered whole, and on the card the update's
kernels run as they do unsharded. A batch replicated on every mesh dim needs no
collective. The contribution lives for the call only.

A DTensor state of another reduction merges by its sync rule. Its whole value
is read (gathered once where it is sharded); the update gives this process's
contribution (from the state's ``init()``; a ``mean`` state's from its whole
value), which is gathered over the mesh dims that split the batch as the sync
plane gathers it (:func:`~metrics_tpu_torch.parallel.collectives.merge_array`:
``mean`` averages, ``None`` and a custom reduction stack, ``cat``
concatenates) and merged into the whole value: ``mean`` takes the average of
the processes' updated values, ``cat`` appends, a custom reduction folds the
stack of the old value and its merged contributions, and ``None`` states go
to the metric's own merge of stacked states (``Metric._merge_stacked``,
PearsonCorrCoef's pairwise moment merge). Each process keeps the block of the
result its placements select, so a state sharded on its own rows ends with
each row on its owner. This is what JAX's jitted update over the global batch
gives wherever the state's reduction is the one its update implies. A state of
another reduction that is replicated on every mesh dim, under a batch that is
too, is updated whole on its local tensor, with no collective.

Plain (non-DTensor) states, list states among them, come from the update as
they are. ``compute`` reads the whole state, so :func:`full_states` gathers
each sharded state once there.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import Tensor

__all__ = [
    "NamedSharding",
    "PartitionSpec",
    "full_states",
    "has_sharded_states",
    "infer_state_pspecs",
    "infer_state_shardings",
    "shard_states",
    "sharded_update",
    "state_shardings",
]


class PartitionSpec(tuple):
    """For each tensor dim, the mesh dim name that splits it (None: not split); a
    tuple of names splits one tensor dim over several mesh dims. Reads as JAX's.

    Example:
        >>> from metrics_tpu_torch.parallel.sharding import PartitionSpec
        >>> PartitionSpec("c", None)
        PartitionSpec('c', None)
        >>> PartitionSpec() == PartitionSpec()
        True
    """

    def __new__(cls, *parts: Any) -> "PartitionSpec":
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec({', '.join(map(repr, self))})"


class NamedSharding:
    """A :class:`PartitionSpec` on a ``DeviceMesh``; ``placements`` is its DTensor form."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh: Any, spec: Sequence[Any]) -> None:
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) else PartitionSpec(*spec)

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard

        names = list(self.mesh.mesh_dim_names or ())
        out = [Replicate()] * self.mesh.ndim
        for dim, entry in enumerate(self.spec):
            for name in (entry if isinstance(entry, tuple) else (entry,)):
                if name is None:
                    continue
                if name not in names:
                    raise ValueError(f"spec {self.spec!r} names mesh dim {name!r}; the mesh has {names}")
                out[names.index(name)] = Shard(dim)
        return tuple(out)


def state_shardings(
    states: Dict[str, Any], mesh: Any, specs: Mapping[str, Sequence[Any]]
) -> Dict[str, Optional[NamedSharding]]:
    """A :class:`NamedSharding` for each state of ``states``.

    States named in ``specs`` get their spec; every other tensor state is
    replicated (``PartitionSpec()``). A list ("cat") state cannot be split this
    way (it grows at each update) and raises when named; a spec key that names
    no state raises too, since a typo would otherwise replicate everything.
    ``states`` may be a ``FuncState``: its tree is read.
    """
    states = getattr(states, "states", states)
    unknown = set(specs) - set(states)
    if unknown:
        raise ValueError(
            f"specs name states that do not exist: {sorted(unknown)}; this metric's states are {sorted(states)}"
        )
    out: Dict[str, Optional[NamedSharding]] = {}
    for name, value in states.items():
        if isinstance(value, list):
            if name in specs:
                raise ValueError(
                    f"State `{name}` is a list ('cat') state; shard the inputs or use a "
                    "binned/sufficient-statistics metric for sharded accumulation."
                )
            out[name] = None
            continue
        out[name] = NamedSharding(mesh, specs.get(name, PartitionSpec()))
    return out


def shard_states(states: Dict[str, Any], mesh: Any, specs: Mapping[str, Sequence[Any]]) -> Dict[str, Any]:
    """Each tensor state as a DTensor on ``mesh`` under its spec (list states as they are).

    Every process passes the same full state (an ``init()`` does) and keeps
    the slice its placements select: nothing is sent between processes. A
    ``FuncState`` comes back as one, its epoch kept.
    """
    from metrics_tpu_torch.functional_core import _rewrap

    wrapped, states = states, getattr(states, "states", states)
    shardings = state_shardings(states, mesh, specs)
    out: Dict[str, Any] = {}
    for name, value in states.items():
        sharding = shardings[name]
        if sharding is None:
            out[name] = value
            continue
        value = value.to(mesh.device_type) if value.device.type != mesh.device_type else value
        out[name] = _placed(value, mesh, sharding.placements)
    return _rewrap(out, wrapped)


# ------------------------------------------------------- per-leaf inference
def _first_divisible_spec(shape: tuple, size: int, axis_name: str) -> PartitionSpec:
    """Split the first dim divisible by the mesh dim's size; the dims before it
    stay whole. No divisible dim (a fresh empty cat state among them) replicates."""
    for i, dim in enumerate(shape):
        if dim and dim % size == 0:
            return PartitionSpec(*([None] * i + [axis_name]))
    return PartitionSpec()


def infer_state_pspecs(
    states: Dict[str, Any],
    mesh: Any,
    reduction_specs: Mapping[str, Any],
    axis_name: Optional[str] = None,
) -> Dict[str, Optional[PartitionSpec]]:
    """Per-leaf :class:`PartitionSpec` inference for a functional state tree.

    Each state's reduction decides its layout under a data-parallel mesh dim
    (``axis_name``; default: the mesh's first dim): a ``cat``/``None`` tensor
    state is a row accumulator and splits its first dim divisible by the
    mesh dim's size (replicated when none is); a reduced state (``sum``,
    ``mean``, ``max``, ``min``, custom) is replicated; a list state maps to None.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.parallel.sharding import infer_state_pspecs
        >>> class Mesh:  # a stand-in with a DeviceMesh's names and sizes
        ...     mesh_dim_names = ("dp",)
        ...     def size(self, dim=None):
        ...         return 1
        >>> infer_state_pspecs({"total": torch.zeros(())}, Mesh(), {"total": "sum"})
        {'total': PartitionSpec()}
    """
    names = tuple(mesh.mesh_dim_names or ())
    if axis_name is None:
        axis_name = names[0]
    size = mesh.size(names.index(axis_name))
    out: Dict[str, Optional[PartitionSpec]] = {}
    for name, value in states.items():
        if isinstance(value, (list, tuple)):
            out[name] = None
            continue
        spec = reduction_specs.get(name)
        if spec in ("cat", None) and not callable(spec):
            out[name] = _first_divisible_spec(tuple(value.shape), size, axis_name)
        else:
            out[name] = PartitionSpec()
    return out


def infer_state_shardings(
    states: Dict[str, Any],
    mesh: Any,
    reduction_specs: Mapping[str, Any],
    axis_name: Optional[str] = None,
) -> Dict[str, Optional[NamedSharding]]:
    """:func:`infer_state_pspecs` as :class:`NamedSharding` (what :func:`shard_states`
    places); list states stay None.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import infer_state_shardings
        >>> class Mesh:  # a stand-in with a DeviceMesh's names and sizes
        ...     mesh_dim_names = ("dp",)
        ...     def size(self, dim=None):
        ...         return 2
        >>> infer_state_shardings({"rows": torch.zeros(4, 3)}, Mesh(), {"rows": "cat"})["rows"].spec
        PartitionSpec('dp')
    """
    pspecs = infer_state_pspecs(states, mesh, reduction_specs, axis_name=axis_name)
    return {name: None if spec is None else NamedSharding(mesh, spec) for name, spec in pspecs.items()}


# ------------------------------------------------------- updates and computes
def _is_dtensor(x: Any) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def has_sharded_states(tree: Any) -> bool:
    """Whether any leaf of a state tree (one or two levels of dicts) is a DTensor."""
    if isinstance(tree, dict):
        return any(has_sharded_states(v) for v in tree.values())
    return _is_dtensor(tree)


def _local_slice(full: Tensor, mesh: Any, placements: Sequence[Any]) -> Tensor:
    """The block of ``full`` that this process holds under ``placements``."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    shape, offset = compute_local_shape_and_global_offset(full.shape, mesh, placements)
    return full[tuple(slice(o, o + s) for o, s in zip(offset, shape))]


_MERGES: Dict[str, Callable[[Tensor, Tensor], Tensor]] = {
    "sum": torch.add,
    "max": torch.maximum,
    "min": torch.minimum,
}


def _leaves(tree: Dict[str, Any], specs: Dict[str, Any]):
    """``(path, value, spec)`` of each leaf of a state tree of one or two levels of dicts."""
    for name, value in tree.items():
        if isinstance(value, dict):
            for k, v in value.items():
                yield (name, k), v, specs[name][k]
        else:
            yield (name,), value, specs[name]


def _batch_split_dims(mesh: Any, args: tuple, kwargs: dict) -> Tuple[Tuple[int, ...], tuple, dict]:
    """The mesh dims over which the batch is split, and the arguments with each DTensor as its local tensor.

    A DTensor argument is split on the mesh dims where it is ``Shard(0)`` and whole on those where it is
    ``Replicate()``; a plain tensor is this process's own rows, split on every mesh dim. The tensor
    arguments must agree."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    every = tuple(range(mesh.ndim))
    seen = set()

    def local(x: Any) -> Any:
        if isinstance(x, DTensor):
            if x.device_mesh != mesh:
                raise ValueError("a DTensor batch argument lies on another mesh than the sharded states")
            split = []
            for dim, p in enumerate(x.placements):
                if isinstance(p, Shard) and p.dim == 0:
                    split.append(dim)
                elif not isinstance(p, Replicate):
                    raise ValueError(f"a DTensor batch argument is split along its rows (Shard(0)) or replicated, not {p}")
            seen.add(tuple(split))
            return x.to_local()
        if isinstance(x, Tensor):
            seen.add(every)
        return x

    args = tuple(local(a) for a in args)
    kwargs = {k: local(v) for k, v in kwargs.items()}
    if len(seen) > 1:
        raise ValueError(
            "the batch arguments disagree on how they are split over the mesh: a plain tensor is this "
            "process's own rows, a DTensor says it by its placements; pass them all one way"
        )
    return (seen.pop() if seen else every), args, kwargs


def _gather_over(x: Tensor, mesh: Any, dims: Sequence[int], stack: bool) -> Tensor:
    """Every process's ``x`` over the mesh dims ``dims``, stacked on a new first dim (``stack``) or
    concatenated along dim 0, in the mesh's row-major order (one all-gather a dim)."""
    from metrics_tpu_torch.parallel.collectives import _gather_rows

    out = x.unsqueeze(0) if stack else torch.atleast_1d(x)
    for dim in reversed(dims):
        out = _gather_rows(out, mesh.get_group(dim))
    return out


def _placed(full: Tensor, mesh: Any, placements: Sequence[Any]) -> Any:
    """``full`` as a DTensor on ``mesh`` under ``placements``: this process keeps its block, nothing is sent."""
    from torch.distributed.tensor import DTensor

    local = _local_slice(full, mesh, placements).contiguous()
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=full.shape, stride=full.stride())


def sharded_update(
    update_fn: Callable, init_fn: Callable, specs: Mapping[str, Any], state: Dict[str, Any],
    args: tuple, kwargs: dict, stacked_merges: Any = None,
) -> Dict[str, Any]:
    """``update_fn(state, *args, **kwargs)`` for a state tree holding DTensors: each DTensor
    state's contribution from the update, reduced or gathered over the mesh dims that split the
    batch and merged by the state's reduction (module docstring). ``specs`` maps each state to its
    reduction spec, a custom reduction as its callable (a dict of them per member for a
    collection's tree); ``stacked_merges`` is the metric's merge of its stacked ``None`` states
    (a dict of them per member)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    from metrics_tpu_torch.parallel.collectives import merge_array

    fresh = init_fn()
    mesh = next(v.device_mesh for _, v, _ in _leaves(state, specs) if _is_dtensor(v))
    split, args, kwargs = _batch_split_dims(mesh, args, kwargs)
    swapped: Dict[str, Any] = {k: dict(v) if isinstance(v, dict) else v for k, v in state.items()}
    merged = []  # (path, state, fresh value, spec) of the DTensor states merged from a contribution
    others = []  # (path, state, whole value, spec) of the DTensor states of other reductions
    for path, value, spec in _leaves(state, specs):
        if not _is_dtensor(value):
            continue
        if value.device_mesh != mesh:
            raise ValueError(f"State `{'.'.join(path)}` lies on another mesh than the tree's other sharded states")
        owner = swapped[path[0]] if len(path) == 2 else swapped
        init = fresh[path[0]][path[1]] if len(path) == 2 else fresh[path[0]]
        replicated = all(isinstance(p, Replicate) for p in value.placements)
        if spec in _MERGES:
            owner[path[-1]] = init
            merged.append((path, value, init, spec))
        elif not split and replicated:
            owner[path[-1]] = value.to_local()  # the whole state, and the batch is whole on every process
        else:
            whole = value.to_local() if replicated else value.full_tensor()
            owner[path[-1]] = whole if spec == "mean" else init
            others.append((path, value, whole, spec))
    new = {k: dict(v) if isinstance(v, dict) else v for k, v in update_fn(swapped, *args, **kwargs).items()}
    for path, value, init, spec in merged:
        out = new[path[0]] if len(path) == 2 else new
        delta = out[path[-1]] - init if spec == "sum" else out[path[-1]]
        partial = [Partial(spec) if dim in split else Replicate() for dim in range(mesh.ndim)]
        local = DTensor.from_local(delta, mesh, partial, run_check=False, shape=delta.shape, stride=delta.stride())
        local = local.redistribute(mesh, value.placements).to_local()
        out[path[-1]] = DTensor.from_local(_MERGES[spec](value.to_local(), local), mesh, value.placements,
                                           run_check=False, shape=value.shape, stride=value.stride())
    stacked: Dict[tuple, Dict[str, Tensor]] = {}  # the None states of each metric: old value, then contributions
    for path, value, whole, spec in others:
        out = new[path[0]] if len(path) == 2 else new
        mine = out[path[-1]]
        if spec == "mean":
            for dim in split:
                mine = merge_array(mine, "mean", mesh.get_group(dim))
            out[path[-1]] = _placed(mine, mesh, value.placements)
        elif spec == "cat":
            full = torch.cat([torch.atleast_1d(whole), _gather_over(mine, mesh, split, False)])
            out[path[-1]] = _placed(full, mesh, value.placements)
        elif callable(spec):
            full = spec(torch.stack([whole, spec(_gather_over(mine, mesh, split, True))]))
            out[path[-1]] = _placed(full, mesh, value.placements)
        elif spec is None:
            rows = torch.cat([whole.unsqueeze(0), _gather_over(mine, mesh, split, True)])
            stacked.setdefault(path[:-1], {})[path[-1]] = rows
        else:
            raise ValueError(f"State `{'.'.join(path)}` has an unknown reduction spec {spec!r}")
    for member, rows in stacked.items():
        merge = (stacked_merges or {}).get(member[0]) if member else stacked_merges
        if merge is None:
            raise ValueError(f"States {sorted(rows)} reduce by None and their metric has no merge of stacked states")
        out = new[member[0]] if member else new
        for name, full in merge(rows).items():
            out[name] = _placed(full, mesh, (state[member[0]][name] if member else state[name]).placements)
    done = {m[0] for m in merged} | {m[0] for m in others}
    for path, value, _ in _leaves(state, specs):
        if _is_dtensor(value) and path not in done:  # replicated, updated whole on its local tensor
            out = new[path[0]] if len(path) == 2 else new
            out[path[-1]] = DTensor.from_local(out[path[-1]], mesh, value.placements, run_check=False)
    return new


def full_states(tree: Any) -> Any:
    """The state tree with each DTensor gathered whole (one collective a sharded state)."""
    if isinstance(tree, dict):
        return {k: full_states(v) for k, v in tree.items()}
    return tree.full_tensor() if _is_dtensor(tree) else tree


def _metric_specs(m: Any) -> Dict[str, Any]:
    """A Metric's reduction spec of each state, a custom reduction as its callable."""
    return {k: m._reductions[k] if spec == "custom" else spec for k, spec in m._reduction_specs.items()}


def _spec_tree(owner: Any) -> Dict[str, Any]:
    """The reduction spec of each state of a Metric, or of each member's states of a collection."""
    from metrics_tpu_torch.functional_core import _is_collection

    if _is_collection(owner):
        return {name: _metric_specs(m) for name, m in owner.items(keep_base=True, copy_state=False)}
    return _metric_specs(owner)


def _stacked_merge_tree(owner: Any) -> Any:
    """The merge of stacked ``None`` states of a Metric, or of each member of a collection."""
    from metrics_tpu_torch.functional_core import _is_collection

    if _is_collection(owner):
        return {name: m._merge_stacked for name, m in owner.items(keep_base=True, copy_state=False)}
    return owner._merge_stacked
