"""One collective per state: reduce a state across processes by its spec.

JAX counterpart: `metrics_tpu/parallel/collectives.py` (``sync_array`` `:34`,
``sync_pytree`` `:62`), where each spec lowers to one XLA collective inside
``shard_map``. Here each spec is one ``torch.distributed`` collective over
``group`` (the default process group when None), on the state's own device:

  "sum"  -> all_reduce SUM      "mean" -> all_reduce SUM, then / world size
  "max"  -> all_reduce MAX      "min"  -> all_reduce MIN
  "cat"  -> all_gather, concatenated along dim 0
  None   -> all_gather, stacked (a new leading process dim)
  custom -> all_gather stacked, then the callable

"mean" divides a SUM, so Gloo and NCCL agree (NCCL's AVG exists only there).
As with XLA's collectives, the gathers need the same shape on every process;
:func:`metrics_tpu_torch.parallel.sync.gather_all_tensors` takes uneven ones.
With no process group initialised the world is one process.

The in-graph merge lane (:func:`merge_pytree`, what ``apply_compute(state,
axis_name=...)`` runs; JAX's ``sync_pytree`` under ``shard_map``): the same
specs through ``torch.distributed._functional_collectives``, one functional
collective per state, nothing read on the host, so a CUDA graph can capture
it. ``axis_name`` names the group: a ``ProcessGroup``, a one-dimensional
``DeviceMesh`` or a ``(DeviceMesh, dim_name)`` pair.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist
from torch import Tensor

from metrics_tpu_torch.parallel import sync as _sync
from metrics_tpu_torch.utils.exceptions import SyncConfigFault

_REDUCE_OPS = {"sum": "SUM", "mean": "SUM", "max": "MAX", "min": "MIN"}


def _all_reduce(x: Tensor, op: str, group: Optional[Any]) -> Tensor:
    out = x.clone()
    if _sync._live():
        dist.all_reduce(out, op=getattr(dist.ReduceOp, op), group=group)
    return out


def _stacked(x: Tensor, group: Optional[Any]) -> Tensor:
    return _sync._all_gather(x, group) if _sync._live() else x.unsqueeze(0)


def sync_array(
    x: Tensor,
    spec: Optional[str],
    group: Optional[Any] = None,
    custom_fn: Optional[Callable] = None,
) -> Tensor:
    """Reduce ``x`` across the processes of ``group`` by ``spec``: one collective."""
    if spec in _REDUCE_OPS:
        out = _all_reduce(x, _REDUCE_OPS[spec], group)
        return out / _sync.world_size(group) if spec == "mean" else out
    if spec == "cat":
        stacked = _stacked(x, group)
        return stacked.reshape((-1,) + tuple(x.shape[1:]))
    if spec is None:
        return _stacked(x, group)
    if spec == "custom":
        if custom_fn is None:
            raise SyncConfigFault("custom reduction requires `custom_fn`", site="sync-spec")
        return custom_fn(_stacked(x, group))
    raise SyncConfigFault(f"Unknown reduction spec {spec!r}", site="sync-spec")


def sync_pytree(
    state: Dict[str, Any],
    specs: Dict[str, Any],
    group: Optional[Any] = None,
    custom_fns: Optional[Dict[str, Callable]] = None,
) -> Dict[str, Any]:
    """Reduce a dict of states with per-key specs (a spec may be the callable itself).

    List states are concatenated locally first, so each costs one collective,
    and come back as one tensor in a one-element list; an empty list stays empty.
    """
    custom_fns = dict(custom_fns or {})
    out: Dict[str, Any] = {}
    for name, value in state.items():
        spec = specs.get(name)
        if callable(spec):
            custom_fns[name], spec = spec, "custom"
        if isinstance(value, (list, tuple)):
            if len(value) == 0:
                out[name] = list(value)
                continue
            local = torch.cat([torch.atleast_1d(v) for v in value], dim=0)
            out[name] = [sync_array(local, spec, group, custom_fns.get(name))]
        else:
            out[name] = sync_array(value, spec, group, custom_fns.get(name))
    return out


# --------------------------------------------------------------- in-graph lane
def resolve_axis(axis_name: Any) -> Any:
    """The ``ProcessGroup`` an ``axis_name`` names: a ``ProcessGroup`` itself, a
    one-dimensional ``DeviceMesh``'s group, or a ``(DeviceMesh, dim_name)`` pair's.
    Anything else (a bare mesh-axis string among them) raises
    :class:`SyncConfigFault`."""
    from torch.distributed.device_mesh import DeviceMesh

    if _sync._is_process_group(axis_name):
        return axis_name
    if isinstance(axis_name, DeviceMesh) and axis_name.ndim == 1:
        return axis_name.get_group()
    if (
        isinstance(axis_name, tuple)
        and len(axis_name) == 2
        and isinstance(axis_name[0], DeviceMesh)
        and isinstance(axis_name[1], str)
    ):
        return axis_name[0].get_group(axis_name[1])
    raise SyncConfigFault(
        f"axis_name must be a torch.distributed ProcessGroup, a one-dimensional DeviceMesh or a"
        f" (DeviceMesh, dim_name) pair; got {axis_name!r}",
        site="sync-spec",
    )


def _waited(t: Tensor) -> Tensor:
    import torch.distributed._functional_collectives as funcol

    return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t


def _gather_rows(x: Tensor, group: Any) -> Tensor:
    """Every member's ``x`` concatenated along dim 0: one functional all-gather
    (``all_gather_single`` where this torch has it, else ``all_gather_tensor``)."""
    import torch.distributed._functional_collectives as funcol

    gather = getattr(funcol, "all_gather_single", None) or funcol.all_gather_tensor
    return _waited(gather(x.contiguous(), 0, group))


def merge_array(x: Tensor, spec: Optional[str], group: Any, custom_fn: Optional[Callable] = None) -> Tensor:
    """Reduce ``x`` across ``group`` by ``spec`` with one functional collective
    (an all-reduce or an all-gather); "mean" is the sum over the group's size."""
    import torch.distributed._functional_collectives as funcol

    if spec in _REDUCE_OPS:
        out = _waited(funcol.all_reduce(x, _REDUCE_OPS[spec].lower(), group))
        return out / dist.get_world_size(group) if spec == "mean" else out
    if spec == "cat":
        return _gather_rows(torch.atleast_1d(x), group)
    if spec is None or spec == "custom":
        if spec == "custom" and custom_fn is None:
            raise SyncConfigFault("custom reduction requires `custom_fn`", site="sync-spec")
        stacked = _gather_rows(x.unsqueeze(0), group)
        return stacked if spec is None else custom_fn(stacked)
    raise SyncConfigFault(f"Unknown reduction spec {spec!r}", site="sync-spec")


def merge_pytree(
    state: Dict[str, Any],
    specs: Dict[str, Any],
    axis_name: Any,
    custom_fns: Optional[Dict[str, Callable]] = None,
) -> Dict[str, Any]:
    """:func:`sync_pytree`'s result over the group ``axis_name`` names, through the
    functional collectives: one per state, no host read. List states are
    concatenated locally first and come back as one tensor in a one-element list."""
    group = resolve_axis(axis_name)
    custom_fns = dict(custom_fns or {})
    out: Dict[str, Any] = {}
    for name, value in state.items():
        spec = specs.get(name)
        if callable(spec):
            custom_fns[name], spec = spec, "custom"
        if isinstance(value, (list, tuple)):
            if len(value) == 0:
                out[name] = list(value)
                continue
            local = torch.cat([torch.atleast_1d(v) for v in value], dim=0)
            out[name] = [merge_array(local, spec, group, custom_fns.get(name))]
        else:
            out[name] = merge_array(value, spec, group, custom_fns.get(name))
    return out


__all__ = ["merge_array", "merge_pytree", "resolve_axis", "sync_array", "sync_pytree"]
