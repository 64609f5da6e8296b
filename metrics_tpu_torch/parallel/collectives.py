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


__all__ = ["sync_array", "sync_pytree"]
