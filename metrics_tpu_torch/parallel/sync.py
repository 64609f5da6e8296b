"""State sync across processes: ``torch.distributed`` collectives on the states' own device.

JAX counterpart: the core of `metrics_tpu/parallel/sync.py`
(``distributed_available`` `:40`, ``world_size`` `:65`, the collective
counters `:1063-1100`, ``gather_all_tensors`` `:1106-1208`, ``reduce`` and
``class_reduce`` `:1211-1238`); reference
`src/torchmetrics/utilities/distributed.py`.

The collectives run in the default process group, or in the
``torch.distributed.ProcessGroup`` a caller passes as ``group=``: NCCL for
states on the card, Gloo for states on the CPU (Gloo also takes CUDA
tensors). Only the members of a group call a collective over it, and each
member receives every member's entry in group rank order. With no process
group initialised, a gather returns the caller's own entry (a world of one).

Left for a later slice of the port: retries and backoff, the deadline
watchdog, membership and epochs, the degraded and quorum tiers, and the
asynchronous lane (``sync_async``/``SyncFuture``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist
from torch import Tensor

from metrics_tpu_torch.utils.exceptions import SyncFault

_counters: Dict[str, int] = {
    # one slot per protocol collective: the per-state protocol pays a shape
    # exchange and a payload gather per state; the coalesced protocol one
    # payload gather per sync, plus one metadata exchange where a `cat` list
    # state is packed (or the first time a static layout is seen in a live world)
    "sync_shape_collectives": 0,
    "sync_payload_collectives": 0,
    "sync_bytes_gathered": 0,
    # the coalesced protocol: syncs that packed, and the states they carried
    "sync_coalesced_payloads": 0,
    "sync_states_coalesced": 0,
}


def _live() -> bool:
    """True when a process group is initialised, so a collective really runs (a world of one included)."""
    return dist.is_available() and dist.is_initialized()


def distributed_available() -> bool:
    """True when more than one process takes part: ``Metric.sync`` is a no-op otherwise."""
    return _live() and dist.get_world_size() > 1


def world_size(group: Optional[Any] = None) -> int:
    return dist.get_world_size(group) if _live() else 1


def check_group(group: Optional[Any]) -> Optional[Any]:
    """A ``process_group`` is None (every process) or a ``torch.distributed.ProcessGroup``."""
    process_group_type = getattr(dist, "ProcessGroup", None)
    if group is None or (process_group_type is not None and isinstance(group, process_group_type)):
        return group
    raise ValueError(
        f"`process_group` must be None or a torch.distributed.ProcessGroup (from dist.new_group), got {group!r}"
    )


def note_collective(kind: str, nbytes: int = 0) -> None:
    """Count one protocol collective (``kind``: "shape" | "payload") and the bytes it gathered."""
    _counters[f"sync_{kind}_collectives"] += 1
    if nbytes:
        _counters["sync_bytes_gathered"] += int(nbytes)


def _bump(name: str, n: int = 1) -> None:
    _counters[name] += n


def collective_stats() -> dict:
    """The collective counters, their total and the coalescing ratio (states
    packed per coalesced payload; the per-state protocol's 1.0 is the floor)."""
    out = dict(_counters)
    out["sync_collectives_issued"] = out["sync_shape_collectives"] + out["sync_payload_collectives"]
    payloads = out["sync_coalesced_payloads"]
    out["sync_coalesce_ratio"] = round(out["sync_states_coalesced"] / payloads, 3) if payloads else 0.0
    return out


def reset_collective_stats() -> None:
    for key in _counters:
        _counters[key] = 0


def _all_gather(tensor: Tensor, group: Optional[Any] = None) -> Tensor:
    """``(world, *tensor.shape)``: every member's ``tensor`` (equal shapes), in group rank order.

    One ``all_gather`` in its list form, which every torch version has; the
    list holds views into one buffer, so the rows land in place. A failed
    collective raises :class:`SyncFault`.
    """
    try:
        out = torch.empty((dist.get_world_size(group),) + tuple(tensor.shape), dtype=tensor.dtype, device=tensor.device)
        dist.all_gather(list(out.unbind(0)), tensor.contiguous(), group=group)
    except (RuntimeError, ValueError) as err:
        raise SyncFault(f"all_gather of {tuple(tensor.shape)} {tensor.dtype} failed: {err}", site="sync-gather") from err
    return out


def gather_all_tensors(result: Tensor, group: Optional[Any] = None) -> List[Tensor]:
    """All-gather a tensor from every process of ``group``; sizes may differ between processes.

    The reference's uneven-shape protocol: gather the shapes, pad to the
    largest, all-gather, trim each entry back to its own shape. Returns one
    entry per member, in group rank order; every member receives them all.
    Every process must have the same number of dimensions. Two collectives a
    call, each counted by :func:`collective_stats`, as a call with no process
    group initialised is too (it returns ``[result]``).
    """
    if not _live():
        note_collective("shape")
        note_collective("payload", nbytes=result.numel() * result.element_size())
        return [result]
    x = result.reshape(1) if result.ndim == 0 else result
    note_collective("shape")
    shapes = _all_gather(torch.tensor(x.shape, dtype=torch.int64, device=x.device), group).tolist()
    max_shape = [max(s[d] for s in shapes) for d in range(x.ndim)]
    if list(x.shape) != max_shape:
        padded = x.new_zeros(max_shape)
        padded[tuple(slice(0, d) for d in x.shape)] = x
        x = padded
    note_collective("payload", nbytes=x.numel() * x.element_size() * len(shapes))
    gathered = _all_gather(x, group)
    out = [gathered[r][tuple(slice(0, d) for d in shape)] for r, shape in enumerate(shapes)]
    return [o.reshape(()) for o in out] if result.ndim == 0 else out


def reduce(x: Tensor, reduction: str) -> Tensor:
    """Reduce a tensor: "elementwise_mean" | "sum" | "none" (reference `distributed.py:22-41`)."""
    if reduction == "elementwise_mean":
        return torch.mean(x)
    if reduction == "sum":
        return torch.sum(x)
    if reduction in ("none", None):
        return x
    raise ValueError("Reduction parameter unknown.")


def class_reduce(num: Tensor, denom: Tensor, weights: Tensor, class_reduction: str = "none") -> Tensor:
    """Per-class fraction reduce: "micro" | "macro" | "weighted" | "none".

    Parity: reference `utilities/distributed.py:44-93`, with 0/0 -> 0 for the
    per-class fractions.
    """
    valid_reduction = ("micro", "macro", "weighted", "none", None)
    if class_reduction == "micro":
        return torch.sum(num) / torch.sum(denom)
    fraction = torch.where(
        denom == 0, torch.zeros((), dtype=torch.float32, device=num.device), num / torch.where(denom == 0, 1, denom)
    )
    if class_reduction == "macro":
        return torch.mean(fraction)
    if class_reduction == "weighted":
        return torch.sum(fraction * (weights / torch.sum(weights)))
    if class_reduction in ("none", None):
        return fraction
    raise ValueError(f"Reduction parameter {class_reduction!r} unknown. Choose between one of these: {valid_reduction}")


__all__ = [
    "check_group",
    "class_reduce",
    "collective_stats",
    "distributed_available",
    "gather_all_tensors",
    "note_collective",
    "reduce",
    "reset_collective_stats",
    "world_size",
]
