"""State sync across processes: the per-state and the coalesced protocols, and one collective per spec."""
from metrics_tpu_torch.parallel.collectives import sync_array, sync_pytree
from metrics_tpu_torch.parallel.reductions import resolve_reduction
from metrics_tpu_torch.parallel.sync import (
    class_reduce,
    collective_stats,
    distributed_available,
    gather_all_tensors,
    reduce,
    reset_collective_stats,
    world_size,
)

__all__ = [
    "class_reduce",
    "collective_stats",
    "distributed_available",
    "gather_all_tensors",
    "reduce",
    "reset_collective_stats",
    "resolve_reduction",
    "sync_array",
    "sync_pytree",
    "world_size",
]
