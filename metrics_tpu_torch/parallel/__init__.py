"""State sync across processes: the per-state and the coalesced protocols, and one collective per spec."""
from metrics_tpu_torch.parallel.bucketing import coalesce_enabled
from metrics_tpu_torch.parallel.collectives import sync_array, sync_pytree
from metrics_tpu_torch.parallel.reductions import resolve_reduction
from metrics_tpu_torch.parallel.sharding import shard_states, state_shardings
from metrics_tpu_torch.parallel.sync import (
    SyncFuture,
    class_reduce,
    collective_stats,
    distributed_available,
    gather_all_tensors,
    inflight_stats,
    reduce,
    reset_collective_stats,
    world_size,
)

__all__ = [
    "SyncFuture",
    "class_reduce",
    "coalesce_enabled",
    "collective_stats",
    "distributed_available",
    "gather_all_tensors",
    "inflight_stats",
    "reduce",
    "reset_collective_stats",
    "resolve_reduction",
    "shard_states",
    "state_shardings",
    "sync_array",
    "sync_pytree",
    "world_size",
]
