"""Rank bodies of the fleet plane's real Gloo worlds (``run_world`` in ``tests/helpers/torch_sync.py``).
They import no JAX: a spawned rank runs the port alone."""
import time
from typing import Any, Dict

import torch

from tests.helpers.torch_sync import headline_suite, suite_batches


def fleet_world_worker(rank: int, world: int, seed: int, slow_rank: int, sleep_s: float) -> Dict[str, Any]:
    """A headline suite fed this rank's batches and synced three times (rank ``slow_rank``'s pack
    sleeps ``sleep_s``), then the fleet faces: the snapshot with its collective count, its
    Prometheus text and the fleet performance report."""
    import metrics_tpu_torch as tmt
    from metrics_tpu_torch.ops import fleetobs, telemetry
    from metrics_tpu_torch.parallel import bucketing, collective_stats

    telemetry.set_telemetry(True)
    if rank == slow_rank:
        collect = bucketing._collect

        def slow_collect(nodes):
            time.sleep(sleep_s)
            return collect(nodes)

        bucketing._collect = slow_collect
    suite = headline_suite(tmt)
    for preds, target in suite_batches(seed + rank, 2):
        suite.update(torch.from_numpy(preds), torch.from_numpy(target))
    for _ in range(3):
        suite.sync()
        suite.unsync()
    before = collective_stats()["sync_payload_collectives"]
    snap = fleetobs.fleet_snapshot()
    issued = collective_stats()["sync_payload_collectives"] - before
    return {"snap": snap, "text": fleetobs.fleet_prometheus_text(snap), "issued": issued,
            "perf": fleetobs.fleet_perf_report(), "health": suite.fleet_health()["world_size"]}
