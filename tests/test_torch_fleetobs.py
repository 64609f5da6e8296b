"""The port's fleet plane (``metrics_tpu_torch/ops/fleetobs.py``) against the JAX package's.

The same per-rank planes (real snapshots of both packages with per-rank
latencies drawn from a seed, dead, missing and corrupt placeholders) go
through both packages' merges, straggler report, streaming merge and
Prometheus exposition, and give equal results. Then the port's gather: a
world of one issues no collective; an emulated world at the
``bucketing._host_allgather`` seam maps rows to ranks, marks the ranks it
cannot decode, and ships its own plane byte for byte; a real two-process
Gloo world with one rank slowed names that rank.
"""
import copy
import json
import os
import tempfile

import jax
import jax._src.core
import numpy as np
import pytest
import torch

from metrics_tpu.ops import fleetobs as jfleet
from metrics_tpu.ops import telemetry as jtelemetry
from metrics_tpu_torch.ops import fleetobs, telemetry
from metrics_tpu_torch.parallel import bucketing, collective_stats
from metrics_tpu_torch.parallel import sync as psync
from tests.helpers.torch_fleet import fleet_world_worker
from tests.helpers.torch_sync import headline_suite, run_world, suite_batches
import metrics_tpu_torch as tmt


@pytest.fixture(autouse=True)
def _reference_runs(monkeypatch):
    monkeypatch.setattr(jax.core, "trace_state_clean", jax._src.core.trace_state_clean, raising=False)
    armed = (telemetry.armed, jtelemetry.armed)
    telemetry.set_telemetry(True)
    jtelemetry.set_telemetry(True)
    psync.reset_membership()
    yield
    psync.reset_membership()
    telemetry.set_telemetry(armed[0])
    jtelemetry.set_telemetry(armed[1])


def _activity():
    suite = headline_suite(tmt)
    for preds, target in suite_batches(3, 2):
        suite.update(torch.from_numpy(preds), torch.from_numpy(target))
    for _ in range(2):
        suite.sync(distributed_available=lambda: True)
        suite.unsync()
    return suite


def _planes(seed: int) -> dict:
    """Rank planes: the port's snapshot on every live rank with the sync phase means, p95s, latency
    buckets and some counters and gauges drawn per rank (rank 2 slow in the payload gather), a dead,
    a missing and a corrupt placeholder, and a streaming block with a lagging window."""
    _activity()
    base = json.loads(json.dumps(telemetry._json_safe({k: v for k, v in telemetry.snapshot().items()
                                                       if k != "failure_log"})))
    rng = np.random.default_rng(seed)
    planes = {}
    for r in range(4):
        p = copy.deepcopy(base)
        for site in telemetry.SYNC_PHASE_SITES:
            slow = 20.0 if (r == 2 and site == "sync-payload-gather") else 1.0
            mean = float(rng.uniform(1e-3, 2e-3)) * slow
            p["sync_phase_stats"][site] = {"count": 5, "mean_s": mean, "max_s": mean * 2, "total_s": mean * 5}
            count = int(rng.integers(1, 30))
            p["latency_stats"][site] = {"count": count, "sum_s": mean * count, "max_s": mean * 3,
                                        "p50_s": mean, "p95_s": mean * 2, "p99_s": mean * 2.5,
                                        "buckets": {"0.001024": count - 1, "0.002048": 1}}
        p["builds"] = int(rng.integers(0, 9))
        p["monotonic_step"] = 100 + r
        p["sync_coalesce_ratio"] = float(rng.random())
        p["sync_health"]["degraded"] = bool(r == 1)
        p["streaming"] = {"windows": {"acc": {"window": 7 - (r == 3), "values": {"7": {"value": 0.5}}}},
                          "drift": {"acc": {"psi": 0.1, "ks": 0.2}},
                          "arenas": {"tenants": {"tenants": 10, "cohorts": {"0": {"value": 0.25}}}}}
        p["ingest_state"] = {"gateways": {"gw": {"staging_rows": r, "staging_bytes": 8 * r, "degraded": False,
                                                  "quarantine_depth": 0}}}
        planes[r] = p
    planes[4] = {"dead": True, "rank": 4, "declared_dead_epoch": 2, "timeouts": 3}
    planes[5] = {"missing": True, "rank": 5}
    planes[6] = {"corrupt": True, "rank": 6}
    return planes


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merges_and_stragglers_match_the_reference(seed):
    planes = _planes(seed)
    assert fleetobs.merge_snapshots(copy.deepcopy(planes)) == jfleet.merge_snapshots(copy.deepcopy(planes))
    assert fleetobs.merge_latency_stats(copy.deepcopy(planes)) == jfleet.merge_latency_stats(copy.deepcopy(planes))
    assert fleetobs.merge_streaming(copy.deepcopy(planes)) == jfleet.merge_streaming(copy.deepcopy(planes))
    mine = fleetobs.straggler_report(copy.deepcopy(planes))
    assert mine == jfleet.straggler_report(copy.deepcopy(planes))
    assert mine["phases"]["sync-payload-gather"]["slowest_rank"] == 2 and 2 in mine["stragglers"]


@pytest.mark.parametrize("seed", [0, 1])
def test_fleet_prometheus_text_matches_the_reference(seed):
    planes = _planes(seed)
    snap = {"fleet_schema": 1, "world_size": 7, "rank": 0, "epoch": 3, "gathered": True, "dead_ranks": [4],
            "ranks": planes, "aggregate": fleetobs.merge_snapshots(planes),
            "stragglers": fleetobs.straggler_report(planes), "streaming": fleetobs.merge_streaming(planes)}
    assert fleetobs.fleet_prometheus_text(snap) == jfleet.fleet_prometheus_text(copy.deepcopy(snap))


def test_the_tables_and_knobs_are_the_reference_ones(monkeypatch):
    assert fleetobs.FLEET_SCHEMA == jfleet.FLEET_SCHEMA and fleetobs.FLEET_GAUGE_KEYS == jfleet.FLEET_GAUGE_KEYS
    keys = ["monotonic_step", "builds", "sync_health_epoch", "latency_stats_x_count", "fleet_gathers", "x_ratio"]
    for key in keys:
        assert fleetobs._fleet_is_counter(key) == jfleet._fleet_is_counter(key), key
        assert telemetry.is_histogram_sample_key(key) == jtelemetry.is_histogram_sample_key(key), key
    for key in ("latency_stats_sync-pack_buckets_0.001", "latency_stats_a_sum_s", "latency_stats_a_p95_s"):
        assert telemetry.is_histogram_sample_key(key) == jtelemetry.is_histogram_sample_key(key), key
    assert fleetobs.straggler_threshold() == jfleet.straggler_threshold() == 0.5
    monkeypatch.setenv("METRICS_TPU_STRAGGLER_THRESHOLD", "0.25")
    assert fleetobs.straggler_threshold() == 0.25


def test_a_world_of_one_issues_no_collective():
    suite = _activity()
    before = collective_stats()
    snap = fleetobs.fleet_snapshot()
    report = fleetobs.fleet_perf_report()
    health = suite.fleet_health()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fleet.json")
        events = fleetobs.export_fleet_trace(path)
        doc = json.load(open(path))
    assert collective_stats() == before
    assert snap["gathered"] is False and snap["world_size"] == 1 and list(snap["ranks"]) == [0]
    assert snap["aggregate"]["ranks_merged"] == [0] and snap["fleet_stats"]["fleet_gathers"] == 0
    assert report["gathered"] is False and 0 in report["reports"]
    assert health["suite"]["degraded"] is False and health["world_size"] == 1
    assert events == sum(1 for e in doc["traceEvents"] if e["ph"] != "M") and doc["otherData"]["ranks"] == [0]


class _BlobWorld:
    """A world whose other ranks' blobs stand at the ``_host_allgather`` seam: the length
    exchange (int64) and the padded payload (uint8), the caller's row first."""

    def __init__(self, monkeypatch, others):
        self.others = others
        self.calls = 0
        monkeypatch.setattr(bucketing, "_host_allgather", self._host)

    def _host(self, vec, group):
        self.calls += 1
        if vec.dtype == torch.int64:
            return torch.stack([vec] + [torch.tensor([len(b)], dtype=torch.int64) for b in self.others])
        rows = [vec] + [torch.frombuffer(bytearray(b), dtype=torch.uint8) for b in self.others]
        out = torch.zeros(len(rows), vec.numel(), dtype=torch.uint8)
        for i, row in enumerate(rows):
            out[i, : row.numel()] = row
        return out


def test_an_emulated_world_merges_every_rank(monkeypatch):
    planes = _planes(4)
    others = [json.dumps(planes[1]).encode(), b"\xff not json", json.dumps(planes[2]).encode()]
    world = _BlobWorld(monkeypatch, others)
    psync.set_expected_world(4)
    _activity()
    with pytest.warns(UserWarning, match="dropped undecodable"):
        events = fleetobs.export_fleet_trace(os.path.join(tempfile.mkdtemp(), "t.json"))
    assert events > 0
    snap = fleetobs.fleet_snapshot()
    assert snap["gathered"] and world.calls == 4  # two exchanges a gather
    assert snap["ranks"][2].get("corrupt") and snap["ranks"][3]["builds"] == planes[2]["builds"]
    assert snap["aggregate"]["ranks_merged"] == [0, 1, 3]
    live = {r: p for r, p in snap["ranks"].items()}
    assert snap["aggregate"] == jfleet.merge_snapshots(copy.deepcopy(live))
    assert snap["stragglers"] == jfleet.straggler_report(copy.deepcopy(live))
    assert fleetobs.fleet_stats()["fleet_gathers"] >= 2
    # the gathered local plane is the local serialisation, byte for byte
    assert json.dumps(snap["ranks"][0], sort_keys=True) == json.dumps(
        json.loads(json.dumps(snap["ranks"][0])), sort_keys=True)


def test_a_dead_rank_gets_a_placeholder_and_survivors_map_in_order(monkeypatch):
    planes = _planes(5)
    _BlobWorld(monkeypatch, [json.dumps(planes[2]).encode()])
    psync.set_expected_world(3)
    psync._declare_dead([1], reason="test")
    snap = fleetobs.fleet_snapshot()
    assert snap["dead_ranks"] == [1] and snap["ranks"][1]["dead"] and snap["ranks"][2]["builds"] == planes[2]["builds"]
    assert snap["aggregate"]["ranks_merged"] == [0, 2]


def test_a_gloo_world_names_its_slowed_rank():
    results = run_world(fleet_world_worker, 2, 7, 1, 0.05, timeout=120.0)
    for rank, res in enumerate(results):
        snap = res["snap"]
        assert snap["gathered"] and snap["world_size"] == 2 and snap["rank"] == rank and res["health"] == 2
        assert res["issued"] == 1  # the blob gather's payload slot (its length exchange is the shape slot)
        assert snap["stragglers"]["phases"]["sync-pack"]["slowest_rank"] == 1
        assert 1 in snap["stragglers"]["stragglers"]
        planes = snap["ranks"]
        assert snap["aggregate"] == jfleet.merge_snapshots(copy.deepcopy(planes))
        assert res["text"] == jfleet.fleet_prometheus_text(copy.deepcopy(snap))
        assert 'metrics_tpu_fleet_straggler_flagged{rank="1"} 1' in res["text"]
        assert res["perf"]["gathered"] and sorted(res["perf"]["reports"]) == [0, 1]
    assert results[0]["snap"]["aggregate"] == results[1]["snap"]["aggregate"]
