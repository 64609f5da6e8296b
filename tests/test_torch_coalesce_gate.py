"""``METRICS_TPU_SYNC_COALESCE`` in the port against the JAX package.

Under ``=0`` (or ``false``) every sync lane takes the per-state protocol, as
in JAX (``metrics_tpu/parallel/bucketing.py`` ``coalesce_enabled``, checked by
``Metric._sync_coalesced``, ``Metric.sync_async`` and the collection's sync
and async lanes). Two collectives a state: the counts equal JAX's per-state
walk of the same suite in a world of one, and, in a real two-process Gloo
world (``tests/helpers/torch_sync.coalesce_gate_worker``), the synced states
equal those of the coalesced protocol under ``=1`` bit for bit.
"""
import jax
import jax._src.core
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jmt
import metrics_tpu_torch as tmt
from metrics_tpu.parallel import bucketing as jbucketing
from metrics_tpu.parallel import sync as jsync
from metrics_tpu_torch.parallel import bucketing, coalesce_enabled, collective_stats, reset_collective_stats
from tests.helpers.torch_sync import coalesce_gate_worker, run_world

DIST_ON = lambda: True  # noqa: E731
COUNTS = ("sync_shape_collectives", "sync_payload_collectives", "sync_coalesced_payloads", "sync_states_coalesced")


@pytest.fixture(autouse=True)
def _reference_runs(monkeypatch):
    """jax 0.9 no longer exports ``jax.core.trace_state_clean``; this file's copy of it lets the reference run."""
    monkeypatch.setattr(jax.core, "trace_state_clean", jax._src.core.trace_state_clean, raising=False)


@pytest.mark.parametrize("value", [None, "1", "true", "0", "false", "FALSE", "no"])
def test_the_gate_reads_as_the_reference(value, monkeypatch):
    if value is None:
        monkeypatch.delenv("METRICS_TPU_SYNC_COALESCE", raising=False)
    else:
        monkeypatch.setenv("METRICS_TPU_SYNC_COALESCE", value)
    assert coalesce_enabled() == jbucketing.coalesce_enabled() == bucketing.coalesce_enabled()


def _suites(seed=0):
    rng = np.random.RandomState(seed)
    logits = rng.rand(20, 5).astype(np.float32)
    preds, target = logits / logits.sum(-1, keepdims=True), rng.randint(0, 5, 20)
    mine = tmt.MetricCollection([tmt.Accuracy(num_classes=5, device="cpu"), tmt.ConfusionMatrix(num_classes=5, device="cpu")])
    ref = jmt.MetricCollection([jmt.Accuracy(num_classes=5), jmt.ConfusionMatrix(num_classes=5)])
    mine.update(torch.from_numpy(preds), torch.from_numpy(target))
    ref.update(jnp.asarray(preds), jnp.asarray(target))
    return mine, ref


@pytest.mark.parametrize("env", ["1", "0"])
@pytest.mark.parametrize("owner", ["suite", "member"])
def test_counts_equal_the_reference_in_a_world_of_one(env, owner, monkeypatch):
    monkeypatch.setenv("METRICS_TPU_SYNC_COALESCE", env)
    mine, ref = _suites()
    if owner == "member":
        mine, ref = mine["ConfusionMatrix"], ref["ConfusionMatrix"]
    reset_collective_stats()
    jsync.reset_collective_stats()
    mine.sync(distributed_available=DIST_ON)
    ref.sync(distributed_available=DIST_ON)
    stats, jstats = collective_stats(), jsync.collective_stats()
    assert {k: stats[k] for k in COUNTS} == {k: jstats[k] for k in COUNTS}
    assert (stats["sync_coalesced_payloads"] == 0) == (env == "0")


@pytest.mark.parametrize("owner", ["suite", "member"])
def test_the_async_lanes_decline_under_the_gate(owner, monkeypatch):
    monkeypatch.setenv("METRICS_TPU_SYNC_COALESCE", "0")
    mine, _ = _suites()
    if owner == "member":
        mine = mine["Accuracy"]
    reset_collective_stats()
    fut = mine.sync_async(distributed_available=DIST_ON)
    if fut is not None:
        fut.wait()
    stats = collective_stats()
    assert stats["sync_coalesced_payloads"] == 0 and stats["sync_payload_collectives"] > 0
    assert stats["sync_async_dispatches"] == 0


@pytest.fixture(scope="module")
def world():
    return run_world(coalesce_gate_worker, 2, 11, timeout=120.0)


def test_a_two_rank_world_takes_the_per_state_walk_under_the_gate(world, monkeypatch):
    monkeypatch.setenv("METRICS_TPU_SYNC_COALESCE", "0")
    _, ref = _suites()
    jsync.reset_collective_stats()
    ref.sync(distributed_available=DIST_ON)
    per_state = {k: jsync.collective_stats()[k] for k in COUNTS}
    assert per_state["sync_shape_collectives"] == per_state["sync_payload_collectives"] == 7
    for rank in world:
        for lane in ("sync", "sync_async"):
            assert rank[("0", lane)]["counts"] == per_state, lane
            coalesced = rank[("1", lane)]["counts"]
            assert coalesced["sync_coalesced_payloads"] == 1 and coalesced["sync_states_coalesced"] == 7
            off, on = rank[("0", lane)]["states"], rank[("1", lane)]["states"]
            assert set(off) == set(on) and all(torch.equal(off[k], on[k]) for k in on), lane
    assert all(torch.equal(world[0][("0", "sync")]["states"][k], world[1][("0", "sync")]["states"][k])
               for k in world[0][("0", "sync")]["states"])
