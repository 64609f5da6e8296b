"""The port's asynchronous, quantized and hierarchical sync lanes against the JAX package's
(``tests/parallel/test_async_sync.py``).

- **Async** (``Metric.sync_async``/``MetricCollection.sync_async`` ->
  ``SyncFuture``): the forced states equal the blocking protocol's at the
  dispatch point, bit for bit, and JAX's values; ``compute()`` forces a
  pending future; a second force does nothing; updates made in flight come
  back with ``unsync``; a blocking sync forces every future first and waits
  out a cancelled one's collective; every failure at the force (a deadline,
  an epoch fence) leaves the local states intact; ``reset`` cancels.
- **Quantized** (``METRICS_TPU_SYNC_QUANT``): the bf16 and int8 wire bytes of
  a float state equal JAX's byte for byte; integer states stay exact under
  every tier; float values stay within the JAX test's tolerance (atol 2e-2)
  with fewer bytes on the wire.
- **Hierarchical** (``METRICS_TPU_SYNC_HIER``): the psum lane over two nodes
  of two equals the flat sum bit for bit; float layouts take the two-stage
  gather, bit for bit.

``inflight_stats()``, ``sync_health()['inflight']`` and ``collective_stats()``
have JAX's keys, and the same values where both packages ran the same calls.
"""
import copy
import time
import warnings

import jax
import jax._src.core
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jmt
from metrics_tpu.parallel import bucketing as jbucketing
from metrics_tpu.parallel import sync as jsync
import metrics_tpu_torch as tmt
from metrics_tpu_torch.ops import faults, telemetry
from metrics_tpu_torch.parallel import bucketing, collective_stats
from metrics_tpu_torch.parallel import sync as psync
from metrics_tpu_torch.utils.exceptions import EpochFault, MetricsUserError, SyncTimeoutFault
from tests.helpers.torch_sync import TorchFakeGather, install_world, pack_tree
from tests.parallel.test_async_sync import _install_world as jax_install_world

DIST_ON = lambda: True  # noqa: E731


@pytest.fixture(autouse=True)
def _fast_backoff(monkeypatch):
    """jax 0.9 no longer exports ``jax.core.trace_state_clean``, which the JAX
    package's engine calls; this test's copy of it lets the reference run."""
    monkeypatch.setattr(jax.core, "trace_state_clean", jax._src.core.trace_state_clean, raising=False)
    monkeypatch.setenv("METRICS_TPU_SYNC_BACKOFF_MS", "0")
    yield
    psync.drain_inflight()
    psync.reset_membership()
    jsync.reset_membership()


def _mean_ranks(n=3, pkg="port"):
    out = []
    for r in range(n):
        v = np.asarray([1.0 + r, 4.0 * (r + 1)], np.float32)
        m = jmt.MeanMetric() if pkg == "jax" else tmt.MeanMetric(device="cpu")
        m.update(jnp.asarray(v) if pkg == "jax" else torch.from_numpy(v))
        out.append(m)
    return out


def _oracle_sync(ranks):
    copies = [copy.deepcopy(m) for m in ranks]
    copies[0].sync(dist_sync_fn=TorchFakeGather(copies), distributed_available=DIST_ON)
    return copies[0]


def _states_equal(a, b):
    for name in a.metric_state:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and torch.equal(x, y), name


# ------------------------------------------------------------------- async
def test_overlapped_sync_bitexact_vs_blocking_oracle(monkeypatch):
    ranks = _mean_ranks()
    oracle = _oracle_sync(ranks)
    install_world(monkeypatch, ranks[1:])
    s0 = collective_stats()
    fut = ranks[0].sync_async(distributed_available=DIST_ON)
    assert fut is not None and not fut._forced
    fut.wait()
    s1 = collective_stats()
    for key in ("sync_async_dispatches", "sync_async_forces", "sync_payload_collectives"):
        assert s1[key] - s0[key] == 1, key
    assert ranks[0]._is_synced
    _states_equal(ranks[0], oracle)
    got = ranks[0].compute()
    assert torch.equal(got, oracle.compute())
    ranks[0].unsync()
    assert collective_stats()["sync_stale_collectives"] == s0["sync_stale_collectives"]
    # the JAX package's async lane on the same data
    jranks = _mean_ranks(pkg="jax")
    jax_install_world(monkeypatch, [jbucketing.tree_nodes(m) for m in jranks])
    jfut = jranks[0].sync_async(distributed_available=DIST_ON)
    jfut.wait()
    assert float(got) == float(jranks[0].compute())
    jranks[0].unsync()


def test_compute_before_force_auto_waits(monkeypatch):
    ranks = _mean_ranks()
    oracle_val = float(_oracle_sync(ranks).compute())
    install_world(monkeypatch, ranks[1:])
    s0 = collective_stats()["sync_async_auto_forces"]
    ranks[0].sync_async(distributed_available=DIST_ON)
    assert float(ranks[0].compute()) == oracle_val
    assert collective_stats()["sync_async_auto_forces"] == s0 + 1
    assert not ranks[0]._is_synced and ranks[0].__dict__.get("_pending_sync") is None


def test_double_force_idempotent(monkeypatch):
    ranks = _mean_ranks()
    install_world(monkeypatch, ranks[1:])
    fut = ranks[0].sync_async(distributed_available=DIST_ON)
    fut.wait()
    state = dict(ranks[0].metric_state)
    forces = collective_stats()["sync_async_forces"]
    fut.wait()
    fut.wait()
    assert collective_stats()["sync_async_forces"] == forces
    assert all(getattr(ranks[0], k) is v for k, v in state.items())
    ranks[0].unsync()


def test_inflight_tail_updates_restore_through_unsync(monkeypatch):
    ranks = _mean_ranks()
    oracle = _oracle_sync(ranks)
    install_world(monkeypatch, ranks[1:])
    m = ranks[0]
    fut = m.sync_async(distributed_available=DIST_ON)
    m.update(torch.tensor([100.0]))  # the overlap window
    tail = dict(m.metric_state)
    fut.wait()
    assert torch.equal(m.compute(), oracle.compute())  # the dispatch point's merge
    m.unsync()
    assert all(getattr(m, k) is v for k, v in tail.items())


def test_dispatch_while_pending_raises(monkeypatch):
    ranks = _mean_ranks()
    install_world(monkeypatch, ranks[1:])
    fut = ranks[0].sync_async(distributed_available=DIST_ON)
    with pytest.raises(MetricsUserError, match="in flight"):
        ranks[0].sync_async(distributed_available=DIST_ON)
    with pytest.raises(MetricsUserError, match="in flight"):
        ranks[0].sync(distributed_available=DIST_ON)
    fut.wait()
    ranks[0].unsync()


def _suite(pkg, seed):
    rng = np.random.RandomState(seed)
    p, t = rng.rand(48).astype(np.float32), rng.randint(0, 2, 48)
    if pkg == "jax":
        c = jmt.MetricCollection({"mean": jmt.MeanMetric(), "acc": jmt.Accuracy()})
        c.update(jnp.asarray(p), jnp.asarray(t))
    else:
        c = tmt.MetricCollection({"mean": tmt.MeanMetric(device="cpu"), "acc": tmt.Accuracy(device="cpu")})
        c.update(torch.from_numpy(p), torch.from_numpy(t))
    return c


def test_suite_async_bitexact_and_auto_force(monkeypatch):
    oracles = [_suite("port", 3) for _ in range(3)]
    install_world(monkeypatch, oracles[1:])
    oracles[0].sync(distributed_available=DIST_ON)
    oracle_vals = oracles[0].compute()
    oracles[0].unsync()
    suites = [_suite("port", 3) for _ in range(3)]
    install_world(monkeypatch, suites[1:])
    fut = suites[0].sync_async(distributed_available=DIST_ON)
    assert fut is not None
    got = suites[0].compute()
    assert all(torch.equal(got[k], v) for k, v in oracle_vals.items())
    assert suites[0].__dict__.get("_pending_sync") is None
    assert not any(m._is_synced for _, m in suites[0].items(keep_base=True, copy_state=False))
    jsuites = [_suite("jax", 3) for _ in range(3)]
    jax_install_world(monkeypatch, [tree_of_jax(s) for s in jsuites])
    jsuites[0].sync_async(distributed_available=DIST_ON)
    ref = jsuites[0].compute()
    assert {k: float(v) for k, v in got.items()} == {k: float(v) for k, v in ref.items()}


def tree_of_jax(suite):
    return [n for _, m in suite.items(keep_base=True, copy_state=False) for n in jbucketing.tree_nodes(m)]


def test_blocking_sync_drains_inflight_first(monkeypatch):
    ranks = _mean_ranks()
    install_world(monkeypatch, ranks[1:])
    fut = ranks[0].sync_async(distributed_available=DIST_ON)
    assert psync.inflight_stats()["count"] == 1
    other = tmt.MeanMetric(device="cpu")
    other.update(torch.tensor([5.0, 7.0]))
    other.sync(dist_sync_fn=TorchFakeGather([other]), distributed_available=DIST_ON)
    assert psync.inflight_stats()["count"] == 0 and ranks[0]._is_synced and fut._forced
    other.unsync()
    ranks[0].unsync()


def test_member_compute_during_suite_flight_no_double_merge(monkeypatch):
    oracles = [_suite("port", 5) for _ in range(2)]
    install_world(monkeypatch, oracles[1:])
    oracles[0].sync(distributed_available=DIST_ON)
    oracle_mean = float(oracles[0]["mean"].compute())
    oracles[0].unsync()
    suites = [_suite("port", 5) for _ in range(2)]
    install_world(monkeypatch, suites[1:])
    monkeypatch.setattr(psync, "_live", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: 2)
    fut = suites[0].sync_async(distributed_available=DIST_ON)
    got = float(suites[0]["mean"].compute())
    assert got == oracle_mean and fut._forced


def test_cancel_still_blocks_next_collective_until_wire_idle(monkeypatch):
    ranks = _mean_ranks(2)
    install_world(monkeypatch, ranks[1:])
    real_payload = bucketing._payload_allgather
    calls = []

    def slow_payload(x, group):
        calls.append(("start", time.perf_counter()))
        time.sleep(0.15)
        calls.append(("end", time.perf_counter()))
        return real_payload(x, group)

    monkeypatch.setattr(bucketing, "_payload_allgather", slow_payload)
    m = ranks[0]
    m.sync_async(distributed_available=DIST_ON)
    m.reset()
    assert psync.inflight_stats()["count"] == 0
    other = tmt.MeanMetric(device="cpu")
    other.update(torch.tensor([5.0, 7.0]))
    other.sync(distributed_available=DIST_ON)
    other.unsync()
    assert len(calls) == 4, calls
    (k0, _), (k1, t_end_cancelled), (k2, t_start_blocking), _ = calls
    assert (k0, k1, k2) == ("start", "end", "start") and t_start_blocking >= t_end_cancelled


def test_fallback_future_auto_unsyncs_at_compute():
    ranks = _mean_ranks(2)
    oracle_val = float(_oracle_sync(ranks).compute())
    m = ranks[0]
    fut = m.sync_async(dist_sync_fn=TorchFakeGather(ranks), distributed_available=DIST_ON)
    assert fut.done() and m.__dict__.get("_pending_sync") is fut
    assert float(m.compute()) == oracle_val
    assert not m._is_synced and m.__dict__.get("_pending_sync") is None
    m._computed = None
    fut2 = m.sync_async(dist_sync_fn=TorchFakeGather(ranks), distributed_available=DIST_ON)
    fut2.wait()
    m.unsync()


def test_dispatch_pack_fault_demotes_and_replays_blocking(monkeypatch):
    ranks = _mean_ranks(2)
    twin = copy.deepcopy(ranks[0])
    with faults.inject_faults("sync-pack", count=1):
        with pytest.warns(UserWarning, match="Coalesced sync failed"):
            twin.sync(distributed_available=DIST_ON)
    twin_val = twin.compute()
    twin.unsync()
    install_world(monkeypatch, ranks[1:])
    m = ranks[0]
    with faults.inject_faults("sync-pack", count=1) as plan:
        with pytest.warns(UserWarning, match="dispatch"):
            fut = m.sync_async(distributed_available=DIST_ON)
    assert plan.fired >= 1 and fut is not None and fut.done() and m._is_synced
    assert torch.equal(m.compute(), twin_val)
    assert not m._is_synced
    assert m.__dict__["_fault_ladders"]["sync-pack"].demoted


def test_fallback_to_blocking_when_not_coalescible():
    ranks = _mean_ranks(2)
    oracle = _oracle_sync(ranks)
    fb0 = collective_stats()["sync_async_fallbacks"]
    fut = ranks[0].sync_async(dist_sync_fn=TorchFakeGather(ranks), distributed_available=DIST_ON)
    assert fut is not None and fut.done()
    fut.wait()
    assert collective_stats()["sync_async_fallbacks"] == fb0 + 1 and ranks[0]._is_synced
    assert torch.equal(ranks[0].compute(), oracle.compute())
    ranks[0].unsync()


# ------------------------------------------------------------- force faults
def test_fence_trip_at_force_classified_state_intact(monkeypatch):
    ranks = _mean_ranks()
    install_world(monkeypatch, ranks[1:])
    m = ranks[0]
    before = dict(m.metric_state)
    s0 = collective_stats()
    fut = m.sync_async(distributed_available=DIST_ON)
    psync.bump_epoch("test-membership-race")
    with pytest.raises(EpochFault):
        fut.wait()
    s1 = collective_stats()
    assert s1["sync_epoch_fence_trips"] > s0["sync_epoch_fence_trips"]
    assert s1["sync_async_stale_futures"] == s0["sync_async_stale_futures"] + 1
    assert s1["sync_stale_collectives"] == s0["sync_stale_collectives"] and not m._is_synced
    assert all(getattr(m, k) is v for k, v in before.items())
    fut.wait()
    m.sync(distributed_available=DIST_ON)
    m.unsync()


def _hung(x, group):
    time.sleep(0.5)
    raise RuntimeError("abandoned hung collective (force deadline fired long ago)")


def test_force_deadline_timeout_classified_state_intact(monkeypatch):
    monkeypatch.setenv("METRICS_TPU_SYNC_DEADLINE_MS", "80")
    ranks = _mean_ranks(2)
    install_world(monkeypatch, ranks[1:])
    monkeypatch.setattr(bucketing, "_payload_allgather", _hung)
    m = ranks[0]
    before = dict(m.metric_state)
    t0 = collective_stats()["sync_deadline_timeouts"]
    fut = m.sync_async(distributed_available=DIST_ON)
    with pytest.raises(SyncTimeoutFault):
        fut.wait()
    assert collective_stats()["sync_deadline_timeouts"] > t0 and not m._is_synced
    assert all(getattr(m, k) is v for k, v in before.items())


def test_force_timeout_degrades_through_local_tier(monkeypatch):
    monkeypatch.setenv("METRICS_TPU_SYNC_DEADLINE_MS", "80")
    monkeypatch.setenv("METRICS_TPU_SYNC_DEGRADED", "local")
    ranks = _mean_ranks(2)
    local_val = float(copy.deepcopy(ranks[0]).compute())
    install_world(monkeypatch, ranks[1:])
    monkeypatch.setattr(bucketing, "_payload_allgather", _hung)
    m = ranks[0]
    assert m.sync_async(distributed_available=DIST_ON) is not None
    with pytest.warns(UserWarning, match="LOCAL-ONLY"):
        served = float(m.compute())
    assert served == local_val
    health = m.sync_health()
    assert health["degraded"] and health["degraded_serves"] >= 1


def test_reset_cancels_inflight_future(monkeypatch):
    ranks = _mean_ranks()
    install_world(monkeypatch, ranks[1:])
    m = ranks[0]
    fut = m.sync_async(distributed_available=DIST_ON)
    m.reset()
    assert m.__dict__.get("_pending_sync") is None
    fut.wait()
    assert not m._is_synced and float(m.weight) == 0.0


def test_inflight_block_surfaces_with_the_reference_keys(monkeypatch):
    ranks = _mean_ranks()
    install_world(monkeypatch, ranks[1:])
    m = ranks[0]
    assert m.sync_health()["inflight"] is None
    fut = m.sync_async(distributed_available=DIST_ON)
    block = m.sync_health()["inflight"]
    assert block["dispatch_epoch"] == fut.dispatch_epoch and block["age_steps"] >= 0
    assert block["quant_tier"] is None
    assert telemetry.snapshot()["sync_health"]["inflight"]["count"] >= 1
    assert sorted(psync.inflight_stats()) == sorted(jsync.inflight_stats())
    jranks = _mean_ranks(pkg="jax")
    jax_install_world(monkeypatch, [jbucketing.tree_nodes(j) for j in jranks])
    jfut = jranks[0].sync_async(distributed_available=DIST_ON)
    assert sorted(block) == sorted(jranks[0].sync_health()["inflight"])
    jfut.wait()
    jranks[0].unsync()
    fut.wait()
    assert m.sync_health()["inflight"] is None
    assert telemetry.snapshot()["sync_health"]["inflight"]["count"] == 0
    m.unsync()


def test_collective_stats_keys_are_the_reference_keys():
    assert sorted(collective_stats()) == sorted(jsync.collective_stats())


# -------------------------------------------------------------- quant lane
def _float_states(seed, shapes):
    rng = np.random.RandomState(seed)
    return [np.asarray(rng.randn(*shape) * 10 ** rng.uniform(-3, 3), np.float32) for shape in shapes]


class _PortHolder(tmt.Metric):
    full_state_update = True

    def __init__(self, values):
        super().__init__(device="cpu")
        for i, v in enumerate(values):
            self.add_state(f"s{i}", torch.from_numpy(v), dist_reduce_fx="sum")
        self.add_state("count", torch.tensor(3, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self):
        pass

    def compute(self):
        return self.count


class _JaxHolder(jmt.Metric):
    full_state_update = True

    def __init__(self, values):
        super().__init__()
        for i, v in enumerate(values):
            self.add_state(f"s{i}", jnp.asarray(v), dist_reduce_fx="sum")
        self.add_state("count", jnp.asarray(3, jnp.int32), dist_reduce_fx="sum")

    def update(self):
        pass

    def compute(self):
        return self.count


WIRE_SHAPES = [(), (1,), (3,), (64,), (16, 9), (1000,)]


@pytest.mark.parametrize("tier", ["bf16", "int8"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wire_bytes_equal_the_reference(tier, seed):
    values = _float_states(seed, WIRE_SHAPES)
    values[-1][::7] = 0.0  # exact zeros and a constant tail
    mine, ref = _PortHolder(values), _JaxHolder(values)
    p_entries, p_vals = bucketing._collect([mine])
    j_entries, j_vals = jbucketing._collect([ref])
    bucketing._quant_encode(p_entries, p_vals, tier, mine)
    jbucketing._quant_encode(j_entries, j_vals, tier, ref)
    assert [(e.name, e.quant, e.wire_nbytes) for e in p_entries] == [(e.name, e.quant, e.wire_nbytes)
                                                                      for e in j_entries]
    lossy = 0
    for pe, pv, jv in zip(p_entries, p_vals, j_vals):
        if pe.quant is not None:
            lossy += 1
            assert pv.numpy().tobytes() == np.asarray(jv).tobytes(), pe.name
    assert lossy == (len(WIRE_SHAPES) if tier == "bf16" else len(WIRE_SHAPES) - 2)


@pytest.mark.parametrize("tier", ["bf16", "int8"])
def test_integer_states_exact_under_any_tier(tier, monkeypatch):
    rng = np.random.RandomState(0)
    ranks = []
    for _ in range(3):
        m = tmt.ConfusionMatrix(num_classes=4, device="cpu")
        m.update(torch.from_numpy(rng.randint(0, 4, 32)), torch.from_numpy(rng.randint(0, 4, 32)))
        ranks.append(m)
    oracle = _oracle_sync(ranks)
    monkeypatch.setenv("METRICS_TPU_SYNC_QUANT", tier)
    install_world(monkeypatch, ranks[1:])
    s0 = collective_stats()
    ranks[0].sync(distributed_available=DIST_ON)
    s1 = collective_stats()
    assert s1["sync_quant_exact_states"] > s0["sync_quant_exact_states"]
    assert s1["sync_quant_lossy_states"] == s0["sync_quant_lossy_states"]
    assert torch.equal(ranks[0].compute(), oracle.compute())
    ranks[0].unsync()


def _regression_ranks(seed, pkg="port"):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(3):
        preds, target = rng.rand(64, 16).astype(np.float32), rng.rand(64, 16).astype(np.float32)
        if pkg == "jax":
            c = jmt.MetricCollection({"r2": jmt.R2Score(num_outputs=16), "pearson": jmt.PearsonCorrCoef(),
                                      "mse": jmt.MeanSquaredError()})
            c["r2"].update(jnp.asarray(preds), jnp.asarray(target))
            c["pearson"].update(jnp.asarray(preds[:, 0]), jnp.asarray(target[:, 0]))
            c["mse"].update(jnp.asarray(preds), jnp.asarray(target))
        else:
            c = tmt.MetricCollection({"r2": tmt.R2Score(num_outputs=16, device="cpu"),
                                      "pearson": tmt.PearsonCorrCoef(device="cpu"),
                                      "mse": tmt.MeanSquaredError(device="cpu")})
            c["r2"].update(torch.from_numpy(preds), torch.from_numpy(target))
            c["pearson"].update(torch.from_numpy(preds[:, 0]), torch.from_numpy(target[:, 0]))
            c["mse"].update(torch.from_numpy(preds), torch.from_numpy(target))
        out.append(c)
    return out


@pytest.mark.parametrize("tier", ["bf16", "int8"])
def test_float_states_within_tolerance_and_fewer_bytes(tier, monkeypatch):
    exact = _regression_ranks(7)
    install_world(monkeypatch, exact[1:])
    b0 = collective_stats()["sync_bytes_gathered"]
    exact[0].sync(distributed_available=DIST_ON)
    exact_bytes = collective_stats()["sync_bytes_gathered"] - b0
    exact_vals = exact[0].compute()
    exact_total = exact[0]["r2"].total
    exact[0].unsync()
    quant = _regression_ranks(7)
    monkeypatch.setenv("METRICS_TPU_SYNC_QUANT", tier)
    install_world(monkeypatch, quant[1:])
    s0 = collective_stats()
    quant[0].sync(distributed_available=DIST_ON)
    s1 = collective_stats()
    quant_bytes = s1["sync_bytes_gathered"] - s0["sync_bytes_gathered"]
    assert s1["sync_quant_lossy_states"] > s0["sync_quant_lossy_states"]
    assert s1["sync_quant_bytes_saved"] > s0["sync_quant_bytes_saved"] and quant_bytes < exact_bytes
    assert torch.equal(quant[0]["r2"].total, exact_total)  # an integer count: exact
    quant_vals = quant[0].compute()
    quant[0].unsync()
    for k in exact_vals:
        np.testing.assert_allclose(quant_vals[k].numpy(), exact_vals[k].numpy(), atol=2e-2)
    # the JAX package's values under the same tier, on the same data
    jranks = _regression_ranks(7, "jax")
    jax_install_world(monkeypatch, [tree_of_jax(c) for c in jranks])
    jranks[0].sync(distributed_available=DIST_ON)
    ref = jranks[0].compute()
    jranks[0].unsync()
    for k in ref:
        np.testing.assert_allclose(quant_vals[k].numpy(), np.asarray(ref[k]), atol=1e-5, rtol=1e-5)


def test_async_quant_tier_rides_the_future(monkeypatch):
    monkeypatch.setenv("METRICS_TPU_SYNC_QUANT", "bf16")
    ranks = _mean_ranks()
    install_world(monkeypatch, ranks[1:])
    fut = ranks[0].sync_async(distributed_available=DIST_ON)
    assert fut.quant_tier == "bf16" and ranks[0].sync_health()["inflight"]["quant_tier"] == "bf16"
    fut.wait()
    ranks[0].unsync()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_env_garbage_warns_once_naming_value(pkg, monkeypatch):
    mod = jsync if pkg == "jax" else psync
    monkeypatch.setenv("METRICS_TPU_SYNC_QUANT", "fp4")
    monkeypatch.setattr(mod, "_QUANT_WARN_OWNER", mod._EnvWarnOwner())
    with pytest.warns(UserWarning, match="fp4"):
        assert mod.sync_quant_tier() is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert mod.sync_quant_tier() is None


# ------------------------------------------------------- hierarchical lane
def _confmat_ranks(n=4):
    rng = np.random.RandomState(1)
    ranks = []
    for _ in range(n):
        m = tmt.ConfusionMatrix(num_classes=3, device="cpu")
        m.update(torch.from_numpy(rng.randint(0, 3, 16)), torch.from_numpy(rng.randint(0, 3, 16)))
        ranks.append(m)
    return ranks


def test_two_node_psum_lane_bitexact(monkeypatch):
    ranks = _confmat_ranks()
    flat_oracle = sum(m.confmat for m in ranks)
    ctx_box = {}
    orig_pack_phase = bucketing._pack_phase

    def spy_pack_phase(*a, **k):
        ctx_box["ctx"] = orig_pack_phase(*a, **k)
        return ctx_box["ctx"]

    monkeypatch.setattr(bucketing, "_pack_phase", spy_pack_phase)
    monkeypatch.setattr(bucketing, "_intranode_allgather", lambda x: torch.stack([x, pack_tree(ranks[1])[0]]))

    def internode(block):  # node 1's leader reduced ranks {2, 3}
        intra2 = torch.stack([pack_tree(ranks[2])[0], pack_tree(ranks[3])[0]])
        return torch.stack([block, bucketing._node_reduce(ctx_box["ctx"], intra2)])

    monkeypatch.setattr(bucketing, "_internode_allgather", internode)
    monkeypatch.setenv("METRICS_TPU_SYNC_HIER", "2")
    s0 = collective_stats()
    ranks[0].sync(distributed_available=DIST_ON)
    s1 = collective_stats()
    for key in ("sync_hier_intranode_collectives", "sync_hier_internode_collectives", "sync_hier_node_reduces"):
        assert s1[key] - s0[key] == 1, key
    assert s1["sync_stale_collectives"] == s0["sync_stale_collectives"]
    # half the flat gather's rows cross between the nodes
    assert s1["sync_bytes_gathered"] - s0["sync_bytes_gathered"] == 2 * pack_tree(ranks[1])[0].numel()
    assert torch.equal(ranks[0].compute(), flat_oracle)
    ranks[0].unsync()


def test_two_stage_gather_bitexact_for_float_layouts(monkeypatch):
    ranks = _mean_ranks(4)
    oracle = _oracle_sync(ranks)
    monkeypatch.setattr(bucketing, "_intranode_allgather", lambda x: torch.stack([x, pack_tree(ranks[1])[0]]))
    monkeypatch.setattr(bucketing, "_internode_allgather", lambda block: torch.stack(
        [block, torch.cat([pack_tree(ranks[2])[0], pack_tree(ranks[3])[0]])]))
    monkeypatch.setenv("METRICS_TPU_SYNC_HIER", "2")
    s0 = collective_stats()["sync_hier_node_reduces"]
    ranks[0].sync(distributed_available=DIST_ON)
    assert collective_stats()["sync_hier_node_reduces"] == s0
    assert torch.equal(ranks[0].compute(), oracle.compute())
    ranks[0].unsync()


def test_unbound_seams_in_a_live_world_warn_and_take_the_flat_gather(monkeypatch):
    ranks = _confmat_ranks(2)
    install_world(monkeypatch, ranks[1:])
    monkeypatch.setattr(psync, "_live", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(bucketing, "_HIER_FALLBACK_WARN_OWNER", bucketing._HierWarnOwner())
    monkeypatch.setenv("METRICS_TPU_SYNC_HIER", "2")
    s0 = collective_stats()
    with pytest.warns(UserWarning, match="seams are not"):
        ranks[0].sync(distributed_available=DIST_ON)
    s1 = collective_stats()
    assert s1["sync_hier_intranode_collectives"] == s0["sync_hier_intranode_collectives"]
    assert torch.equal(ranks[0].confmat, ranks[0]._cache["confmat"] + ranks[1].confmat)
    ranks[0].unsync()
