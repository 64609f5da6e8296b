"""The port's world membership against the JAX package's (``tests/parallel/test_world_membership.py``).

- **Epoch fence**: a membership change between a protocol's entry and a
  (re)issued collective raises the classified ``EpochFault``, local states
  intact, and ``sync_stale_collectives`` stays 0.
- **Registry**: the same sequence of timeouts, probes, deaths, rejoins and
  successes leaves the same ``world_health()`` in both packages (steps
  compared by their order).
- **Surviving quorum**: with ``METRICS_TPU_SYNC_DEGRADED=quorum`` and a dead
  rank, ``compute()`` merges over the survivors, bit for bit the per-state
  oracle over them and the JAX package's quorum value, then re-promotes to
  the full world after the rank rejoins; alone and suite-wide.
- **Barrier and rejoin**: ``checkpoint_barrier`` stamps one agreed step and
  the epoch into the manifest; ``rejoin`` restores the journal (or a newer
  handoff record) and enters the next epoch.

The world of several processes is stood in for the protocol's collectives by
:class:`tests.helpers.torch_sync.ElasticWorld`, the port's twin of JAX's
``_ElasticWorld``: the full-world collective hangs while the dead rank is
undeclared, and the survivors' collective answers once it is declared.
"""
import copy
import time

import jax
import jax._src.core
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jmt
import metrics_tpu.metric as jmetric_mod
import metrics_tpu_torch as tmt
from metrics_tpu.ops import faults as jfaults
from metrics_tpu.parallel import bucketing as jbucketing
from metrics_tpu.parallel import sync as jsync
from metrics_tpu_torch.ops import faults, journal
from metrics_tpu_torch.parallel import bucketing, collective_stats
from metrics_tpu_torch.parallel import sync as psync
from metrics_tpu_torch.utils.exceptions import EpochFault, SyncFault, SyncTimeoutFault
from tests.helpers.torch_sync import ElasticWorld, TorchFakeGather
from tests.parallel.test_world_membership import _install_elastic_world as jax_elastic_world

DIST_ON = lambda: True  # noqa: E731
DEADLINE_MS = "150"


@pytest.fixture(autouse=True)
def _fresh_membership(monkeypatch):
    """jax 0.9 no longer exports ``jax.core.trace_state_clean``, which the JAX
    package's engine calls; this test's copy of it lets the reference run."""
    monkeypatch.setattr(jax.core, "trace_state_clean", jax._src.core.trace_state_clean, raising=False)
    monkeypatch.setenv("METRICS_TPU_SYNC_BACKOFF_MS", "0")
    for mod in (psync, jsync):
        mod.reset_membership()
    yield
    for mod, fmod in ((psync, faults), (jsync, jfaults)):
        mod.reset_membership()
        fmod.set_recovery_policy(steps=8)


def _live_world(monkeypatch, n: int) -> None:
    """The port syncs in compute() only in a live world of more than one process: pretend one."""
    monkeypatch.setattr(psync, "_live", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: n)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda group=None: 0)
    monkeypatch.setattr(psync, "transport_group", lambda group, members: members)  # the fake world's own rows


# ---------------------------------------------------------------- registry
def test_bump_is_monotonic_and_counted():
    s0 = collective_stats()["sync_epoch_bumps"]
    e0 = psync.world_epoch()
    assert psync.bump_epoch("test-transition") == e0 + 1 == psync.world_epoch()
    assert collective_stats()["sync_epoch_bumps"] == s0 + 1
    assert psync.world_health()["transitions"][-1]["reason"] == "test-transition"


def test_stale_fence_raises_classified_epoch_fault():
    fence = psync.world_epoch()
    psync.check_epoch(fence)
    psync.bump_epoch("membership-change")
    t0 = collective_stats()["sync_epoch_fence_trips"]
    with pytest.raises(EpochFault) as err:
        psync.check_epoch(fence, site="sync-gather")
    assert err.value.site == "epoch-fence" and isinstance(err.value, SyncFault)
    assert faults.classify(err.value) == "sync"
    assert collective_stats()["sync_epoch_fence_trips"] == t0 + 1
    assert faults.fault_stats()["failure_log"][-1]["site"] == "epoch-fence"


def test_epoch_fault_is_never_retried():
    calls = {"n": 0}

    def fenced():
        calls["n"] += 1
        raise EpochFault("stale", site="epoch-fence")

    with pytest.raises(EpochFault):
        faults.retry_with_backoff(fenced, attempts=5, base_delay_s=0.0)
    assert calls["n"] == 1


def test_epoch_fence_is_an_instrumented_site():
    with faults.inject_faults("epoch-fence", count=1) as plan:
        with pytest.raises(EpochFault):
            psync.check_epoch(psync.world_epoch())
    assert plan.fired == 1 and "epoch-fence" in faults.INSTRUMENTED_SITES
    # and the protocol reaches it: one injected fence trip fails a sync, which stays retryable
    m = tmt.SumMetric(device="cpu")
    m.update(torch.tensor([1.0]))
    with faults.inject_faults("epoch-fence", count=1) as plan:
        with pytest.raises(EpochFault):
            m.sync(distributed_available=DIST_ON)
    assert plan.fired == 1 and not m._is_synced


def test_mid_sync_membership_change_fences_the_retry(monkeypatch):
    monkeypatch.setenv("METRICS_TPU_SYNC_RETRIES", "1")
    m = tmt.MeanMetric(device="cpu")
    m.update(torch.tensor([2.0, 4.0]))
    before = dict(m.metric_state)
    calls = {"n": 0}

    def flaky(x, group):
        calls["n"] += 1
        if calls["n"] == 1:
            psync.bump_epoch("peer-died-mid-sync")
            raise RuntimeError("transport reset by membership change")
        return x[None]

    monkeypatch.setattr(bucketing, "_payload_allgather", flaky)
    s0 = collective_stats()
    with pytest.raises(EpochFault):
        m.sync(distributed_available=DIST_ON)
    s1 = collective_stats()
    assert s1["sync_epoch_fence_trips"] - s0["sync_epoch_fence_trips"] == 1
    assert s1["sync_stale_collectives"] == s0["sync_stale_collectives"] == 0
    assert calls["n"] == 1 and not m._is_synced
    assert all(getattr(m, k) is v for k, v in before.items())
    m.sync(distributed_available=DIST_ON)
    m.unsync()
    assert float(m.compute()) == 3.0


def _normalise(h, e0):
    """``world_health()`` with its monotonic steps replaced by their rank among the steps it holds, and
    its epochs counted from ``e0`` (each package's epoch is monotonic over the process's life)."""
    h = copy.deepcopy(h)
    h.pop("live_world")
    h["epoch"] -= e0
    for t in h["transitions"]:
        t["epoch"] -= e0
    for rec in h["peers"].values():
        for key in ("declared_dead_epoch", "rejoined_epoch", "last_good_epoch"):
            if key in rec:
                rec[key] -= e0
    steps = sorted({t["step"] for t in h["transitions"]} | ({h["last_good_sync_step"]} - {None}))
    rank = {s: i for i, s in enumerate(steps)}
    for t in h["transitions"]:
        t["step"] = rank[t["step"]]
    if h["last_good_sync_step"] is not None:
        h["last_good_sync_step"] = rank[h["last_good_sync_step"]]
    return h


REGISTRY_SEQUENCES = {
    "timeouts_then_success": [("expect", 3), ("timeout",), ("timeout",), ("success", 3)],
    "kth_timeout_declares_dead": [("env", "2"), ("expect", 3), ("prober", [2]), ("timeout",), ("timeout",)],
    "no_prober_no_change": [("env", "1"), ("expect", 2), ("timeout",), ("timeout",)],
    "rejoin_clears_dead": [("expect", 2), ("dead", 1), ("rejoin", 1)],
    "observed_world_promoted_at_death": [("success", 4), ("dead", 3), ("dead", 3), ("subgroup_success",)],
    "broken_prober_keeps_timeout": [("env", "1"), ("expect", 3), ("prober", "raise"), ("timeout",)],
}


@pytest.mark.parametrize("name", sorted(REGISTRY_SEQUENCES))
def test_registry_sequence_matches_the_reference(name, monkeypatch):
    healths = []
    for mod in (psync, jsync):
        mod.reset_membership()
        e0 = mod.world_epoch()
        for step in REGISTRY_SEQUENCES[name]:
            op = step[0]
            if op == "env":
                monkeypatch.setenv("METRICS_TPU_SYNC_DEAD_AFTER", step[1])
            elif op == "expect":
                mod.set_expected_world(step[1])
            elif op == "prober":
                mod.set_peer_prober((lambda r=step[1]: r) if step[1] != "raise" else (lambda: 1 / 0))
            elif op == "timeout":
                mod.note_sync_timeout("sync-gather")
            elif op == "success":
                mod.note_sync_success(world=step[1])
            elif op == "subgroup_success":
                mod.note_sync_success(members=mod.surviving_members())
            elif op == "dead":
                mod.mark_peer_dead(step[1], reason="operator")
            elif op == "rejoin":
                mod.rejoin_rank(step[1])
        healths.append((_normalise(mod.world_health(), e0), mod.surviving_members(), mod.effective_world_size()))
        monkeypatch.delenv("METRICS_TPU_SYNC_DEAD_AFTER", raising=False)
    assert healths[0] == healths[1]


# -------------------------------------------------------------- the quorum
def _ranks(pkg, n=3):
    out = []
    for r in range(n):
        m = jmt.MeanMetric() if pkg == "jax" else tmt.MeanMetric(device="cpu")
        v = np.asarray([1.0 + 2 * r, 3.0 + 2 * r], np.float32)
        m.update(jnp.asarray(v) if pkg == "jax" else torch.from_numpy(v))
        out.append(m)
    return out


def _quorum_env(monkeypatch, retries="1"):
    monkeypatch.setenv("METRICS_TPU_SYNC_DEADLINE_MS", DEADLINE_MS)
    monkeypatch.setenv("METRICS_TPU_SYNC_DEGRADED", "quorum")
    monkeypatch.setenv("METRICS_TPU_SYNC_RETRIES", retries)
    monkeypatch.setenv("METRICS_TPU_SYNC_DEAD_AFTER", "2")


def _jax_quorum_value(monkeypatch):
    """The JAX package's quorum serve and its rejoined full-world value, on the same data."""
    monkeypatch.setattr(jmetric_mod, "_dist_available", lambda: True)
    jfaults.set_recovery_policy(steps=1)
    ranks = _ranks("jax")
    jsync.set_expected_world(3)
    jsync.set_peer_prober(lambda: [2])
    world = jax_elastic_world(monkeypatch, [jbucketing.tree_nodes(m) for m in ranks], dead_rank=2)
    with pytest.warns(UserWarning, match="QUORUM"):
        quorum = np.asarray(ranks[0].compute())
    world.revive()
    jsync.rejoin_rank(2)
    ranks[0]._computed = None
    return quorum, np.asarray(ranks[0].compute())


def test_quorum_merge_bit_exact_vs_survivor_oracle(monkeypatch):
    _quorum_env(monkeypatch)
    _live_world(monkeypatch, 3)
    faults.set_recovery_policy(steps=1)
    ranks = _ranks("port")
    surv = [copy.deepcopy(ranks[r]) for r in (0, 1)]
    surv[0].sync(dist_sync_fn=TorchFakeGather(surv), distributed_available=DIST_ON)
    quorum_oracle = surv[0].compute()
    full = [copy.deepcopy(m) for m in ranks]
    full[0].sync(dist_sync_fn=TorchFakeGather(full), distributed_available=DIST_ON)
    full_oracle = full[0].compute()

    psync.set_expected_world(3)
    psync.set_peer_prober(lambda: [2])
    world = ElasticWorld(monkeypatch, ranks[1:])
    m = ranks[0]
    s0 = collective_stats()
    with pytest.warns(UserWarning, match="QUORUM"):
        got = m.compute()
    assert torch.equal(got, quorum_oracle) and not torch.equal(got, full_oracle)
    s1 = collective_stats()
    assert s1["sync_quorum_serves"] - s0["sync_quorum_serves"] == 1 and s1["sync_stale_collectives"] == 0
    health = m.sync_health()
    assert health["degraded"] and health["degraded_tier"] == "quorum" and health["quorum_serves"] == 1
    assert health["last_good_sync_step"] is None and health["degraded_since_step"] is not None
    assert psync.world_health()["dead_ranks"] == [2]
    assert float(m.value) == 4.0

    world.revive()
    psync.rejoin_rank(2)
    m._computed = None
    got2 = m.compute()
    assert torch.equal(got2, full_oracle)
    health = m.sync_health()
    assert not health["degraded"] and health["last_good_sync_step"] is not None
    assert health["degraded_since_step"] is None and collective_stats()["sync_stale_collectives"] == 0
    ref_quorum, ref_full = _jax_quorum_value(monkeypatch)
    assert float(got) == float(ref_quorum) and float(got2) == float(ref_full)


def test_quorum_without_known_survivors_serves_local(monkeypatch):
    _quorum_env(monkeypatch, retries="0")
    _live_world(monkeypatch, 2)
    m = tmt.MeanMetric(device="cpu")
    m.update(torch.tensor([2.0, 4.0]))

    def hung(x, group):
        time.sleep(1.0)
        raise RuntimeError("abandoned hung collective")

    monkeypatch.setattr(bucketing, "_payload_allgather", hung)
    monkeypatch.setattr(bucketing, "_host_allgather", lambda vec, group: torch.stack([vec, vec]))
    s0 = collective_stats()
    with pytest.warns(UserWarning, match="QUORUM"):
        v = m.compute()
    assert float(v) == 3.0
    s1 = collective_stats()
    assert s1["sync_degraded_serves"] - s0["sync_degraded_serves"] == 1
    assert s1["sync_quorum_serves"] == s0["sync_quorum_serves"]


def test_suite_quorum_serve_and_sync_health(monkeypatch):
    _quorum_env(monkeypatch)
    _live_world(monkeypatch, 3)
    faults.set_recovery_policy(steps=1)

    def make(r, pkg="port"):
        if pkg == "jax":
            c = jmt.MetricCollection({"mean": jmt.MeanMetric(), "sum": jmt.SumMetric()})
            c.update(jnp.asarray([1.0 + 2 * r, 3.0 + 2 * r]))
        else:
            c = tmt.MetricCollection({"mean": tmt.MeanMetric(device="cpu"), "sum": tmt.SumMetric(device="cpu")})
            c.update(torch.tensor([1.0 + 2 * r, 3.0 + 2 * r]))
        return c

    rank_colls = [make(r) for r in range(3)]
    oracle = [copy.deepcopy(rank_colls[r]) for r in (0, 1)]
    for name, m0 in oracle[0].items(keep_base=True, copy_state=False):
        m0.sync(dist_sync_fn=TorchFakeGather([oc[name] for oc in oracle]), distributed_available=DIST_ON)
    oracle_vals = oracle[0].compute()
    psync.set_expected_world(3)
    psync.set_peer_prober(lambda: [2])
    ElasticWorld(monkeypatch, rank_colls[1:])
    suite = rank_colls[0]
    with pytest.warns(UserWarning, match="QUORUM"):
        got = suite.compute()
    for k in oracle_vals:
        assert torch.equal(got[k], oracle_vals[k])
    health = suite.sync_health()
    assert health["degraded"] and health["quorum_serves"] == 1
    assert health["world"]["dead_ranks"] == [2] and health["world"]["surviving_ranks"] == [0, 1]
    assert not any(mm._is_synced for _, mm in suite.items(keep_base=True, copy_state=False))

    # the JAX package's suite quorum serve on the same data
    monkeypatch.setattr(jmetric_mod, "_dist_available", lambda: True)
    jfaults.set_recovery_policy(steps=1)
    jcolls = [make(r, "jax") for r in range(3)]
    jsync.set_expected_world(3)
    jsync.set_peer_prober(lambda: [2])
    jax_elastic_world(monkeypatch, [[n for _, mm in c.items(keep_base=True, copy_state=False)
                                     for n in jbucketing.tree_nodes(mm)] for c in jcolls], dead_rank=2)
    with pytest.warns(UserWarning, match="QUORUM"):
        ref = jcolls[0].compute()
    assert {k: float(v) for k, v in got.items()} == {k: float(v) for k, v in ref.items()}
    ref_health = jcolls[0].sync_health()
    assert sorted(health) == sorted(ref_health) and sorted(health["world"]) == sorted(ref_health["world"])
    for key in ("degraded", "degraded_tier", "degraded_serves", "quorum_serves", "inflight"):
        assert health[key] == ref_health[key], key
    for key in ("dead_ranks", "surviving_ranks", "expected_world", "degraded", "consecutive_timeouts"):
        assert health["world"][key] == ref_health["world"][key], key


def test_subset_degraded_members_aggregate_and_order_vs_failure_log(monkeypatch):
    from metrics_tpu_torch.metric import _enter_degraded

    monkeypatch.setenv("METRICS_TPU_SYNC_DEGRADED", "local")
    coll = tmt.MetricCollection({"mean": tmt.MeanMetric(device="cpu"), "sum": tmt.SumMetric(device="cpu")})
    coll.update(torch.tensor([2.0, 4.0]))
    exc = SyncTimeoutFault("peer hung", site="sync-gather")
    faults.note_fault("sync", site="sync-gather", owner=coll["mean"], error=exc)
    fault_step = faults.fault_stats()["failure_log"][-1]["step"]
    with pytest.warns(UserWarning, match="LOCAL-ONLY"):
        _enter_degraded(coll["mean"], exc, "local")
    health = coll.sync_health()
    members = health["members"]
    assert health["degraded"] is True and members["mean"]["degraded"] and not members["sum"]["degraded"]
    assert members["sum"]["degraded_since_step"] is None
    onset = members["mean"]["degraded_since_step"]
    assert onset is not None and onset >= fault_step and faults.current_step() >= onset
    coll.sync(distributed_available=DIST_ON)
    coll.unsync()
    health = coll.sync_health()
    assert health["last_good_sync_step"] > onset
    assert health["members"]["mean"]["degraded_since_step"] is None


def test_member_counts_fold_from_failure_log_domains():
    coll = tmt.MetricCollection({"mean": tmt.MeanMetric(device="cpu")})
    coll.update(torch.tensor([1.0]))
    faults.note_fault("sync", site="sync-gather")
    faults.note_fault("journal", site="journal-load")
    counts = coll.sync_health()["members"]["mean"]["fault_domain_counts"]
    assert counts.get("sync", 0) >= 1 and counts.get("journal", 0) >= 1


# ------------------------------------------------------ barrier and rejoin
def _suite(pkg="port"):
    if pkg == "jax":
        return jmt.MetricCollection({"mean": jmt.MeanMetric()})
    return tmt.MetricCollection({"mean": tmt.MeanMetric(device="cpu")})


def test_checkpoint_barrier_stamps_epoch_and_agreed_step(tmp_path):
    from metrics_tpu.ops import journal as jjournal

    out = {}
    for pkg, jmod in (("port", journal), ("jax", jjournal)):
        coll = _suite(pkg)
        arr = torch.tensor if pkg == "port" else jnp.asarray
        coll.update(arr([1.0, 3.0]))
        path = str(tmp_path / f"{pkg}.journal")
        info = coll.checkpoint_barrier(path)
        manifest, _ = jmod.read_record(path)
        coll.update(arr([5.0]))
        info2 = coll.checkpoint_barrier(path)
        out[pkg] = (info, manifest, info2)
    info, manifest, info2 = out["port"]
    assert info["epoch"] == psync.world_epoch() and info["world_size"] == 1 and info["bytes"] > 0
    assert manifest["epoch"] == info["epoch"] and manifest["barrier_step"] == info["barrier_step"]
    assert manifest["barrier"] is True and info2["barrier_step"] > info["barrier_step"]
    ref = out["jax"]
    assert sorted(info) == sorted(ref[0])
    assert {k: manifest[k] for k in ("world_size", "barrier")} == {k: ref[1][k] for k in ("world_size", "barrier")}
    assert set(journal._META_KEYS) <= set(manifest) and set(journal._META_KEYS) <= set(ref[1])


def test_barrier_fences_on_mid_exchange_epoch_bump(tmp_path, monkeypatch):
    coll = _suite()
    coll.update(torch.tensor([1.0]))

    def bumping_exchange(vec, group):
        psync.bump_epoch("peer-died-mid-barrier")
        return vec[None]

    monkeypatch.setattr(bucketing, "_host_allgather", bumping_exchange)
    with pytest.raises(EpochFault):
        coll.checkpoint_barrier(str(tmp_path / "j"))
    assert not (tmp_path / "j").exists()


def test_rejoin_restores_journal_and_enters_next_epoch(tmp_path):
    path = str(tmp_path / "rank2.journal")
    live = _suite()
    live.update(torch.tensor([2.0, 4.0]))
    live.save_state(path)
    oracle = live.compute()
    psync.set_expected_world(3)
    psync.mark_peer_dead(2, reason="crash")
    e_dead = psync.world_epoch()
    restored = _suite()
    out = restored.rejoin(path, rank=2)
    assert out["generation"] == 0 and out["handoff"] is False
    assert out["epoch"] == e_dead + 1 == psync.world_epoch()
    assert psync.world_health()["dead_ranks"] == []
    assert sorted(out) == ["epoch", "generation", "handoff", "rank", "restored_step", "warmed_programs"]
    got = restored.compute()
    assert all(torch.equal(got[k], oracle[k]) for k in oracle)


def test_rejoin_handoff_fast_forwards_to_newer_record(tmp_path):
    path = str(tmp_path / "rank1.journal")
    live = _suite()
    live.update(torch.tensor([2.0, 4.0]))
    live.checkpoint_barrier(path)
    live.update(torch.tensor([9.0]))
    newer = journal.pack_record(
        live._journal_nodes(),
        manifest_extra={"epoch": psync.world_epoch(), "barrier_step": faults.tick(), "nodes": None},
    )
    oracle = live.compute()
    handoffs = []

    def handoff(meta):
        handoffs.append(meta)
        return newer

    restored = _suite()
    out = restored.rejoin(path, handoff=handoff, rank=1)
    assert out["handoff"] is True and handoffs and "barrier_step" in handoffs[0]
    got = restored.compute()
    assert all(torch.equal(got[k], oracle[k]) for k in oracle)
    assert journal.restored_meta(restored)["barrier_step"] == out["restored_step"]


def test_rejoin_handoff_corrupt_record_demotes_to_local_restore(tmp_path):
    path = str(tmp_path / "rank1.journal")
    live = _suite()
    live.update(torch.tensor([2.0, 4.0]))
    live.checkpoint_barrier(path)
    oracle = live.compute()
    j0 = faults.fault_stats()["fault_journal"]
    e0 = psync.world_epoch()
    restored = _suite()
    with pytest.warns(UserWarning, match="handoff record failed verification"):
        out = restored.rejoin(path, handoff=lambda meta: b"garbage-not-a-record", rank=1)
    assert out["handoff"] is False and out["epoch"] == e0 + 1
    assert faults.fault_stats()["fault_journal"] > j0
    got = restored.compute()
    assert all(torch.equal(got[k], oracle[k]) for k in oracle)


def test_rejoin_handoff_older_record_is_ignored(tmp_path):
    path = str(tmp_path / "rank1.journal")
    live = _suite()
    live.update(torch.tensor([2.0]))
    older = journal.pack_record(live._journal_nodes(), manifest_extra={"barrier_step": 0})
    live.update(torch.tensor([4.0]))
    live.checkpoint_barrier(path)
    oracle = live.compute()
    restored = _suite()
    out = restored.rejoin(path, handoff=lambda meta: older, rank=1)
    assert out["handoff"] is False
    got = restored.compute()
    assert all(torch.equal(got[k], oracle[k]) for k in oracle)


# ----------------------------------------------------------- env parsers
@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_backoff_garbage_warns_once_naming_the_value(pkg, monkeypatch):
    mod = jsync if pkg == "jax" else psync
    monkeypatch.setenv("METRICS_TPU_SYNC_BACKOFF_MS", "soonish")
    monkeypatch.setattr(mod, "_BACKOFF_WARN_OWNER", mod._EnvWarnOwner())
    with pytest.warns(UserWarning, match=r"METRICS_TPU_SYNC_BACKOFF_MS='soonish'"):
        assert mod.sync_backoff_s() == 0.05
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert mod.sync_backoff_s() == 0.05


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_degraded_tier_accepts_quorum_and_rejects_garbage(pkg, monkeypatch):
    mod = jsync if pkg == "jax" else psync
    monkeypatch.setenv("METRICS_TPU_SYNC_DEGRADED", "quorum")
    assert mod.sync_degraded_tier() == "quorum"
    monkeypatch.setenv("METRICS_TPU_SYNC_DEGRADED", "mostly")
    monkeypatch.setattr(mod, "_DEADLINE_WARN_OWNER", mod._EnvWarnOwner())
    with pytest.warns(UserWarning, match="quorum"):
        assert mod.sync_degraded_tier() is None
