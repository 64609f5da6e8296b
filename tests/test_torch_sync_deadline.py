"""The port's sync deadline and degraded tiers against the JAX package's (``tests/parallel/test_sync_deadline.py``).

The watchdog (``METRICS_TPU_SYNC_DEADLINE_MS``) turns a hung collective into
a classified ``SyncTimeoutFault`` with the local states bit for bit as they
were and the sync retryable; with ``METRICS_TPU_SYNC_DEGRADED=local``,
``compute()`` serves the local value, tagged in ``sync_health()``, and
re-promotes to the full coalesced sync after the ``sync-degrade`` lane's
recovery edge, alone and suite-wide. The world of N processes is stood in
for the protocol's collectives (``tests/helpers/torch_sync.install_world``).
The same scenarios run in the JAX package (its own fake world,
``tests/parallel/test_coalesced_sync._install_world``) and the port's
values, ``sync_health()`` and counters must equal JAX's: exact comparisons,
as the JAX tests make them.
"""
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
from metrics_tpu.ops import engine as jengine
from metrics_tpu.ops import faults as jfaults
from metrics_tpu.parallel import bucketing as jbucketing
from metrics_tpu.parallel import sync as jsync
from metrics_tpu_torch.ops import faults
from metrics_tpu_torch.parallel import bucketing, collective_stats
from metrics_tpu_torch.parallel import sync as psync
from metrics_tpu_torch.utils.exceptions import SyncConfigFault, SyncTimeoutFault
from tests.helpers.torch_sync import install_world
from tests.parallel.test_coalesced_sync import _install_world as jax_install_world

DIST_ON = lambda: True  # noqa: E731
DEADLINE_MS = "150"


@pytest.fixture(autouse=True)
def _fast_sync(monkeypatch):
    """jax 0.9 no longer exports ``jax.core.trace_state_clean``, which the JAX
    package's engine calls; this test's copy of it lets the reference run."""
    monkeypatch.setattr(jax.core, "trace_state_clean", jax._src.core.trace_state_clean, raising=False)
    monkeypatch.setenv("METRICS_TPU_SYNC_BACKOFF_MS", "0")
    monkeypatch.setenv("METRICS_TPU_SYNC_RETRIES", "0")
    yield
    for mod in (psync, jsync):
        mod.reset_membership()


def _hung(seconds: float = 1.0):
    def hung(*args):
        time.sleep(seconds)
        raise RuntimeError("abandoned hung collective (watchdog timed out long ago)")

    return hung


def _live_world(monkeypatch, n: int = 2) -> None:
    """The port's compute() syncs only in a live world of more than one process: pretend one."""
    monkeypatch.setattr(psync, "_live", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: n)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda group=None: 0)


def _mean_ranks(pkg, values):
    out = []
    for v in values:
        m = jmt.MeanMetric() if pkg == "jax" else tmt.MeanMetric(device="cpu")
        m.update(jnp.asarray(np.asarray(v, np.float32)) if pkg == "jax" else torch.tensor(v))
        out.append(m)
    return out


# ------------------------------------------------------------------ deadline
def test_default_off_is_direct_call(monkeypatch):
    monkeypatch.delenv("METRICS_TPU_SYNC_DEADLINE_MS", raising=False)
    assert psync.sync_deadline_s() is None
    s0 = collective_stats()["sync_deadline_timeouts"]
    with pytest.raises(KeyError):
        psync.run_with_deadline(lambda: {}["missing"])
    assert psync.run_with_deadline(lambda: 41 + 1) == 42
    assert collective_stats()["sync_deadline_timeouts"] == s0


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_env_garbage_warns_once_and_stays_off(pkg, monkeypatch):
    mod = jsync if pkg == "jax" else psync
    monkeypatch.setenv("METRICS_TPU_SYNC_DEADLINE_MS", "soon")
    monkeypatch.setattr(mod, "_DEADLINE_WARN_OWNER", mod._EnvWarnOwner())
    with pytest.warns(UserWarning, match="METRICS_TPU_SYNC_DEADLINE_MS"):
        assert mod.sync_deadline_s() is None
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert mod.sync_deadline_s() is None


def test_timeout_raises_classified_state_intact_retryable(monkeypatch):
    monkeypatch.setenv("METRICS_TPU_SYNC_DEADLINE_MS", DEADLINE_MS)
    values = [[1.0 + r, 3.0 + r] for r in range(2)]
    ranks = _mean_ranks("port", values)
    install_world(monkeypatch, ranks[1:])
    monkeypatch.setattr(bucketing, "_payload_allgather", _hung())
    before = {k: v for k, v in ranks[0].metric_state.items()}
    s0 = collective_stats()["sync_deadline_timeouts"]
    with pytest.raises(SyncTimeoutFault):
        ranks[0].sync(distributed_available=DIST_ON)
    assert collective_stats()["sync_deadline_timeouts"] == s0 + 1
    assert all(getattr(ranks[0], k) is v for k, v in before.items()) and not ranks[0]._is_synced
    # the transport heals: the same metric syncs, still coalesced, to the JAX package's merged value
    monkeypatch.undo()
    monkeypatch.setenv("METRICS_TPU_SYNC_BACKOFF_MS", "0")
    monkeypatch.setattr(jax.core, "trace_state_clean", jax._src.core.trace_state_clean, raising=False)
    install_world(monkeypatch, ranks[1:])
    s1 = collective_stats()["sync_coalesced_payloads"]
    ranks[0].sync(distributed_available=DIST_ON)
    assert collective_stats()["sync_coalesced_payloads"] - s1 == 1
    jranks = _mean_ranks("jax", values)
    jax_install_world(monkeypatch, [jbucketing.tree_nodes(m) for m in jranks])
    jranks[0].sync(distributed_available=DIST_ON)
    assert float(ranks[0].compute()) == float(jranks[0].compute()) == 2.5
    ranks[0].unsync()
    jranks[0].unsync()


def test_timeout_on_per_state_gather_path(monkeypatch):
    monkeypatch.setenv("METRICS_TPU_SYNC_DEADLINE_MS", DEADLINE_MS)
    monkeypatch.setattr(psync, "_gather_once", _hung())
    m = tmt.SumMetric(device="cpu")
    m.update(torch.tensor([5.0]))
    per_state = lambda x, group=None: psync.gather_all_tensors(x, group)  # noqa: E731 - not the coalesced lane
    with pytest.raises(SyncTimeoutFault):
        m.sync(dist_sync_fn=per_state, distributed_available=DIST_ON)
    assert not m._is_synced and float(m.value) == 5.0


def test_healthy_path_identical_armed_vs_disarmed(monkeypatch):
    vals = {}
    for armed in (False, True):
        if armed:
            monkeypatch.setenv("METRICS_TPU_SYNC_DEADLINE_MS", "60000")
        else:
            monkeypatch.delenv("METRICS_TPU_SYNC_DEADLINE_MS", raising=False)
        m = tmt.MeanMetric(device="cpu")
        m.update(torch.tensor([2.0, 4.0]))
        s0 = collective_stats()
        m.sync(distributed_available=DIST_ON)
        s1 = collective_stats()
        assert s1["sync_payload_collectives"] - s0["sync_payload_collectives"] == 1
        assert s1["sync_deadline_timeouts"] == s0["sync_deadline_timeouts"]
        m.unsync()
        vals[armed] = float(m.compute())
    assert vals[True] == vals[False]


# ----------------------------------------------------------- degraded tier
HEALTH_COMPARED = ("degraded", "degraded_tier", "degraded_serves", "quorum_serves", "inflight")


def _health_view(h):
    """The health keys compared by value; the step stamps are compared by whether they are set."""
    out = {k: h[k] for k in HEALTH_COMPARED}
    out.update({k: h[k] is not None for k in ("last_good_sync_step", "degraded_since_step")})
    return out


def _degrade_then_heal(pkg, monkeypatch):
    """The JAX ``test_metric_serves_local_then_promotes_to_full_sync`` scenario in one package:
    returns the served values and the health views at each step."""
    monkeypatch.setenv("METRICS_TPU_SYNC_DEADLINE_MS", DEADLINE_MS)
    monkeypatch.setenv("METRICS_TPU_SYNC_DEGRADED", "local")
    fmod = jfaults if pkg == "jax" else faults
    values = [[1.0 + 2 * r, 3.0 + 2 * r] for r in range(2)]
    ranks = _mean_ranks(pkg, values)

    def world():
        if pkg == "jax":
            monkeypatch.setattr(jmetric_mod, "_dist_available", lambda: True)
            jax_install_world(monkeypatch, [jbucketing.tree_nodes(m) for m in ranks])
        else:
            _live_world(monkeypatch)
            install_world(monkeypatch, ranks[1:])

    fmod.set_recovery_policy(steps=2)
    try:
        world()
        m = ranks[0]
        monkeypatch.setattr(jbucketing if pkg == "jax" else bucketing, "_payload_allgather", _hung())
        with pytest.warns(UserWarning, match="LOCAL-ONLY"):
            served = [float(m.compute())]
        health = [_health_view(m.sync_health())]
        local = (float(np.asarray(m.value)), float(np.asarray(m.weight)))
        monkeypatch.undo()
        monkeypatch.setattr(jax.core, "trace_state_clean", jax._src.core.trace_state_clean, raising=False)
        monkeypatch.setenv("METRICS_TPU_SYNC_BACKOFF_MS", "0")
        monkeypatch.setenv("METRICS_TPU_SYNC_RETRIES", "0")
        monkeypatch.setenv("METRICS_TPU_SYNC_DEGRADED", "local")
        world()
        for _ in range(2):
            m._computed = None
            served.append(float(m.compute()))
            health.append(_health_view(m.sync_health()))
        return served, health, local
    finally:
        fmod.set_recovery_policy(steps=8)


def test_metric_serves_local_then_promotes_to_full_sync(monkeypatch):
    s0 = collective_stats()["sync_degraded_serves"]
    mine = _degrade_then_heal("port", monkeypatch)
    assert collective_stats()["sync_degraded_serves"] == s0 + 2  # the timed-out compute, then one clean serve
    ref = _degrade_then_heal("jax", monkeypatch)
    assert mine == ref
    served, health, local = mine
    assert served == [2.0, 2.0, 3.0] and local == (4.0, 2.0)
    assert health[0]["degraded"] and health[0]["degraded_serves"] == 1 and health[0]["degraded_since_step"]
    assert not health[0]["last_good_sync_step"]
    assert not health[2]["degraded"] and health[2]["last_good_sync_step"] and not health[2]["degraded_since_step"]


def test_degraded_off_by_default_failure_raises(monkeypatch):
    monkeypatch.setenv("METRICS_TPU_SYNC_DEADLINE_MS", DEADLINE_MS)
    monkeypatch.delenv("METRICS_TPU_SYNC_DEGRADED", raising=False)
    _live_world(monkeypatch)
    m = tmt.MeanMetric(device="cpu")
    m.update(torch.tensor([2.0, 4.0]))
    monkeypatch.setattr(bucketing, "_payload_allgather", _hung())
    with pytest.raises(SyncTimeoutFault):
        m.compute()
    lad = m.__dict__.get("_fault_ladders", {}).get("sync-degrade")
    assert lad is None or not lad.demoted


def test_config_fault_never_degrades(monkeypatch):
    """A process whose states were built otherwise (a configuration fault in the port: the static
    layouts disagree) raises through the degraded tier, which stays up."""
    monkeypatch.setenv("METRICS_TPU_SYNC_DEGRADED", "local")
    _live_world(monkeypatch)
    monkeypatch.setattr(bucketing, "_MANIFEST_CACHE", {})
    m, other = tmt.MeanMetric(device="cpu"), tmt.SumMetric(device="cpu")
    m.update(torch.tensor([2.0]))
    other.update(torch.tensor([2.0]))
    install_world(monkeypatch, [other])
    with pytest.raises(SyncConfigFault):
        m.compute()
    assert not m.sync_health()["degraded"]


def _suite_degrade_then_heal(pkg, monkeypatch):
    monkeypatch.setenv("METRICS_TPU_SYNC_DEADLINE_MS", DEADLINE_MS)
    monkeypatch.setenv("METRICS_TPU_SYNC_DEGRADED", "local")
    fmod = jfaults if pkg == "jax" else faults
    if pkg == "jax":
        coll = jmt.MetricCollection({"mean": jmt.MeanMetric(), "sum": jmt.SumMetric()})
        coll.update(jnp.asarray([2.0, 4.0]))
    else:
        coll = tmt.MetricCollection({"mean": tmt.MeanMetric(device="cpu"), "sum": tmt.SumMetric(device="cpu")})
        coll.update(torch.tensor([2.0, 4.0]))

    def live():
        if pkg == "jax":
            monkeypatch.setattr(jmetric_mod, "_dist_available", lambda: True)  # a world of one that syncs
        else:
            # the port syncs only in a live world of more than one process: a second process whose
            # suite was never updated leaves the merged values the local ones, as JAX's world of one does
            _live_world(monkeypatch)
            install_world(monkeypatch, [tmt.MetricCollection({"mean": tmt.MeanMetric(device="cpu"),
                                                              "sum": tmt.SumMetric(device="cpu")})])

    fmod.set_recovery_policy(steps=1)
    try:
        live()
        monkeypatch.setattr(jbucketing if pkg == "jax" else bucketing, "_payload_allgather", _hung())
        with pytest.warns(UserWarning, match="LOCAL-ONLY"):
            first = {k: float(v) for k, v in coll.compute().items()}
        health = [coll.sync_health()]
        monkeypatch.undo()
        monkeypatch.setattr(jax.core, "trace_state_clean", jax._src.core.trace_state_clean, raising=False)
        monkeypatch.setenv("METRICS_TPU_SYNC_BACKOFF_MS", "0")
        monkeypatch.setenv("METRICS_TPU_SYNC_DEGRADED", "local")
        live()
        for _, m in coll.items(keep_base=True, copy_state=False):
            m._computed = None
        stats = (lambda: jengine.engine_stats()) if pkg == "jax" else collective_stats
        s0 = stats()["sync_payload_collectives"]
        second = {k: float(v) for k, v in coll.compute().items()}
        payloads = stats()["sync_payload_collectives"] - s0
        health.append(coll.sync_health())
        return first, second, payloads, health
    finally:
        fmod.set_recovery_policy(steps=8)


def test_collection_degrades_and_promotes_suite_wide(monkeypatch):
    mine = _suite_degrade_then_heal("port", monkeypatch)
    ref = _suite_degrade_then_heal("jax", monkeypatch)
    assert mine[:3] == ref[:3] == ({"mean": 3.0, "sum": 6.0}, {"mean": 3.0, "sum": 6.0}, 1)
    for h_mine, h_ref in zip(mine[3], ref[3]):
        assert sorted(h_mine) == sorted(h_ref)
        assert _health_view(h_mine) == _health_view(h_ref)
        assert sorted(h_mine["members"]) == sorted(h_ref["members"])
        for k in h_mine["members"]:
            assert sorted(h_mine["members"][k]) == sorted(h_ref["members"][k])
            assert _health_view(h_mine["members"][k]) == _health_view(h_ref["members"][k])
    assert mine[3][0]["degraded"] and mine[3][0]["degraded_serves"] == 1
    assert not mine[3][1]["degraded"] and mine[3][1]["last_good_sync_step"] is not None


def test_sync_health_keys_are_the_reference_keys():
    mine, ref = tmt.MeanMetric(device="cpu"), jmt.MeanMetric()
    assert sorted(mine.sync_health()) == sorted(ref.sync_health())
    assert _health_view(mine.sync_health()) == _health_view(ref.sync_health())
    assert sorted(psync.world_health()) == sorted(jsync.world_health())


# ------------------------------------------------------------- taxonomy
@pytest.mark.parametrize("exc, default", [
    (TimeoutError("peer hung"), "runtime"), (OSError(28, "No space left on device"), "runtime"),
    (IOError("disk detached"), "runtime"), (OSError("host path"), "host"),
])
def test_classify_maps_stdlib_timeout_and_oserror(exc, default):
    assert faults.classify(exc, default) == jfaults.classify(exc, default)


def test_classify_sync_timeout_fault():
    from metrics_tpu.utils.exceptions import SyncTimeoutFault as JSyncTimeoutFault

    assert faults.classify(SyncTimeoutFault("deadline", site="sync-gather")) == jfaults.classify(
        JSyncTimeoutFault("deadline", site="sync-gather")) == "sync"
    assert faults.domain_recoverable("journal") == jfaults.domain_recoverable("journal") is True


def test_timeout_folds_into_the_membership_registry(monkeypatch):
    """A watchdog timeout counts one cohort-wide suspicion, as JAX's does."""
    monkeypatch.setenv("METRICS_TPU_SYNC_DEADLINE_MS", "50")
    for mod in (psync, jsync):
        mod.set_expected_world(2)
        with pytest.raises(Exception, match="watchdog deadline"):
            mod.run_with_deadline(_hung(0.3), site="sync-gather")
    mine, ref = psync.world_health(), jsync.world_health()
    assert mine["consecutive_timeouts"] == ref["consecutive_timeouts"] == 1
    assert mine["peers"] == ref["peers"]
