"""The port's sync failure domain against the JAX package's (``tests/parallel/test_sync_faults.py``).

Each case runs in both packages on the same numpy data: the ``sync-gather``
fault site fires inside the retried closure, so a transient failure within
``METRICS_TPU_SYNC_RETRIES`` is absorbed and one past it raises a classified
``SyncFault`` after the same number of attempts; a failed sync leaves the
local states intact and the metric retryable; ``compute()`` after a failed
sync raises instead of serving a half-synced value; a group of process
indices is range-checked against the live world at sync time
(``SyncConfigFault``, never retried). The environment knobs parse alike in
both packages, warning once on a value that does not parse. Then
``compute_on_cpu``: the rows move to host memory after each update, the
values equal JAX's, the ``host-offload`` site demotes the ``host`` lane and
clean updates re-promote it as JAX's do, and ``forward`` computes its batch
value with the offload off. Exact comparisons, as the JAX tests make them.
"""
import jax
import jax._src.core
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jmt
import metrics_tpu_torch as tmt
from metrics_tpu.ops import faults as jfaults
from metrics_tpu.parallel import sync as jsync
from metrics_tpu_torch.ops import faults
from metrics_tpu_torch.parallel import sync as psync
from metrics_tpu_torch.utils.exceptions import SyncConfigFault, SyncFault
from metrics_tpu.utils.exceptions import SyncConfigFault as JSyncConfigFault
from metrics_tpu.utils.exceptions import SyncFault as JSyncFault

DIST_ON = lambda: True  # noqa: E731


@pytest.fixture(autouse=True)
def _reference_runs(monkeypatch):
    """jax 0.9 no longer exports ``jax.core.trace_state_clean``, which the JAX
    package's engine calls; this test's copy of it lets the reference run.
    Retries back off by 0 ms in both packages."""
    monkeypatch.setattr(jax.core, "trace_state_clean", jax._src.core.trace_state_clean, raising=False)
    monkeypatch.setenv("METRICS_TPU_SYNC_BACKOFF_MS", "0")
    yield


PKGS = {
    "jax": (jmt, jfaults, jsync, jnp.asarray, JSyncFault, JSyncConfigFault, {}),
    "port": (tmt, faults, psync, torch.tensor, SyncFault, SyncConfigFault, {"device": "cpu"}),
}


# ------------------------------------------------------------- retry ladder
@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_transient_failure_retries_and_succeeds(pkg):
    _, fmod, smod, arr, _, _, _ = PKGS[pkg]
    x = arr(np.arange(4.0, dtype=np.float32))
    with fmod.inject_faults("sync-gather", count=1) as plan:
        out = smod.gather_all_tensors(x)
    assert plan.fired == 1 and len(out) == 1
    np.testing.assert_array_equal(np.asarray(out[0]), np.arange(4.0, dtype=np.float32))


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_budget_exhaustion_raises_classified_sync_fault(pkg):
    _, fmod, smod, arr, sync_fault, _, _ = PKGS[pkg]
    n_attempts = smod.sync_retries() + 1
    assert n_attempts == 3  # a world of one: two retries
    before = faults.fault_stats()["fault_sync"] if pkg == "port" else None
    with fmod.inject_faults("sync-gather", count=n_attempts + 5) as plan:
        with pytest.raises(sync_fault):
            smod.gather_all_tensors(arr(np.arange(3.0, dtype=np.float32)))
    assert plan.fired == n_attempts  # one failure an attempt, then the raise
    if pkg == "port":
        assert faults.fault_stats()["fault_sync"] - before == n_attempts


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_retry_knobs_read_from_env(pkg, monkeypatch):
    _, fmod, smod, arr, sync_fault, _, _ = PKGS[pkg]
    monkeypatch.setenv("METRICS_TPU_SYNC_RETRIES", "0")
    monkeypatch.setenv("METRICS_TPU_SYNC_BACKOFF_MS", "125")
    assert smod.sync_retries() == 0 and smod.sync_backoff_s() == 0.125
    with fmod.inject_faults("sync-gather", count=1) as plan:
        with pytest.raises(sync_fault):
            smod.gather_all_tensors(arr(np.arange(2.0, dtype=np.float32)))
    assert plan.fired == 1


# ------------------------------------------------------- state stays intact
@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_failed_sync_is_retryable(pkg):
    mod, fmod, _, arr, sync_fault, _, dev = PKGS[pkg]
    m = mod.MeanMetric(**dev)
    m.update(arr(np.asarray([2.0, 4.0], np.float32)))
    with fmod.inject_faults("sync-gather", count=100):
        with pytest.raises(sync_fault):
            m.sync(distributed_available=DIST_ON)
    assert m._is_synced is False and m._cache is None
    assert float(np.asarray(m.value)) == 6.0
    m.sync(distributed_available=DIST_ON)
    assert m._is_synced is True
    m.unsync()
    assert float(m.compute()) == 3.0


def test_failed_sync_mid_state_restores_every_state():
    m = tmt.MeanMetric(device="cpu")
    m.update(torch.tensor([1.0, 3.0]))
    before = {k: v for k, v in m.metric_state.items()}
    calls = {"n": 0}

    def flaky_gather(x, group=None):
        calls["n"] += 1
        if calls["n"] == 2:
            raise SyncFault("second state gather died", site="sync-gather")
        return [x * 2]

    with pytest.raises(SyncFault):
        m.sync(dist_sync_fn=flaky_gather, distributed_available=DIST_ON)
    for k, v in before.items():
        assert getattr(m, k) is v
    assert m._is_synced is False


def test_compute_after_failed_sync_raises_classified(monkeypatch):
    m = tmt.MeanMetric(device="cpu")
    m.update(torch.tensor([2.0, 4.0]))
    monkeypatch.setattr(psync, "_live", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: 2)
    with faults.inject_faults("sync-gather", count=100):
        with pytest.raises(SyncFault):
            m.compute()
    monkeypatch.undo()
    assert m._computed is None and m._is_synced is False
    assert float(m.compute()) == 3.0


# --------------------------------------------------- the live world's size
@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_deferred_range_check_enforced_at_sync(pkg):
    """JAX takes the group at construction and checks it at sync; the port's
    metrics take a ``ProcessGroup``, and a list of indices at sync (the quorum
    tier's survivors): both check it against the live world there."""
    mod, _, _, arr, _, config_fault, dev = PKGS[pkg]
    if pkg == "jax":
        m = mod.SumMetric(process_group=[3])
        m.update(arr(np.asarray([1.0], np.float32)))
        sync = lambda: m.sync(distributed_available=DIST_ON)  # noqa: E731
    else:
        m = mod.SumMetric(**dev)
        m.update(arr([1.0]))
        sync = lambda: m.sync(process_group=[3], distributed_available=DIST_ON)  # noqa: E731
    with pytest.raises(config_fault, match="out of range"):
        sync()
    assert issubclass(config_fault, ValueError)
    assert m._is_synced is False
    assert float(m.compute()) == 1.0


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_validate_group_live_passthrough_and_classify(pkg):
    _, _, smod, _, _, config_fault, _ = PKGS[pkg]
    assert smod.validate_group_live(None) is None
    assert smod.validate_group_live([0]) == [0]
    with pytest.raises(config_fault):
        smod.validate_group_live([0, 1])
    with pytest.raises(config_fault, match="iterable of process indices"):
        smod.validate_group_live(123)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_config_faults_are_not_retried(pkg):
    _, fmod, smod, arr, _, config_fault, _ = PKGS[pkg]
    stats = fmod.fault_stats
    s0 = stats()["fault_sync"]
    with pytest.raises(config_fault):
        smod.gather_all_tensors(arr(np.zeros(2, np.float32)), group=[5])
    assert stats()["fault_sync"] == s0 + 1


# ------------------------------------------------------------ the knobs
KNOB_CASES = [
    ("sync_retries", "METRICS_TPU_SYNC_RETRIES", v) for v in (None, "", "0", "4", "-3", "many")
] + [
    ("sync_backoff_s", "METRICS_TPU_SYNC_BACKOFF_MS", v) for v in (None, "0", "12.5", "-1", "soonish")
] + [
    ("sync_deadline_s", "METRICS_TPU_SYNC_DEADLINE_MS", v) for v in (None, "150", "0", "-5", "soon")
] + [
    ("sync_dead_after", "METRICS_TPU_SYNC_DEAD_AFTER", v) for v in (None, "1", "0", "5", "never")
] + [
    ("sync_degraded_tier", "METRICS_TPU_SYNC_DEGRADED", v) for v in (None, "local", " QUORUM ", "off", "mostly")
] + [
    ("sync_quant_tier", "METRICS_TPU_SYNC_QUANT", v) for v in (None, "bf16", "INT8", "false", "fp4")
] + [
    ("sync_hier_node_size", "METRICS_TPU_SYNC_HIER", v) for v in (None, "1", "2", "8", "x")
]


@pytest.mark.parametrize("fn, env, value", KNOB_CASES)
def test_knobs_parse_like_the_reference(fn, env, value, monkeypatch):
    if value is None:
        monkeypatch.delenv(env, raising=False)
    else:
        monkeypatch.setenv(env, value)
    for mod in (psync, jsync):  # fresh warn-once anchors: both packages warn here
        for name in ("_RETRIES_WARN_OWNER", "_BACKOFF_WARN_OWNER", "_DEADLINE_WARN_OWNER", "_MEMBERSHIP_WARN_OWNER",
                     "_QUANT_WARN_OWNER", "_HIER_WARN_OWNER"):
            monkeypatch.setattr(mod, name, mod._EnvWarnOwner())
    with _warnings() as mine_w:
        mine = getattr(psync, fn)()
    with _warnings() as ref_w:
        ref = getattr(jsync, fn)()
    assert mine == ref
    assert [str(w.message).split(" [fault domain")[0] for w in mine_w] == [
        str(w.message).split(" [fault domain")[0] for w in ref_w]


def _warnings():
    import warnings

    class _Record(warnings.catch_warnings):
        def __init__(self):
            super().__init__(record=True)

        def __enter__(self):
            out = super().__enter__()
            warnings.simplefilter("always")
            return out

    return _Record()


# -------------------------------------------------------------- compute_on_cpu
def _ap_batches():
    rng = np.random.RandomState(0)
    preds = rng.rand(64).astype(np.float32)
    target = (rng.rand(64) > 0.5).astype(np.int64)
    return [(preds[sl], target[sl]) for sl in (slice(0, 32), slice(32, 64))]


def test_compute_on_cpu_offloads_list_states():
    """The JAX package's ``test_compute_on_cpu_offloads_list_states``, both packages."""
    mine, regular, ref = (tmt.AveragePrecision(compute_on_cpu=True, device="cpu"), tmt.AveragePrecision(device="cpu"),
                          jmt.AveragePrecision(compute_on_cpu=True))
    for p, t in _ap_batches():
        mine.update(torch.from_numpy(p), torch.from_numpy(t))
        regular.update(torch.from_numpy(p), torch.from_numpy(t))
        ref.update(jnp.asarray(p), jnp.asarray(t))
    assert all(v.device.type == "cpu" for v in mine.preds) and len(mine.preds) == len(ref.preds) == 2
    assert all(isinstance(v, np.ndarray) for v in ref.preds)
    assert float(mine.compute()) == float(regular.compute())
    np.testing.assert_allclose(float(mine.compute()), float(ref.compute()), atol=1e-6)
    mine.reset()
    assert mine.preds == []
    with pytest.raises(ValueError, match="compute_on_cpu"):
        tmt.AveragePrecision(compute_on_cpu=1, device="cpu")


def test_host_offload_fault_keeps_rows_on_device_then_recovers():
    """The JAX package's ``TestHostOffloadSite``: the same sequence of updates gives the same ladder
    states and the same value in both packages."""
    rows_np = np.asarray([1.5, 2.5], np.float32)
    trace = {}
    for pkg, (mod, fmod, _, arr, _, _, dev) in PKGS.items():
        fmod.set_recovery_policy(steps=3, max_exponent=6)
        try:
            c = mod.CatMetric(compute_on_cpu=True, **dev)
            rows = arr(rows_np)
            c.update(rows)
            steps = []
            with pytest.warns(UserWarning, match="Host offload .* for `CatMetric`"):
                with fmod.inject_faults("host-offload") as plan:
                    c.update(rows)
            assert plan.fired == 1
            steps.append(c._host_offload_ok)
            for _ in range(3):
                c.update(rows)
                steps.append(c._host_offload_ok)
            c.update(rows)
            lad = c.__dict__["_fault_ladders"]["host"]
            trace[pkg] = (steps, lad.demoted, lad.threshold, list(lad.history), np.asarray(c.compute()))
            assert fmod.fault_stats()["fault_host"] >= 1
        finally:
            fmod.set_recovery_policy(steps=8, max_exponent=6)
    mine, ref = trace["port"], trace["jax"]
    assert mine[:4] == ref[:4] and mine[0] == [False, False, False, True]
    np.testing.assert_array_equal(mine[4], ref[4])


def test_host_offload_is_an_instrumented_site():
    c = tmt.CatMetric(compute_on_cpu=True, device="cpu")
    with pytest.warns(UserWarning):
        with faults.inject_faults("host-offload", count=1) as plan:
            c.update(torch.tensor([1.0]))
    assert plan.fired == 1 and faults.fault_stats()["failure_log"][-1]["site"] == "host-offload"
    assert "host-offload" in faults.INSTRUMENTED_SITES


@pytest.mark.parametrize("full_state", [True, False])
def test_forward_computes_the_batch_value_with_the_offload_off(full_state):
    """Both forward paths switch ``compute_on_cpu`` off around the batch value and back on after."""
    batches = _ap_batches()
    mine = tmt.AveragePrecision(compute_on_cpu=True, device="cpu")
    ref = jmt.AveragePrecision(compute_on_cpu=True)
    seen = []
    update = mine.update

    def spy(*args, **kwargs):
        seen.append(mine.compute_on_cpu)
        return update(*args, **kwargs)

    object.__setattr__(mine, "update", spy)
    path = "_forward_full_state_update" if full_state else "_forward_reduce_state_update"
    jpath = "_forward_full_state_update" if full_state else "_forward_reduce_state_update_eager"
    for p, t in batches:
        got = getattr(mine, path)(torch.from_numpy(p), torch.from_numpy(t))
        want = getattr(ref, jpath)(jnp.asarray(p), jnp.asarray(t))
        np.testing.assert_allclose(float(got), float(want), atol=1e-6)
    assert mine.compute_on_cpu is True and ref.compute_on_cpu is True
    assert False in seen  # the batch value's update ran with the offload off
    np.testing.assert_allclose(float(mine.compute()), float(ref.compute()), atol=1e-6)
