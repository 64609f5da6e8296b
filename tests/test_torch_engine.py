"""The port's dispatch engine (``metrics_tpu_torch/ops/engine.py``) against the JAX package's.

Config fingerprints (hyperparameters by value, arrays by content, children
recursed), the program cache (a second instance of one configuration builds
nothing; the LRU of 256), ``pow2_chunks`` against JAX's, the deferral knobs
and their environment names, the device probe's counting, and the engine's
snapshot keys against JAX's. Then the behaviours the JAX package pins on its
single-step tiers, which hold for the port's eager step: a ``compute()`` value
survives later steps, the default states survive ``reset()``, and a cached
program keeps no instance alive. Exact comparisons throughout.
"""
import gc
import weakref

import jax
import jax._src.core
import numpy as np
import pytest
import torch

import metrics_tpu as jmt
import metrics_tpu_torch as tmt
from metrics_tpu.ops import engine as jengine
from metrics_tpu_torch.ops import engine, telemetry
from metrics_tpu_torch.utils import checks


@pytest.fixture(autouse=True)
def _reference_runs(monkeypatch):
    """jax 0.9 no longer exports ``jax.core.trace_state_clean``, which the JAX engine calls;
    this file's copy of it lets the reference run. Validation mode "first", deferral on,
    the probe off, and the engine's knobs put back after."""
    monkeypatch.setattr(jax.core, "trace_state_clean", jax._src.core.trace_state_clean, raising=False)
    checks.set_validation_mode("first")
    engine.set_deferred_dispatch(True, max_pending=128, max_age_ms=250)
    yield
    engine.set_device_probe(0)
    engine.set_deferred_dispatch(True, max_pending=128, max_age_ms=250)
    checks.set_validation_mode("first")


RNG = np.random.RandomState(3)
P = RNG.rand(32).astype(np.float32)
T = RNG.randint(0, 2, 32)


def _pt():
    return torch.from_numpy(P), torch.from_numpy(T)


# ------------------------------------------------------------ fingerprints
def test_same_configuration_same_fingerprint_and_a_hyperparameter_changes_it():
    a, b = tmt.Accuracy(device="cpu"), tmt.Accuracy(device="cpu")
    assert engine.config_fingerprint(a) == engine.config_fingerprint(b)
    b.threshold = 0.7
    assert engine.config_fingerprint(a) != engine.config_fingerprint(b)
    assert engine.config_fingerprint(tmt.F1Score(num_classes=3, device="cpu")) != engine.config_fingerprint(
        tmt.F1Score(num_classes=4, device="cpu"))


@pytest.mark.parametrize("make", [
    lambda n: np.arange(n, dtype=np.float32) / n,
    lambda n: torch.arange(n, dtype=torch.float32) / n,
], ids=["numpy", "torch"])
def test_long_array_hyperparameters_fingerprint_by_content(make):
    """A repr truncates arrays past 1000 elements: two that differ only in the middle must differ."""
    a, b = make(5000), make(5000)
    b[2500] = 0.123
    assert engine._value_digest(a) != engine._value_digest(b)
    assert engine._value_digest(a) == engine._value_digest(make(5000))
    # the JAX package digests numpy arrays the same way
    assert jengine._value_digest(np.asarray(a)) == engine._value_digest(np.asarray(a))


@pytest.mark.parametrize("value", [0.5, 3, "macro", None, (1, 2.0, "x"), [1, [2, [3, [4]]]], {"b": 1, "a": 2.5}],
                         ids=str)
def test_scalar_and_container_digests_equal_the_reference(value):
    assert engine._value_digest(value) == jengine._value_digest(value)


def test_enum_digests_as_its_value():
    from metrics_tpu_torch.utils.enums import AverageMethod

    assert engine._value_digest(AverageMethod.MACRO) == engine._value_digest("macro")


def test_fingerprint_recurses_into_child_metrics():
    a = tmt.MinMaxMetric(tmt.Accuracy(device="cpu"))
    b = tmt.MinMaxMetric(tmt.Accuracy(threshold=0.7, device="cpu"))
    assert engine.config_fingerprint(a) != engine.config_fingerprint(b)
    assert engine.config_fingerprint(a) == engine.config_fingerprint(tmt.MinMaxMetric(tmt.Accuracy(device="cpu")))


# ------------------------------------------------------------ program cache
def _flush_one(m, n=3):
    p, t = _pt()
    for _ in range(n):
        m.update(p, t)
    m.compute()


def test_acquire_builds_once_and_a_second_instance_builds_nothing():
    engine.reset_engine()
    _flush_one(tmt.Accuracy(device="cpu"))
    stats = engine.engine_stats()
    assert stats["builds"] == 1 and stats["cached"] == 1 and stats["hits"] == 0
    _flush_one(tmt.Accuracy(device="cpu"))
    stats = engine.engine_stats()
    assert stats["builds"] == 1 and stats["hits"] == 1
    _flush_one(tmt.Accuracy(threshold=0.7, device="cpu"))
    assert engine.engine_stats()["builds"] == 2


def test_suite_members_and_suites_share_programs():
    engine.reset_engine()

    def suite():
        return tmt.MetricCollection({"acc": tmt.Accuracy(device="cpu"), "mean": tmt.MeanMetric(device="cpu")})

    for _ in range(2):
        s = suite()
        p, t = _pt()
        for _ in range(3):
            s.update(p, t)
        s.compute()
    stats = engine.engine_stats()
    assert stats["builds"] == 1 and stats["hits"] == 1  # one suite program, the second suite's a hit


def test_acquire_keyed_lru_holds_256():
    engine.reset_engine()
    build = lambda: (lambda state: state)  # noqa: E731
    first = engine.acquire_keyed(("lru", 0), build)
    for i in range(1, 257):
        engine.acquire_keyed(("lru", i), build)
    assert engine.engine_stats()["cached"] == 256
    assert engine.acquire_keyed(("lru", 0), build) is not first  # evicted, built again
    assert engine.engine_stats()["builds"] == 258
    engine.reset_engine()


def test_executable_counts_runs_and_signatures():
    exe = engine.acquire_keyed(("sig",), lambda: (lambda state, x, n: state + x.sum()))
    assert exe.kind == "sig" and len(exe.key_digest) == 12 and exe.probe_key == f"sig:{exe.key_digest[:8]}"
    for n in range(3):
        assert exe.run(1.0, (torch.ones(4), n)) == 5.0  # an int argument is a per-run value, not a signature
    exe(1.0, torch.ones(2, 2), 0)
    assert exe.runs == 4 and exe.compiled_signatures() == 2
    engine.reset_engine()


def test_donation_has_no_counterpart():
    assert engine.donation_supported() is False


def test_pow2_chunks_equal_the_reference():
    for n in list(range(0, 70)) + [127, 128, 129, 1000]:
        assert engine.pow2_chunks(n) == jengine.pow2_chunks(n)
        assert sum(engine.pow2_chunks(n)) == n


# ------------------------------------------------------------- deferral knobs
def test_deferral_knobs_read_the_reference_environment(monkeypatch):
    for name, env, value, want in (
        ("_defer_enabled", "METRICS_TPU_DEFER", "0", False),
        ("_defer_enabled", "METRICS_TPU_DEFER", "off", False),
        ("_defer_enabled", "METRICS_TPU_DEFER", None, True),
        ("_defer_max_pending", "METRICS_TPU_DEFER_MAX", "7", 7),
        ("_defer_max_pending", "METRICS_TPU_DEFER_MAX", "junk", 128),
        ("_defer_max_pending", "METRICS_TPU_DEFER_MAX", None, 128),
        ("_defer_max_age_s", "METRICS_TPU_DEFER_AGE_MS", "40", 0.04),
        ("_defer_max_age_s", "METRICS_TPU_DEFER_AGE_MS", None, 0.25),
    ):
        getter = {"_defer_enabled": "defer_enabled", "_defer_max_pending": "defer_max_pending",
                  "_defer_max_age_s": "defer_max_age_s"}[name]
        for mod in (engine, jengine):
            monkeypatch.setattr(mod, name, None)
            if value is None:
                monkeypatch.delenv(env, raising=False)
            else:
                monkeypatch.setenv(env, value)
            assert getattr(mod, getter)() == want, (mod.__name__, env, value)


def test_size_threshold_flushes_at_the_enqueue_that_reaches_it():
    engine.set_deferred_dispatch(True, max_pending=4)
    m = tmt.MeanMetric(device="cpu")
    x = torch.rand(8)
    m.update(x)  # validated, eager
    for _ in range(3):
        m.update(x)
    assert m._defer_pending is not None and len(m._defer_pending.entries) == 3
    m.update(x)
    assert m._defer_pending is None


def test_copied_bytes_bound_a_queue(monkeypatch):
    """A queue whose input copies reach ``QUEUE_MAX_BYTES`` flushes at that enqueue."""
    monkeypatch.setattr(engine, "QUEUE_MAX_BYTES", 3 * 8 * 4)  # three calls of 8 float32
    m = tmt.MeanMetric(device="cpu")
    x = torch.rand(8)
    m.update(x)
    m.update(x)
    m.update(x)
    assert m._defer_pending is not None and m._defer_pending.nbytes == 2 * 32
    m.update(x)
    assert m._defer_pending is None


def test_age_threshold_flushes_at_the_next_enqueue():
    engine.set_deferred_dispatch(True, max_age_ms=0)
    m = tmt.MeanMetric(device="cpu")
    x = torch.rand(8)
    m.update(x)
    m.update(x)  # a queue older than 0 ms flushes when it is enqueued into
    assert m._defer_pending is None
    engine.set_deferred_dispatch(True, max_age_ms=10_000)
    m.update(x)
    assert m._defer_pending is not None


# ------------------------------------------------------------- device probe
def test_probe_counts_every_nth_run_and_lands_the_family(monkeypatch):
    """Every 2nd run of a program (not the first run of a signature) is probed: counted in
    ``device_probes`` and observed in ``device-dispatch:<program>``."""
    telemetry.set_telemetry(True)
    engine.reset_engine()
    engine.set_device_probe(2)
    m = tmt.Accuracy(device="cpu")
    p, t = _pt()
    m.update(p, t)
    for _ in range(6):
        m.update(p, t)
        m.compute()  # a flush of one entry: one run of the program
    stats = engine.engine_stats()
    # six runs of one signature: the first is its first sight, the five after it probe at every 2nd
    assert stats["device_probes"] == 2
    exe = m._many_programs[False]
    assert telemetry.device_dispatch_stats()[exe.probe_key]["count"] == 2
    engine.set_device_probe(0)
    m.update(p, t)
    m.compute()
    assert engine.engine_stats()["device_probes"] == 2


def test_probe_env_is_the_reference_knob_and_garbage_warns(monkeypatch):
    monkeypatch.setattr(engine, "_probe_every", None)
    monkeypatch.setenv("METRICS_TPU_DEVICE_PROBE_EVERY", "3")
    assert engine.device_probe_every() == 3
    monkeypatch.setattr(engine, "_probe_every", None)
    monkeypatch.setenv("METRICS_TPU_DEVICE_PROBE_EVERY", "often")
    from metrics_tpu_torch.ops import faults

    faults.reset_warn_dedupe()
    with pytest.warns(UserWarning, match="not an integer"):
        assert engine.device_probe_every() == 0


# ---------------------------------------------------------- snapshot keys
def test_engine_stats_has_the_reference_engine_keys():
    mine, ref = engine.engine_stats(), jengine.engine_stats()
    engine_keys = {"builds", "hits", "cached", "deferred_steps", "deferred_flushes", "deferred_fallbacks",
                   "deferred_sync_barrier_flushes", "device_probes"}
    assert engine_keys <= set(mine) and engine_keys <= set(ref)
    snap = telemetry.snapshot()
    assert engine_keys <= set(snap)
    assert "program_analyses" in mine and "program_analyses" in snap and set(snap["programs"]) == set(jengine.program_summary())


def test_reset_stats_keeps_programs_and_zeroes_counters():
    _flush_one(tmt.Accuracy(device="cpu"))
    assert engine.engine_stats()["cached"] >= 1
    engine.reset_stats()
    stats = engine.engine_stats()
    assert stats["cached"] >= 1 and stats["builds"] == stats["hits"] == stats["deferred_steps"] == 0


# ------------------------------------------- single-step tier behaviours
def test_compute_result_survives_later_steps():
    """JAX `tests/bases/test_dispatch_engine.py:116`."""
    m = tmt.SumMetric(device="cpu")
    m.update(torch.ones(4))
    m.update(torch.ones(4))
    value = m.compute()
    held = value.clone()
    for _ in range(5):
        m.update(torch.ones(4))
    m.compute()
    assert torch.equal(value, held)


def test_default_states_survive_reset():
    """JAX `tests/bases/test_dispatch_engine.py:127`: a step never writes into the default."""
    m = tmt.SumMetric(device="cpu")
    default = m._defaults["value"].clone()
    for _ in range(4):
        m.update(torch.ones(4))
    m.reset()
    assert torch.equal(m._defaults["value"], default) and torch.equal(m.value, default)
    m.update(torch.ones(4))
    assert float(m.compute()) == 4.0


def test_cached_program_does_not_keep_its_acquiring_instance_alive():
    """JAX `tests/bases/test_dispatch_engine.py:232`."""
    m = tmt.Accuracy(device="cpu")
    _flush_one(m)
    assert engine.engine_stats()["cached"] >= 1
    ref = weakref.ref(m)
    del m
    gc.collect()
    assert ref() is None


def test_jax_reference_second_instance_builds_nothing_too():
    """The same contract on the JAX package, with its deferred flush (its values equal the port's)."""
    jengine.reset_engine()
    import jax.numpy as jnp

    values = []
    for _ in range(2):
        jm = jmt.Accuracy()
        for _ in range(3):
            jm.update(jnp.asarray(P), jnp.asarray(T))
        values.append(float(jm.compute()))
    builds = jengine.engine_stats()["builds"]
    jm = jmt.Accuracy()
    for _ in range(3):
        jm.update(jnp.asarray(P), jnp.asarray(T))
    jm.compute()
    assert jengine.engine_stats()["builds"] == builds
    m = tmt.Accuracy(device="cpu")
    _flush_one(m)
    assert float(m.compute()) == values[0]
