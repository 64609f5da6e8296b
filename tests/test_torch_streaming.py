"""The port's streaming plane (``metrics_tpu_torch/streaming.py``) against the JAX package's.

``Windowed`` (tumbling and sliding, values, closes, the journal ring and its
restore with a torn slot demoting), ``Decayed``, the module-level
``drift_report`` and the knobs, on the same numpy inputs made from a seed in
both packages. Counts bit for bit; floats within atol 1e-6 and rtol 1e-5; the
drift scores within rtol 1e-9 (both packages bin on the host in float64 and
count in integers).
"""
import warnings

import jax
import jax._src.core
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jmt
import metrics_tpu_torch as tmt
from metrics_tpu import streaming as jstreaming
from metrics_tpu.ops import engine as jengine
from metrics_tpu_torch import streaming
from metrics_tpu_torch.ops import engine, histogram
from tests.helpers.torch_sync import headline_suite, suite_batches

ATOL, RTOL = 1e-6, 1e-5


@pytest.fixture(autouse=True)
def _reference_runs(monkeypatch):
    """jax 0.9 no longer exports ``jax.core.trace_state_clean``, which the JAX engine calls; this file's
    copy of it lets the reference run. The counters of both packages start at zero."""
    monkeypatch.setattr(jax.core, "trace_state_clean", jax._src.core.trace_state_clean, raising=False)
    engine.reset_stats()
    jengine.reset_stats()
    yield


def close(mine, ref):
    if isinstance(ref, dict):
        assert set(mine) == set(ref)
        for k in ref:
            close(mine[k], ref[k])
        return
    np.testing.assert_allclose(np.asarray(torch.as_tensor(mine).cpu()), np.asarray(ref), atol=ATOL, rtol=RTOL)


STRIDES = {"tumbling": (4, None), "sliding": (4, 2)}


@pytest.mark.parametrize("kind", sorted(STRIDES))
def test_windowed_suite_equals_the_reference(kind, tmp_path):
    window, stride = STRIDES[kind]
    mine = tmt.Windowed(headline_suite(tmt), window, stride, name="w", journal_path=str(tmp_path / "w"))
    ref = jmt.Windowed(headline_suite(jmt), window, stride, name="w", journal_path=str(tmp_path / "jw"))
    for preds, target in suite_batches(3, 9):
        out = mine.update(torch.from_numpy(preds), torch.from_numpy(target))
        jout = ref.update(jnp.asarray(preds), jnp.asarray(target))
        assert (out is None) == (jout is None)
        if out is not None:
            assert (out["window"], out["slots"], out["world"]) == (jout["window"], jout["slots"], jout["world"])
            close(out["value"], jout["value"])
    assert mine.window_id == ref.window_id and mine.slots == ref.slots
    close(mine.value(), ref.value())
    restored = tmt.Windowed(headline_suite(tmt), window, stride, name="w", journal_path=str(tmp_path / "w"))
    out = restored.restore()
    assert out["slots"] == mine.slots and out["window"] == mine.window_id
    close(out["value"], ref.value())
    close(mine.value(), out["value"])  # a second read of each window: served from its cache
    stats, jstats = streaming.streaming_stats(), jstreaming.streaming_stats()
    for key in ("window_closes", "window_slots_packed", "window_slot_writes", "window_value_cache_hits"):
        assert stats[key] == jstats[key], key


def test_a_torn_slot_demotes_to_its_previous_generation(tmp_path):
    path = str(tmp_path / "m")
    mine = tmt.Windowed(tmt.MeanMetric(device="cpu"), window=2, stride=1, journal_path=path)
    ref = jmt.Windowed(jmt.MeanMetric(), window=2, stride=1, journal_path=str(tmp_path / "j"))
    for x in (1.0, 2.0, 3.0, 5.0):  # slot 1 holds window 3 (its previous generation: window 1)
        mine.update(torch.tensor([x]))
        ref.update(jnp.asarray([x]))
    with open(f"{path}.slot1", "r+b") as fh:
        fh.seek(30)
        fh.write(b"\x00\xff\x00\xff")
    fresh = tmt.Windowed(tmt.MeanMetric(device="cpu"), window=2, stride=1, journal_path=path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = fresh.restore()
    assert streaming.streaming_stats()["window_ring_demotions"] == 1
    assert out["window"] == 4 and out["slots"] == 2
    assert float(out["value"]) == 3.0  # windows 1 and 4: (1 + 5) / 2
    assert float(mine.value()) == float(ref.value()) == 4.0


def test_windowed_refuses_what_the_reference_refuses():
    for pkg, dev in ((tmt, {"device": "cpu"}), (jmt, {})):
        with pytest.raises(ValueError, match="divisor"):
            pkg.Windowed(pkg.MeanMetric(**dev), window=4, stride=3)
        with pytest.raises(ValueError, match="positive"):
            pkg.Windowed(pkg.MeanMetric(**dev), window=0)
        with pytest.raises(TypeError):
            pkg.Windowed(object(), window=2)
    assert tmt.Windowed(tmt.MeanMetric(device="cpu"), 3).value() is None


def test_windowed_drift_report_launches_the_plain_kernel_path():
    mine = tmt.Windowed(tmt.SumMetric(device="cpu"), window=4, stride=1, name="s")
    ref = jmt.Windowed(jmt.SumMetric(), window=4, stride=1, name="s")
    for x in (1.0, 2.0, 4.0, 30.0):
        mine.update(torch.tensor([x]))
        ref.update(jnp.asarray([x]))
    calls = []
    real = streaming.fused_bincount
    streaming.fused_bincount = lambda x, n: calls.append(x.device) or real(x, n)
    try:
        out = mine.drift_report(bins=4)
    finally:
        streaming.fused_bincount = real
    jout = ref.drift_report(bins=4)
    assert calls == [torch.device("cpu")] * 2
    assert {k: out[k] for k in ("bins", "n_current", "n_reference", "lo", "hi")} == \
        {k: jout[k] for k in ("bins", "n_current", "n_reference", "lo", "hi")}
    np.testing.assert_allclose([out["psi"], out["ks"]], [jout["psi"], jout["ks"]], rtol=1e-9)
    assert tmt.telemetry_snapshot()["streaming"]["drift"]["s"]["bins"] == 4


@pytest.mark.parametrize("halflife", [1.0, 2.5])
def test_decayed_equals_the_reference(halflife):
    mine = tmt.Decayed(tmt.MeanMetric(device="cpu"), halflife=halflife)
    ref = jmt.Decayed(jmt.MeanMetric(), halflife=halflife)
    rng = np.random.RandomState(4)
    for _ in range(5):
        x = rng.rand(7).astype(np.float32)
        mine.update(torch.from_numpy(x))
        ref.update(jnp.asarray(x))
    close(mine.compute(), ref.compute())
    assert mine.decay == ref.decay
    stats, jstats = streaming.streaming_stats(), jstreaming.streaming_stats()
    assert stats["window_decay_ticks"] == jstats["window_decay_ticks"] == 5
    assert stats["window_decay_layout_reuses"] == jstats["window_decay_layout_reuses"] == 4


def test_decayed_refuses_what_the_reference_refuses():
    for pkg, dev in ((tmt, {"device": "cpu"}), (jmt, {})):
        with pytest.raises(ValueError, match="sum-reduction"):
            pkg.Decayed(pkg.MaxMetric(**dev), halflife=2.0)
        with pytest.raises(ValueError, match="floating"):
            pkg.Decayed(pkg.ConfusionMatrix(num_classes=3, **dev), halflife=2.0)
        with pytest.raises(ValueError, match="positive"):
            pkg.Decayed(pkg.SumMetric(**dev), halflife=0.0)


SAMPLES = {
    "same": (np.arange(100.0), np.arange(100.0)),
    "shifted": (np.arange(100.0), np.arange(100.0) + 80.0),
    "normal": (np.random.RandomState(0).randn(500), np.random.RandomState(1).randn(400) * 1.5 + 0.3),
    "constant": (np.full(10, 3.0), np.full(7, 3.0)),
    "with_nan": (np.asarray([1.0, np.nan, 2.0, np.inf, 4.0]), np.asarray([1.0, 2.0, 2.0])),
}


@pytest.mark.parametrize("case", sorted(SAMPLES))
@pytest.mark.parametrize("bins", [None, 5])
def test_drift_report_equals_the_reference(case, bins):
    cur, ref = SAMPLES[case]
    out = tmt.drift_report(cur, torch.from_numpy(ref), bins=bins, name=f"d_{case}", device="cpu")
    jout = jmt.drift_report(cur, ref, bins=bins, name=f"d_{case}")
    for key in ("bins", "n_current", "n_reference", "lo", "hi"):
        assert out[key] == jout[key], key
    np.testing.assert_allclose([out["psi"], out["ks"]], [jout["psi"], jout["ks"]], rtol=1e-9, atol=1e-12)


def test_drift_report_needs_finite_samples_and_a_device():
    with pytest.raises(ValueError, match="non-empty finite"):
        tmt.drift_report(np.asarray([np.nan]), np.arange(3.0), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(tmt.utils.exceptions.MetricsUserError):
            tmt.drift_report(np.arange(3.0), np.arange(3.0))


KNOBS = [
    ("METRICS_TPU_WINDOW_DEFAULT_STRIDE", "window_default_stride", ("3", "-2", "junk")),
    ("METRICS_TPU_WINDOW_VALUES_KEPT", "window_values_kept", ("2", "0", "junk")),
    ("METRICS_TPU_DRIFT_BINS", "drift_bins", ("32", "1", "junk")),
    ("METRICS_TPU_DRIFT_EPS", "drift_eps", ("0.01", "-1", "junk")),
]


@pytest.mark.parametrize("env,fn,values", KNOBS, ids=[k[0] for k in KNOBS])
def test_knobs_read_as_the_reference(env, fn, values, monkeypatch):
    for value in values:
        monkeypatch.setenv(env, value)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            assert getattr(streaming, fn)() == getattr(jstreaming, fn)(), value


def test_window_values_kept_bounds_the_registry(monkeypatch):
    monkeypatch.setenv("METRICS_TPU_WINDOW_VALUES_KEPT", "2")
    win = tmt.Windowed(tmt.SumMetric(device="cpu"), window=1, name="kept")
    for x in range(5):
        win.update(torch.tensor([float(x)]))
    block = tmt.telemetry_snapshot()["streaming"]["windows"]["kept"]
    assert sorted(block["values"], key=int) == ["4", "5"] and block["values"]["5"] == {"value": 4.0}
    assert histogram.KERNEL_LAUNCHES >= 0


# ----------------------------------------------------------------- fleet close
class _FakeFleet:
    """3 identical ranks at both seams of the coalesced protocol (the agreement and layout exchange, the
    payload), as JAX's ``tests/ops/test_streaming.py`` stands them in."""

    def __init__(self, monkeypatch):
        from metrics_tpu_torch.parallel import bucketing
        from metrics_tpu_torch.parallel import sync as psync

        psync.set_expected_world(3)
        monkeypatch.setattr(bucketing, "_host_allgather", lambda vec, group: torch.stack([vec] * 3))
        monkeypatch.setattr(bucketing, "_payload_allgather", lambda packed, group: torch.stack([packed] * 3))


@pytest.fixture
def fleet(monkeypatch):
    from metrics_tpu_torch.parallel import bucketing
    from metrics_tpu_torch.parallel import sync as psync

    psync.reset_membership()
    yield _FakeFleet(monkeypatch)
    psync.reset_membership()
    bucketing._MANIFEST_CACHE.clear()


def test_a_fleet_close_is_one_payload_collective(fleet):
    from metrics_tpu_torch.parallel import sync as psync

    win = tmt.Windowed(tmt.SumMetric(device="cpu"), window=4, stride=2, name="fleet")
    win.base.update(torch.tensor([1.0, 2.0]))
    win.base.update(torch.tensor([3.0, 4.0]))
    p0 = psync.collective_stats()["sync_payload_collectives"]
    out = win.close_window(distributed_available=lambda: True)
    assert psync.collective_stats()["sync_payload_collectives"] - p0 == 1
    assert out["world"] == 3 and float(out["value"]) == 3.0 * 10.0  # three identical ranks
    assert streaming.streaming_stats()["window_close_payload_collectives"] == 1


def test_a_world_of_one_closes_with_no_collective():
    from metrics_tpu_torch.parallel import sync as psync

    win = tmt.Windowed(tmt.SumMetric(device="cpu"), window=2, stride=2)
    before = psync.collective_stats()["sync_collectives_issued"]
    win.update(torch.tensor([1.0]))
    win.update(torch.tensor([2.0]))
    assert win.window_id == 1 and psync.collective_stats()["sync_collectives_issued"] == before


def test_a_membership_change_mid_close_is_an_epoch_fault(fleet, monkeypatch):
    from metrics_tpu_torch.parallel import bucketing
    from metrics_tpu_torch.parallel import sync as psync
    from metrics_tpu_torch.utils.exceptions import EpochFault

    win = tmt.Windowed(tmt.SumMetric(device="cpu"), window=2, stride=2, name="fence")
    win.base.update(torch.tensor([5.0]))
    before = win.base.compute().clone()

    def racing(vec, group):
        psync.bump_epoch("a membership change mid-close")
        raise RuntimeError("transport interrupted by a membership change")

    monkeypatch.setattr(bucketing, "_host_allgather", racing)
    with pytest.raises(EpochFault):
        win.close_window(distributed_available=lambda: True)
    assert streaming.streaming_stats()["window_epoch_trips"] == 1
    assert win.slots == 0 and win.window_id == 0 and torch.equal(win.base.compute(), before)
    monkeypatch.setattr(bucketing, "_host_allgather", lambda vec, group: torch.stack([vec] * 3))
    out = win.close_window(distributed_available=lambda: True)
    assert out["window"] == 1 and out["epoch"] == psync.world_epoch() and float(out["value"]) == 15.0


@pytest.mark.parametrize("family", ["MeanMetric", "CatMetric", "MaxMetric"])
def test_window_families_equal_a_fresh_metric_fed_the_retained_updates(family):
    data = [np.asarray([float(i), float(i) + 0.25], np.float32) for i in range(8)]
    win = tmt.Windowed(getattr(tmt, family)(device="cpu"), window=4, stride=2)
    ref = jmt.Windowed(getattr(jmt, family)(), window=4, stride=2)
    oracle = getattr(tmt, family)(device="cpu")
    for i, x in enumerate(data):
        win.update(torch.from_numpy(x))
        ref.update(jnp.asarray(x))
        if i >= 4:
            oracle.update(torch.from_numpy(x))
    assert torch.equal(win.value(), oracle.compute())
    np.testing.assert_array_equal(win.value().numpy(), np.asarray(ref.value()))
