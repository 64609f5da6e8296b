"""``update_many`` and ``forward_many`` in the port, against the JAX package's.

A leading steps axis on every array argument: ``update_many(p, t)`` equals
``n`` calls ``update(p[i], t[i])``, and ``forward_many`` returns the per-step
values stacked. For a metric of each family and for the headline suite, a
fixed schedule of chunks (the JAX package's ``tests/test_fuzz_batched.py``
kinds: ``forward_many``, ``update_many`` and single ``forward`` calls, with a
chunk signature seen twice so that its second chunk runs through the step
program) goes through both packages on the same numpy inputs. Integer results
equal JAX's bit for bit, floats within ``FLOAT_ATOL``/``FLOAT_RTOL``; the port's
chunked run equals its own per-call run exactly.
"""
import jax
import jax._src.core
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jmt
import metrics_tpu_torch as tmt
from metrics_tpu.utils import checks as jchecks
from metrics_tpu_torch.ops import engine
from metrics_tpu_torch.utils import checks

# float32 sums of the same values in another order on each side: a few ulps (tests/test_fuzz_batched.py
# holds the JAX package's chunked values to its sequential ones within atol 1e-6, rtol 1e-5)
FLOAT_ATOL, FLOAT_RTOL = 1e-6, 1e-5


@pytest.fixture(autouse=True)
def _first_mode(monkeypatch):
    monkeypatch.setattr(jax.core, "trace_state_clean", jax._src.core.trace_state_clean, raising=False)
    checks.set_validation_mode("first")
    jchecks.set_validation_mode("first")
    yield
    checks.set_validation_mode("first")
    jchecks.set_validation_mode("first")


def _binary(rng, n, batch):
    return rng.rand(n, batch).astype(np.float32), rng.randint(0, 2, (n, batch))


def _multiclass(rng, n, batch, c=4):
    p = rng.rand(n, batch, c).astype(np.float32)
    return p / p.sum(-1, keepdims=True), rng.randint(0, c, (n, batch))


def _regression(rng, n, batch):
    return rng.rand(n, batch).astype(np.float32), rng.rand(n, batch).astype(np.float32)


def _single(rng, n, batch):
    return (rng.rand(n, batch).astype(np.float32) * 3,)


def _images(rng, n, batch):
    return rng.rand(n, 2, 1, 8, 8).astype(np.float32), rng.rand(n, 2, 1, 8, 8).astype(np.float32)


def _audio(rng, n, batch):
    t = rng.randn(n, 2, 64).astype(np.float32)
    return (t + 0.3 * rng.randn(n, 2, 64)).astype(np.float32), t


CASES = [
    ("Accuracy", lambda pkg, **k: pkg.Accuracy(**k), _binary),
    ("F1Score", lambda pkg, **k: pkg.F1Score(num_classes=4, average="macro", **k), _multiclass),
    ("ConfusionMatrix", lambda pkg, **k: pkg.ConfusionMatrix(num_classes=4, **k), _multiclass),
    ("CalibrationError", lambda pkg, **k: pkg.CalibrationError(**k), _binary),
    ("MeanMetric", lambda pkg, **k: pkg.MeanMetric(**k), _single),
    ("MaxMetric", lambda pkg, **k: pkg.MaxMetric(**k), _single),
    ("CatMetric", lambda pkg, **k: pkg.CatMetric(**k), _single),
    ("MeanSquaredError", lambda pkg, **k: pkg.MeanSquaredError(**k), _regression),
    ("PSNR", lambda pkg, **k: pkg.PeakSignalNoiseRatio(data_range=1.0, **k), _images),
    ("SNR", lambda pkg, **k: pkg.SignalNoiseRatio(**k), _audio),
]
SCHEDULE = ("forward_many", "update_many", "forward", "forward_many", "update_many")


def _compare(got, want):
    """``got`` (the port's) against ``want`` (JAX's): integers exactly, floats within the tolerance."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _compare(got[k], want[k])
        return
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _compare(g, w)
        return
    got = got._force() if isinstance(got, engine.LazyValue) else got
    want = want._force() if hasattr(want, "_force") else want
    w, g = np.asarray(want), got.detach().cpu().numpy()
    assert g.shape == w.shape, (g.shape, w.shape)
    if np.issubdtype(w.dtype, np.integer) or w.dtype == bool:
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, atol=FLOAT_ATOL, rtol=FLOAT_RTOL, equal_nan=True)


def _exact(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _exact(got[k], want[k])
        return
    if isinstance(want, (list, tuple)):
        for g, w in zip(got, want):
            _exact(g, w)
        return
    got = got._force() if isinstance(got, engine.LazyValue) else got
    want = want._force() if isinstance(want, engine.LazyValue) else want
    assert got.dtype == want.dtype and torch.equal(got, want), (got, want)


def _run(obj, kind, arrays, conv):
    args = tuple(conv(a) for a in arrays)
    if kind == "forward":
        return obj(*tuple(a[0] for a in args))
    if kind == "forward_many":
        return obj.forward_many(*args)
    return obj.update_many(*args)


@pytest.mark.parametrize("name,factory,inputs", CASES, ids=[c[0] for c in CASES])
def test_schedule_matches_jax_and_the_per_call_run(name, factory, inputs):
    rng = np.random.RandomState(sum(map(ord, name)))
    draws = [inputs(rng, 1 if kind == "forward" else 3, 16) for kind in SCHEDULE]
    mine, ref = factory(tmt, device="cpu"), factory(jmt)
    seq = factory(tmt, device="cpu")
    for kind, arrays in zip(SCHEDULE, draws):
        got = _run(mine, kind, arrays, torch.from_numpy)
        want = _run(ref, kind, arrays, jnp.asarray)
        # the per-call oracle: the same steps one call at a time, deferral off
        engine.set_deferred_dispatch(False)
        try:
            steps = [tuple(torch.from_numpy(a[i]) for a in arrays) for i in range(arrays[0].shape[0])]
            seq_vals = [seq(*s) if kind != "update_many" else seq.update(*s) for s in steps]
        finally:
            engine.set_deferred_dispatch(True)
        if kind == "forward_many":
            _compare(got, want)
            for i, v in enumerate(seq_vals):
                _exact(got[i] if not isinstance(got, dict) else {k: x[i] for k, x in got.items()}, v)
        elif kind == "forward":
            _compare(got, want)
            _exact(got, seq_vals[0])
        else:
            assert got is None
    _compare(mine.compute(), ref.compute())
    _exact(mine.compute(), seq.compute())
    assert mine.update_count == ref._update_count == seq.update_count == 13


def _headline(pkg, c=8, **k):
    return pkg.MetricCollection({
        "acc": pkg.Accuracy(num_classes=c, average="macro", **k),
        "f1": pkg.F1Score(num_classes=c, average="macro", **k),
        "confmat": pkg.ConfusionMatrix(num_classes=c, **k),
        "precision": pkg.Precision(num_classes=c, average="macro", **k),
    })


def test_headline_suite_schedule_matches_jax():
    rng = np.random.RandomState(42)
    mine, ref, seq = _headline(tmt, device="cpu"), _headline(jmt), _headline(tmt, device="cpu")
    first = _multiclass(rng, 1, 32, 8)
    for suite, conv in ((mine, torch.from_numpy), (ref, jnp.asarray), (seq, torch.from_numpy)):
        suite.update(*(conv(a[0]) for a in first))  # every member updates: the groups are found
    for kind in SCHEDULE:
        arrays = _multiclass(rng, 1 if kind == "forward" else 3, 32, 8)
        got = _run(mine, kind, arrays, torch.from_numpy)
        want = _run(ref, kind, arrays, jnp.asarray)
        engine.set_deferred_dispatch(False)
        try:
            steps = [tuple(torch.from_numpy(a[i]) for a in arrays) for i in range(arrays[0].shape[0])]
            seq_vals = [seq(*s) if kind != "update_many" else seq.update(*s) for s in steps]
        finally:
            engine.set_deferred_dispatch(True)
        if kind == "forward_many":
            _compare(got, want)
            for i, v in enumerate(seq_vals):
                _exact({k: x[i] for k, x in got.items()}, v)
        elif kind == "forward":
            _compare(got, want)
            _exact(got, seq_vals[0])
    _compare(mine.compute(), ref.compute())
    _exact(mine.compute(), seq.compute())
    assert sorted(sorted(g) for g in mine.compute_groups.values()) == [["acc"], ["confmat"], ["f1", "precision"]]


def test_update_many_launches_the_bincount_once_a_step(monkeypatch):
    """Each compute group of the headline suite counts each step with one bincount, chunked or not:
    ConfusionMatrix its pairs, Accuracy and F1/Precision their class pairs."""
    from metrics_tpu_torch.utils import data

    calls = []
    real = data.fused_bincount
    monkeypatch.setattr(data, "fused_bincount", lambda *a, **k: calls.append(1) or real(*a, **k))
    rng = np.random.RandomState(7)
    suite = _headline(tmt, device="cpu")
    suite.update(*(torch.from_numpy(a[0]) for a in _multiclass(rng, 1, 32, 8)))
    for _ in range(2):
        suite.update_many(*(torch.from_numpy(a) for a in _multiclass(rng, 5, 32, 8)))
    # the first update (each of the 4 members), then each step of both chunks (the second the program's)
    assert len(calls) == 4 + 3 * 5 + 3 * 5


def test_chunk_errors_are_the_reference_errors():
    m = tmt.Accuracy(device="cpu")
    with pytest.raises(ValueError, match="leading steps axis"):
        m.update_many(0.5)
    with pytest.raises(ValueError, match="zero-length"):
        m.update_many(torch.zeros(0, 4), torch.zeros(0, 4, dtype=torch.int64))
    with pytest.raises(ValueError, match="same leading steps-axis"):
        m.update_many(torch.zeros(3, 4), torch.zeros(2, 4, dtype=torch.int64))


def test_many_raises_when_synced():
    m = tmt.SumMetric(device="cpu")
    m.update(torch.ones(3))
    m.sync(distributed_available=lambda: True)
    from metrics_tpu_torch.utils.exceptions import MetricsUserError

    with pytest.raises(MetricsUserError, match="synced"):
        m.update_many(torch.ones(2, 3))
    m.unsync()


def test_weight_styles_ride_the_chunk():
    """MeanMetric's weight as a stacked tensor, a 0-d tensor or a python scalar (tests/test_fuzz_batched.py:78)."""
    rng = np.random.RandomState(5)
    v = torch.from_numpy(rng.rand(4, 8).astype(np.float32))
    for w in (torch.from_numpy(rng.rand(4, 8).astype(np.float32) + 0.1), torch.tensor(0.7), 0.7):
        chunked, seq = tmt.MeanMetric(device="cpu"), tmt.MeanMetric(device="cpu")
        for _ in range(2):
            chunked.forward_many(v, weight=w)
        engine.set_deferred_dispatch(False)
        try:
            for _ in range(2):
                for i in range(4):
                    seq(v[i], weight=w[i] if isinstance(w, torch.Tensor) and w.ndim else w)
        finally:
            engine.set_deferred_dispatch(True)
        _exact(chunked.compute(), seq.compute())


def test_full_mode_runs_call_by_call_and_builds_nothing():
    checks.set_validation_mode("full")
    engine.reset_engine()
    m = tmt.Accuracy(device="cpu")
    rng = np.random.RandomState(1)
    for _ in range(2):
        m.update_many(*(torch.from_numpy(a) for a in _binary(rng, 3, 8)))
    assert engine.engine_stats()["builds"] == 0 and m.update_count == 6
