"""The host fast lanes and SQuAD's host buffer, against the JAX package's.

After the first validated update of a signature, an append-only metric binds
a lane: a later update of the same shapes, dtypes and device is its list
appends and one guard (the raw-row curves, retrieval, ``CatMetric``), or the
host scoring and Python sums (SQuAD, whose sums fold into the states, in one
copy, when anything observes them). The lanes hold their rows and values to
the full path's and to JAX's on the same numpy inputs: rows and integer
states bit for bit, float values within ``FLOAT_ATOL``; and they step aside
where the full path must run (validation mode ``full``, ``compute_on_cpu``,
another signature, a tensor on another device).
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
from metrics_tpu_torch.ops import telemetry
from metrics_tpu_torch.utils import checks

# float values of the two packages from the same rows: areas and means of float32 in another order
# (the JAX package's curve tests hold areas within 1e-6, its SQuAD test within 1e-6 of the oracle)
FLOAT_ATOL = 1e-6


@pytest.fixture(autouse=True)
def _first_mode(monkeypatch):
    monkeypatch.setattr(jax.core, "trace_state_clean", jax._src.core.trace_state_clean, raising=False)
    checks.set_validation_mode("first")
    jchecks.set_validation_mode("first")
    armed = telemetry.armed
    telemetry.set_telemetry(True)
    yield
    telemetry.set_telemetry(armed)
    checks.set_validation_mode("first")
    jchecks.set_validation_mode("first")


def _lane_updates(fn):
    telemetry.clear_spans()
    fn()
    return sum(r["site"] == "host-lane" for r in telemetry.spans())


def _close(got, want):
    if isinstance(want, (list, tuple)):
        for g, w in zip(got, want):
            _close(g, w)
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FLOAT_ATOL, rtol=0)


RNG = np.random.RandomState(8)
BINARY = [(RNG.rand(64).astype(np.float32), RNG.randint(0, 2, 64)) for _ in range(5)]


@pytest.mark.parametrize("name", ["AUROC", "AveragePrecision", "ROC", "PrecisionRecallCurve"])
def test_curve_lane_appends_the_rows_of_the_full_path(name):
    m = getattr(tmt, name)(pos_label=1, device="cpu")
    inputs = [tuple(torch.from_numpy(a) for a in b) for b in BINARY]
    lanes = _lane_updates(lambda: [m.update(*b) for b in inputs])
    assert lanes == len(inputs) - 1 and m._update_lane is not None
    assert all(p is b[0] and t is b[1] for p, t, b in zip(m.preds, m.target, inputs))  # the rows as they came
    checks.set_validation_mode("full")  # the oracle: the full path every call
    full = getattr(tmt, name)(pos_label=1, device="cpu")
    assert _lane_updates(lambda: [full.update(*b) for b in inputs]) == 0
    got, want = m.compute(), full.compute()
    for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        assert torch.equal(g, w)
    jm = getattr(jmt, name)(pos_label=1)
    for p, t in BINARY:
        jm.update(jnp.asarray(p), jnp.asarray(t))
    _close(got, jm.compute())


def test_curve_lane_steps_aside_for_another_signature_and_mode():
    m = tmt.AUROC(pos_label=1, device="cpu")
    p, t = (torch.from_numpy(a) for a in BINARY[0])
    m.update(p, t)
    assert _lane_updates(lambda: m.update(p[:32], t[:32])) == 0  # another shape: the full path, which binds it
    assert _lane_updates(lambda: m.update(p[:32], t[:32])) == 1
    assert _lane_updates(lambda: m.update(p, t)) == 0
    assert _lane_updates(lambda: m.update(p, t)) == 1
    checks.set_validation_mode("full")  # a mode change drops every lane
    assert _lane_updates(lambda: m.update(p, t)) == 0 and m._update_lane is None
    assert _lane_updates(lambda: m.update(p, t)) == 0  # "full" binds none
    checks.set_validation_mode("first")
    m.update(p, t)
    assert _lane_updates(lambda: m.update(p, t)) == 1
    assert _lane_updates(lambda: m.update(p.double(), t)) == 0  # another dtype
    assert m.update_count == 10


def test_lanes_are_bypassed_under_compute_on_cpu():
    m = tmt.AUROC(pos_label=1, compute_on_cpu=True, device="cpu")
    p, t = (torch.from_numpy(a) for a in BINARY[0])
    assert _lane_updates(lambda: [m.update(p, t) for _ in range(3)]) == 0
    assert m._update_lane is None


def test_retrieval_lane_against_the_full_path_and_jax():
    rng = np.random.RandomState(4)
    batches = [(rng.rand(40).astype(np.float32), rng.randint(0, 2, 40), np.repeat(np.arange(4) + 4 * i, 10))
               for i in range(4)]
    inputs = [tuple(torch.from_numpy(a) for a in b) for b in batches]
    m = tmt.RetrievalMAP(device="cpu")
    assert _lane_updates(lambda: [m.update(*b) for b in inputs]) == len(inputs) - 1
    checks.set_validation_mode("full")
    full = tmt.RetrievalMAP(device="cpu")
    for b in inputs:
        full.update(*b)
    assert torch.equal(m.compute(), full.compute())
    jm = jmt.RetrievalMAP()
    for p, t, i in batches:
        jm.update(jnp.asarray(p), jnp.asarray(t), indexes=jnp.asarray(i))
    _close(m.compute(), jm.compute())


def test_retrieval_lane_declines_keyword_indexes():
    """The JAX lane takes three positional arguments only: ``indexes=`` goes the full path."""
    rng = np.random.RandomState(5)
    p, t, i = torch.rand(20), torch.from_numpy(rng.randint(0, 2, 20)), torch.arange(20) // 5
    m = tmt.RetrievalMRR(device="cpu")
    assert _lane_updates(lambda: [m.update(p, t, indexes=i) for _ in range(3)]) == 0


@pytest.mark.parametrize("nan_strategy", ["warn", "ignore", "error", 0.5], ids=str)
def test_cat_metric_lane(nan_strategy):
    rng = np.random.RandomState(6)
    values = [rng.rand(8).astype(np.float32) for _ in range(4)]
    m = tmt.CatMetric(nan_strategy=nan_strategy, device="cpu")
    lanes = _lane_updates(lambda: [m.update(torch.from_numpy(v)) for v in values])
    assert lanes == (0 if nan_strategy == 0.5 else 3)  # a float strategy rewrites values: no lane
    jm = jmt.CatMetric(nan_strategy=nan_strategy)
    for v in values:
        jm.update(jnp.asarray(v))
    got = m.compute()
    np.testing.assert_array_equal(got.numpy(), np.asarray(jm.compute()))
    assert got.dtype == torch.float32


def test_cat_metric_lane_casts_as_the_full_path():
    m = tmt.CatMetric(device="cpu")
    m.update(torch.arange(4, dtype=torch.float64))
    assert _lane_updates(lambda: m.update(torch.arange(4, dtype=torch.float64) + 4)) == 1
    assert m.value[-1].dtype == torch.float32
    assert torch.equal(m.compute(), torch.arange(8, dtype=torch.float32))


def _squad_batches():
    rng = np.random.RandomState(9)
    words = ["alpha", "beta", "gamma", "delta", "the", "epsilon"]
    preds, target = [], []
    for i in range(24):
        answers = [" ".join(rng.choice(words, rng.randint(1, 4))) for _ in range(rng.randint(1, 3))]
        pred = answers[0] if rng.rand() < 0.5 else " ".join(rng.choice(words, 2))
        preds.append({"prediction_text": pred, "id": f"q{i}"})
        target.append({"answers": {"answer_start": [0] * len(answers), "text": answers}, "id": f"q{i}"})
    return [(preds[i:i + 6], target[i:i + 6]) for i in range(0, 24, 6)]


def test_squad_buffers_on_the_host_and_folds_once():
    batches = _squad_batches()
    m = tmt.SQuAD(device="cpu")
    copies = []
    real = torch.tensor

    def counting(*a, **k):
        copies.append(1)
        return real(*a, **k)

    torch.tensor = counting
    try:
        lanes = _lane_updates(lambda: [m.update(*b) for b in batches])
    finally:
        torch.tensor = real
    assert lanes == len(batches) - 1 and copies == []  # no tensor made: nothing copied to the device
    assert m._pending is not None and m._pending[2] == 24
    state = m.metric_state  # an observation folds the buffer
    assert m._pending is None and int(state["total"]) == 24 and state["total"].dtype == torch.int32
    jm = jmt.SQuAD()
    for p, t in batches:
        jm.update(p, t)
    got, want = m.compute(), jm.compute()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=FLOAT_ATOL, rtol=0)
    for k in ("f1_score", "exact_match"):
        assert float(getattr(m, k)) == float(np.asarray(getattr(jm, k)))  # one float32 fold of the same sums


@pytest.mark.parametrize("surface", ["state_dict", "pickle", "sync", "save_state", "reset"])
def test_squad_buffer_folds_at_every_surface(surface, tmp_path):
    import pickle

    batches = _squad_batches()
    m = tmt.SQuAD(device="cpu")
    for b in batches[:2]:
        m.update(*b)
    assert m._pending is not None
    if surface == "state_dict":
        m.persistent(True)
        assert int(m.state_dict()["total"]) == 12
    elif surface == "pickle":
        assert int(pickle.loads(pickle.dumps(m)).total) == 12
    elif surface == "sync":
        m.sync(distributed_available=lambda: True)
        assert int(m.total) == 12
        m.unsync()
    elif surface == "save_state":
        m.save_state(str(tmp_path / "j"))
        fresh = tmt.SQuAD(device="cpu")
        fresh.load_state(str(tmp_path / "j"))
        assert int(fresh.total) == 12
    else:
        m.reset()
        assert int(m.total) == 0
        return
    assert m._pending is None and int(m.total) == 12


def test_squad_lane_raises_like_the_full_path():
    m = tmt.SQuAD(device="cpu")
    b = _squad_batches()[0]
    m.update(*b)
    m.update(*b)
    with pytest.raises(Exception) as lane_err:
        m.update([{"prediction_text": "x"}], b[1])
    checks.set_validation_mode("full")
    with pytest.raises(Exception) as full_err:
        tmt.SQuAD(device="cpu").update([{"prediction_text": "x"}], b[1])
    assert type(lane_err.value) is type(full_err.value)
