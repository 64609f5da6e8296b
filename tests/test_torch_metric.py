"""The port's ``Metric`` lifecycle: forward, accumulation, reset, clone,
state_dict, persistence, compute caching, reductions, the device rule, a
synced compute across processes, and the validation modes (held to the
JAX package's behaviour on the same inputs)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jmt
import metrics_tpu_torch as tmt
from metrics_tpu.utils import checks as jax_checks
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils import checks as torch_checks
from metrics_tpu_torch.utils.exceptions import MetricsUserError

C = 5


def _batch(seed, n=64):
    rng = np.random.RandomState(seed)
    logits = rng.randn(n, C).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)
    return probs.astype(np.float32), rng.randint(0, C, n)


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _f1(**kwargs):
    return tmt.F1Score(num_classes=C, average="macro", device="cpu", **kwargs)


class _Stats(Metric):
    """One state of each tensor reduction and one list state."""

    full_state_update = False

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("avg", torch.tensor(0.0), dist_reduce_fx="mean")
        self.add_state("hi", torch.tensor(-float("inf")), dist_reduce_fx="max")
        self.add_state("lo", torch.tensor(float("inf")), dist_reduce_fx="min")
        self.add_state("rows", [], dist_reduce_fx="cat")

    def update(self, x):
        self.total = self.total + x.sum()
        self.avg = x.mean()
        self.hi = torch.maximum(self.hi, x.max())
        self.lo = torch.minimum(self.lo, x.min())
        self.rows.append(x)

    def compute(self):
        return {"total": self.total, "avg": self.avg, "hi": self.hi, "lo": self.lo, "n": torch.cat(self.rows).numel()}


class _FullStats(_Stats):
    full_state_update = True


def test_forward_returns_batch_value_and_accumulates():
    jm, tm = jmt.F1Score(num_classes=C, average="macro"), _f1()
    for seed in range(3):
        p, t = _batch(seed)
        batch_val = tm(*_t(p, t))
        np.testing.assert_allclose(batch_val.numpy(), np.asarray(jm(jnp.asarray(p), jnp.asarray(t))), atol=1e-6)
        single = _f1()
        single.update(*_t(p, t))
        torch.testing.assert_close(batch_val, single.compute())
    np.testing.assert_allclose(tm.compute().numpy(), np.asarray(jm.compute()), atol=1e-6)
    assert tm.update_count == 3 and tm.tp.dtype == torch.int32


@pytest.mark.parametrize("cls", [_Stats, _FullStats])
def test_reductions_through_forward(cls):
    m = cls(device="cpu")
    xs = [torch.tensor([1.0, 2.0]), torch.tensor([5.0, -3.0, 4.0]), torch.tensor([0.5])]
    for x in xs:
        m(x)
    out = m.compute()
    assert float(out["total"]) == pytest.approx(9.5)
    # reduce-state forward merges "mean" states by update count; the full-state
    # forward runs update on the accumulated state, which here keeps the last batch's
    expected_avg = 0.5 if cls.full_state_update else np.mean([1.5, 2.0, 0.5])
    assert float(out["avg"]) == pytest.approx(expected_avg)
    assert float(out["hi"]) == 5.0 and float(out["lo"]) == -3.0
    assert out["n"] == 6


def test_reset_restores_defaults():
    m = _f1()
    m.update(*_t(*_batch(0)))
    assert m.update_called and int(m.tp.sum()) > 0
    m.reset()
    assert not m.update_called and m.update_count == 0
    assert int(m.tp.abs().sum()) == 0 and m.tp.dtype == torch.int32
    m.update(*_t(*_batch(1)))
    fresh = _f1()
    fresh.update(*_t(*_batch(1)))
    torch.testing.assert_close(m.compute(), fresh.compute())


def test_reset_never_aliases_the_default():
    m = _Stats(device="cpu")
    m.update(torch.tensor([1.0]))
    m.reset()
    m.total += 7.0  # a write into the state must not reach the default
    m.reset()
    assert float(m.total) == 0.0


def test_clone_is_independent():
    m = _f1()
    m.update(*_t(*_batch(0)))
    c = m.clone()
    before = m.compute().clone()
    c.update(*_t(*_batch(1)))
    assert c.update_count == 2 and m.update_count == 1
    torch.testing.assert_close(m.compute(), before)
    assert not torch.equal(c.tp, m.tp)
    # the clone's wrapped update drives the clone, not the original
    c.reset()
    assert m.update_count == 1 and int(m.tp.sum()) > 0


def test_state_dict_persistence_and_round_trip():
    m = _f1()
    m.update(*_t(*_batch(0)))
    assert m.state_dict() == {}  # states are not persistent by default, as in the JAX package
    m.persistent(True)
    sd = m.state_dict()
    assert sorted(sd) == ["fn", "fp", "tn", "tp"]
    assert all(v.dtype == torch.int32 for v in sd.values())
    restored = _f1()
    restored.persistent(True)
    restored.load_state_dict(sd)
    for name in ("tp", "fp", "tn", "fn"):
        assert torch.equal(getattr(restored, name), getattr(m, name))
    restored._update_count = m.update_count
    torch.testing.assert_close(restored.compute(), m.compute())
    sd["tp"] += 1  # the loaded state is a copy
    assert not torch.equal(restored.tp, sd["tp"])


def test_load_state_dict_strict_missing_key():
    m = _f1()
    m.persistent(True)
    with pytest.raises(RuntimeError, match="Missing key"):
        m.load_state_dict({"tp": torch.zeros(C, dtype=torch.int32)})
    m.load_state_dict({"tp": torch.ones(C, dtype=torch.int32)}, strict=False)
    assert int(m.tp.sum()) == C


def test_compute_is_cached_until_the_next_update():
    m = _f1()
    m.update(*_t(*_batch(0)))
    first = m.compute()
    assert m.compute() is first
    m.update(*_t(*_batch(1)))
    assert m.compute() is not first


def test_compute_before_update_warns():
    with pytest.warns(UserWarning, match="before the ``update``"):
        _f1().compute()


def test_to_moves_states_and_casts_only_floats():
    m = _Stats(device="cpu")
    m.update(torch.tensor([1.0, 2.0]))
    m.double()
    assert m.total.dtype == torch.float64 and m._defaults["total"].dtype == torch.float64
    assert m.rows[0].dtype == torch.float64
    f1 = _f1().to("cpu").double()
    assert f1.tp.dtype == torch.int32 and f1.device == torch.device("cpu")


def test_no_device_means_cuda_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MetricsUserError, match="device='cpu'"):
        tmt.Accuracy()
    with pytest.raises(MetricsUserError):
        tmt.ConfusionMatrix(num_classes=3)
    assert tmt.Accuracy(device="cpu").device == torch.device("cpu")


def test_compute_syncs_in_a_multi_process_world(monkeypatch):
    from tests.helpers.torch_sync import TorchFakeGather

    m, other, both = _f1(), _f1(), _f1()
    p, t = _t(*_batch(0))
    other.update(*_t(*_batch(1)))
    for batch in (0, 0, 1):
        both.update(*_t(*_batch(batch)))
    want = both.compute()  # one process fed every batch of both ranks
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: 2)
    m(p, t)  # forward's batch value is local by definition
    m.update(p, t)
    local_tp = m.tp
    m.dist_sync_fn = TorchFakeGather([m, other])
    assert torch.equal(m.compute(), want)
    assert not m._is_synced and m.tp is local_tp  # the local states are back
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: 1)
    m.update(p, t)
    assert torch.isfinite(m.compute())


def test_unexpected_kwargs_and_const_attributes():
    with pytest.raises(ValueError, match="Unexpected keyword"):
        tmt.Accuracy(device="cpu", compute_on_step=True)
    m = _f1()
    with pytest.raises(RuntimeError, match="const"):
        m.higher_is_better = False


def test_filter_kwargs():
    assert _f1()._filter_kwargs(preds=1, target=2, other=3) == {"preds": 1, "target": 2}


def test_failed_forward_keeps_the_accumulated_state():
    m = _f1()
    m.update(*_t(*_batch(0)))
    before = m.tp.clone()
    with pytest.raises(ValueError):
        m(torch.rand(4, C), torch.tensor([0.0, 1.0, 2.0, 3.0]))  # float target
    assert torch.equal(m.tp, before) and m.update_count == 1


@pytest.fixture
def _restore_modes():
    jax_prev, torch_prev = jax_checks._get_validation_mode(), torch_checks._get_validation_mode()
    yield
    jax_checks.set_validation_mode(jax_prev)
    torch_checks.set_validation_mode(torch_prev)


@pytest.mark.parametrize("mode", ["full", "first", "off"])
def test_validation_modes_match_jax(mode, _restore_modes):
    """A bad batch after a good one of the same signature: "full" raises, "first" and "off" do not."""
    jax_checks.set_validation_mode(mode)
    torch_checks.set_validation_mode(mode)
    good_p, good_t = _batch(0, n=8)
    bad_t = good_t.copy()
    bad_t[0] = C + 3  # label out of range
    outcomes = []
    for pkg, arr in ((jmt, jnp.asarray), (tmt, torch.from_numpy)):
        kwargs = {} if pkg is jmt else {"device": "cpu"}
        m = pkg.Accuracy(num_classes=C, average="macro", **kwargs)
        m.update(arr(good_p), arr(good_t))
        try:
            m.update(arr(good_p), arr(bad_t))
            outcomes.append("accepted")
        except ValueError:
            outcomes.append("raised")
    assert outcomes[0] == outcomes[1] == ("raised" if mode == "full" else "accepted")


def test_first_mode_checks_each_new_instance(_restore_modes):
    torch_checks.set_validation_mode("first")
    p, t = _batch(0, n=8)
    tmt.Accuracy(num_classes=C, average="macro", device="cpu").update(*_t(p, t))
    bad_t = t.copy()
    bad_t[0] = -5
    with pytest.raises(ValueError):
        tmt.Accuracy(num_classes=C, average="macro", device="cpu").update(*_t(p, bad_t))


def test_validation_mode_rejects_unknown():
    with pytest.raises(ValueError):
        torch_checks.set_validation_mode("sometimes")
