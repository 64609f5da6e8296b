"""The port's ``MetricCollection`` against the JAX package: the headline suite
(Accuracy, F1Score, ConfusionMatrix, Precision, macro, as in ``bench.py``) at a
small size, its compute groups, prefix/postfix naming, and state carried
across from a JAX-accumulated suite with ``load_reference_state``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jmt
import metrics_tpu_torch as tmt
from metrics_tpu_torch.interop import load_reference_state

B, C, STEPS = 64, 8, 5


def _batches(seed=0, steps=STEPS):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        logits = rng.randn(B, C).astype(np.float32)
        probs = np.exp(logits - logits.max(axis=1, keepdims=True))
        out.append(((probs / probs.sum(axis=1, keepdims=True)).astype(np.float32), rng.randint(0, C, B)))
    return out


def _suite(pkg, **kwargs):
    dev = {} if pkg is jmt else {"device": "cpu"}
    return pkg.MetricCollection(
        {
            "acc": pkg.Accuracy(num_classes=C, average="macro", **dev),
            "f1": pkg.F1Score(num_classes=C, average="macro", **dev),
            "confmat": pkg.ConfusionMatrix(num_classes=C, **dev),
            "precision": pkg.Precision(num_classes=C, average="macro", **dev),
        },
        **kwargs,
    )


def _assert_results_equal(expected, got):
    assert sorted(expected) == sorted(got)
    for key, value in expected.items():
        e = np.asarray(value)
        g = got[key].cpu().numpy()
        assert e.shape == g.shape
        if np.issubdtype(e.dtype, np.integer):
            assert e.dtype == np.int32 and got[key].dtype == torch.int32
            np.testing.assert_array_equal(g, e)
        else:
            np.testing.assert_allclose(g, e, atol=1e-6, rtol=0)


def test_headline_suite_matches_jax():
    js, ts = _suite(jmt), _suite(tmt)
    for preds, target in _batches():
        js.update(jnp.asarray(preds), jnp.asarray(target))
        ts.update(torch.from_numpy(preds), torch.from_numpy(target))
    _assert_results_equal(js.compute(), ts.compute())


def test_headline_suite_forward_matches_jax():
    js, ts = _suite(jmt), _suite(tmt)
    for preds, target in _batches(seed=1, steps=3):
        _assert_results_equal(
            js(jnp.asarray(preds), jnp.asarray(target)), ts(torch.from_numpy(preds), torch.from_numpy(target))
        )
    _assert_results_equal(js.compute(), ts.compute())


def test_compute_groups_match_jax_and_share_state():
    js, ts = _suite(jmt), _suite(tmt)
    preds, target = _batches(steps=1)[0]
    js.update(jnp.asarray(preds), jnp.asarray(target))
    ts.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert ts.compute_groups == js.compute_groups
    groups = sorted(sorted(g) for g in ts.compute_groups.values())
    assert groups == [["acc"], ["confmat"], ["f1", "precision"]]
    # only the leader updates from here on; the member reads the leader's tensors
    for preds, target in _batches(seed=2, steps=2):
        ts.update(torch.from_numpy(preds), torch.from_numpy(target))
    members = dict(ts.items(keep_base=True, copy_state=False))
    for state in ("tp", "fp", "tn", "fn"):
        assert getattr(members["precision"], state) is getattr(members["f1"], state)
    assert members["precision"].update_count == members["f1"].update_count == 3


def test_compute_groups_off_and_pinned():
    ts = _suite(tmt, compute_groups=False)
    preds, target = _batches(steps=1)[0]
    ts.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert ts.compute_groups == {}
    pinned = _suite(tmt, compute_groups=[["f1", "precision"], ["acc"], ["confmat"]])
    pinned.update(torch.from_numpy(preds), torch.from_numpy(target))
    ref = _suite(tmt, compute_groups=False)
    ref.update(torch.from_numpy(preds), torch.from_numpy(target))
    _assert_results_equal({k: v.numpy() for k, v in ref.compute().items()}, pinned.compute())
    with pytest.raises(ValueError, match="does not match a metric"):
        _suite(tmt, compute_groups=[["f1", "nope"]])


@pytest.mark.parametrize("prefix,postfix", [("val_", None), (None, "_ep"), ("val_", "_ep")])
def test_prefix_postfix(prefix, postfix):
    js, ts = _suite(jmt, prefix=prefix, postfix=postfix), _suite(tmt, prefix=prefix, postfix=postfix)
    preds, target = _batches(steps=1)[0]
    js.update(jnp.asarray(preds), jnp.asarray(target))
    ts.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert list(ts.keys()) == list(js.keys())
    _assert_results_equal(js.compute(), ts.compute())
    clone = ts.clone(prefix="test_")
    assert all(k.startswith("test_") for k in clone.compute())


def test_list_construction_naming_and_duplicates():
    ts = tmt.MetricCollection([tmt.Accuracy(device="cpu"), tmt.Precision(device="cpu")], tmt.Recall(device="cpu"))
    assert list(ts.keys()) == ["Accuracy", "Precision", "Recall"]
    with pytest.raises(ValueError, match="two metrics both named"):
        tmt.MetricCollection([tmt.Accuracy(device="cpu"), tmt.Accuracy(device="cpu")])
    nested = tmt.MetricCollection({"a": tmt.MetricCollection([tmt.Recall(device="cpu")])})
    assert list(nested.keys()) == ["a_Recall"]
    with pytest.raises(ValueError):
        tmt.MetricCollection({"x": 3})


def test_reset_and_reuse():
    ts = _suite(tmt)
    batches = _batches(seed=4)
    for preds, target in batches:
        ts.update(torch.from_numpy(preds), torch.from_numpy(target))
    first = {k: v.clone() for k, v in ts.compute().items()}
    ts.reset()
    for preds, target in batches:
        ts.update(torch.from_numpy(preds), torch.from_numpy(target))
    _assert_results_equal({k: v.numpy() for k, v in first.items()}, ts.compute())


def test_collection_state_dict_round_trip():
    ts = _suite(tmt)
    for preds, target in _batches(seed=5, steps=2):
        ts.update(torch.from_numpy(preds), torch.from_numpy(target))
    ts.persistent(True)
    sd = ts.state_dict()
    assert "confmat.confmat" in sd and "f1.tp" in sd and "acc.correct" in sd
    restored = _suite(tmt)
    restored.persistent(True)
    restored.load_state_dict(sd)
    assert torch.equal(restored["confmat"].confmat, ts["confmat"].confmat)


def test_device_argument_moves_members():
    ts = tmt.MetricCollection([tmt.Accuracy(device="cpu")], device="cpu")
    assert ts["Accuracy"].device == torch.device("cpu")


@pytest.mark.parametrize("layout", ["nested", "flat"])
def test_load_reference_state_carries_a_jax_suite(layout):
    """Accumulate in JAX, carry the state into the port, compute the same values."""
    js = _suite(jmt)
    batches = _batches(seed=6)
    for preds, target in batches:
        js.update(jnp.asarray(preds), jnp.asarray(target))
    expected = js.compute()
    members = dict(js.items(keep_base=True))
    if layout == "nested":
        state = {name: {k: np.asarray(v) for k, v in m.metric_state.items()} for name, m in members.items()}
    else:
        js.persistent(True)
        state = js.state_dict()
    ts = _suite(tmt)
    load_reference_state(ts, state, update_count=len(batches), mode=str(members["acc"].mode.value))
    _assert_results_equal(expected, ts.compute())
    # the carried suite keeps accumulating like the JAX one
    preds, target = _batches(seed=7, steps=1)[0]
    js.update(jnp.asarray(preds), jnp.asarray(target))
    ts.update(torch.from_numpy(preds), torch.from_numpy(target))
    _assert_results_equal(js.compute(), ts.compute())


@pytest.mark.parametrize("cls_name,kwargs", [("ConfusionMatrix", {"num_classes": C}),
                                             ("Recall", {"num_classes": C, "average": "weighted"}),
                                             ("StatScores", {"reduce": "samples"})])
def test_load_reference_state_single_metric(cls_name, kwargs):
    jm = getattr(jmt, cls_name)(**kwargs)
    for preds, target in _batches(seed=8, steps=2):
        jm.update(jnp.asarray(preds), jnp.asarray(target))
    state = {k: ([np.asarray(r) for r in v] if isinstance(v, list) else np.asarray(v))
             for k, v in jm.metric_state.items()}
    tm = getattr(tmt, cls_name)(device="cpu", **kwargs)
    load_reference_state(tm, state, update_count=2)
    np.testing.assert_allclose(tm.compute().numpy(), np.asarray(jm.compute()), atol=1e-6)


def test_load_reference_state_refuses_mismatched_state():
    tm = tmt.ConfusionMatrix(num_classes=C, device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        load_reference_state(tm, {"confmat": np.zeros((C, C), dtype=np.int64)})
    with pytest.raises(ValueError, match="does not fit"):
        load_reference_state(tm, {"confmat": np.zeros((C + 1, C + 1), dtype=np.int32)})
    with pytest.raises(KeyError):
        load_reference_state(tm, {})
