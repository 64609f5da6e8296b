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


def _agreement_suite(pkg, num_classes=C):
    """The agreement suite: three confusion-matrix metrics, Specificity and HammingDistance."""
    dev = {} if pkg is jmt else {"device": "cpu"}
    return pkg.MetricCollection(
        {
            "kappa": pkg.CohenKappa(num_classes=num_classes, **dev),
            "mcc": pkg.MatthewsCorrCoef(num_classes=num_classes, **dev),
            "jaccard": pkg.JaccardIndex(num_classes=num_classes, **dev),
            "specificity": pkg.Specificity(num_classes=num_classes, average="macro", **dev),
            "hamming": pkg.HammingDistance(**dev),
        }
    )


def test_agreement_suite_matches_jax_and_groups_the_confusion_matrices(monkeypatch):
    """kappa, mcc and jaccard share one compute group: after the first update, which
    updates every member to find the groups, one bincount serves all three."""
    from metrics_tpu_torch.utils import data

    calls = []
    real = data.fused_bincount
    monkeypatch.setattr(data, "fused_bincount", lambda *a, **k: calls.append(1) or real(*a, **k))
    js, ts = _agreement_suite(jmt), _agreement_suite(tmt)
    per_update = []
    for preds, target in _batches(seed=9):
        before = len(calls)
        js.update(jnp.asarray(preds), jnp.asarray(target))
        ts.update(torch.from_numpy(preds), torch.from_numpy(target))
        per_update.append(len(calls) - before)
    assert per_update == [3] + [1] * (STEPS - 1)
    assert ts.compute_groups == js.compute_groups
    groups = sorted(sorted(g) for g in ts.compute_groups.values())
    assert groups == [["hamming"], ["jaccard", "kappa", "mcc"], ["specificity"]]
    members = dict(ts.items(keep_base=True, copy_state=False))
    assert members["kappa"].confmat is members["mcc"].confmat is members["jaccard"].confmat
    _assert_results_equal(js.compute(), ts.compute())


def test_mean_metric_beside_the_suite():
    """A loss MeanMetric in the same collection: its update takes the loss, the others skip it."""
    js = jmt.MetricCollection({"loss": jmt.MeanMetric(), "sum": jmt.SumMetric()})
    ts = tmt.MetricCollection({"loss": tmt.MeanMetric(device="cpu"), "sum": tmt.SumMetric(device="cpu")})
    rng = np.random.RandomState(10)
    for _ in range(3):
        loss = rng.rand(B).astype(np.float32)
        js.update(jnp.asarray(loss))
        ts.update(torch.from_numpy(loss))
    _assert_results_equal(js.compute(), ts.compute())


# ------------------------------------------------------------- the curve suites
def _curves_binary_suite(pkg):
    """The binary curve suite of ``chip_smoke.py``: four metrics buffering the same raw rows."""
    dev = {} if pkg is jmt else {"device": "cpu"}
    return pkg.MetricCollection(
        {
            "auroc": pkg.AUROC(pos_label=1, **dev),
            "ap": pkg.AveragePrecision(pos_label=1, **dev),
            "roc": pkg.ROC(pos_label=1, **dev),
            "pr_curve": pkg.PrecisionRecallCurve(pos_label=1, **dev),
        }
    )


def _curves_imagenet_suite(pkg, num_classes=C):
    """The ImageNet curve suite of ``chip_smoke.py`` at a small width."""
    dev = {} if pkg is jmt else {"device": "cpu"}
    return pkg.MetricCollection(
        {
            "auroc": pkg.AUROC(num_classes=num_classes, average="macro", **dev),
            "ap": pkg.AveragePrecision(num_classes=num_classes, average="macro", **dev),
            "ece": pkg.CalibrationError(n_bins=15, norm="l1", **dev),
            "binned_ap": pkg.BinnedAveragePrecision(num_classes=num_classes, thresholds=100, **dev),
        }
    )


def _binary_batches(seed=11, steps=STEPS):
    rng = np.random.RandomState(seed)
    return [(np.round(rng.rand(B), 2).astype(np.float32), (rng.rand(B) < 0.3).astype(np.int64)) for _ in range(steps)]


@pytest.mark.parametrize("kind", ["binary", "imagenet"])
def test_curve_suites_form_the_jax_groups_and_match_jax(kind, monkeypatch):
    from metrics_tpu_torch.utils import data
    from tests.test_torch_curves import assert_curve

    calls = []
    real = data.fused_bincount
    monkeypatch.setattr(data, "fused_bincount", lambda *a, **k: calls.append(1) or real(*a, **k))
    make = _curves_binary_suite if kind == "binary" else _curves_imagenet_suite
    batches = _binary_batches() if kind == "binary" else _batches(seed=12)
    js, ts = make(jmt), make(tmt)
    for preds, target in batches:
        js.update(jnp.asarray(preds), jnp.asarray(target))
        ts.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert ts.compute_groups == js.compute_groups
    groups = sorted(sorted(g) for g in ts.compute_groups.values())
    if kind == "binary":
        assert groups == [["ap", "auroc", "pr_curve", "roc"]]
        assert calls == []
    else:
        assert groups == [["ap", "auroc"], ["binned_ap"], ["ece"]]
        assert len(calls) == STEPS  # CalibrationError: one bincount an update
    members = dict(ts.items(keep_base=True, copy_state=False))
    leader = ts.compute_groups[0][0]
    for name in ts.compute_groups[0][1:]:
        assert members[name].preds is members[leader].preds
    want, got = js.compute(), ts.compute()
    assert sorted(want) == sorted(got)
    for key in want:
        exact = key in ("roc", "pr_curve")
        assert_curve(want[key], got[key], None if exact else (1e-6 if kind == "binary" else 1e-5))


def test_grouped_members_keep_their_inferred_attributes():
    """Only the leader updates after the first update, so the members compute with
    the mode, classes and positive label their own first update inferred."""
    from tests.test_torch_curves import assert_curve

    def suite(pkg):
        dev = {} if pkg is jmt else {"device": "cpu"}
        return pkg.MetricCollection(
            {"a_auroc": pkg.AUROC(num_classes=C, **dev), "b_ap": pkg.AveragePrecision(num_classes=C, **dev),
             "c_pr": pkg.PrecisionRecallCurve(num_classes=C, **dev)}
        )

    js, ts = suite(jmt), suite(tmt)
    for preds, target in _batches(seed=13):
        js.update(jnp.asarray(preds), jnp.asarray(target))
        ts.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert ts.compute_groups == js.compute_groups == {0: ["a_auroc", "b_ap", "c_pr"]}
    members = dict(ts.items(keep_base=True, copy_state=False))
    assert members["a_auroc"].mode == "multi-class" and members["a_auroc"].update_count == STEPS
    assert members["b_ap"].num_classes == members["c_pr"].num_classes == C and members["c_pr"].pos_label is None
    want, got = js.compute(), ts.compute()
    for key in want:
        assert_curve(want[key], got[key], None if key == "c_pr" else 1e-5)
