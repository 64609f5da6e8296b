"""The port's classification metrics against the JAX package on the same inputs.

Functional forms (stat_scores, accuracy, precision, recall, precision_recall,
f1/fbeta, confusion_matrix) and module forms (StatScores, Accuracy,
Precision, Recall, F1Score, FBetaScore, ConfusionMatrix) run on binary,
multi-class probability, multi-class label, multi-label and multi-dim
multi-class inputs, made with numpy from a seed. Integer results must be
exact and int32; float results agree within atol=1e-6. Where the JAX package
refuses a configuration or an input (a 0-row batch, integer-label preds to
calibration_error, multilabel=True on other inputs, an empty curve, a binned
metric with num_classes=1 on (N, C) preds), the port must raise the same
exception type.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jmt
import metrics_tpu.functional as jF
import metrics_tpu_torch as tmt
import metrics_tpu_torch.functional as tF
from metrics_tpu.utils import checks as jax_checks
from metrics_tpu_torch.utils import checks as torch_checks

ATOL = 1e-6
N, C, X = 96, 6, 3


@pytest.fixture(autouse=True)
def _full_validation():
    """Both packages check every call's values, so the same misuse raises in both."""
    jax_prev, torch_prev = jax_checks._get_validation_mode(), torch_checks._get_validation_mode()
    jax_checks.set_validation_mode("full")
    torch_checks.set_validation_mode("full")
    yield
    jax_checks.set_validation_mode(jax_prev)
    torch_checks.set_validation_mode(torch_prev)


def _softmax(logits):
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    return (e / e.sum(axis=1, keepdims=True)).astype(np.float32)


def make_inputs(kind, seed=0, n=N):
    rng = np.random.RandomState(seed)
    if kind == "binary":
        return rng.rand(n).astype(np.float32), rng.randint(0, 2, n)
    if kind == "mc_probs":
        return _softmax(rng.randn(n, C)), rng.randint(0, C, n)
    if kind == "mc_labels":
        return rng.randint(0, C, n), rng.randint(0, C, n)
    if kind == "multilabel":
        return rng.rand(n, C).astype(np.float32), rng.randint(0, 2, (n, C))
    if kind == "mdmc_probs":
        return _softmax(rng.randn(n, C, X)), rng.randint(0, C, (n, X))
    raise ValueError(kind)


KINDS = ["binary", "mc_probs", "mc_labels", "multilabel", "mdmc_probs"]
NUM_CLASSES = {"binary": 1, "mc_probs": C, "mc_labels": C, "multilabel": C, "mdmc_probs": C}
MDMC = {"mdmc_probs": "global"}


def assert_same(expected, got):
    """JAX result vs port result: exact and int32 for integers, atol for floats."""
    if isinstance(expected, (tuple, list)):
        assert len(expected) == len(got)
        for e, g in zip(expected, got):
            assert_same(e, g)
        return
    if isinstance(expected, dict):
        assert sorted(expected) == sorted(got)
        for k in expected:
            assert_same(expected[k], got[k])
        return
    e = np.asarray(expected)
    assert isinstance(got, torch.Tensor)
    g = got.detach().cpu().numpy()
    assert e.shape == g.shape, (e.shape, g.shape)
    if np.issubdtype(e.dtype, np.integer):
        assert e.dtype == np.int32 and got.dtype == torch.int32
        np.testing.assert_array_equal(g, e)
    else:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(g, e, atol=ATOL, rtol=0, equal_nan=True)


def run_both(jax_fn, torch_fn, arrays, **kwargs):
    try:
        expected = jax_fn(*[jnp.asarray(a) for a in arrays], **kwargs)
    except (ValueError, RuntimeError) as err:
        with pytest.raises(type(err)):
            torch_fn(*[torch.from_numpy(np.asarray(a)) for a in arrays], **kwargs)
        return None
    got = torch_fn(*[torch.from_numpy(np.asarray(a)) for a in arrays], **kwargs)
    assert_same(expected, got)
    return got


AVERAGES = ["micro", "macro", "weighted", "none"]
PAIRS = [
    ("accuracy", jF.accuracy, tF.accuracy),
    ("precision", jF.precision, tF.precision),
    ("recall", jF.recall, tF.recall),
    ("f1_score", jF.f1_score, tF.f1_score),
    ("precision_recall", jF.precision_recall, tF.precision_recall),
]


@pytest.mark.parametrize("average", AVERAGES)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name,jax_fn,torch_fn", PAIRS, ids=[p[0] for p in PAIRS])
def test_functional_scores(name, jax_fn, torch_fn, kind, average):
    kwargs = dict(average=average, num_classes=NUM_CLASSES[kind])
    if kind in MDMC:
        kwargs["mdmc_average"] = MDMC[kind]
    run_both(jax_fn, torch_fn, make_inputs(kind, seed=len(name)), **kwargs)


@pytest.mark.parametrize("average", ["macro", "weighted", "none"])
@pytest.mark.parametrize("beta", [0.5, 2.0])
@pytest.mark.parametrize("kind", ["mc_probs", "mc_labels", "multilabel"])
def test_functional_fbeta(kind, beta, average):
    run_both(jF.fbeta_score, tF.fbeta_score, make_inputs(kind, seed=7), beta=beta, average=average, num_classes=C)


@pytest.mark.parametrize("kind", ["multilabel", "mdmc_probs"])
def test_functional_samplewise(kind):
    preds, target = make_inputs(kind, seed=11)
    if kind == "multilabel":
        run_both(jF.accuracy, tF.accuracy, (preds, target), average="samples")
        run_both(jF.f1_score, tF.f1_score, (preds, target), average="samples")
    else:
        for fn in ("precision", "recall", "f1_score"):
            run_both(getattr(jF, fn), getattr(tF, fn), (preds, target), average="macro", num_classes=C,
                     mdmc_average="samplewise")
        run_both(jF.accuracy, tF.accuracy, (preds, target), average="micro", mdmc_average="samplewise")


@pytest.mark.parametrize("kind", ["multilabel", "mdmc_probs"])
def test_functional_subset_accuracy(kind):
    preds, target = make_inputs(kind, seed=5)
    kwargs = {"mdmc_average": "global"} if kind == "mdmc_probs" else {}
    run_both(jF.accuracy, tF.accuracy, (preds, target), subset_accuracy=True, **kwargs)


@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_functional_top_k(top_k):
    preds, target = make_inputs("mc_probs", seed=13)
    run_both(jF.accuracy, tF.accuracy, (preds, target), top_k=top_k)
    run_both(jF.precision, tF.precision, (preds, target), top_k=top_k, average="macro", num_classes=C)


@pytest.mark.parametrize("reduce", ["micro", "macro", "samples"])
@pytest.mark.parametrize("kind", KINDS)
def test_functional_stat_scores(kind, reduce):
    kwargs = dict(reduce=reduce, num_classes=NUM_CLASSES[kind])
    if kind in MDMC:
        kwargs["mdmc_reduce"] = MDMC[kind]
    run_both(jF.stat_scores, tF.stat_scores, make_inputs(kind, seed=3), **kwargs)


@pytest.mark.parametrize("normalize", [None, "true", "pred", "all"])
@pytest.mark.parametrize("kind", ["binary", "mc_probs", "mc_labels", "multilabel"])
def test_functional_confusion_matrix(kind, normalize):
    preds, target = make_inputs(kind, seed=17)
    num_classes = 2 if kind == "binary" else C
    multilabel = kind == "multilabel"
    run_both(jF.confusion_matrix, tF.confusion_matrix, (preds, target), num_classes=num_classes,
             normalize=normalize, multilabel=multilabel)


@pytest.mark.parametrize("ignore_index", [0, 2, -1])
@pytest.mark.parametrize("name,jax_fn,torch_fn", PAIRS + [("stat_scores", jF.stat_scores, tF.stat_scores)],
                         ids=[p[0] for p in PAIRS] + ["stat_scores"])
@pytest.mark.parametrize("average", ["micro", "macro"])
def test_functional_ignore_index(name, jax_fn, torch_fn, average, ignore_index):
    preds, target = make_inputs("mc_probs", seed=19)
    if ignore_index < 0:
        target = target.copy()
        target[::5] = ignore_index
    kwargs = dict(num_classes=C, ignore_index=ignore_index)
    kwargs.update(reduce=average) if name == "stat_scores" else kwargs.update(average=average)
    run_both(jax_fn, torch_fn, (preds, target), **kwargs)


@pytest.mark.parametrize(
    "preds,target,kwargs",
    [
        (np.array([0.2, 0.8]), np.array([0.0, 1.0]), {}),  # float target
        (np.array([0, 1, 2]), np.array([0, 1, 7]), {"num_classes": 3, "average": "macro"}),  # label >= C
        (np.array([-1, 1, 0]), np.array([0, 1, 1]), {}),  # negative int preds
        (np.random.RandomState(0).rand(4, 3).astype(np.float32), np.array([0, 1, 5, 2]), {}),  # target >= C
        (np.array([0.3, 0.7]), np.array([0, 1]), {"average": "macro", "num_classes": 3}),  # binary with C > 2
        # a case below names its function and the exception type JAX raises
        (np.zeros(0, np.float32), np.zeros(0, np.int64), {"fn": "stat_scores", "reduce": "samples"}),  # 0 rows
        (np.zeros(0, np.int64), np.zeros(0, np.int64), {"fn": "accuracy"}),  # 0 integer rows
        (np.zeros((0, 3), np.int64), np.zeros((0, 3), np.int64), {"fn": "hamming_distance"}),
        (np.array([0, 2, 1, 1]), np.array([0, 1, 1, 2]), {"fn": "calibration_error"}),  # integer-label preds
        (np.random.RandomState(1).rand(6, 3, 4).astype(np.float32), np.random.RandomState(2).randint(0, 2, (6, 3, 4)),
         {"fn": "confusion_matrix", "num_classes": 3, "multilabel": True}),  # multidim
        (np.random.RandomState(3).rand(6, 3).astype(np.float32), np.array([0, 1, 2, 0, 1, 2]),
         {"fn": "confusion_matrix", "num_classes": 3, "multilabel": True, "exc": TypeError}),  # 2-D multi-class
        (np.array([0, 1, 2, 0, 1, 2]), np.array([0, 1, 2, 2, 1, 0]),
         {"fn": "confusion_matrix", "num_classes": 3, "multilabel": True, "exc": TypeError}),  # 1-D labels
        (np.zeros(0, np.float32), np.zeros(0, np.int64), {"fn": "roc", "pos_label": 1, "exc": TypeError}),  # no rows
        (np.zeros(0, np.float32), np.zeros(0, np.int64), {"fn": "auroc", "pos_label": 1, "exc": TypeError}),
    ],
)
def test_functional_misuse_raises_like_jax(preds, target, kwargs):
    kwargs = dict(kwargs)
    name, exc = kwargs.pop("fn", "accuracy"), kwargs.pop("exc", ValueError)
    with pytest.raises(exc):
        getattr(jF, name)(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    with pytest.raises(exc):
        getattr(tF, name)(torch.from_numpy(preds), torch.from_numpy(target), **kwargs)


_RNG = np.random.RandomState(4)
MODULE_MISUSE = [
    # (metric, its arguments, preds, target, the exception type JAX raises); every raise comes at
    # update or compute, the same call in both packages
    ("Accuracy", {}, np.zeros(0, np.float32), np.zeros(0, np.int64), ValueError),
    ("Accuracy", {"num_classes": 3, "average": "macro"}, np.zeros((0, 3, 2), np.int64), np.zeros((0, 3, 2), np.int64),
     ValueError),
    ("StatScores", {"reduce": "samples"}, np.zeros(0, np.float32), np.zeros(0, np.int64), ValueError),
    ("StatScores", {"reduce": "samples"}, np.zeros((0, 3), np.int64), np.zeros((0, 3), np.int64), ValueError),
    ("HammingDistance", {}, np.zeros(0, np.int64), np.zeros(0, np.int64), ValueError),
    ("CalibrationError", {}, np.array([0, 2, 1, 1]), np.array([0, 1, 1, 2]), ValueError),
    ("ConfusionMatrix", {"num_classes": 3, "multilabel": True}, _RNG.rand(6, 3, 4).astype(np.float32),
     _RNG.randint(0, 2, (6, 3, 4)), ValueError),
    ("ConfusionMatrix", {"num_classes": 3, "multilabel": True}, _RNG.rand(6, 3).astype(np.float32),
     np.array([0, 1, 2, 0, 1, 2]), TypeError),
    ("AUROC", {"pos_label": 1}, np.zeros(0, np.float32), np.zeros(0, np.int64), TypeError),
    ("AveragePrecision", {"pos_label": 1}, np.zeros(0, np.float32), np.zeros(0, np.int64), TypeError),
    ("ROC", {"pos_label": 1}, np.zeros(0, np.float32), np.zeros(0, np.int64), TypeError),
    ("PrecisionRecallCurve", {"pos_label": 1}, np.zeros(0, np.float32), np.zeros(0, np.int64), TypeError),
    ("BinnedPrecisionRecallCurve", {"num_classes": 1, "thresholds": 5}, _RNG.rand(6, 3).astype(np.float32),
     _RNG.randint(0, 2, (6, 3)), TypeError),
    ("BinnedAveragePrecision", {"num_classes": 1, "thresholds": 5}, _RNG.rand(6, 3).astype(np.float32),
     _RNG.randint(0, 2, (6, 3)), TypeError),
    ("BinnedRecallAtFixedPrecision", {"num_classes": 1, "thresholds": 5, "min_precision": 0.5},
     _RNG.rand(6, 3).astype(np.float32), _RNG.randint(0, 2, (6, 3)), TypeError),
]


@pytest.mark.parametrize("cls_name,kwargs,preds,target,exc", MODULE_MISUSE,
                         ids=[f"{m[0]}-{i}" for i, m in enumerate(MODULE_MISUSE)])
def test_module_misuse_raises_like_jax(cls_name, kwargs, preds, target, exc):
    def update_and_compute(metric, convert):
        metric.update(convert(preds), convert(target))
        metric.compute()

    with pytest.raises(exc):
        update_and_compute(getattr(jmt, cls_name)(**kwargs), jnp.asarray)
    with pytest.raises(exc):
        update_and_compute(getattr(tmt, cls_name)(device="cpu", **kwargs), torch.from_numpy)


MODULES = [
    ("StatScores", dict(reduce="macro", num_classes=C)),
    ("StatScores", dict(reduce="micro")),
    ("StatScores", dict(reduce="samples")),
    ("Accuracy", dict(num_classes=C, average="macro")),
    ("Accuracy", dict(num_classes=C, average="weighted")),
    ("Accuracy", dict()),
    ("Precision", dict(num_classes=C, average="macro")),
    ("Precision", dict(num_classes=C, average="none")),
    ("Recall", dict(num_classes=C, average="macro")),
    ("Recall", dict(num_classes=C, average="micro", ignore_index=1)),
    ("F1Score", dict(num_classes=C, average="macro")),
    ("F1Score", dict(num_classes=C, average="weighted", ignore_index=0)),
    ("FBetaScore", dict(num_classes=C, beta=0.5, average="macro")),
    ("ConfusionMatrix", dict(num_classes=C)),
    ("ConfusionMatrix", dict(num_classes=C, normalize="true")),
]


@pytest.mark.parametrize("kind", ["mc_probs", "mc_labels"])
@pytest.mark.parametrize("cls_name,kwargs", MODULES, ids=[f"{m}-{i}" for i, (m, _) in enumerate(MODULES)])
def test_module_forward_update_compute(cls_name, kwargs, kind):
    jm = getattr(jmt, cls_name)(**kwargs)
    tm = getattr(tmt, cls_name)(device="cpu", **kwargs)
    for step in range(3):
        preds, target = make_inputs(kind, seed=100 + step)
        if step == 1:  # forward: the batch value, and the batch is accumulated
            assert_same(jm(jnp.asarray(preds), jnp.asarray(target)), tm(torch.from_numpy(preds), torch.from_numpy(target)))
        else:
            jm.update(jnp.asarray(preds), jnp.asarray(target))
            tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert_same(jm.compute(), tm.compute())
    for name, value in jm.metric_state.items():
        got = getattr(tm, name)
        if isinstance(value, list):
            assert_same([np.asarray(v) for v in value], got)
        else:
            assert_same(value, got)


@pytest.mark.parametrize("cls_name", ["Accuracy", "F1Score", "Precision", "Recall"])
def test_module_binary_and_multilabel(cls_name):
    for kind in ("binary", "multilabel"):
        kwargs = {"num_classes": NUM_CLASSES[kind], "average": "macro"}
        jm, tm = getattr(jmt, cls_name)(**kwargs), getattr(tmt, cls_name)(device="cpu", **kwargs)
        for step in range(2):
            preds, target = make_inputs(kind, seed=200 + step)
            jm.update(jnp.asarray(preds), jnp.asarray(target))
            tm.update(torch.from_numpy(preds), torch.from_numpy(target))
        assert_same(jm.compute(), tm.compute())


def test_module_multilabel_confusion_matrix():
    jm = jmt.ConfusionMatrix(num_classes=C, multilabel=True)
    tm = tmt.ConfusionMatrix(num_classes=C, multilabel=True, device="cpu")
    for step in range(2):
        preds, target = make_inputs("multilabel", seed=300 + step)
        jm.update(jnp.asarray(preds), jnp.asarray(target))
        tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert_same(jm.compute(), tm.compute())


def test_module_mixed_input_modes_raise_like_jax():
    jm, tm = jmt.Accuracy(), tmt.Accuracy(device="cpu")
    preds, target = make_inputs("binary", seed=1)
    jm.update(jnp.asarray(preds), jnp.asarray(target))
    tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    preds, target = make_inputs("mc_probs", seed=1)
    with pytest.raises(ValueError):
        jm.update(jnp.asarray(preds), jnp.asarray(target))
    with pytest.raises(ValueError):
        tm.update(torch.from_numpy(preds), torch.from_numpy(target))
