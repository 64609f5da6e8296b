"""The port's curve metrics against the JAX package on the same inputs.

PrecisionRecallCurve, ROC, AUROC, AveragePrecision, AUC and CalibrationError,
functional and module, on binary, multi-class and multi-label inputs made
with numpy from a seed (N <= 4096, C <= 10): with ties, signed zeros and NaN
scores, sample weights, ``max_fpr``, unobserved classes and single-class
targets. Curves and counts must equal the JAX package's bit for bit; areas
agree within atol 1e-6 (binary) and 1e-5 (multi-class and multi-label), the
tolerances of the JAX package's own tests. Warnings must be the same, also
for the partial AUROC of a batch with no negative sample (NaN). Also:
the raw-row buffering (raw appends, the checks that still raise at
``update``, canonical rows in ``state_dict`` and pickles, mixed ``(N,)`` and
``(M, 1)`` binary rows), and list states carried across from the JAX
package with ``load_reference_state``.
"""
import importlib
import pickle
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jmt
import metrics_tpu.functional as jF
import metrics_tpu_torch as tmt
import metrics_tpu_torch.functional as tF
from metrics_tpu.utils import checks as jax_checks
from metrics_tpu_torch.interop import load_reference_state
from metrics_tpu_torch.utils import checks as torch_checks

# the modules, not the functions of the same name that the packages export
jce = importlib.import_module("metrics_tpu.functional.classification.calibration_error")
tce = importlib.import_module("metrics_tpu_torch.functional.classification.calibration_error")

N, C = 512, 5
ATOL_BINARY, ATOL_MULTI = 1e-6, 1e-5


@pytest.fixture(autouse=True)
def _full_validation():
    jax_prev, torch_prev = jax_checks._get_validation_mode(), torch_checks._get_validation_mode()
    jax_checks.set_validation_mode("full")
    torch_checks.set_validation_mode("full")
    yield
    jax_checks.set_validation_mode(jax_prev)
    torch_checks.set_validation_mode(torch_prev)


def _softmax(logits):
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    return (e / e.sum(axis=1, keepdims=True)).astype(np.float32)


def make_inputs(kind, seed=0, n=N, decimals=None):
    """Scores and labels as numpy arrays; ``decimals`` rounds the scores so that ties form."""
    rng = np.random.RandomState(seed)
    if kind == "binary":
        preds, target = rng.rand(n).astype(np.float32), rng.randint(0, 2, n)
    elif kind == "multiclass":
        preds, target = _softmax(rng.randn(n, C).astype(np.float32)), rng.randint(0, C, n)
    elif kind == "multilabel":
        preds, target = rng.rand(n, C).astype(np.float32), rng.randint(0, 2, (n, C))
    elif kind == "mdmc":
        preds, target = _softmax(rng.randn(n, C, 3).astype(np.float32)), rng.randint(0, C, (n, 3))
    else:
        raise ValueError(kind)
    if decimals is not None:
        preds = np.round(preds, decimals).astype(np.float32)
    return preds, target


def _special_scores(seed=3, n=N):
    """Binary scores with long tie runs, both signed zeros and NaNs."""
    rng = np.random.RandomState(seed)
    preds = np.round(rng.rand(n) - 0.5, 1).astype(np.float32)
    preds[::7] = 0.0
    preds[3::7] = -0.0
    preds[5::41] = np.nan
    return preds, rng.randint(0, 2, n)


def _call(fn, arrays, kwargs, to_tensor):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn(*[to_tensor(a) for a in arrays], **kwargs)
    return out, sorted({str(w.message) for w in caught})


def assert_curve(expected, got, atol=None):
    """Curves exactly (``atol`` None), areas within ``atol``; lists and tuples element by element."""
    if hasattr(expected, "_force"):  # a JAX ``forward`` value whose dispatch was deferred
        expected = expected._force()
    if isinstance(expected, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(expected) == len(got)
        for e, g in zip(expected, got):
            assert_curve(e, g, atol)
        return
    e = np.asarray(expected)
    assert isinstance(got, torch.Tensor), type(got)
    g = got.detach().cpu().numpy()
    assert e.shape == g.shape, (e.shape, g.shape)
    assert e.dtype == g.dtype, (e.dtype, g.dtype)
    if atol is None:
        np.testing.assert_array_equal(g, e)
    else:
        np.testing.assert_allclose(g, e, atol=atol, rtol=0, equal_nan=True)


def run_both(jax_fn, torch_fn, arrays, atol=None, **kwargs):
    """The same call in both packages: the same exception type, or the same warnings and results."""
    try:
        expected, jax_warnings = _call(jax_fn, arrays, kwargs, jnp.asarray)
    except (ValueError, RuntimeError) as err:
        with pytest.raises(type(err)):
            _call(torch_fn, arrays, kwargs, lambda a: torch.from_numpy(np.asarray(a)))
        return None
    got, torch_warnings = _call(torch_fn, arrays, kwargs, lambda a: torch.from_numpy(np.asarray(a)))
    assert torch_warnings == jax_warnings
    assert_curve(expected, got, atol)
    return got


# ------------------------------------------------------------------ curves
CURVE_FNS = [(jF.precision_recall_curve, tF.precision_recall_curve), (jF.roc, tF.roc)]


@pytest.mark.parametrize("decimals", [None, 1, 2])
@pytest.mark.parametrize("fns", CURVE_FNS, ids=["pr_curve", "roc"])
def test_binary_curves_bit_for_bit(fns, decimals):
    run_both(*fns, make_inputs("binary", seed=1, decimals=decimals), pos_label=1)


@pytest.mark.parametrize("fns", CURVE_FNS, ids=["pr_curve", "roc"])
def test_curves_with_signed_zeros_and_nans(fns):
    got = run_both(*fns, _special_scores(), pos_label=1)
    assert torch.isnan(got[2]).any()  # every NaN score is a threshold of its own


@pytest.mark.parametrize("pos_label", [0, 1])
@pytest.mark.parametrize("fns", CURVE_FNS, ids=["pr_curve", "roc"])
def test_binary_curves_pos_label(fns, pos_label):
    run_both(*fns, make_inputs("binary", seed=2, decimals=2), pos_label=pos_label)


@pytest.mark.parametrize("kind", ["multiclass", "multilabel"])
@pytest.mark.parametrize("fns", CURVE_FNS, ids=["pr_curve", "roc"])
def test_per_class_curves_bit_for_bit(fns, kind):
    run_both(*fns, make_inputs(kind, seed=4, decimals=2), num_classes=C)


@pytest.mark.parametrize("fns", CURVE_FNS, ids=["pr_curve", "roc"])
def test_curves_with_sample_weights(fns):
    preds, target = make_inputs("binary", seed=5, n=256, decimals=1)
    weights = np.random.RandomState(6).rand(256).astype(np.float32)
    # float weights sum in another order on each side: within float32 rounding, not bit for bit
    run_both(*fns, (preds, target), atol=1e-5, pos_label=1, sample_weights=weights)


@pytest.mark.parametrize("fill", [0, 1])
def test_roc_single_class_target_warns_and_gives_zeros(fill):
    preds = make_inputs("binary", seed=7, n=64)[0]
    run_both(jF.roc, tF.roc, (preds, np.full(64, fill)), pos_label=1)


def test_pr_curve_without_positives_is_nan():
    preds = make_inputs("binary", seed=8, n=64)[0]
    run_both(jF.precision_recall_curve, tF.precision_recall_curve, (preds, np.zeros(64, np.int64)), pos_label=1)


def test_multiclass_pr_curve_warns_on_pos_label():
    run_both(jF.precision_recall_curve, tF.precision_recall_curve, make_inputs("multiclass", seed=9), num_classes=C,
             pos_label=1)


@pytest.mark.parametrize("num_classes", [3, None])
def test_curve_class_mismatch_raises(num_classes):
    run_both(jF.precision_recall_curve, tF.precision_recall_curve, make_inputs("multiclass", seed=10),
             num_classes=num_classes)


def test_curve_bad_ranks_raise():
    preds, target = make_inputs("multiclass", seed=11)
    run_both(jF.roc, tF.roc, (preds[:, :, None, None], target), num_classes=C)


def test_dtype_of_the_unweighted_counts_is_float32():
    from metrics_tpu_torch.functional.classification.precision_recall_curve import _binary_clf_curve

    preds, target = make_inputs("binary", seed=12, decimals=2)
    fps, tps, thr = _binary_clf_curve(torch.from_numpy(preds), torch.from_numpy(target))
    assert fps.dtype == tps.dtype == torch.float32
    assert float(tps[-1]) == target.sum() and float(fps[-1]) == len(target) - target.sum()


# ------------------------------------------------------------------ areas
@pytest.mark.parametrize("decimals", [None, 1, 3])
def test_binary_auroc(decimals):
    run_both(jF.auroc, tF.auroc, make_inputs("binary", seed=13, decimals=decimals), atol=ATOL_BINARY, pos_label=1)


def test_binary_auroc_signed_zeros_and_nans():
    run_both(jF.auroc, tF.auroc, _special_scores(seed=14), atol=ATOL_BINARY, pos_label=1)


@pytest.mark.parametrize("max_fpr", [0.1, 0.5, 0.8, 1.0])
def test_partial_auroc(max_fpr):
    run_both(jF.auroc, tF.auroc, make_inputs("binary", seed=15, decimals=2), atol=ATOL_BINARY, pos_label=1,
             max_fpr=max_fpr)


def _one_label_inputs(n, label, seed=17):
    """``n`` scores whose targets are all ``label``: with ``pos_label=label`` no negative sample."""
    rng = np.random.RandomState(seed + n)
    return np.round(rng.rand(n), 2).astype(np.float32), np.full(n, label, dtype=np.int64)


@pytest.mark.parametrize("max_fpr", [0.25, 0.75])
@pytest.mark.parametrize("label", [1, 0], ids=["all-positive", "all-zero-pos-label-0"])
@pytest.mark.parametrize("n", [1, 2, 5, 17, 50])
def test_partial_auroc_without_negatives_is_nan_with_the_warning(n, label, max_fpr):
    got = run_both(jF.auroc, tF.auroc, _one_label_inputs(n, label), atol=ATOL_BINARY, pos_label=label, max_fpr=max_fpr)
    assert torch.isnan(got)


@pytest.mark.parametrize("label", [1, 0], ids=["all-positive", "all-zero-pos-label-0"])
@pytest.mark.parametrize("n", [1, 50])
def test_partial_auroc_module_without_negatives_is_nan(n, label):
    jm, tm = _module_pair("AUROC", {"pos_label": label, "max_fpr": 0.3})
    for step in range(2):
        preds, target = _one_label_inputs(n, label, seed=17 + step)
        expected, jax_warnings = _call(jm, (preds, target), {}, jnp.asarray)
        got, torch_warnings = _call(tm, (preds, target), {}, torch.from_numpy)
        assert torch_warnings == jax_warnings and any("No negative samples" in w for w in torch_warnings)
        assert_curve(expected, got, ATOL_BINARY)
    expected, jax_warnings = _call(jm.compute, (), {}, jnp.asarray)
    got, torch_warnings = _call(tm.compute, (), {}, torch.from_numpy)
    assert torch_warnings == jax_warnings
    assert_curve(expected, got, ATOL_BINARY)
    assert torch.isnan(got)


@pytest.mark.parametrize("max_fpr", [0.0, 1.5, 1])
def test_partial_auroc_refuses_a_bad_max_fpr(max_fpr):
    run_both(jF.auroc, tF.auroc, make_inputs("binary", seed=16), max_fpr=max_fpr)


def test_partial_auroc_refuses_multiclass():
    run_both(jF.auroc, tF.auroc, make_inputs("multiclass", seed=17), num_classes=C, max_fpr=0.5)


def test_auroc_sample_weights():
    preds, target = make_inputs("binary", seed=18, n=256, decimals=1)
    weights = np.random.RandomState(19).rand(256).astype(np.float32)
    run_both(jF.auroc, tF.auroc, (preds, target), atol=1e-5, pos_label=1, sample_weights=weights)


@pytest.mark.parametrize("average", ["macro", "weighted", "none", None])
@pytest.mark.parametrize("kind", ["multiclass", "multilabel", "mdmc"])
def test_auroc_per_class_averages(kind, average):
    run_both(jF.auroc, tF.auroc, make_inputs(kind, seed=20, decimals=2), atol=ATOL_MULTI, num_classes=C,
             average=average)


def test_auroc_multilabel_micro():
    run_both(jF.auroc, tF.auroc, make_inputs("multilabel", seed=21), atol=ATOL_MULTI, num_classes=C, average="micro")


@pytest.mark.parametrize("average", ["macro", "weighted", "none"])
def test_auroc_unobserved_class(average):
    preds, _ = make_inputs("multiclass", seed=22)
    target = np.random.RandomState(23).randint(0, C - 2, N)  # the last two classes never occur
    run_both(jF.auroc, tF.auroc, (preds, target), atol=ATOL_MULTI, num_classes=C, average=average)


def test_auroc_weighted_with_one_observed_class_raises():
    preds, _ = make_inputs("multiclass", seed=24)
    run_both(jF.auroc, tF.auroc, (preds, np.full(N, 2)), num_classes=C, average="weighted")


def test_auroc_without_num_classes_raises():
    run_both(jF.auroc, tF.auroc, make_inputs("multiclass", seed=25))


@pytest.mark.parametrize("fill", [0, 1])
def test_auroc_single_class_binary_warns_and_gives_zero(fill):
    preds = make_inputs("binary", seed=26, n=64)[0]
    got = run_both(jF.auroc, tF.auroc, (preds, np.full(64, fill)), atol=ATOL_BINARY, pos_label=1)
    assert float(got) == 0.0


@pytest.mark.parametrize("decimals", [None, 1, 3])
def test_binary_average_precision(decimals):
    run_both(jF.average_precision, tF.average_precision, make_inputs("binary", seed=27, decimals=decimals),
             atol=ATOL_BINARY, pos_label=1)


def test_binary_average_precision_signed_zeros_and_nans():
    run_both(jF.average_precision, tF.average_precision, _special_scores(seed=28), atol=ATOL_BINARY, pos_label=1)


@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none", None])
@pytest.mark.parametrize("kind", ["multiclass", "multilabel"])
def test_average_precision_averages(kind, average):
    run_both(jF.average_precision, tF.average_precision, make_inputs(kind, seed=29, decimals=2), atol=ATOL_MULTI,
             num_classes=C, average=average)


@pytest.mark.parametrize("average", ["macro", "weighted", "none"])
def test_average_precision_unobserved_class_is_nan_and_left_out(average):
    preds, _ = make_inputs("multiclass", seed=30)
    target = np.random.RandomState(31).randint(0, C - 1, N)
    run_both(jF.average_precision, tF.average_precision, (preds, target), atol=ATOL_MULTI, num_classes=C,
             average=average)


def test_average_precision_bad_average_raises():
    run_both(jF.average_precision, tF.average_precision, make_inputs("multiclass", seed=32), num_classes=C,
             average="samples")


def test_average_precision_without_positives_is_nan():
    preds = make_inputs("binary", seed=33, n=64)[0]
    got = run_both(jF.average_precision, tF.average_precision, (preds, np.zeros(64, np.int64)), atol=ATOL_BINARY,
                   pos_label=1)
    assert torch.isnan(got)


# ------------------------------------------------------------------ auc
@pytest.mark.parametrize("reorder", [False, True])
@pytest.mark.parametrize("order", ["ascending", "descending", "mixed"])
def test_auc(order, reorder):
    rng = np.random.RandomState(34)
    x = np.sort(rng.rand(40)).astype(np.float32)
    if order == "descending":
        x = x[::-1].copy()
    elif order == "mixed":
        x = rng.rand(40).astype(np.float32)
    y = rng.rand(40).astype(np.float32)
    run_both(jF.auc, tF.auc, (x, y), atol=ATOL_BINARY, reorder=reorder)


def test_auc_integer_points_and_shapes():
    run_both(jF.auc, tF.auc, (np.array([[0], [1], [2], [3]]), np.array([0, 1, 2, 2])), atol=ATOL_BINARY)
    run_both(jF.auc, tF.auc, (np.zeros((3, 2), np.float32), np.zeros(3, np.float32)))
    run_both(jF.auc, tF.auc, (np.arange(4, dtype=np.float32), np.arange(5, dtype=np.float32)))


# ------------------------------------------------------------------ calibration error
def _ce_inputs(kind, seed):
    rng = np.random.RandomState(seed)
    if kind == "binary_probs":
        return rng.rand(N).astype(np.float32), rng.randint(0, 2, N)
    if kind == "binary_logits":
        return (rng.randn(N) * 3).astype(np.float32), rng.randint(0, 2, N)
    if kind == "multiclass_probs":
        return make_inputs("multiclass", seed)
    if kind == "multiclass_logits":
        return (rng.randn(N, C) * 2).astype(np.float32), rng.randint(0, C, N)
    return make_inputs("mdmc", seed)


CE_KINDS = ["binary_probs", "binary_logits", "multiclass_probs", "multiclass_logits", "mdmc"]


@pytest.mark.parametrize("n_bins", [1, 10, 15])
@pytest.mark.parametrize("norm", ["l1", "l2", "max"])
@pytest.mark.parametrize("kind", CE_KINDS)
def test_calibration_error(kind, norm, n_bins):
    run_both(jF.calibration_error, tF.calibration_error, _ce_inputs(kind, seed=35), atol=ATOL_BINARY, norm=norm,
             n_bins=n_bins)


@pytest.mark.parametrize("kwargs", [{"norm": "l3"}, {"n_bins": 0}, {"n_bins": 2.5}])
def test_calibration_error_refuses_bad_arguments(kwargs):
    run_both(jF.calibration_error, tF.calibration_error, _ce_inputs("binary_probs", seed=36), **kwargs)


def test_calibration_error_refuses_multilabel():
    run_both(jF.calibration_error, tF.calibration_error, make_inputs("multilabel", seed=37))


@pytest.mark.parametrize("n_bins", [4, 15])
def test_bin_sums_counts_exact(n_bins):
    conf, acc = jce._ce_update(*[jnp.asarray(a) for a in _ce_inputs("multiclass_probs", seed=38)])
    bounds = jnp.linspace(0, 1, n_bins + 1, dtype=jnp.float32)
    t_bounds = tce._uniform_bin_boundaries(n_bins, torch.device("cpu"))
    np.testing.assert_array_equal(t_bounds.numpy(), np.asarray(bounds))
    count, conf_sum, acc_sum = jce._bin_sums(conf, acc, bounds)
    t_count, t_conf, t_acc = tce._bin_sums(torch.from_numpy(np.asarray(conf)), torch.from_numpy(np.asarray(acc)), t_bounds)
    assert t_count.dtype == torch.int32
    np.testing.assert_array_equal(t_count.numpy(), np.asarray(count))
    np.testing.assert_array_equal(t_acc.numpy(), np.asarray(acc_sum))
    np.testing.assert_allclose(t_conf.numpy(), np.asarray(conf_sum), rtol=1e-6, atol=1e-5)


def test_bin_edges_fall_in_the_same_bins():
    """Confidences exactly on the boundaries go where the JAX package puts them."""
    bounds = jnp.linspace(0, 1, 11, dtype=jnp.float32)
    conf = np.concatenate([np.asarray(bounds), np.nextafter(np.asarray(bounds), 2).astype(np.float32)])
    conf = np.clip(conf, 0, 1).astype(np.float32)
    acc = (np.arange(conf.size) % 2).astype(np.float32)
    want = jce._bin_sums(jnp.asarray(conf), jnp.asarray(acc), bounds)
    got = tce._bin_sums(torch.from_numpy(conf), torch.from_numpy(acc), tce._uniform_bin_boundaries(10, "cpu"))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("norm", ["l1", "l2", "max"])
@pytest.mark.parametrize("debias", [False, True])
def test_ce_compute_with_debias(norm, debias):
    conf, acc = jce._ce_update(*[jnp.asarray(a) for a in _ce_inputs("multiclass_logits", seed=39)])
    bounds = jnp.linspace(0, 1, 16, dtype=jnp.float32)
    want = jce._ce_compute(conf, acc, bounds, norm=norm, debias=debias)
    got = tce._ce_compute(torch.from_numpy(np.asarray(conf)), torch.from_numpy(np.asarray(acc)),
                          tce._uniform_bin_boundaries(15, "cpu"), norm=norm, debias=debias)
    assert_curve(want, got, ATOL_BINARY)


# ------------------------------------------------------------------ modules
MODULES = [
    ("PrecisionRecallCurve", {"pos_label": 1}, "binary", None),
    ("PrecisionRecallCurve", {"num_classes": C}, "multiclass", None),
    ("PrecisionRecallCurve", {"num_classes": C}, "multilabel", None),
    ("ROC", {"pos_label": 1}, "binary", None),
    ("ROC", {"num_classes": C}, "multiclass", None),
    ("ROC", {"num_classes": C}, "mdmc", None),
    ("AUROC", {"pos_label": 1}, "binary", ATOL_BINARY),
    ("AUROC", {"pos_label": 1, "max_fpr": 0.3}, "binary", ATOL_BINARY),
    ("AUROC", {"num_classes": C}, "multiclass", ATOL_MULTI),
    ("AUROC", {"num_classes": C, "average": "weighted"}, "multiclass", ATOL_MULTI),
    ("AUROC", {"num_classes": C, "average": None}, "multilabel", ATOL_MULTI),
    ("AUROC", {"num_classes": C, "average": "micro"}, "multilabel", ATOL_MULTI),
    ("AUROC", {"num_classes": C}, "mdmc", ATOL_MULTI),
    ("AveragePrecision", {"pos_label": 1}, "binary", ATOL_BINARY),
    ("AveragePrecision", {"num_classes": C}, "multiclass", ATOL_MULTI),
    ("AveragePrecision", {"num_classes": C, "average": "weighted"}, "multiclass", ATOL_MULTI),
    ("AveragePrecision", {"num_classes": C, "average": "micro"}, "multilabel", ATOL_MULTI),
    ("AveragePrecision", {"num_classes": C, "average": None}, "multilabel", ATOL_MULTI),
]


def _module_pair(name, kwargs):
    return getattr(jmt, name)(**kwargs), getattr(tmt, name)(device="cpu", **kwargs)


def _batches(kind, steps=3, seed=40, n=128):
    return [make_inputs(kind, seed=seed + i, n=n, decimals=2) for i in range(steps)]


@pytest.mark.parametrize("name,kwargs,kind,atol", MODULES)
def test_modules_over_several_updates(name, kwargs, kind, atol):
    jm, tm = _module_pair(name, kwargs)
    for preds, target in _batches(kind):
        jm.update(jnp.asarray(preds), jnp.asarray(target))
        tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert_curve(jm.compute(), tm.compute(), atol)


@pytest.mark.parametrize("name,kwargs,kind,atol", MODULES[::3])
def test_module_forward_gives_the_batch_value(name, kwargs, kind, atol):
    jm, tm = _module_pair(name, kwargs)
    for preds, target in _batches(kind, steps=2):
        assert_curve(jm(jnp.asarray(preds), jnp.asarray(target)), tm(torch.from_numpy(preds), torch.from_numpy(target)), atol)
    assert_curve(jm.compute(), tm.compute(), atol)


@pytest.mark.parametrize("norm", ["l1", "l2", "max"])
@pytest.mark.parametrize("kind", CE_KINDS)
def test_calibration_error_module(kind, norm):
    jm, tm = jmt.CalibrationError(n_bins=15, norm=norm), tmt.CalibrationError(n_bins=15, norm=norm, device="cpu")
    for i in range(3):
        preds, target = _ce_inputs(kind, seed=41 + i)
        jm.update(jnp.asarray(preds), jnp.asarray(target))
        tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    for state in ("count_bin", "acc_bin"):
        assert getattr(tm, state).dtype == torch.int32
        np.testing.assert_array_equal(getattr(tm, state).numpy(), np.asarray(getattr(jm, state)))
    np.testing.assert_allclose(tm.conf_bin.numpy(), np.asarray(jm.conf_bin), rtol=1e-6, atol=1e-5)
    assert_curve(jm.compute(), tm.compute(), ATOL_BINARY)


def test_calibration_error_module_refuses_bad_arguments_and_an_empty_compute():
    for kwargs in ({"norm": "l3"}, {"n_bins": 0}):
        with pytest.raises(ValueError):
            jmt.CalibrationError(**kwargs)
        with pytest.raises(ValueError):
            tmt.CalibrationError(device="cpu", **kwargs)
    with pytest.raises(ValueError, match="No samples"), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tmt.CalibrationError(device="cpu").compute()


@pytest.mark.parametrize("reorder", [False, True])
def test_auc_module(reorder):
    rng = np.random.RandomState(42)
    jm, tm = jmt.AUC(reorder=reorder), tmt.AUC(reorder=reorder, device="cpu")
    for i in range(3):
        x = ((np.arange(10) + 10 * i) / 30).astype(np.float32)  # an area of the size of a ROC curve's
        if reorder:
            x = rng.permutation(x)
        y = rng.rand(10).astype(np.float32)
        jm.update(jnp.asarray(x), jnp.asarray(y))
        tm.update(torch.from_numpy(x), torch.from_numpy(y))
    assert_curve(jm.compute(), tm.compute(), ATOL_BINARY)


@pytest.mark.parametrize("name,kwargs", [("AUROC", {"average": "bad"}), ("AUROC", {"max_fpr": 2.0}),
                                         ("AveragePrecision", {"average": "samples"})])
def test_module_arguments_are_checked(name, kwargs):
    with pytest.raises(ValueError):
        getattr(jmt, name)(**kwargs)
    with pytest.raises(ValueError):
        getattr(tmt, name)(device="cpu", **kwargs)


# ------------------------------------------------------------------ raw rows
@pytest.mark.parametrize("name", ["PrecisionRecallCurve", "ROC", "AUROC", "AveragePrecision"])
def test_update_appends_the_raw_rows(name):
    m = getattr(tmt, name)(num_classes=C, device="cpu")
    preds, target = (torch.from_numpy(a) for a in make_inputs("multiclass", seed=43, n=16))
    m.update(preds, target)
    assert m.preds[0] is preds and m.target[0] is target


def test_update_still_fails_fast():
    preds, target = make_inputs("multiclass", seed=44, n=16)
    for pkg, conv, dev in ((jmt, jnp.asarray, {}), (tmt, lambda a: torch.from_numpy(np.asarray(a)), {"device": "cpu"})):
        with pytest.raises(ValueError, match="number of classes"):
            pkg.PrecisionRecallCurve(num_classes=2, **dev).update(conv(preds), conv(target))
        with pytest.raises(ValueError, match="micro"):
            pkg.AveragePrecision(num_classes=C, average="micro", **dev).update(conv(preds), conv(target))
        with pytest.raises(ValueError, match="same number of dimensions"):
            pkg.ROC(**dev).update(conv(preds[:, :, None, None]), conv(target))
        m = pkg.AUROC(num_classes=C, **dev)
        m.update(conv(preds), conv(target))
        with pytest.raises(ValueError, match="should be constant"):
            m.update(conv(preds[:, 0]), conv(target % 2))
        with pytest.raises(ValueError):
            pkg.AUROC(**dev).update(conv(preds), conv(target + C))


def test_auroc_compute_without_any_update_raises():
    with pytest.raises(RuntimeError, match="determined mode"), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tmt.AUROC(device="cpu").compute()


def _mixed_binary_rows(seed=45):
    rng = np.random.RandomState(seed)
    return [(rng.rand(17).astype(np.float32), rng.randint(0, 2, 17)),
            (rng.rand(23, 1).astype(np.float32), rng.randint(0, 2, (23, 1))),
            (np.round(rng.rand(9), 1).astype(np.float32), rng.randint(0, 2, 9))]


@pytest.mark.parametrize("name,atol", [("AUROC", ATOL_BINARY), ("AveragePrecision", ATOL_BINARY),
                                       ("PrecisionRecallCurve", None), ("ROC", None)])
def test_mixed_rank_binary_rows(name, atol):
    jm, tm = _module_pair(name, {"pos_label": 1})
    for preds, target in _mixed_binary_rows():
        jm.update(jnp.asarray(preds), jnp.asarray(target))
        tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert_curve(jm.compute(), tm.compute(), atol)
    tm._canonicalize_list_states()
    assert all(p.ndim == 1 for p in tm.preds) and all(t.ndim == 1 for t in tm.target)


@pytest.mark.parametrize("name", ["PrecisionRecallCurve", "ROC", "AUROC", "AveragePrecision"])
def test_state_dict_and_pickle_rows_are_canonical_and_idempotent(name):
    kwargs = {"num_classes": C}
    jm, tm = _module_pair(name, kwargs)
    for preds, target in _batches("mdmc", steps=2, n=16):
        jm.update(jnp.asarray(preds), jnp.asarray(target))
        tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    jm.persistent(True)
    tm.persistent(True)
    j_sd, t_sd = jm.state_dict(), tm.state_dict()
    for key in ("preds", "target"):
        assert [r.shape for r in t_sd[key]] == [tuple(np.asarray(r).shape) for r in j_sd[key]]
        for jr, tr in zip(j_sd[key], t_sd[key]):
            np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    before = tm.compute()
    tm._canonicalize_list_states()
    tm._computed = None
    assert_curve(before, tm.compute())
    again = pickle.loads(pickle.dumps(tm))
    assert all(p.ndim == 2 for p in again.preds)
    assert_curve(before, again.compute())
    fresh = getattr(tmt, name)(device="cpu", **kwargs)
    fresh.persistent(True)
    fresh.load_state_dict(t_sd)
    if name == "AUROC":
        assert fresh.mode is None  # derived again at compute, from the canonical rows
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # a loaded state counts no update
        assert_curve(before, fresh.compute())


@pytest.mark.parametrize("name", ["PrecisionRecallCurve", "ROC"])
def test_rows_of_varying_extra_dims_are_canonicalised_first(name):
    rng = np.random.RandomState(46)
    jm, tm = _module_pair(name, {"num_classes": C})
    for x in (3, 5):
        preds = _softmax(rng.randn(4, C, x).astype(np.float32))
        target = rng.randint(0, C, (4, x))
        jm.update(jnp.asarray(preds), jnp.asarray(target))
        tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert_curve(jm.compute(), tm.compute())


@pytest.mark.parametrize("name,kwargs,kind,atol", [MODULES[6], MODULES[8], MODULES[13], MODULES[1]])
def test_load_reference_state_of_list_states(name, kwargs, kind, atol):
    jm, tm = _module_pair(name, kwargs)
    for preds, target in _batches(kind):
        jm.update(jnp.asarray(preds), jnp.asarray(target))
    state = {k: [np.asarray(v) for v in rows] for k, rows in jm.metric_state.items()}
    mode = getattr(jm, "mode", None)
    load_reference_state(tm, state, update_count=3, mode=None if mode is None else mode.value)
    assert len(tm.preds) == 3
    assert_curve(jm.compute(), tm.compute(), atol)
