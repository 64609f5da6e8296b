"""The port's confusion-matrix metrics against the JAX package on the same inputs.

CohenKappa, MatthewsCorrCoef and JaccardIndex, functional and module, on
binary, multi-class, multi-label and multi-dim multi-class inputs made with
numpy from a seed. The int32 confusion matrix must match exactly; values
agree within atol=1e-6. Also: ``high_precision``, the state that
``JaccardIndex.compute`` must leave alone, and states carried across from
the JAX package with ``load_reference_state``.
"""
import importlib

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
from metrics_tpu_torch.utils.compute import high_precision
from tests.test_torch_classification import C, assert_same, make_inputs, run_both
from tests.test_torch_statscores_family import (  # noqa: F401 - onehot_only is a fixture
    ID_KINDS,
    IDS_C,
    VMAP_K,
    _forms_after,
    _same_as_reference,
    _same_state,
    make_id_inputs,
    onehot_only,
)


@pytest.fixture(autouse=True)
def _full_validation():
    jax_prev, torch_prev = jax_checks._get_validation_mode(), torch_checks._get_validation_mode()
    jax_checks.set_validation_mode("full")
    torch_checks.set_validation_mode("full")
    yield
    jax_checks.set_validation_mode(jax_prev)
    torch_checks.set_validation_mode(torch_prev)


def _num_classes(kind):
    return 2 if kind in ("binary", "multilabel") else C


def _absent_last_class(seed):
    """Multi-class labels that never reach class C-1, in preds or target."""
    rng = np.random.RandomState(seed)
    return rng.randint(0, C - 1, 80), rng.randint(0, C - 1, 80)


# ---------------------------------------------------------------- functional
@pytest.mark.parametrize("weights", [None, "none", "linear", "quadratic"])
@pytest.mark.parametrize("kind", ["binary", "mc_probs", "mc_labels", "multilabel"])
def test_cohen_kappa(kind, weights):
    run_both(jF.cohen_kappa, tF.cohen_kappa, make_inputs(kind, seed=21), num_classes=_num_classes(kind), weights=weights)


@pytest.mark.parametrize("kind", ["binary", "mc_probs", "mc_labels", "multilabel", "mdmc_probs"])
def test_matthews_corrcoef(kind):
    run_both(jF.matthews_corrcoef, tF.matthews_corrcoef, make_inputs(kind, seed=23), num_classes=_num_classes(kind))


@pytest.mark.parametrize("threshold", [0.3, 0.7])
def test_matthews_corrcoef_multilabel_threshold(threshold):
    run_both(jF.matthews_corrcoef, tF.matthews_corrcoef, make_inputs("multilabel", seed=25), num_classes=2,
             threshold=threshold)


def test_matthews_corrcoef_degenerate_is_zero():
    # every prediction one class: a zero denominator gives 0, not NaN
    preds, target = np.zeros(10, dtype=np.int64), np.arange(10) % 2
    assert float(run_both(jF.matthews_corrcoef, tF.matthews_corrcoef, (preds, target), num_classes=2)) == 0.0


@pytest.mark.parametrize("ignore_index", [None, 0, 2, C, -1])
@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none", None])
@pytest.mark.parametrize("kind", ["mc_probs", "mc_labels", "mdmc_probs"])
def test_jaccard_index(kind, average, ignore_index):
    run_both(jF.jaccard_index, tF.jaccard_index, make_inputs(kind, seed=27), num_classes=C, average=average,
             ignore_index=ignore_index)


@pytest.mark.parametrize("ignore_index", [None, 1])
@pytest.mark.parametrize("absent_score", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("average", ["macro", "weighted", "none"])
def test_jaccard_index_absent_score(average, absent_score, ignore_index):
    run_both(jF.jaccard_index, tF.jaccard_index, _absent_last_class(29), num_classes=C, average=average,
             absent_score=absent_score, ignore_index=ignore_index)


@pytest.mark.parametrize("kind", ["binary", "multilabel"])
def test_jaccard_index_binary_and_multilabel_inputs(kind):
    run_both(jF.jaccard_index, tF.jaccard_index, make_inputs(kind, seed=31), num_classes=2)


def test_misuse_raises_like_jax():
    preds, target = make_inputs("mc_labels", seed=33)
    run_both(jF.cohen_kappa, tF.cohen_kappa, (preds, target), num_classes=C, weights="cubic")
    run_both(jF.jaccard_index, tF.jaccard_index, (preds, target), num_classes=C, average="samples")
    run_both(jF.matthews_corrcoef, tF.matthews_corrcoef, (preds, target + C), num_classes=C)
    with pytest.raises(ValueError):
        jmt.CohenKappa(num_classes=C, weights="cubic")
    with pytest.raises(ValueError):
        tmt.CohenKappa(num_classes=C, weights="cubic", device="cpu")


# ------------------------------------------------------------------- modules
MODULES = [
    ("CohenKappa", dict(num_classes=C)),
    ("CohenKappa", dict(num_classes=C, weights="linear")),
    ("CohenKappa", dict(num_classes=C, weights="quadratic")),
    ("MatthewsCorrCoef", dict(num_classes=C)),
    ("JaccardIndex", dict(num_classes=C)),
    ("JaccardIndex", dict(num_classes=C, average="weighted", ignore_index=0)),
    ("JaccardIndex", dict(num_classes=C, average="none", ignore_index=C)),
    ("JaccardIndex", dict(num_classes=C, average="micro", absent_score=1.0)),
]


@pytest.mark.parametrize("kind", ["mc_probs", "mc_labels", "mdmc_probs"])
@pytest.mark.parametrize("cls_name,kwargs", MODULES, ids=[f"{m}-{i}" for i, (m, _) in enumerate(MODULES)])
def test_module_forward_update_compute(cls_name, kwargs, kind):
    jm = getattr(jmt, cls_name)(**kwargs)
    tm = getattr(tmt, cls_name)(device="cpu", **kwargs)
    for step in range(3):
        preds, target = make_inputs(kind, seed=400 + step)
        if step == 1:  # forward: the batch value, and the batch is accumulated
            assert_same(jm(jnp.asarray(preds), jnp.asarray(target)), tm(torch.from_numpy(preds), torch.from_numpy(target)))
        else:
            jm.update(jnp.asarray(preds), jnp.asarray(target))
            tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert_same(jm.confmat, tm.confmat)
    assert_same(jm.compute(), tm.compute())


@pytest.mark.parametrize("cls_name", ["CohenKappa", "MatthewsCorrCoef", "JaccardIndex"])
def test_module_binary_inputs(cls_name):
    jm, tm = getattr(jmt, cls_name)(num_classes=2), getattr(tmt, cls_name)(num_classes=2, device="cpu")
    for step in range(2):
        preds, target = make_inputs("binary", seed=410 + step)
        jm.update(jnp.asarray(preds), jnp.asarray(target))
        tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert_same(jm.confmat, tm.confmat)
    assert_same(jm.compute(), tm.compute())


def test_jaccard_multilabel_module():
    """The (C, 2, 2) state accumulates exactly; ``compute`` refuses it in both packages."""
    jm = jmt.JaccardIndex(num_classes=C, multilabel=True)
    tm = tmt.JaccardIndex(num_classes=C, multilabel=True, device="cpu")
    for step in range(2):
        preds, target = make_inputs("multilabel", seed=420 + step)
        jm.update(jnp.asarray(preds), jnp.asarray(target))
        tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert_same(jm.confmat, tm.confmat)
    with pytest.raises(ValueError):
        jm.compute()
    with pytest.raises(ValueError):
        tm.compute()


@pytest.mark.parametrize("average", ["macro", "weighted", "none"])
@pytest.mark.parametrize("ignore_index", [0, 3])
def test_jaccard_compute_leaves_the_state_alone(ignore_index, average):
    tm = tmt.JaccardIndex(num_classes=C, ignore_index=ignore_index, average=average, device="cpu")
    preds, target = make_inputs("mc_labels", seed=430)
    tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    before = tm.confmat.clone()
    assert int(before[ignore_index].sum()) > 0
    first = tm.compute().clone()
    tm._computed = None  # compute again from the state, not from the cache
    second = tm.compute()
    assert torch.equal(tm.confmat, before)
    assert torch.equal(first, second)


@pytest.mark.parametrize("cls_name,kwargs", [("CohenKappa", dict(num_classes=C, weights="quadratic")),
                                             ("JaccardIndex", dict(num_classes=C, ignore_index=1))])
def test_load_reference_state(cls_name, kwargs):
    jm = getattr(jmt, cls_name)(**kwargs)
    for step in range(2):
        preds, target = make_inputs("mc_probs", seed=440 + step)
        jm.update(jnp.asarray(preds), jnp.asarray(target))
    tm = getattr(tmt, cls_name)(device="cpu", **kwargs)
    load_reference_state(tm, {k: np.asarray(v) for k, v in jm.metric_state.items()}, update_count=2)
    assert_same(jm.compute(), tm.compute())


# ------------------------------------------- class ids against the one-hot
CONFUSION_MATRIX = importlib.import_module("metrics_tpu_torch.functional.classification.confusion_matrix")


@pytest.mark.parametrize("multilabel", [False, True])
@pytest.mark.parametrize("kind", ID_KINDS + ["few_probs", "binary", "multilabel"])
def test_class_ids_equal_the_onehot_and_the_reference(kind, multilabel, onehot_only):
    """The confusion matrix of multi-class inputs from their class ids, with no one-hot: equal, bit for bit, to
    the one-hot's arg-max route and to the JAX package, whatever the batch's size (``few_probs``: 4 positions
    of 5 classes). Binary and multi-label inputs take neither form."""
    if kind in ("binary", "multilabel"):
        preds, target = make_inputs(kind, seed=605)
    elif kind == "few_probs":
        preds, target = make_id_inputs("probs", seed=605)
        preds, target = preds[:4], target[:4]
    else:
        preds, target = make_id_inputs(kind, seed=605)
    if kind == "outside":  # labels outside the classes pass only with the value checks off
        jax_checks.set_validation_mode("off")
        torch_checks.set_validation_mode("off")
    # multilabel=True on a multi-class input keeps the labels' shape: its broadcast check raises as in JAX
    num_classes = 2 if kind == "binary" else (C if kind == "multilabel" else IDS_C)
    kwargs = dict(num_classes=num_classes, multilabel=multilabel)
    ids, ids_forms = _forms_after(tF.confusion_matrix, torch.from_numpy(preds), torch.from_numpy(target), **kwargs)
    onehot_only(CONFUSION_MATRIX)
    onehot, onehot_forms = _forms_after(tF.confusion_matrix, torch.from_numpy(preds), torch.from_numpy(target),
                                        **kwargs)
    _same_state(ids, onehot)
    _same_as_reference(jF.confusion_matrix, ids, (preds, target), **kwargs)
    assert onehot_forms["perf_canon_class_ids"] == 0
    if kind in ("binary", "multilabel"):
        assert ids_forms == onehot_forms == {"perf_canon_class_ids": 0, "perf_canon_onehot": 0}
    elif kind == "empty":
        assert ids_forms == {"perf_canon_class_ids": 0, "perf_canon_onehot": 1}
    else:
        assert ids_forms == {"perf_canon_class_ids": 1, "perf_canon_onehot": 0}


@pytest.mark.parametrize("cls_name,kind", [("JaccardIndex", "probs_hw"), ("ConfusionMatrix", "labels"),
                                           ("MatthewsCorrCoef", "outside")])
def test_class_ids_under_vmap_equal_the_onehot_and_the_reference(cls_name, kind, onehot_only):
    """A batch of confusion matrices updated under ``torch.func.vmap`` (as the tenant planes stack them): the
    class ids through the bincount's batched rule, against the one-hot route vmapped and JAX's ``jax.vmap``."""
    import jax

    batches = [[make_id_inputs(kind, seed=620 + 10 * s + r) for r in range(VMAP_K)] for s in range(2)]
    cols = [[np.stack([b[i] for b in step]) for i in range(2)] for step in batches]

    def run_port():
        tm = getattr(tmt, cls_name)(num_classes=IDS_C, device="cpu")
        st = tmt.stack_states([tm.init() for _ in range(VMAP_K)])
        for p, t in cols:
            st = torch.func.vmap(lambda s, a, b: tm.apply_update(s, a, b))(st, torch.from_numpy(p), torch.from_numpy(t))
        return st.states["confmat"]

    ids, ids_forms = _forms_after(run_port)
    onehot_only(CONFUSION_MATRIX)
    onehot = run_port()
    jm = getattr(jmt, cls_name)(num_classes=IDS_C)
    js = jax.tree.map(lambda x: jnp.stack([x] * VMAP_K), jm.init())
    for p, t in cols:
        js = jax.vmap(lambda s, a, b: jm.apply_update(s, a, b))(js, jnp.asarray(p), jnp.asarray(t))
    assert ids_forms == {"perf_canon_class_ids": 2, "perf_canon_onehot": 0}
    _same_state(ids, onehot)
    assert_same(js.states["confmat"], ids)


# ------------------------------------------------------------ high_precision
@pytest.fixture
def _restore_matmul_precision():
    prev = torch.get_float32_matmul_precision()
    yield
    torch.set_float32_matmul_precision(prev)


@pytest.mark.parametrize("caller", ["highest", "high", "medium"])
def test_high_precision_restores_the_callers_setting(_restore_matmul_precision, caller):
    torch.set_float32_matmul_precision(caller)
    seen = high_precision(torch.get_float32_matmul_precision)()
    assert seen == "highest"
    assert torch.get_float32_matmul_precision() == caller

    @high_precision
    def boom():
        raise KeyError("inside")

    with pytest.raises(KeyError, match="inside"):
        boom()
    assert torch.get_float32_matmul_precision() == caller


def test_cohen_kappa_under_tf32_setting(_restore_matmul_precision):
    """Counts above 2048: the caller's "high" setting does not reach kappa's product."""
    rng = np.random.RandomState(35)
    preds, target = rng.randint(0, 3, 30000), rng.randint(0, 3, 30000)
    torch.set_float32_matmul_precision("high")
    expected = jF.cohen_kappa(jnp.asarray(preds), jnp.asarray(target), num_classes=3, weights="quadratic")
    got = tF.cohen_kappa(torch.from_numpy(preds), torch.from_numpy(target), num_classes=3, weights="quadratic")
    assert torch.get_float32_matmul_precision() == "high"
    assert_same(expected, got)
