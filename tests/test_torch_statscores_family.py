"""The port's Specificity, Dice (and the legacy ``dice_score``) and
HammingDistance against the JAX package on the same inputs.

Functional and module forms on binary, multi-class, multi-label and
multi-dim multi-class inputs made with numpy from a seed. tp/fp/tn/fn and
the Hamming counts must match exactly and stay int32; values agree within
atol=1e-6. Where the JAX package refuses a configuration, the port raises the
same exception type.
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
from metrics_tpu_torch.utils import checks as torch_checks
from tests.test_torch_classification import C, KINDS, MDMC, NUM_CLASSES, _softmax, assert_same, make_inputs, run_both

AVERAGES = ["micro", "macro", "weighted", "none", "samples"]


@pytest.fixture(autouse=True)
def _full_validation():
    jax_prev, torch_prev = jax_checks._get_validation_mode(), torch_checks._get_validation_mode()
    jax_checks.set_validation_mode("full")
    torch_checks.set_validation_mode("full")
    yield
    jax_checks.set_validation_mode(jax_prev)
    torch_checks.set_validation_mode(torch_prev)


def _kwargs(kind, average, **extra):
    kwargs = dict(average=average, num_classes=NUM_CLASSES[kind], **extra)
    if kind in MDMC:
        kwargs["mdmc_average"] = MDMC[kind]
    return kwargs


# ---------------------------------------------------------------- functional
@pytest.mark.parametrize("average", AVERAGES)
@pytest.mark.parametrize("kind", KINDS)
def test_specificity(kind, average):
    run_both(jF.specificity, tF.specificity, make_inputs(kind, seed=41), **_kwargs(kind, average))


@pytest.mark.parametrize("zero_division", [0, 1])
@pytest.mark.parametrize("average", AVERAGES)
@pytest.mark.parametrize("kind", KINDS)
def test_dice(kind, average, zero_division):
    kwargs = _kwargs(kind, average, zero_division=zero_division)
    kwargs.setdefault("mdmc_average", "global")
    run_both(jF.dice, tF.dice, make_inputs(kind, seed=43), **kwargs)


@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none"])
@pytest.mark.parametrize("mdmc_average", ["global", "samplewise"])
@pytest.mark.parametrize("name", ["specificity", "dice"])
def test_mdmc_average(name, mdmc_average, average):
    run_both(getattr(jF, name), getattr(tF, name), make_inputs("mdmc_probs", seed=45), average=average,
             num_classes=C, mdmc_average=mdmc_average)


@pytest.mark.parametrize("ignore_index", [0, 2, -1])
@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none"])
@pytest.mark.parametrize("name", ["specificity", "dice"])
def test_ignore_index(name, average, ignore_index):
    preds, target = make_inputs("mc_probs", seed=47)
    if ignore_index < 0:
        target = target.copy()
        target[::4] = ignore_index
    run_both(getattr(jF, name), getattr(tF, name), (preds, target), average=average, num_classes=C,
             ignore_index=ignore_index)


@pytest.mark.parametrize("zero_division", [0, 1])
@pytest.mark.parametrize("average", ["macro", "weighted", "none"])
def test_dice_zero_division_with_absent_classes(average, zero_division):
    rng = np.random.RandomState(49)
    preds, target = rng.randint(0, C - 2, 60), rng.randint(0, C - 2, 60)  # the last two classes never appear
    run_both(jF.dice, tF.dice, (preds, target), average=average, num_classes=C, zero_division=zero_division)


@pytest.mark.parametrize("reduction", ["elementwise_mean", "sum", "none"])
@pytest.mark.parametrize("bg", [False, True])
def test_dice_score(bg, reduction):
    rng = np.random.RandomState(51)
    preds, target = _softmax(rng.randn(40, C)), rng.randint(0, C, 40)
    run_both(jF.dice_score, tF.dice_score, (preds, target), bg=bg, reduction=reduction)


@pytest.mark.parametrize("no_fg_score", [0.0, 0.25])
@pytest.mark.parametrize("nan_score", [0.0, 0.5])
def test_dice_score_empty_classes(nan_score, no_fg_score):
    """Class C-1 never in target (no foreground); the others predicted only as class 0."""
    rng = np.random.RandomState(53)
    logits = rng.randn(40, C).astype(np.float32)
    logits[:, 0] += 10.0
    preds, target = _softmax(logits), rng.randint(0, C - 1, 40)
    run_both(jF.dice_score, tF.dice_score, (preds, target), nan_score=nan_score, no_fg_score=no_fg_score,
             reduction="none")
    # mdmc probability maps (N, C, X)
    preds, target = make_inputs("mdmc_probs", seed=55)
    run_both(jF.dice_score, tF.dice_score, (preds, target), nan_score=nan_score, no_fg_score=no_fg_score)


def test_dice_score_bad_reduction_raises_like_jax():
    preds, target = _softmax(np.random.RandomState(57).randn(8, C)), np.arange(8) % C
    run_both(jF.dice_score, tF.dice_score, (preds, target), reduction="max")


@pytest.mark.parametrize("threshold", [0.3, 0.5])
@pytest.mark.parametrize("kind", KINDS)
def test_hamming_distance(kind, threshold):
    run_both(jF.hamming_distance, tF.hamming_distance, make_inputs(kind, seed=59), threshold=threshold)


@pytest.mark.parametrize("name", ["specificity", "dice"])
@pytest.mark.parametrize("kwargs", [dict(average="bad", num_classes=C), dict(average="macro"),
                                    dict(average="macro", num_classes=C, mdmc_average="bad"),
                                    dict(average="macro", num_classes=C, ignore_index=C)])
def test_functional_misuse_raises_like_jax(name, kwargs):
    run_both(getattr(jF, name), getattr(tF, name), make_inputs("mc_probs", seed=61), **kwargs)


@pytest.mark.parametrize("cls_name", ["Specificity", "Dice"])
def test_module_bad_average_raises_like_jax(cls_name):
    with pytest.raises(ValueError):
        getattr(jmt, cls_name)(average="bad", num_classes=C)
    with pytest.raises(ValueError):
        getattr(tmt, cls_name)(average="bad", num_classes=C, device="cpu")


# ------------------------------------------------------------------- modules
MODULES = [
    ("Specificity", dict(num_classes=C, average="macro")),
    ("Specificity", dict(num_classes=C, average="weighted", ignore_index=1)),
    ("Specificity", dict(num_classes=C, average="none")),
    ("Specificity", dict(average="micro")),
    ("Dice", dict(num_classes=C, average="macro")),
    ("Dice", dict(num_classes=C, average="none", zero_division=1)),
    ("Dice", dict(average="micro")),
    ("Dice", dict(num_classes=C, average="samples")),
    ("HammingDistance", dict()),
    ("HammingDistance", dict(threshold=0.3)),
]


@pytest.mark.parametrize("kind", ["mc_probs", "mc_labels"])
@pytest.mark.parametrize("cls_name,kwargs", MODULES, ids=[f"{m}-{i}" for i, (m, _) in enumerate(MODULES)])
def test_module_forward_update_compute(cls_name, kwargs, kind):
    jm = getattr(jmt, cls_name)(**kwargs)
    tm = getattr(tmt, cls_name)(device="cpu", **kwargs)
    for step in range(3):
        preds, target = make_inputs(kind, seed=500 + step)
        if step == 1:
            assert_same(jm(jnp.asarray(preds), jnp.asarray(target)), tm(torch.from_numpy(preds), torch.from_numpy(target)))
        else:
            jm.update(jnp.asarray(preds), jnp.asarray(target))
            tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert_same(jm.compute(), tm.compute())
    for name, value in jm.metric_state.items():
        got = getattr(tm, name)
        assert_same([np.asarray(v) for v in value] if isinstance(value, list) else value, got)


@pytest.mark.parametrize("mdmc_average", ["global", "samplewise"])
@pytest.mark.parametrize("cls_name", ["Specificity", "Dice"])
def test_module_mdmc(cls_name, mdmc_average):
    kwargs = dict(num_classes=C, average="macro", mdmc_average=mdmc_average)
    jm, tm = getattr(jmt, cls_name)(**kwargs), getattr(tmt, cls_name)(device="cpu", **kwargs)
    for step in range(2):
        preds, target = make_inputs("mdmc_probs", seed=510 + step)
        jm.update(jnp.asarray(preds), jnp.asarray(target))
        tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert_same(jm.compute(), tm.compute())


@pytest.mark.parametrize("kind", ["binary", "multilabel", "mc_probs", "mdmc_probs"])
def test_hamming_states_stay_int32(kind):
    jm, tm = jmt.HammingDistance(), tmt.HammingDistance(device="cpu")
    for step in range(3):
        preds, target = make_inputs(kind, seed=520 + step)
        jm.update(jnp.asarray(preds), jnp.asarray(target))
        tm.update(torch.from_numpy(preds), torch.from_numpy(target))
        assert tm.correct.dtype == torch.int32 and tm.total.dtype == torch.int32
    assert_same(jm.correct, tm.correct)
    assert_same(jm.total, tm.total)
    assert_same(jm.compute(), tm.compute())


# ------------------------------------------- class ids against the one-hot
# Multi-class updates reduced over every position take the class ids and one pair histogram; every other
# update the one-hot. Each case runs an update both ways (the one-hot forced by replacing the module's
# ``_takes_class_ids``) and against the JAX package: the states must be equal, bit for bit and int32.
IDS_N, IDS_C, IDS_H, IDS_W = 24, 5, 3, 4
STAT_SCORES = importlib.import_module("metrics_tpu_torch.functional.classification.stat_scores")


def make_id_inputs(kind, seed):
    """Multi-class inputs of the class-id path: scores or labels, flat or ``(H, W)`` maps, tied scores, labels
    outside ``[0, C)``, an empty batch."""
    rng = np.random.RandomState(seed)
    n, c, hw = IDS_N, IDS_C, (IDS_H, IDS_W)
    if kind == "probs":
        return _softmax(rng.randn(n, c)), rng.randint(0, c, n)
    if kind == "probs_hw":
        return _softmax(rng.randn(n, c, *hw).swapaxes(1, -1)).swapaxes(1, -1).copy(), rng.randint(0, c, (n, *hw))
    if kind == "labels":
        return rng.randint(0, c, n), rng.randint(0, c, n)
    if kind == "labels_hw":
        return rng.randint(0, c, (n, *hw)), rng.randint(0, c, (n, *hw))
    if kind == "ties":  # scores from {0, 0.5}: most rows tie, some rows are all zero
        return (0.5 * rng.randint(0, 2, (n, c))).astype(np.float32), rng.randint(0, c, n)
    if kind == "outside":  # labels at -2 and at C on both sides: their one-hot columns are all zero
        preds, target = rng.randint(-2, c + 1, n), rng.randint(-2, c + 1, n)
        return preds, target
    if kind == "empty":
        return np.zeros((0, c), np.float32), np.zeros((0,), np.int64)
    raise ValueError(kind)


ID_KINDS = ["probs", "probs_hw", "labels", "labels_hw", "ties", "outside", "empty"]


@pytest.fixture
def onehot_only(monkeypatch):
    """Force a module's update onto the one-hot path, as the inputs that the class ids do not take go."""

    def force(module):
        monkeypatch.setattr(module, "_takes_class_ids", lambda *a, **k: False)

    return force


def _forms_after(fn, *args, **kwargs):
    """``fn``'s result or exception type, and the canonicalizations by form it made."""
    before = torch_checks.canon_stats()
    try:
        out = fn(*args, **kwargs)
    except (ValueError, RuntimeError, TypeError) as err:
        out = type(err)
    after = torch_checks.canon_stats()
    return out, {k: after[k] - before[k] for k in after}


def _same_as_reference(jax_fn, got, arrays, **kwargs):
    """The JAX package's result on the same arrays equals ``got``, or it raises the exception type ``got`` is."""
    try:
        expected = jax_fn(*[jnp.asarray(a) for a in arrays], **kwargs)
    except (ValueError, RuntimeError, TypeError) as err:
        assert got is type(err)
        return
    assert_same(expected, got)


def _same_state(a, b):
    if isinstance(a, type) or isinstance(b, type):
        assert a is b
        return
    assert a.dtype == b.dtype == torch.int32 and a.shape == b.shape
    assert torch.equal(a, b)


# an empty batch with a negative ignore_index fails in both packages before either form (the mask's reshape)
ID_CASES = [(k, i) for k in ID_KINDS for i in (None, 2, -1) if not (k == "empty" and i == -1)]


@pytest.mark.parametrize("mdmc_reduce", [None, "global"])
@pytest.mark.parametrize("reduce", ["micro", "macro"])
@pytest.mark.parametrize("kind,ignore_index", ID_CASES)
def test_class_ids_equal_the_onehot_and_the_reference(kind, reduce, mdmc_reduce, ignore_index, onehot_only):
    preds, target = make_id_inputs(kind, seed=601)
    if ignore_index == -1 and len(target):
        target = target.copy()
        target[::5] = -1
    if kind == "outside":  # labels outside the classes pass only with the value checks off
        jax_checks.set_validation_mode("off")
        torch_checks.set_validation_mode("off")
    # an empty batch implies no class, which num_classes would not match
    num_classes = None if kind == "empty" else IDS_C
    kwargs = dict(reduce=reduce, mdmc_reduce=mdmc_reduce, num_classes=num_classes, ignore_index=ignore_index)
    ids, ids_forms = _forms_after(tF.stat_scores, torch.from_numpy(preds), torch.from_numpy(target), **kwargs)
    onehot_only(STAT_SCORES)
    onehot, onehot_forms = _forms_after(tF.stat_scores, torch.from_numpy(preds), torch.from_numpy(target), **kwargs)
    _same_state(ids, onehot)
    _same_as_reference(jF.stat_scores, ids, (preds, target), **kwargs)
    assert onehot_forms["perf_canon_class_ids"] == 0
    if kind == "empty":  # no position: the one-hot form, as before (macro refuses a missing num_classes first)
        assert ids_forms == {"perf_canon_class_ids": 0, "perf_canon_onehot": int(reduce == "micro")}
    else:
        assert ids_forms == {"perf_canon_class_ids": 1, "perf_canon_onehot": 0}


FALLBACKS = {
    "top_k_2": (tF.stat_scores, jF.stat_scores, "probs", dict(reduce="macro", num_classes=IDS_C, top_k=2)),
    "multiclass_false": (tF.stat_scores, jF.stat_scores, "two_probs", dict(reduce="micro", multiclass=False)),
    "samples": (tF.stat_scores, jF.stat_scores, "probs", dict(reduce="samples", num_classes=IDS_C)),
    "samplewise": (tF.stat_scores, jF.stat_scores, "probs_hw",
                   dict(reduce="macro", num_classes=IDS_C, mdmc_reduce="samplewise")),
    "hamming": (tF.hamming_distance, jF.hamming_distance, "probs", dict()),
    # 4 positions of 5 classes: the (C + 1)**2 pair bins outnumber the one-hot's entries
    "few_positions": (tF.stat_scores, jF.stat_scores, "few_probs", dict(reduce="macro", num_classes=IDS_C)),
}


@pytest.mark.parametrize("name", sorted(FALLBACKS))
def test_what_the_class_ids_cannot_express_takes_the_onehot(name):
    torch_fn, jax_fn, kind, kwargs = FALLBACKS[name]
    if kind == "two_probs":
        preds, target = _softmax(np.random.RandomState(603).randn(IDS_N, 2)), np.arange(IDS_N) % 2
    elif kind == "few_probs":
        preds, target = make_id_inputs("probs", seed=603)
        preds, target = preds[:4], target[:4]
    else:
        preds, target = make_id_inputs(kind, seed=603)
    _, forms = _forms_after(run_both, jax_fn, torch_fn, (preds, target), **kwargs)
    assert forms == {"perf_canon_class_ids": 0, "perf_canon_onehot": 1}


VMAP_K = 3


@pytest.mark.parametrize("cls_name,kwargs,kind", [
    ("Dice", dict(num_classes=IDS_C, average="macro", mdmc_average="global"), "probs_hw"),
    ("StatScores", dict(reduce="micro", num_classes=IDS_C, ignore_index=1), "labels"),
    ("Precision", dict(num_classes=IDS_C, average="macro", ignore_index=-1), "probs"),
])
def test_class_ids_under_vmap_equal_the_onehot_and_the_reference(cls_name, kwargs, kind, onehot_only):
    """A batch of states updated under ``torch.func.vmap``: the pair histogram through the bincount's batched
    rule, against the one-hot path vmapped the same way and JAX's ``jax.vmap``."""
    import jax

    batches = [[make_id_inputs(kind, seed=610 + 10 * s + r) for r in range(VMAP_K)] for s in range(2)]
    if kwargs.get("ignore_index") == -1:
        for step in batches:
            for _, target in step:
                target[::3] = -1
    cols = [[np.stack([b[i] for b in step]) for i in range(2)] for step in batches]

    def run_port():
        tm = getattr(tmt, cls_name)(device="cpu", **kwargs)
        st = tmt.stack_states([tm.init() for _ in range(VMAP_K)])
        for p, t in cols:
            st = torch.func.vmap(lambda s, a, b: tm.apply_update(s, a, b))(st, torch.from_numpy(p), torch.from_numpy(t))
        return st.states

    ids, ids_forms = _forms_after(run_port)
    onehot_only(STAT_SCORES)
    onehot = run_port()
    jm = getattr(jmt, cls_name)(**kwargs)
    js = jax.tree.map(lambda x: jnp.stack([x] * VMAP_K), jm.init())
    for p, t in cols:
        js = jax.vmap(lambda s, a, b: jm.apply_update(s, a, b))(js, jnp.asarray(p), jnp.asarray(t))
    assert ids_forms == {"perf_canon_class_ids": 2, "perf_canon_onehot": 0}
    assert sorted(ids) == sorted(onehot) == ["fn", "fp", "tn", "tp"]
    for name in ids:
        _same_state(ids[name], onehot[name])
        assert_same(js.states[name], ids[name])
