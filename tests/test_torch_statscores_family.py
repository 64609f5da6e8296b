"""The port's Specificity, Dice (and the legacy ``dice_score``) and
HammingDistance against the JAX package on the same inputs.

Functional and module forms on binary, multi-class, multi-label and
multi-dim multi-class inputs made with numpy from a seed. tp/fp/tn/fn and
the Hamming counts must match exactly and stay int32; values agree within
atol=1e-6. Where the JAX package refuses a configuration, the port raises the
same exception type.
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
