"""The port's sort-based exact AUROC and AP against the JAX package's.

``metrics_tpu_torch.ops.sorted_curves`` against ``metrics_tpu.ops.sorted_curves``
(the reference formulations: the JAX package's autotuner is off here) on the
same numpy inputs: binary scores with ties of every length, signed zeros and
NaNs, degenerate and empty inputs, and multi-class scores with each average,
the one batched sort over the classes included. Areas agree within atol 1e-6
(binary) and 1e-5 (multi-class), the JAX package's own tolerances
(`tests/ops/test_sorted_curves.py`); midranks exactly. The sorted areas must
also equal the port's own eager curve path, as they do in the JAX package.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.functional as jF
import metrics_tpu_torch.functional as tF
from metrics_tpu.ops import sorted_curves as J
from metrics_tpu_torch.ops import sorted_curves as T

NUM_CLASSES = 5
ATOL_BINARY, ATOL_MULTI = 1e-6, 1e-5


def _binary_case(seed, n=257, tie_decimals=2):
    rng = np.random.RandomState(seed)
    preds = np.round(rng.rand(n), tie_decimals).astype(np.float32)
    target = (rng.rand(n) > 0.45).astype(np.int32)
    return preds, target


def _multiclass_case(seed, n=300, num_classes=NUM_CLASSES, decimals=None):
    rng = np.random.RandomState(seed)
    p = rng.rand(n, num_classes).astype(np.float32)
    preds = (p / p.sum(1, keepdims=True)).astype(np.float32)
    if decimals is not None:
        preds = np.round(preds, decimals).astype(np.float32)
    return preds, rng.randint(0, num_classes, n).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(want, got, atol):
    g = got.numpy()
    assert got.dtype == torch.float32 and g.shape == np.asarray(want).shape
    np.testing.assert_allclose(g, np.asarray(want), atol=atol, rtol=0, equal_nan=True)


def test_midranks_ties():
    x = np.array([3.0, 1.0, 3.0, 2.0, 3.0], np.float32)
    np.testing.assert_array_equal(T.midranks(_t(x)).numpy(), [4.0, 1.0, 4.0, 2.0, 4.0])


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("decimals", [0, 1, 3, None])
def test_midranks_bit_for_bit(seed, decimals):
    x = np.random.RandomState(seed).randn(400).astype(np.float32)
    if decimals is not None:
        x = np.round(x, decimals).astype(np.float32)
    np.testing.assert_array_equal(T.midranks(_t(x)).numpy(), np.asarray(J.midranks(jnp.asarray(x))))


def test_midranks_signed_zeros_share_a_run_and_nans_do_not():
    x = np.array([0.0, -0.0, np.nan, 1.0, -0.0, np.nan, -1.0], np.float32)
    got = T.midranks(_t(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(J.midranks(jnp.asarray(x))))
    assert got[0] == got[1] == got[4] == 3.0 and got[2] != got[5]


def test_tie_run_ids_rows():
    rows = torch.tensor([[0.0, 0.0, 1.0, 2.0, 2.0], [-1.0, 0.0, -0.0, 0.0, 5.0]])
    np.testing.assert_array_equal(T._tie_run_ids(rows).numpy(), [[0, 0, 1, 2, 2], [0, 1, 1, 1, 2]])


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("tie_decimals", [1, 2, 6])
def test_binary_auroc(seed, tie_decimals):
    preds, target = _binary_case(seed, tie_decimals=tie_decimals)
    _close(J.binary_auroc_sorted(preds, target), T.binary_auroc_sorted(_t(preds), _t(target)), ATOL_BINARY)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("tie_decimals", [1, 2, 6])
def test_binary_average_precision(seed, tie_decimals):
    preds, target = _binary_case(seed, tie_decimals=tie_decimals)
    _close(J.binary_average_precision_sorted(preds, target), T.binary_average_precision_sorted(_t(preds), _t(target)),
           ATOL_BINARY)


def test_binary_signed_zeros_and_nans():
    preds, target = _binary_case(7, n=400, tie_decimals=1)
    preds = preds - np.float32(0.5)
    preds[::9] = -0.0
    preds[4::31] = np.nan
    for j_fn, t_fn in ((J.binary_auroc_sorted, T.binary_auroc_sorted),
                       (J.binary_average_precision_sorted, T.binary_average_precision_sorted)):
        _close(j_fn(preds, target), t_fn(_t(preds), _t(target)), ATOL_BINARY)


def test_binary_rows_of_shape_n_by_one():
    preds, target = _binary_case(8)
    _close(J.binary_auroc_sorted(preds, target), T.binary_auroc_sorted(_t(preds[:, None]), _t(target[:, None])),
           ATOL_BINARY)


def test_degenerate_classes_nan():
    preds, _ = _binary_case(0)
    for target in (np.zeros(len(preds), np.int32), np.ones(len(preds), np.int32)):
        assert torch.isnan(T.binary_auroc_sorted(_t(preds), _t(target)))
    assert torch.isnan(T.binary_average_precision_sorted(_t(preds), _t(np.zeros(len(preds), np.int32))))


def test_empty_input_nan():
    empty = torch.zeros((0,))
    assert torch.isnan(T.binary_auroc_sorted(empty, empty))
    assert torch.isnan(T.binary_average_precision_sorted(empty, empty))


@pytest.mark.parametrize("decimals", [None, 2])
@pytest.mark.parametrize("average", ["macro", "weighted", "none"])
def test_multiclass_auroc(average, decimals):
    preds, target = _multiclass_case(1, decimals=decimals)
    _close(J.multiclass_auroc_sorted(preds, target, NUM_CLASSES, average),
           T.multiclass_auroc_sorted(_t(preds), _t(target), NUM_CLASSES, average), ATOL_MULTI)


@pytest.mark.parametrize("decimals", [None, 2])
@pytest.mark.parametrize("average", ["macro", "micro", "weighted", "none"])
def test_multiclass_average_precision(average, decimals):
    preds, target = _multiclass_case(2, decimals=decimals)
    _close(J.multiclass_average_precision_sorted(preds, target, NUM_CLASSES, average),
           T.multiclass_average_precision_sorted(_t(preds), _t(target), NUM_CLASSES, average), ATOL_MULTI)


@pytest.mark.parametrize("average", ["macro", "weighted", "none"])
def test_multilabel_targets(average):
    rng = np.random.RandomState(3)
    preds = np.round(rng.rand(200, NUM_CLASSES), 2).astype(np.float32)
    target = rng.randint(0, 2, (200, NUM_CLASSES)).astype(np.int32)
    _close(J.multiclass_auroc_sorted(preds, target, NUM_CLASSES, average),
           T.multiclass_auroc_sorted(_t(preds), _t(target), NUM_CLASSES, average), ATOL_MULTI)
    _close(J.multiclass_average_precision_sorted(preds, target, NUM_CLASSES, average),
           T.multiclass_average_precision_sorted(_t(preds), _t(target), NUM_CLASSES, average), ATOL_MULTI)


@pytest.mark.parametrize("average", ["macro", "weighted", "none"])
def test_unobserved_class(average):
    preds, _ = _multiclass_case(4, n=50, num_classes=4)
    target = np.random.RandomState(0).randint(0, 3, 50).astype(np.int32)
    _close(J.multiclass_auroc_sorted(preds, target, 4, average),
           T.multiclass_auroc_sorted(_t(preds), _t(target), 4, average), ATOL_MULTI)
    _close(J.multiclass_average_precision_sorted(preds, target, 4, average),
           T.multiclass_average_precision_sorted(_t(preds), _t(target), 4, average), ATOL_MULTI)


def test_one_batched_sort_equals_each_class_alone():
    preds, target = _multiclass_case(5, decimals=2)
    onehot = np.eye(NUM_CLASSES, dtype=np.int32)[target]
    batched = T.multiclass_auroc_sorted(_t(preds), _t(target), NUM_CLASSES, "none")
    batched_ap = T.multiclass_average_precision_sorted(_t(preds), _t(target), NUM_CLASSES, "none")
    for c in range(NUM_CLASSES):
        assert float(batched[c]) == float(T.binary_auroc_sorted(_t(preds[:, c]), _t(onehot[:, c])))
        assert float(batched_ap[c]) == float(T.binary_average_precision_sorted(_t(preds[:, c]), _t(onehot[:, c])))


def test_unsupported_average_raises():
    preds, target = _multiclass_case(6)
    with pytest.raises(ValueError):
        T.multiclass_auroc_sorted(_t(preds), _t(target), NUM_CLASSES, "micro")
    with pytest.raises(ValueError):
        T.multiclass_average_precision_sorted(_t(preds), _t(target), NUM_CLASSES, "samples")


def test_high_precision_is_restored():
    torch.set_float32_matmul_precision("high")
    try:
        preds, target = _binary_case(9)
        T.binary_auroc_sorted(_t(preds), _t(target))
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision("highest")


# -------------------------------------------------- the sorted areas equal the eager curve path
@pytest.mark.parametrize("seed", range(3))
def test_binary_sorted_equals_the_eager_path(seed):
    preds, target = _binary_case(seed, tie_decimals=2)
    _close(tF.auroc(_t(preds), _t(target)).numpy(), T.binary_auroc_sorted(_t(preds), _t(target)), ATOL_BINARY)
    _close(tF.average_precision(_t(preds), _t(target)).numpy(),
           T.binary_average_precision_sorted(_t(preds), _t(target)), ATOL_BINARY)


@pytest.mark.parametrize("average", ["macro", "weighted", "none"])
def test_multiclass_sorted_equals_the_eager_path(average):
    preds, target = _multiclass_case(4, decimals=3)
    eager = tF.auroc(_t(preds), _t(target), num_classes=NUM_CLASSES, average=average)
    _close(eager.numpy(), T.multiclass_auroc_sorted(_t(preds), _t(target), NUM_CLASSES, average), ATOL_MULTI)
    eager_ap = tF.average_precision(_t(preds), _t(target), num_classes=NUM_CLASSES, average=average)
    eager_ap = torch.stack(eager_ap) if isinstance(eager_ap, list) else eager_ap
    _close(eager_ap.numpy(), T.multiclass_average_precision_sorted(_t(preds), _t(target), NUM_CLASSES, average),
           ATOL_MULTI)


@pytest.mark.parametrize("average", ["macro", "none"])
def test_unobserved_class_sorted_equals_the_eager_path(average):
    preds, _ = _multiclass_case(0, n=50, num_classes=4)
    target = np.random.RandomState(0).randint(0, 3, 50).astype(np.int32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the eager path warns of the class without negatives' false positives
        eager = tF.auroc(_t(preds), _t(target), num_classes=4, average=average)
        want = jF.auroc(jnp.asarray(preds), jnp.asarray(target), num_classes=4, average=average)
    np.testing.assert_allclose(eager.numpy(), np.asarray(want), atol=ATOL_MULTI)
    _close(eager.numpy(), T.multiclass_auroc_sorted(_t(preds), _t(target), 4, average), ATOL_MULTI)
