"""The port's binned curve family against the JAX package on the same inputs.

``ops.binned.binned_curve_counts`` (the compare and ``einsum`` contraction),
which must give the JAX package's float32 counts bit for bit, also when the
thresholds are taken a chunk at a time; and the three binned metrics
(BinnedPrecisionRecallCurve, BinnedAveragePrecision,
BinnedRecallAtFixedPrecision) on binary, multi-class and multi-label inputs
with integer, list and tensor threshold grids. Their count states match
exactly; their values within atol 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jmt
import metrics_tpu_torch as tmt
from metrics_tpu.ops.binned import binned_curve_counts as jax_counts
from metrics_tpu_torch.ops import binned
from tests.test_torch_curves import assert_curve, make_inputs

C = 5
ATOL = 1e-6


def _onehot(target, c=C):
    return np.eye(c, dtype=np.float32)[target]


@pytest.mark.parametrize("t", [1, 7, 100])
@pytest.mark.parametrize("kind", ["binary", "multiclass", "multilabel"])
def test_counts_bit_for_bit(kind, t):
    preds, target = make_inputs(kind, seed=t, n=300, decimals=2)
    if kind == "binary":
        preds, target = preds[:, None], target[:, None].astype(np.float32)
    elif kind == "multiclass":
        target = _onehot(target)
    target = target.astype(np.float32)
    thresholds = np.linspace(0, 1, t, dtype=np.float32)
    want = jax_counts(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(thresholds))
    got = binned.binned_curve_counts(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(thresholds))
    for w, g in zip(want, got):
        assert g.dtype == torch.float32 and g.shape == (preds.shape[1], t)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("chunk_bytes", [1, 300 * C * 4 * 3, 10**9])
def test_chunks_of_thresholds_give_the_same_counts(monkeypatch, chunk_bytes):
    preds, target = make_inputs("multilabel", seed=1, n=300, decimals=2)
    thresholds = np.random.RandomState(2).rand(20).astype(np.float32)  # an unsorted grid
    want = jax_counts(jnp.asarray(preds), jnp.asarray(target.astype(np.float32)), jnp.asarray(thresholds))
    monkeypatch.setattr(binned, "CHUNK_BYTES", chunk_bytes)
    assert binned.threshold_chunk(300, C, 20) == max(1, min(20, chunk_bytes // (300 * C * 4)))
    got = binned.binned_curve_counts(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(thresholds))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_imagenet_update_is_cut_into_chunks_within_the_cap():
    # one ImageNet-1k update: N = 1000 rows, C = 1000 classes, T = 100 thresholds
    step = binned.threshold_chunk(1000, 1000, 100)
    assert step * 1000 * 1000 * 4 <= binned.CHUNK_BYTES < (step + 1) * 1000 * 1000 * 4
    assert -(-100 // step) == 2


def test_counts_under_high_precision_restore_the_setting():
    torch.set_float32_matmul_precision("medium")
    try:
        preds, target = make_inputs("multilabel", seed=3, n=64)
        binned.binned_curve_counts(torch.from_numpy(preds), torch.from_numpy(target), torch.linspace(0, 1, 5))
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision("highest")


THRESHOLDS = [5, 100, [0.1, 0.5, 0.9], "tensor"]


def _grid(thresholds, pkg):
    if thresholds != "tensor":
        return thresholds
    grid = np.array([0.0, 0.2, 0.3, 0.75, 1.0], dtype=np.float32)
    return jnp.asarray(grid) if pkg is jmt else torch.from_numpy(grid)


def _pair(name, num_classes, thresholds, **kwargs):
    return (getattr(jmt, name)(num_classes=num_classes, thresholds=_grid(thresholds, jmt), **kwargs),
            getattr(tmt, name)(num_classes=num_classes, thresholds=_grid(thresholds, tmt), device="cpu", **kwargs))


CASES = [("binary", 1), ("multiclass", C), ("multilabel", C)]


def _feed(jm, tm, kind, steps=3, seed=10):
    for i in range(steps):
        preds, target = make_inputs(kind, seed=seed + i, n=128, decimals=2)
        jm.update(jnp.asarray(preds), jnp.asarray(target))
        tm.update(torch.from_numpy(preds), torch.from_numpy(target))


def _assert_states(jm, tm):
    for name in ("TPs", "FPs", "FNs"):
        got = getattr(tm, name)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jm, name)))


@pytest.mark.parametrize("thresholds", THRESHOLDS)
@pytest.mark.parametrize("kind,num_classes", CASES)
def test_binned_pr_curve(kind, num_classes, thresholds):
    jm, tm = _pair("BinnedPrecisionRecallCurve", num_classes, thresholds)
    _feed(jm, tm, kind)
    _assert_states(jm, tm)
    assert_curve(jm.compute(), tm.compute(), ATOL)


@pytest.mark.parametrize("thresholds", THRESHOLDS)
@pytest.mark.parametrize("kind,num_classes", CASES)
def test_binned_average_precision(kind, num_classes, thresholds):
    jm, tm = _pair("BinnedAveragePrecision", num_classes, thresholds)
    _feed(jm, tm, kind)
    _assert_states(jm, tm)
    assert_curve(jm.compute(), tm.compute(), ATOL)


@pytest.mark.parametrize("min_precision", [0.2, 0.5, 0.99])
@pytest.mark.parametrize("kind,num_classes", CASES)
def test_binned_recall_at_fixed_precision(kind, num_classes, min_precision):
    jm, tm = _pair("BinnedRecallAtFixedPrecision", num_classes, 20, min_precision=min_precision)
    _feed(jm, tm, kind)
    _assert_states(jm, tm)
    assert_curve(jm.compute(), tm.compute(), ATOL)


def test_binned_recall_without_a_precise_enough_threshold():
    preds, target = np.array([0.9, 0.8, 0.1], np.float32), np.array([0, 0, 1])
    jm, tm = _pair("BinnedRecallAtFixedPrecision", 1, 10, min_precision=0.99)
    got = tm(torch.from_numpy(preds), torch.from_numpy(target))
    assert_curve(jm(jnp.asarray(preds), jnp.asarray(target)), got, ATOL)


def test_binned_forward_and_reset():
    jm, tm = _pair("BinnedAveragePrecision", C, 10)
    for i in range(2):
        preds, target = make_inputs("multiclass", seed=20 + i, n=64)
        assert_curve(jm(jnp.asarray(preds), jnp.asarray(target)), tm(torch.from_numpy(preds), torch.from_numpy(target)),
                     ATOL)
    _assert_states(jm, tm)
    tm.reset()
    assert float(tm.TPs.abs().sum()) == 0.0


def test_bad_thresholds_raise():
    with pytest.raises(ValueError):
        jmt.BinnedPrecisionRecallCurve(num_classes=1, thresholds="many")
    with pytest.raises(ValueError):
        tmt.BinnedPrecisionRecallCurve(num_classes=1, thresholds="many", device="cpu")


def test_thresholds_stay_on_the_host_and_one_device_copy_is_kept():
    tm = tmt.BinnedPrecisionRecallCurve(num_classes=1, thresholds=7, device="cpu")
    assert isinstance(tm.thresholds, np.ndarray)
    preds, target = make_inputs("binary", seed=30, n=32)
    tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    first = tm._thresholds_on(torch.device("cpu"))
    tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert tm._thresholds_on(torch.device("cpu")) is first
    assert tm.compute()[2] is first
