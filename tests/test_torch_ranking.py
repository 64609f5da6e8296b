"""The port's hinge loss, KL divergence and multi-label ranking metrics against the JAX package.

The same inputs, made with numpy from a seed, go through the JAX function
and its port, functional and module (N <= 64 rows, L <= 16 labels). Counts
(the int32 ``total`` states) must be equal and int32; float values agree
within atol 1e-6 and rtol 1e-6 (sums of a few dozen float32 terms in two
reduction orders). The inputs have tied scores (rounded to 0.1), rows with
every or no label relevant, and sample weights; the ranking loss's two
sorts must be stable for tied rows to agree.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jmt
import metrics_tpu.functional as jF
import metrics_tpu_torch as tmt
import metrics_tpu_torch.functional as tF
from metrics_tpu_torch.functional.classification import ranking as tranking

ATOL = RTOL = 1e-6
N, C, L = 48, 5, 12


def assert_same(expected, got):
    e = np.asarray(expected)
    assert isinstance(got, torch.Tensor)
    g = got.detach().cpu().numpy()
    assert e.shape == g.shape, (e.shape, g.shape)
    if np.issubdtype(e.dtype, np.integer):
        assert got.dtype == torch.int32 and e.dtype == np.int32
        np.testing.assert_array_equal(g, e)
    else:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(g, e, atol=ATOL, rtol=RTOL, equal_nan=True)


def both(jax_fn, torch_fn, *arrays, **kwargs):
    expected = jax_fn(*[None if a is None else jnp.asarray(a) for a in arrays], **kwargs)
    got = torch_fn(*[None if a is None else torch.from_numpy(np.asarray(a)) for a in arrays], **kwargs)
    assert_same(expected, got)
    return got


def _softmax(x):
    e = np.exp(x - x.max(axis=1, keepdims=True))
    return (e / e.sum(axis=1, keepdims=True)).astype(np.float32)


# ------------------------------------------------------------------- hinge
def hinge_inputs(kind, seed=0, n=N):
    rng = np.random.RandomState(seed)
    if kind == "binary":
        return rng.randn(n).astype(np.float32), rng.randint(0, 2, n)
    return rng.randn(n, C).astype(np.float32), rng.randint(0, C, n)


HINGE_CASES = [("binary", None), ("multiclass", None), ("multiclass", "crammer-singer"), ("multiclass", "one-vs-all")]


@pytest.mark.parametrize("squared", [False, True])
@pytest.mark.parametrize("kind,mode", HINGE_CASES)
def test_hinge_loss(kind, mode, squared):
    both(jF.hinge_loss, tF.hinge_loss, *hinge_inputs(kind, seed=1), squared=squared, multiclass_mode=mode)


def test_hinge_loss_bad_mode_and_shapes_raise_like_jax():
    preds, target = hinge_inputs("multiclass", seed=2)
    for call in (
        lambda F, cv: F.hinge_loss(cv(preds), cv(target), multiclass_mode="bad"),
        lambda F, cv: F.hinge_loss(cv(np.stack([preds, preds], 2)), cv(target)),
        lambda F, cv: F.hinge_loss(cv(preds), cv(np.stack([target, target], 1))),
        lambda F, cv: F.hinge_loss(cv(np.round(preds).astype(np.int64)), cv(target)),
    ):
        with pytest.raises(ValueError):
            call(jF, jnp.asarray)
        with pytest.raises(ValueError):
            call(tF, torch.from_numpy)


@pytest.mark.parametrize("kind,mode", HINGE_CASES)
def test_hinge_module(kind, mode):
    jm = jmt.HingeLoss(squared=True, multiclass_mode=mode)
    tm = tmt.HingeLoss(squared=True, multiclass_mode=mode, device="cpu")
    for step in range(3):
        preds, target = hinge_inputs(kind, seed=10 + step)
        if step == 1:
            assert_same(jm(jnp.asarray(preds), jnp.asarray(target)), tm(torch.from_numpy(preds), torch.from_numpy(target)))
        else:
            jm.update(jnp.asarray(preds), jnp.asarray(target))
            tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert_same(jm.total, tm.total)
    assert_same(jm.measure, tm.measure)
    assert_same(jm.compute(), tm.compute())


# --------------------------------------------------------------------- KL
def kl_inputs(seed=0, log_prob=False, zeros=False):
    rng = np.random.RandomState(seed)
    p, q = _softmax(rng.randn(N, C)), _softmax(rng.randn(N, C))
    if zeros:  # p == 0 terms count 0 (even where q is 0); q == 0 is clamped at eps
        p[::3, 0] = 0.0
        q[::4, 1] = 0.0
        q[::6, 0] = 0.0
    if log_prob:
        return np.log(p), np.log(q)
    return p, q


@pytest.mark.parametrize("reduction", ["mean", "sum", "none", None])
@pytest.mark.parametrize("log_prob", [False, True])
def test_kl_divergence(log_prob, reduction):
    both(jF.kl_divergence, tF.kl_divergence, *kl_inputs(seed=3, log_prob=log_prob), log_prob=log_prob,
         reduction=reduction)


def test_kl_divergence_with_zero_probabilities():
    got = both(jF.kl_divergence, tF.kl_divergence, *kl_inputs(seed=4, zeros=True), reduction="none")
    assert torch.isfinite(got).all()


def test_kl_divergence_unnormalised_rows():
    p, q = kl_inputs(seed=5)
    both(jF.kl_divergence, tF.kl_divergence, p * 3.0, q * 0.5)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none", None])
@pytest.mark.parametrize("log_prob", [False, True])
def test_kl_divergence_module(log_prob, reduction):
    jm = jmt.KLDivergence(log_prob=log_prob, reduction=reduction)
    tm = tmt.KLDivergence(log_prob=log_prob, reduction=reduction, device="cpu")
    for step in range(3):
        p, q = kl_inputs(seed=20 + step, log_prob=log_prob)
        if step == 2:
            assert_same(jm(jnp.asarray(p), jnp.asarray(q)), tm(torch.from_numpy(p), torch.from_numpy(q)))
        else:
            jm.update(jnp.asarray(p), jnp.asarray(q))
            tm.update(torch.from_numpy(p), torch.from_numpy(q))
    assert_same(jm.total, tm.total)
    assert_same(jm.compute(), tm.compute())


def test_kl_divergence_module_refuses_bad_arguments_like_jax():
    for kwargs, exc in (({"log_prob": 1}, TypeError), ({"reduction": "max"}, ValueError)):
        with pytest.raises(exc):
            jmt.KLDivergence(**kwargs)
        with pytest.raises(exc):
            tmt.KLDivergence(device="cpu", **kwargs)


# ---------------------------------------------------------------- ranking
def ranking_inputs(seed=0, n=N, labels=L, decimals=1, weights=False):
    """Multi-label scores with ties (rounded), one row with every label relevant and one with none."""
    rng = np.random.RandomState(seed)
    preds = np.round(rng.rand(n, labels), decimals).astype(np.float32)
    target = (rng.rand(n, labels) < 0.3).astype(np.int64)
    target[0] = 1
    target[1] = 0
    weight = rng.rand(n).astype(np.float32) if weights else None
    if weights:
        weight[2] = 0.0
    return preds, target, weight


RANKING = [
    ("coverage_error", "CoverageError"),
    ("label_ranking_average_precision", "LabelRankingAveragePrecision"),
    ("label_ranking_loss", "LabelRankingLoss"),
]


@pytest.mark.parametrize("weights", [False, True])
@pytest.mark.parametrize("decimals", [1, 3])
@pytest.mark.parametrize("fn", [r[0] for r in RANKING])
def test_ranking_functional(fn, decimals, weights):
    preds, target, weight = ranking_inputs(seed=6, decimals=decimals, weights=weights)
    both(getattr(jF, fn), getattr(tF, fn), preds, target, weight)


@pytest.mark.parametrize("fn", [r[0] for r in RANKING])
def test_ranking_rows_all_tied(fn):
    """Every score of a row equal: the order is the input order in both packages."""
    preds, target, _ = ranking_inputs(seed=7)
    preds[:] = 0.5
    both(getattr(jF, fn), getattr(tF, fn), preds, target)


@pytest.mark.parametrize("fn", [r[0] for r in RANKING])
def test_ranking_misuse_raises_like_jax(fn):
    preds, target, _ = ranking_inputs(seed=8)
    for args in ((preds[0], target[0]), (preds, target[:, :-1]), (np.round(preds).astype(np.int64), target),
                 (preds, target, np.ones((N, 1), np.float32))):
        with pytest.raises(Exception) as jax_err:
            getattr(jF, fn)(*[jnp.asarray(a) for a in args])
        with pytest.raises(type(jax_err.value)):
            getattr(tF, fn)(*[torch.from_numpy(np.asarray(a)) for a in args])


def test_lrap_blocks_give_the_same_bits(monkeypatch):
    preds, target, weight = ranking_inputs(seed=9, n=33, labels=16, weights=True)
    whole = tF.label_ranking_average_precision(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(weight))
    monkeypatch.setattr(tranking, "LRAP_BLOCK_BYTES", 5 * 2 * 16 * 16)  # blocks of 5 rows of int16 counts
    blocked = tF.label_ranking_average_precision(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(weight))
    assert torch.equal(whole, blocked)
    rank_all, rank_rel = tranking._lrap_rank_counts(torch.from_numpy(preds), torch.from_numpy(target) == 1)
    assert rank_all.dtype == torch.int32 and rank_all.shape == (33, 16) and bool((rank_rel <= rank_all).all())


@pytest.mark.parametrize("weights", [False, True])
@pytest.mark.parametrize("fn,cls_name", RANKING)
def test_ranking_modules(fn, cls_name, weights):
    jm, tm = getattr(jmt, cls_name)(), getattr(tmt, cls_name)(device="cpu")
    for step in range(3):
        preds, target, weight = ranking_inputs(seed=30 + step, weights=weights)
        args = (preds, target) if weight is None else (preds, target, weight)
        if step == 1:
            assert_same(jm(*[jnp.asarray(a) for a in args]), tm(*[torch.from_numpy(a) for a in args]))
        else:
            jm.update(*[jnp.asarray(a) for a in args])
            tm.update(*[torch.from_numpy(a) for a in args])
    for name in ("measure", "total", "sample_weight"):
        assert_same(getattr(jm, name), getattr(tm, name))
    assert tm.total.dtype == torch.int32
    assert_same(jm.compute(), tm.compute())


def _jax_state(jm):
    return {k: ([np.asarray(r) for r in v] if isinstance(v, list) else np.asarray(v)) for k, v in jm.metric_state.items()}


@pytest.mark.parametrize(
    "cls_name,kwargs,kind",
    [
        ("LabelRankingAveragePrecision", {}, "weighted"),
        ("LabelRankingLoss", {}, "unweighted"),
        ("HingeLoss", {"multiclass_mode": "one-vs-all"}, "hinge"),
        ("KLDivergence", {"reduction": "none"}, "kl"),
    ],
)
def test_load_reference_state(cls_name, kwargs, kind):
    """A JAX metric's accumulated state, as numpy arrays, computes the same value in the port."""
    jm, tm = getattr(jmt, cls_name)(**kwargs), getattr(tmt, cls_name)(device="cpu", **kwargs)
    for step in range(2):
        if kind == "hinge":
            args = hinge_inputs("multiclass", seed=60 + step)
        elif kind == "kl":
            args = kl_inputs(seed=60 + step)
        else:
            preds, target, weight = ranking_inputs(seed=60 + step, weights=kind == "weighted")
            args = (preds, target) if weight is None else (preds, target, weight)
        jm.update(*[jnp.asarray(a) for a in args])
    tmt.load_reference_state(tm, _jax_state(jm), update_count=2)
    assert_same(jm.compute(), tm.compute())
