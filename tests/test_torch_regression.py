"""The port's regression metrics against the JAX package on the same inputs.

MSE, MAE, MSLE, MAPE, SMAPE, WMAPE, Pearson, Spearman, cosine similarity,
explained variance, R² and the Tweedie deviance, functional and module, on
inputs made with numpy from a seed (N <= 64; up to 4 outputs). Integer
counts must be equal and int32; float values agree within rtol 1e-5 and
atol 1e-6 (float32 sums of a few dozen terms in two reduction orders, and
the streaming Pearson moments). Where the JAX package refuses an input (the
Tweedie domain, R² on one sample, Spearman on two dtypes) the port raises
the same exception type. Also: Pearson's merge of several streams'
moments, and the raw rows that CosineSimilarity and SpearmanCorrCoef buffer.
"""
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
from metrics_tpu.functional.regression import correlation as jcorr
from metrics_tpu.utils import checks as jax_checks
from metrics_tpu_torch.functional.regression import correlation as tcorr
from metrics_tpu_torch.utils import checks as torch_checks

ATOL, RTOL = 1e-6, 1e-5
N, D = 48, 4


@pytest.fixture(autouse=True)
def _full_validation():
    jax_prev, torch_prev = jax_checks._get_validation_mode(), torch_checks._get_validation_mode()
    jax_checks.set_validation_mode("full")
    torch_checks.set_validation_mode("full")
    yield
    jax_checks.set_validation_mode(jax_prev)
    torch_checks.set_validation_mode(torch_prev)


def assert_same(expected, got):
    if isinstance(expected, (tuple, list)):
        assert len(expected) == len(got)
        for e, g in zip(expected, got):
            assert_same(e, g)
        return
    e = np.asarray(expected)
    assert isinstance(got, torch.Tensor), type(got)
    g = got.detach().cpu().numpy()
    assert e.shape == g.shape, (e.shape, g.shape)
    if np.issubdtype(e.dtype, np.integer):
        assert e.dtype == np.int32 and got.dtype == torch.int32
        np.testing.assert_array_equal(g, e)
    else:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(g, e, atol=ATOL, rtol=RTOL, equal_nan=True)


def both(jax_fn, torch_fn, *arrays, **kwargs):
    try:
        expected = jax_fn(*[jnp.asarray(a) for a in arrays], **kwargs)
    except (ValueError, RuntimeError, TypeError) as err:
        with pytest.raises(type(err)):
            torch_fn(*[torch.from_numpy(np.asarray(a)) for a in arrays], **kwargs)
        return None
    got = torch_fn(*[torch.from_numpy(np.asarray(a)) for a in arrays], **kwargs)
    assert_same(expected, got)
    return got


def inputs(kind="1d", seed=0, n=N, positive=False, decimals=None):
    rng = np.random.RandomState(seed)
    shape = (n,) if kind == "1d" else (n, D)
    target = rng.randn(*shape).astype(np.float32)
    preds = (target + 0.5 * rng.randn(*shape)).astype(np.float32)
    if positive:  # a demand or claims model: targets >= 0 with exact zeros, preds > 0
        target = np.where(rng.rand(*shape) < 0.3, 0.0, np.abs(target) * 3).astype(np.float32)
        preds = (np.abs(preds) + 0.05).astype(np.float32)
    if decimals is not None:
        preds, target = np.round(preds, decimals).astype(np.float32), np.round(target, decimals).astype(np.float32)
    return preds, target


BASIC = [
    "mean_absolute_error",
    "mean_squared_log_error",
    "mean_absolute_percentage_error",
    "symmetric_mean_absolute_percentage_error",
    "weighted_mean_absolute_percentage_error",
]


@pytest.mark.parametrize("kind", ["1d", "2d"])
@pytest.mark.parametrize("fn", BASIC)
def test_basic_errors(fn, kind):
    both(getattr(jF, fn), getattr(tF, fn), *inputs(kind, seed=1, positive=fn == "mean_squared_log_error"))


@pytest.mark.parametrize("squared", [True, False])
@pytest.mark.parametrize("kind,num_outputs", [("1d", 1), ("2d", 1), ("2d", D)])
def test_mean_squared_error(kind, num_outputs, squared):
    both(jF.mean_squared_error, tF.mean_squared_error, *inputs(kind, seed=2), squared=squared, num_outputs=num_outputs)


@pytest.mark.parametrize("decimals", [None, 1])
def test_pearson_and_spearman(decimals):
    arrays = inputs(seed=3, decimals=decimals)
    both(jF.pearson_corrcoef, tF.pearson_corrcoef, *arrays)
    both(jF.spearman_corrcoef, tF.spearman_corrcoef, *arrays)


def test_spearman_ranks_with_ties_are_the_same():
    data = np.round(np.random.RandomState(4).rand(N) * 5).astype(np.float32)
    assert_same(jcorr._rank_data(jnp.asarray(data)), tcorr._rank_data(torch.from_numpy(data)))


def test_spearman_misuse_raises_like_jax():
    preds, target = inputs(seed=5)
    both(jF.spearman_corrcoef, tF.spearman_corrcoef, preds, np.round(target).astype(np.int64))  # TypeError
    both(jF.spearman_corrcoef, tF.spearman_corrcoef, np.stack([preds, preds], 1), np.stack([target, target], 1))
    both(jF.pearson_corrcoef, tF.pearson_corrcoef, np.stack([preds, preds], 1), np.stack([target, target], 1))


@pytest.mark.parametrize("reduction", ["sum", "mean", "none", None])
def test_cosine_similarity(reduction):
    both(jF.cosine_similarity, tF.cosine_similarity, *inputs("2d", seed=6), reduction=reduction)


def test_cosine_similarity_of_a_long_stream():
    """2**21 rows as one vector: the norms must be accurate sums (torch's CPU ``vector_norm`` is not)."""
    preds, target = inputs(seed=60, n=2**21, positive=True)
    both(jF.cosine_similarity, tF.cosine_similarity, preds, target)


@pytest.mark.parametrize("multioutput", ["raw_values", "uniform_average", "variance_weighted"])
@pytest.mark.parametrize("kind", ["1d", "2d"])
def test_explained_variance_and_r2(kind, multioutput):
    arrays = inputs(kind, seed=7)
    both(jF.explained_variance, tF.explained_variance, *arrays, multioutput=multioutput)
    both(jF.r2_score, tF.r2_score, *arrays, multioutput=multioutput)


def test_explained_variance_constant_target():
    preds, target = inputs("2d", seed=8)
    target[:, 1] = 2.0
    preds[:, 2] = target[:, 2]
    both(jF.explained_variance, tF.explained_variance, preds, target, multioutput="raw_values")


@pytest.mark.parametrize("adjusted", [0, 3, N - 1, N + 5])
def test_r2_adjusted_and_its_warnings(adjusted):
    arrays = inputs(seed=9)
    with warnings.catch_warnings(record=True) as jax_caught:
        warnings.simplefilter("always")
        expected = jF.r2_score(*[jnp.asarray(a) for a in arrays], adjusted=adjusted)
    with warnings.catch_warnings(record=True) as torch_caught:
        warnings.simplefilter("always")
        got = tF.r2_score(*[torch.from_numpy(a) for a in arrays], adjusted=adjusted)
    assert sorted(str(w.message) for w in torch_caught) == sorted(str(w.message) for w in jax_caught)
    assert_same(expected, got)


def test_r2_misuse_raises_like_jax():
    preds, target = inputs(seed=10)
    both(jF.r2_score, tF.r2_score, preds[:1], target[:1])  # one sample
    both(jF.r2_score, tF.r2_score, preds, target, multioutput="bad")
    both(jF.r2_score, tF.r2_score, preds[:, None, None], target[:, None, None])  # 3-D


@pytest.mark.parametrize("power", [0.0, 1.0, 1.5, 2.0, 3.0, -0.5])
def test_tweedie_deviance(power):
    preds, target = inputs(seed=11, positive=True)
    if power >= 2 or power < 0:
        target = target + 0.25  # the domain of these powers needs targets > 0
    both(jF.tweedie_deviance_score, tF.tweedie_deviance_score, preds, target, power=power)


@pytest.mark.parametrize("power", [0.5, 1.0, 1.5, 2.0, 3.0, -0.5])
def test_tweedie_domain_raises_like_jax(power):
    preds, target = inputs(seed=12, positive=True)
    both(jF.tweedie_deviance_score, tF.tweedie_deviance_score, -preds, target, power=power)
    both(jF.tweedie_deviance_score, tF.tweedie_deviance_score, preds, target - 1.0, power=power)


def test_tweedie_domain_check_follows_the_validation_mode():
    preds, target = inputs(seed=13, positive=True)
    torch_checks.set_validation_mode("off")
    value = tF.tweedie_deviance_score(torch.from_numpy(-preds), torch.from_numpy(target), power=1.5)
    assert value.dtype == torch.float32  # no check, no host read: the value is whatever the formula gives


# ---------------------------------------------------------------- modules
MODULES = [
    ("MeanSquaredError", {}, "1d"),
    ("MeanSquaredError", {"squared": False}, "1d"),
    ("MeanSquaredError", {"num_outputs": D}, "2d"),
    ("MeanAbsoluteError", {}, "2d"),
    ("MeanSquaredLogError", {}, "1d"),
    ("MeanAbsolutePercentageError", {}, "1d"),
    ("SymmetricMeanAbsolutePercentageError", {}, "1d"),
    ("WeightedMeanAbsolutePercentageError", {}, "1d"),
    ("CosineSimilarity", {"reduction": "mean"}, "2d"),
    ("CosineSimilarity", {"reduction": "none"}, "2d"),
    ("ExplainedVariance", {}, "1d"),
    ("ExplainedVariance", {"multioutput": "raw_values"}, "2d"),
    ("R2Score", {}, "1d"),
    ("R2Score", {"num_outputs": D, "multioutput": "raw_values"}, "2d"),
    ("R2Score", {"adjusted": 2}, "1d"),
    ("PearsonCorrCoef", {}, "1d"),
    ("SpearmanCorrCoef", {}, "1d"),
    ("TweedieDevianceScore", {"power": 1.5}, "1d"),
    ("TweedieDevianceScore", {"power": 0.0}, "2d"),
]


@pytest.mark.parametrize("cls_name,kwargs,kind", MODULES, ids=[f"{m[0]}-{i}" for i, m in enumerate(MODULES)])
def test_module_forward_update_compute(cls_name, kwargs, kind):
    jm, tm = getattr(jmt, cls_name)(**kwargs), getattr(tmt, cls_name)(device="cpu", **kwargs)
    positive = cls_name in ("MeanSquaredLogError", "TweedieDevianceScore")
    for step in range(3):
        preds, target = inputs(kind, seed=20 + step, positive=positive, decimals=2)
        if step == 1:
            assert_same(jm(jnp.asarray(preds), jnp.asarray(target)), tm(torch.from_numpy(preds), torch.from_numpy(target)))
        else:
            jm.update(jnp.asarray(preds), jnp.asarray(target))
            tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert_same(jm.compute(), tm.compute())
    tm._canonicalize_list_states()
    for name, value in jm.metric_state.items():
        got = getattr(tm, name)
        if isinstance(value, list):
            jm._canonicalize_list_states()
            assert_same([np.asarray(v) for v in getattr(jm, name)], got)
        else:
            assert_same(value, got)


def test_pearson_merge_of_stacked_moments_equals_one_stream():
    """Moments of three streams, stacked as a sync leaves them, merge to the moments of all rows."""
    streams = [inputs(seed=40 + i, n=16 + 8 * i) for i in range(3)]
    jax_parts, torch_parts = [], []
    for preds, target in streams:
        jm, tm = jmt.PearsonCorrCoef(), tmt.PearsonCorrCoef(device="cpu")
        jm.update(jnp.asarray(preds), jnp.asarray(target))
        tm.update(torch.from_numpy(preds), torch.from_numpy(target))
        jax_parts.append(jm.metric_state)
        torch_parts.append(tm.metric_state)
    names = ("mean_x", "mean_y", "var_x", "var_y", "corr_xy", "n_total")
    jax_stack = [jnp.stack([p[n] for p in jax_parts]) for n in names]
    torch_stack = [torch.stack([p[n] for p in torch_parts]) for n in names]
    assert_same(jcorr._pearson_final_aggregation(*jax_stack), tcorr._pearson_final_aggregation(*torch_stack))
    merged = tmt.PearsonCorrCoef(device="cpu")
    for n, v in zip(names, torch_stack):
        setattr(merged, n, v)
    merged._update_count = 3
    whole = tmt.PearsonCorrCoef(device="cpu")
    whole.update(torch.from_numpy(np.concatenate([s[0] for s in streams])), torch.from_numpy(np.concatenate([s[1] for s in streams])))
    torch.testing.assert_close(merged.compute(), whole.compute(), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("cls_name", ["CosineSimilarity", "SpearmanCorrCoef"])
def test_buffered_rows_are_raw_then_canonical(cls_name):
    tm = getattr(tmt, cls_name)(device="cpu")
    rows = []
    for step in range(3):
        preds, target = inputs("2d" if cls_name == "CosineSimilarity" else "1d", seed=50 + step)
        if cls_name == "SpearmanCorrCoef" and step == 1:
            preds, target = preds[:, None], target[:, None]  # (N, 1) rows beside (N,) rows
        p = torch.from_numpy(preds).to(torch.float64 if step == 2 else torch.float32)
        t = torch.from_numpy(target).to(p.dtype)
        tm.update(p, t)
        rows.append((p, t))
    assert all(tm.preds[i] is rows[i][0] for i in range(3))  # appended raw
    value = tm.compute()
    tm._canonicalize_list_states()
    snapshot = list(tm.preds)
    tm._canonicalize_list_states()
    assert all(a is b for a, b in zip(snapshot, tm.preds))  # idempotent: canonical rows stay the same tensors
    restored = pickle.loads(pickle.dumps(tm))
    torch.testing.assert_close(restored.compute(), value)
    fresh = getattr(tmt, cls_name)(device="cpu")
    fresh.persistent(True)
    tm.persistent(True)
    fresh.load_state_dict(tm.state_dict())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # a loaded state counts no update
        torch.testing.assert_close(fresh.compute(), value)


def _jax_state(jm):
    return {k: ([np.asarray(r) for r in v] if isinstance(v, list) else np.asarray(v)) for k, v in jm.metric_state.items()}


@pytest.mark.parametrize(
    "cls_name,kwargs,kind",
    [
        ("SpearmanCorrCoef", {}, "1d"),
        ("PearsonCorrCoef", {}, "1d"),
        ("ExplainedVariance", {"multioutput": "raw_values"}, "2d"),
        ("CosineSimilarity", {"reduction": "mean"}, "2d"),
        ("MeanSquaredError", {"num_outputs": D}, "2d"),
    ],
)
def test_load_reference_state(cls_name, kwargs, kind):
    """A JAX metric's accumulated state, as numpy arrays, computes the same value in the port."""
    jm, tm = getattr(jmt, cls_name)(**kwargs), getattr(tmt, cls_name)(device="cpu", **kwargs)
    for step in range(2):
        preds, target = inputs(kind, seed=70 + step)
        jm.update(jnp.asarray(preds), jnp.asarray(target))
    tmt.load_reference_state(tm, _jax_state(jm), update_count=2)
    assert_same(jm.compute(), tm.compute())


def test_load_reference_state_of_stacked_pearson_moments():
    """Moments stacked one a process, as a JAX sync leaves them, merge in the port's compute."""
    parts = []
    for i in range(2):
        jm = jmt.PearsonCorrCoef()
        jm.update(*[jnp.asarray(a) for a in inputs(seed=80 + i)])
        parts.append(_jax_state(jm))
    stacked = {k: np.stack([p[k] for p in parts]) for k in parts[0]}
    jm = jmt.PearsonCorrCoef()
    for k, v in stacked.items():
        setattr(jm, k, jnp.asarray(v))
    tm = tmt.PearsonCorrCoef(device="cpu")
    tmt.load_reference_state(tm, stacked, update_count=2)
    assert tm.var_x.shape == (2,)
    assert_same(jm.compute(), tm.compute())
