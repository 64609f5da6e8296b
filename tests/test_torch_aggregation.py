"""The port's aggregators (Max, Min, Sum, Cat, Mean) against the JAX package.

Every aggregator under every ``nan_strategy`` and every validation mode
(``full``, ``first``, ``off``, set in both packages and restored) takes the
same stream of loss-like values with NaNs, made with numpy from a seed: an
update that raises in the JAX package raises the same exception type in the
port, and the states and values then agree (NaN where NaN), with the same
warnings. Also: forward, misuse, the state's dtype, and state carried across with
``load_reference_state``.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jmt
import metrics_tpu_torch as tmt
from metrics_tpu.utils import checks as jax_checks
from metrics_tpu_torch.interop import load_reference_state
from metrics_tpu_torch.utils import checks as torch_checks

AGGREGATORS = ["MaxMetric", "MinMetric", "SumMetric", "CatMetric", "MeanMetric"]
STRATEGIES = ["error", "warn", "ignore", 0.5]
MODES = ["full", "first", "off"]


@pytest.fixture
def mode(request):
    jax_prev, torch_prev = jax_checks._get_validation_mode(), torch_checks._get_validation_mode()
    jax_checks.set_validation_mode(request.param)
    torch_checks.set_validation_mode(request.param)
    yield request.param
    jax_checks.set_validation_mode(jax_prev)
    torch_checks.set_validation_mode(torch_prev)


def _stream(seed=0):
    """(value, weight) per update: clean, NaN in a batch of the same shape,
    all NaN, a python float, a 2-D batch with NaN, NaN only in the weights."""
    rng = np.random.RandomState(seed)
    clean = rng.rand(8).astype(np.float32)
    holes = rng.rand(8).astype(np.float32)
    holes[[1, 5]] = np.nan
    grid = rng.randn(2, 3).astype(np.float32)
    grid[0, 2] = np.nan
    w_holes = rng.rand(8).astype(np.float32)
    w_holes[3] = np.nan
    return [
        (clean, rng.rand(8).astype(np.float32)),
        (holes, rng.rand(8).astype(np.float32)),
        (np.full(4, np.nan, dtype=np.float32), np.ones(4, dtype=np.float32)),
        (2.5, 3.0),
        (grid, 2.0),
        (rng.rand(8).astype(np.float32), w_holes),
    ]


def _args(cls_name, value, weight, to):
    args = (to(value),)
    return args + (to(weight),) if cls_name == "MeanMetric" else args


def _jax(x):
    return jnp.asarray(x) if isinstance(x, np.ndarray) else x


def _torch(x):
    return torch.from_numpy(x) if isinstance(x, np.ndarray) else x


def _call(fn, *args):
    """Run ``fn``; returns (error type or None, the NaN warnings it raised)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            fn(*args)
            err = None
        except (RuntimeError, ValueError) as exc:
            err = type(exc)
    return err, sum("nan" in str(w.message) for w in caught)


def _assert_close(expected, got):
    e = np.asarray(expected)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    g = got.cpu().numpy()
    assert e.shape == g.shape, (e.shape, g.shape)
    np.testing.assert_allclose(g, e, atol=1e-6, rtol=0, equal_nan=True)


@pytest.mark.parametrize("mode", MODES, indirect=True)
@pytest.mark.parametrize("nan_strategy", STRATEGIES, ids=str)
@pytest.mark.parametrize("cls_name", AGGREGATORS)
def test_stream_with_nans(cls_name, nan_strategy, mode):
    jm = getattr(jmt, cls_name)(nan_strategy=nan_strategy)
    tm = getattr(tmt, cls_name)(nan_strategy=nan_strategy, device="cpu")
    for value, weight in _stream():
        j_err, j_warn = _call(jm.update, *_args(cls_name, value, weight, _jax))
        t_err, t_warn = _call(tm.update, *_args(cls_name, value, weight, _torch))
        assert t_err is j_err
        assert bool(t_warn) == bool(j_warn)
    for name, value in jm.metric_state.items():
        got = getattr(tm, name)
        if isinstance(value, list):
            assert len(got) == len(value)
            for e, g in zip(value, got):
                _assert_close(np.asarray(e).reshape(-1), g)
        else:
            _assert_close(value, got)
    _assert_close(jm.compute(), tm.compute())


@pytest.mark.parametrize("cls_name", AGGREGATORS)
def test_forward_and_reset(cls_name):
    jm, tm = getattr(jmt, cls_name)(), getattr(tmt, cls_name)(device="cpu")
    rng = np.random.RandomState(1)
    for step in range(3):
        value, weight = rng.rand(16).astype(np.float32), rng.rand(16).astype(np.float32)
        _assert_close(jm(*_args(cls_name, value, weight, _jax)), tm(*_args(cls_name, value, weight, _torch)))
    _assert_close(jm.compute(), tm.compute())
    tm.reset()
    tm.update(*_args(cls_name, np.ones(1, np.float32), np.ones(1, np.float32), _torch))
    assert float(tm.compute().reshape(-1)[0]) == 1.0


@pytest.mark.parametrize("cls_name", AGGREGATORS)
def test_bad_nan_strategy_raises_like_jax(cls_name):
    with pytest.raises(ValueError):
        getattr(jmt, cls_name)(nan_strategy="drop")
    with pytest.raises(ValueError):
        getattr(tmt, cls_name)(nan_strategy="drop", device="cpu")


def test_mean_weight_broadcasts_and_double_state():
    jm, tm = jmt.MeanMetric(), tmt.MeanMetric(device="cpu")
    values = np.arange(6, dtype=np.float32).reshape(2, 3)
    weights = np.array([1.0, 2.0, 3.0], dtype=np.float32)
    jm.update(jnp.asarray(values), jnp.asarray(weights))
    tm.update(torch.from_numpy(values), torch.from_numpy(weights))
    _assert_close(jm.compute(), tm.compute())
    tm.double()  # the state's dtype is kept: values accumulate in float64 from here
    tm.update(torch.tensor([1.0]))
    assert tm.value.dtype == torch.float64 and tm.weight.dtype == torch.float64


def test_ignore_never_reads_values_on_the_host(monkeypatch):
    """Under "ignore" the Sum/Mean/Max/Min aggregators mask, and never ask for the value check."""
    from metrics_tpu_torch import aggregation

    def refuse(*args, **kwargs):
        raise AssertionError("value check asked for")

    monkeypatch.setattr(aggregation, "_should_value_check", refuse)
    for cls_name in AGGREGATORS:
        tm = getattr(tmt, cls_name)(nan_strategy="ignore", device="cpu")
        tm.update(torch.tensor([1.0, float("nan"), 3.0]))
        assert not torch.isnan(tm.compute()).any()


@pytest.mark.parametrize("cls_name", ["MeanMetric", "CatMetric"])
def test_load_reference_state(cls_name):
    jm = getattr(jmt, cls_name)()
    rng = np.random.RandomState(2)
    for _ in range(3):
        jm.update(jnp.asarray(rng.rand(5).astype(np.float32)))
    state = {k: ([np.asarray(r) for r in v] if isinstance(v, list) else np.asarray(v))
             for k, v in jm.metric_state.items()}
    tm = getattr(tmt, cls_name)(device="cpu")
    load_reference_state(tm, state, update_count=3)
    _assert_close(jm.compute(), tm.compute())
