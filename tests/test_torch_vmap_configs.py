"""The functional core under ``torch.func.vmap`` against JAX's under ``jax.vmap``, one case a configuration.

Each case stacks 3 suites (``stack_states``), vmaps ``apply_update`` twice and
``apply_compute`` once, and compares with JAX doing the same on the same numpy
inputs, made from a seed. These are the configurations whose compute or update
read a value on the host, ran an in-place op into an unbatched tensor or took
a data-dependent shape: CalibrationError, ConfusionMatrix with ``normalize``,
R2Score with and without ``adjusted``, AUROC and AveragePrecision (binary and
multiclass: the sorted route under a transform, as JAX's traced route),
SpearmanCorrCoef and CatMetric under ``nan_strategy`` ``warn`` and ``ignore``.
No case may fall back to a per-row loop (a warning is an error here). ROC and
RetrievalMAP raise in both packages. Then the eager values of the same
configurations equal JAX's eager values, so the routing changed nothing
outside a transform. Floats within atol 1e-5 and rtol 1e-5 (float32 sorts and
sums of a few dozen terms); NaNs must agree.
"""
import warnings

import jax
import jax._src.core
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jmt
import metrics_tpu_torch as tmt

C, N, K = 4, 32, 3
ATOL, RTOL = 1e-5, 1e-5


@pytest.fixture(autouse=True)
def _reference_runs(monkeypatch):
    """jax 0.9 no longer exports ``jax.core.trace_state_clean``; this file's copy of it lets the reference run."""
    monkeypatch.setattr(jax.core, "trace_state_clean", jax._src.core.trace_state_clean, raising=False)


def data(kind, seed):
    rng = np.random.RandomState(seed)
    if kind == "probs":
        x = rng.rand(N, C).astype(np.float32)
        return (x / x.sum(1, keepdims=True)).astype(np.float32), rng.randint(0, C, N)
    if kind == "bin":
        return rng.rand(N).astype(np.float32), rng.randint(0, 2, N)
    if kind == "reg":
        return rng.randn(N).astype(np.float32), rng.randn(N).astype(np.float32)
    x = rng.randn(N).astype(np.float32)
    x[::5] = np.nan
    return (x,)


CONFIGS = {
    "calibration": ("CalibrationError", {"n_bins": 5}, "probs"),
    "confmat_normalize": ("ConfusionMatrix", {"num_classes": C, "normalize": "true"}, "probs"),
    "r2": ("R2Score", {}, "reg"),
    "r2_adjusted": ("R2Score", {"adjusted": 2}, "reg"),
    "auroc_binary": ("AUROC", {}, "bin"),
    "auroc_multiclass": ("AUROC", {"num_classes": C}, "probs"),
    "ap_binary": ("AveragePrecision", {}, "bin"),
    "ap_multiclass": ("AveragePrecision", {"num_classes": C}, "probs"),
    "spearman": ("SpearmanCorrCoef", {}, "reg"),
    "cat_warn": ("CatMetric", {"nan_strategy": "warn"}, "cat"),
    "cat_ignore": ("CatMetric", {"nan_strategy": "ignore"}, "cat"),
}


def steps(kind):
    return [[data(kind, 10 * s + r) for r in range(K)] for s in range(2)]


def columns(step):
    return [np.stack([b[i] for b in step]) for i in range(len(step[0]))]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_vmapped_suites_equal_the_reference(name):
    cls, kw, kind = CONFIGS[name]
    tm, jm = getattr(tmt, cls)(device="cpu", **kw), getattr(jmt, cls)(**kw)
    st = tmt.stack_states([tm.init() for _ in range(K)])
    js = jax.tree.map(lambda x: jnp.stack([x] * K), jm.init())
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no batching rule missing: no per-row fallback loop
        for step in steps(kind):
            cols = columns(step)
            st = torch.func.vmap(lambda s, *a: tm.apply_update(s, *a))(st, *map(torch.from_numpy, cols))
            js = jax.vmap(lambda s, *a: jm.apply_update(s, *a))(js, *map(jnp.asarray, cols))
        got = torch.func.vmap(lambda s: tm.apply_compute(s))(st)
    ref = jax.vmap(lambda s: jm.apply_compute(s))(js)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL, equal_nan=True)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_eager_values_are_unchanged(name):
    cls, kw, kind = CONFIGS[name]
    tm, jm = getattr(tmt, cls)(device="cpu", **kw), getattr(jmt, cls)(**kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the eager NaN and normalize warnings
        for step in steps(kind):
            tm.update(*map(torch.from_numpy, step[0]))
            jm.update(*map(jnp.asarray, step[0]))
        got, ref = tm.compute(), jm.compute()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL, equal_nan=True)


@pytest.mark.parametrize("cls,kw,args", [
    ("ROC", {}, "bin"),
    ("RetrievalMAP", {}, "retrieval"),
])
def test_what_raises_in_the_reference_raises_here(cls, kw, args):
    rng = np.random.RandomState(0)
    if args == "bin":
        cols = [rng.rand(K, N).astype(np.float32), rng.randint(0, 2, (K, N))]
    else:
        cols = [rng.rand(K, N).astype(np.float32), rng.randint(0, 2, (K, N)), np.tile(np.arange(N) // 8, (K, 1))]
    tm, jm = getattr(tmt, cls)(device="cpu", **kw), getattr(jmt, cls)(**kw)
    raised = []
    for step in (
        lambda: torch.func.vmap(lambda s: tm.apply_compute(s))(
            torch.func.vmap(lambda s, *a: tm.apply_update(s, *a))(tmt.stack_states([tm.init()] * K),
                                                                   *map(torch.from_numpy, cols))),
        lambda: jax.vmap(lambda s: jm.apply_compute(s))(
            jax.vmap(lambda s, *a: jm.apply_update(s, *a))(jax.tree.map(lambda x: jnp.stack([x] * K), jm.init()),
                                                           *map(jnp.asarray, cols))),
    ):
        try:
            step()
            raised.append(False)
        except Exception:  # noqa: BLE001 - each package raises its own error type
            raised.append(True)
    assert raised == [True, True]
