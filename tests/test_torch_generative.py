"""The port's FID, KID, InceptionScore and LPIPS metrics against the JAX package's.

FID, KID and IS take a callable ``feature`` here (the flattened input's first
columns), so both packages see the same features and the metric math is
compared directly: FID's float64 covariances and two ``eigh``, KID's float64
polynomial MMD over the same ``RandomState`` draws, IS's KL over the same
permutation and ``array_split`` chunks. Inputs are made with numpy from a
seed. Tolerances: FID, KID and IS within ``F64_RTOL`` (1e-6) relative (float64
math, each package's own LAPACK and reductions; IS in float32 within
``IS_RTOL`` 1e-5); LPIPS within ``LPIPS_ATOL`` (1e-5) with the same weights in
both packages. Also: ``reset_real_features`` both ways, the argument errors,
LPIPS's reductions and input checks (host reads), the host numpy FID oracle,
and the feature buffers syncing row by row.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jmt
from metrics_tpu.image import generative as jgen
from metrics_tpu.models import lpips as jlp
from metrics_tpu.utils.compute import high_precision as jax_high_precision
import metrics_tpu_torch as tmt
from metrics_tpu_torch.image import generative as tgen
from tests.helpers.torch_sync import TorchFakeGather

F64_RTOL = 1e-6
IS_RTOL = 1e-5
LPIPS_ATOL = 1e-5
D = 16
DIST_ON = lambda: True  # noqa: E731


def jax_features(x):
    return jnp.asarray(x).reshape(x.shape[0], -1)[:, :D]


def port_features(x):
    return x.reshape(x.shape[0], -1)[:, :D]


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*will save all extracted features in buffer.*")
        warnings.filterwarnings("ignore", message=".*deterministic random initialization.*")
        yield


def _images(seed, n, shift=0.0):
    return (np.random.RandomState(seed).rand(n, 1, 4, 4) + shift).astype(np.float32)


def _feed(metric, batches, torch_side):
    for imgs, real in batches:
        x = torch.from_numpy(imgs) if torch_side else jnp.asarray(imgs)
        if real is None:
            metric.update(x)
        else:
            metric.update(x, real=real)


def _close(got, want, rtol, atol=0.0):
    assert isinstance(got, torch.Tensor)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)
    assert str(got.dtype).replace("torch.", "") == str(np.asarray(want).dtype)


BATCHES = [(_images(0, 24), True), (_images(1, 20, 0.2), False), (_images(2, 16), True), (_images(3, 28, 0.2), False)]


@pytest.mark.parametrize("batches", [BATCHES, BATCHES[:2]], ids=["four-updates", "two-updates"])
def test_fid_matches_jax(batches):
    jfid = jmt.FrechetInceptionDistance(feature=jax_features)
    tfid = tmt.FrechetInceptionDistance(feature=port_features, device="cpu")
    _feed(jfid, batches, False)
    _feed(tfid, batches, True)
    want = jfid.compute()
    _close(tfid.compute(), want, F64_RTOL)
    # the host numpy oracle (JAX's route without native float64)
    real = np.concatenate([b for b, r in batches if r])[:, 0].reshape(-1, 16)[:, :D]
    fake = np.concatenate([b for b, r in batches if not r])[:, 0].reshape(-1, 16)[:, :D]
    assert tgen._fid_from_features_host(real, fake) == pytest.approx(float(want), rel=F64_RTOL)


def test_fid_of_one_distribution_is_near_zero_and_trace_sqrtm_matches_jax():
    fid = tmt.FrechetInceptionDistance(feature=port_features, device="cpu")
    imgs = torch.from_numpy(_images(5, 40))
    fid.update(imgs, real=True)
    fid.update(imgs, real=False)
    assert abs(float(fid.compute())) < 1e-6
    rng = np.random.RandomState(0)
    for n, rank in ((16, 16), (32, 10), (8, 3)):
        a, b = rng.randn(n, rank), rng.randn(n, max(rank - 1, 1))
        cov1, cov2 = a @ a.T / n, b @ b.T / n
        with jax.enable_x64(True):
            want = float(jgen._trace_sqrtm_product(jnp.asarray(cov1), jnp.asarray(cov2)))
        got = float(tgen._trace_sqrtm_eigh(torch.from_numpy(cov1), torch.from_numpy(cov2)))
        assert got == pytest.approx(want, rel=F64_RTOL, abs=1e-9)


@pytest.mark.parametrize("reset_real_features", [True, False])
def test_reset_real_features_matches_jax(reset_real_features):
    jfid = jmt.FrechetInceptionDistance(feature=jax_features, reset_real_features=reset_real_features)
    tfid = tmt.FrechetInceptionDistance(feature=port_features, reset_real_features=reset_real_features, device="cpu")
    for metric, torch_side in ((jfid, False), (tfid, True)):
        _feed(metric, BATCHES[:2], torch_side)
        metric.reset()
    assert len(tfid.real_features) == len(jfid.real_features) == (0 if reset_real_features else 1)
    assert len(tfid.fake_features) == len(jfid.fake_features) == 0
    new = [(_images(7, 24, 0.1), False)] + ([] if not reset_real_features else [(_images(8, 24), True)])
    _feed(jfid, new, False)
    _feed(tfid, new, True)
    _close(tfid.compute(), jfid.compute(), F64_RTOL)


KID_CASES = [dict(subsets=5, subset_size=16), dict(subsets=3, subset_size=40, degree=2, gamma=0.5, coef=2.0),
             dict(subsets=4, subset_size=20, seed=7)]


@pytest.mark.parametrize("kwargs", KID_CASES, ids=["defaults", "kernel-args", "seed-7"])
def test_kid_matches_jax(kwargs):
    jkid = jmt.KernelInceptionDistance(feature=jax_features, **kwargs)
    tkid = tmt.KernelInceptionDistance(feature=port_features, device="cpu", **kwargs)
    _feed(jkid, BATCHES, False)
    _feed(tkid, BATCHES, True)
    (jm, js), (tm, ts) = jkid.compute(), tkid.compute()
    _close(tm, jm, F64_RTOL)
    _close(ts, js, F64_RTOL, atol=1e-12)  # KID's spread: ddof 0, as jnp.std


def test_kid_of_the_whole_set_has_no_spread():
    kid = tmt.KernelInceptionDistance(feature=port_features, subsets=4, subset_size=40, device="cpu")
    _feed(kid, [(BATCHES[0][0], True), (BATCHES[2][0], True), (BATCHES[1][0], False), (BATCHES[3][0][:20], False)],
          True)
    assert float(kid.compute()[1]) == pytest.approx(0.0, abs=1e-9)


@pytest.mark.parametrize("n,splits,seed", [(30, 3, 0), (31, 4, 2), (10, 1, 5)])
def test_inception_score_matches_jax(n, splits, seed):
    logits = [(np.random.RandomState(seed + i).randn(k, 1, 4, 4).astype(np.float32) * 3, None)
              for i, k in enumerate((n // 2, n - n // 2))]
    jis = jmt.InceptionScore(feature=jax_features, splits=splits, seed=seed)
    tis = tmt.InceptionScore(feature=port_features, splits=splits, seed=seed, device="cpu")
    _feed(jis, logits, False)
    _feed(tis, logits, True)
    (jm, js), (tm, ts) = jis.compute(), tis.compute()
    _close(tm, jm, IS_RTOL)
    if splits > 1:  # IS's spread: ddof 1
        _close(ts, js, IS_RTOL, atol=1e-6)
    else:
        assert np.isnan(np.asarray(js)) and torch.isnan(ts)


def test_argument_errors_match_jax():
    cases = [
        ("KernelInceptionDistance", dict(subsets=0)),
        ("KernelInceptionDistance", dict(subset_size=-1)),
        ("KernelInceptionDistance", dict(degree=0)),
        ("KernelInceptionDistance", dict(gamma=1)),
        ("KernelInceptionDistance", dict(coef=1)),
        ("FrechetInceptionDistance", dict(reset_real_features=1)),
    ]
    for name, kwargs in cases:
        with pytest.raises(ValueError) as jerr:
            getattr(jmt, name)(feature=jax_features, **kwargs)
        with pytest.raises(ValueError) as terr:
            getattr(tmt, name)(feature=port_features, device="cpu", **kwargs)
        assert str(terr.value) == str(jerr.value), (name, kwargs)
    for feature in (2049, "2048", "logits"):
        with pytest.raises(ValueError) as jerr:
            jmt.FrechetInceptionDistance(feature=feature, allow_random_weights=True)
        with pytest.raises(ValueError) as terr:
            tmt.FrechetInceptionDistance(feature=feature, allow_random_weights=True, device="cpu")
        assert str(terr.value) == str(jerr.value)
    with pytest.raises(TypeError, match="unknown input"):
        tmt.InceptionScore(feature=1.5, device="cpu")
    kid = tmt.KernelInceptionDistance(feature=port_features, subset_size=100, device="cpu")
    _feed(kid, BATCHES, True)
    with pytest.raises(ValueError, match="subset_size"):
        kid.compute()


# ---------------------------------------------------------------- LPIPS
@pytest.fixture(scope="module")
def alex_variables():
    rng = np.random.RandomState(11)
    dummy = jnp.zeros((1, 64, 64, 3))
    shapes = jax.eval_shape(jlp.LPIPSNet(net_type="alex").init, jax.random.PRNGKey(0), dummy, dummy)
    return jax.tree_util.tree_map(
        lambda s: (rng.randn(*s.shape) * np.sqrt(2.0 / max(1, int(np.prod(s.shape[:-1]))))).astype(np.float32), shapes)


def _pairs(seed, n=3, size=64):
    rng = np.random.RandomState(seed)
    return [(rng.uniform(-1, 1, (n, 3, size, size)).astype(np.float32),
             rng.uniform(-1, 1, (n, 3, size, size)).astype(np.float32)) for _ in range(2)]


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_lpips_metric_matches_jax(alex_variables, reduction):
    jm = jmt.LearnedPerceptualImagePatchSimilarity(params=alex_variables, reduction=reduction)
    jm.net._forward = lambda params, a, b: jax_high_precision(jm.net.model.apply)(params, a, b)
    tm = tmt.LearnedPerceptualImagePatchSimilarity(params=alex_variables, reduction=reduction, device="cpu")
    for a, b in _pairs(4):
        jm.update(jnp.asarray(a), jnp.asarray(b))
        tm.update(torch.from_numpy(a), torch.from_numpy(b))
    _close(tm.compute(), jm.compute(), 0, atol=LPIPS_ATOL * (6 if reduction == "sum" else 1))
    _close(tm.total, jm.total, 0)


def test_lpips_behaviour():
    lpips = tmt.LearnedPerceptualImagePatchSimilarity(allow_random_weights=True, device="cpu")
    (a, b), (c, _) = _pairs(6, n=2)
    a, b, c = (torch.from_numpy(x) for x in (a, b, c))
    assert float(lpips(a, a)) == pytest.approx(0.0, abs=1e-6)
    lpips.reset()
    forward = float(lpips(a, b))
    lpips.reset()
    assert float(lpips(b, a)) == pytest.approx(forward, rel=1e-5)
    summed = tmt.LearnedPerceptualImagePatchSimilarity(reduction="sum", allow_random_weights=True, device="cpu")
    mean = tmt.LearnedPerceptualImagePatchSimilarity(allow_random_weights=True, device="cpu")
    for m in (summed, mean):
        m.update(a, b)
        m.update(c, b)
    assert float(summed.compute()) == pytest.approx(float(mean.compute()) * 4, rel=1e-5)
    # the input check: NCHW with 3 channels, values in [-1, 1], one host read of the range an image
    for bad in (a * 2.0, a[:, :2], a[0]):
        with pytest.raises(ValueError, match="normalized"):
            lpips.update(bad, b)
    with pytest.raises(ValueError, match="reduction"):
        tmt.LearnedPerceptualImagePatchSimilarity(reduction="max", allow_random_weights=True, device="cpu")
    calls = []
    real_aminmax = torch.aminmax
    try:
        torch.aminmax = lambda x: calls.append(1) or real_aminmax(x)
        lpips.update(a, b)
    finally:
        torch.aminmax = real_aminmax
    assert len(calls) == 2


def test_lpips_callable_net():
    net = lambda x, y: ((x - y) ** 2).mean(dim=(1, 2, 3))  # noqa: E731
    lpips = tmt.LearnedPerceptualImagePatchSimilarity(net_type=net, device="cpu")
    (a, b), _ = _pairs(8, n=2)
    lpips.update(torch.from_numpy(a), torch.from_numpy(b))
    assert float(lpips.compute()) == pytest.approx(float(((a - b) ** 2).mean()), rel=1e-5)


# ---------------------------------------------------------------- sync
def test_feature_buffers_sync_row_by_row():
    """Two emulated ranks: the synced buffers are each update's rows of every rank (spec None,
    gathered row by row), and FID over them equals one metric fed every rank's updates in that order."""
    ranks = [tmt.FrechetInceptionDistance(feature=port_features, device="cpu") for _ in range(2)]
    feeds = [[(_images(10 + r, 12 + r), True), (_images(20 + r, 14, 0.3), False)] for r in range(2)]
    for metric, feed in zip(ranks, feeds):
        _feed(metric, feed, True)
    ranks[0].sync(dist_sync_fn=TorchFakeGather(ranks), distributed_available=DIST_ON)
    synced = ranks[0]
    assert [t.shape[0] for t in synced.real_features] == [12, 13]
    reference = tmt.FrechetInceptionDistance(feature=port_features, device="cpu")
    _feed(reference, [feeds[0][0], feeds[1][0], feeds[0][1], feeds[1][1]], True)
    torch.testing.assert_close(synced.compute(), reference.compute(), rtol=F64_RTOL, atol=0)
    synced.unsync()
    assert [t.shape[0] for t in synced.real_features] == [12]
