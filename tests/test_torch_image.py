"""The port's image-quality metrics against the JAX package on the same inputs.

PSNR, SSIM (2-D and 3-D), MS-SSIM, UQI, ERGAS, SAM and D-lambda in
functional and module form, with every reduction and option; the helpers
(Gaussian and uniform windows, the depthwise convolution, reflection padding
of 4-D and 5-D input, the average pool); ``image_gradients``. Inputs are made
with numpy from a seed; MS-SSIM's targets are correlated copies of the
predictions (on noise its coarse scales decorrelate and both packages give
NaN). Tolerances are the JAX package's own image tests': atol 1e-4 (rtol
1e-5), ERGAS atol 1e-2 (its values are near 100 and more),
``image_gradients`` atol 1e-6 (a single float32 difference). Also: the
buffered rows of a collection form one compute group, sync in one metadata
and one payload collective, and load from a JAX metric's ``state_dict()``.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jmt
import metrics_tpu.functional as jF
import metrics_tpu_torch as tmt
import metrics_tpu_torch.functional as tF
from metrics_tpu.functional.image import helper as jhelper
from metrics_tpu.utils import checks as jax_checks
from metrics_tpu_torch.functional.image import helper as thelper
from metrics_tpu_torch.interop import load_reference_state
from metrics_tpu_torch.parallel import collective_stats, reset_collective_stats
from metrics_tpu_torch.utils import checks as torch_checks
from tests.helpers.torch_sync import install_world

ATOL, RTOL = 1e-4, 1e-5  # the JAX package's image tests (tests/image/test_image.py:53)
ERGAS_ATOL = 1e-2  # tests/image/test_image.py:202
GRADIENTS_ATOL = 1e-6


@pytest.fixture(autouse=True)
def _full_validation():
    jax_prev, torch_prev = jax_checks._get_validation_mode(), torch_checks._get_validation_mode()
    jax_checks.set_validation_mode("full")
    torch_checks.set_validation_mode("full")
    yield
    jax_checks.set_validation_mode(jax_prev)
    torch_checks.set_validation_mode(torch_prev)


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*will save all targets and predictions in buffer.*")
        yield


def assert_same(expected, got, atol=ATOL, rtol=RTOL):
    if isinstance(expected, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(expected) == len(got)
        for e, g in zip(expected, got):
            assert_same(e, g, atol, rtol)
        return
    e = np.asarray(expected)
    assert isinstance(got, torch.Tensor), type(got)
    g = got.detach().cpu().numpy()
    assert e.shape == g.shape, (e.shape, g.shape)
    assert str(e.dtype) == str(got.dtype).replace("torch.", ""), (e.dtype, got.dtype)
    if np.issubdtype(e.dtype, np.floating):
        np.testing.assert_allclose(g, e, atol=atol, rtol=rtol, equal_nan=True)
    else:
        np.testing.assert_array_equal(g, e)


def both(jax_fn, torch_fn, *arrays, atol=ATOL, **kwargs):
    """The two packages' results on the same arrays; the same exception type where JAX refuses."""
    try:
        expected = jax_fn(*[jnp.asarray(a) for a in arrays], **kwargs)
    except (ValueError, RuntimeError, TypeError) as err:
        with pytest.raises(type(err)):
            torch_fn(*[torch.from_numpy(np.asarray(a)) for a in arrays], **kwargs)
        return None
    got = torch_fn(*[torch.from_numpy(np.asarray(a)) for a in arrays], **kwargs)
    assert_same(expected, got, atol=atol)
    return got


def images(shape=(2, 3, 24, 24), seed=0, noise=0.1, dtype=np.float32):
    """Predictions in [0, 1] and a correlated, noisy target."""
    rng = np.random.RandomState(seed)
    preds = rng.rand(*shape).astype(np.float32)
    target = np.clip(preds * 0.8 + 0.1 + noise * rng.randn(*shape), 0, 1).astype(np.float32)
    return preds.astype(dtype), target.astype(dtype)


def smooth_images(shape, seed=0):
    """Correlated images with structure at every scale (MS-SSIM's coarse scales stay correlated)."""
    rng = np.random.RandomState(seed)
    grid = np.stack(np.meshgrid(*[np.linspace(0, 6, s) for s in shape[2:]], indexing="ij"))
    base = np.sin(grid.sum(0) + rng.rand()) * 0.4 + 0.5
    preds = np.clip(base + 0.05 * rng.randn(*shape), 0, 1).astype(np.float32)
    target = np.clip(preds * 0.9 + 0.05 + 0.02 * rng.randn(*shape), 0, 1).astype(np.float32)
    return preds, target


# ------------------------------------------------------------------ helpers
@pytest.mark.parametrize("sizes,sigmas", [((11, 11), (1.5, 1.5)), ((7, 5), (1.0, 2.0))])
def test_windows(sizes, sigmas):
    assert_same(jhelper._gaussian_kernel_2d(sizes, sigmas), thelper._gaussian_kernel_2d(sizes, sigmas), atol=1e-7)
    assert_same(jhelper._gaussian_kernel_3d(sizes + (3,), sigmas + (0.8,)),
                thelper._gaussian_kernel_3d(sizes + (3,), sigmas + (0.8,)), atol=1e-7)
    assert_same(jhelper._uniform_kernel(sizes), thelper._uniform_kernel(sizes), atol=0)


@pytest.mark.parametrize("shape", [(2, 3, 12, 10), (2, 2, 6, 9, 8)], ids=["2d", "3d"])
def test_reflect_pad_depthwise_conv_and_pool(shape):
    x = np.random.RandomState(1).rand(*shape).astype(np.float32)
    pads = [(2, 2), (1, 3)] if len(shape) == 4 else [(1, 1), (2, 2), (3, 1)]
    assert_same(jhelper._reflect_pad(jnp.asarray(x), pads), thelper._reflect_pad(torch.from_numpy(x), pads), atol=0)
    kernel = np.random.RandomState(2).rand(*([3] * (len(shape) - 2))).astype(np.float32)
    assert_same(jhelper._depthwise_conv(jnp.asarray(x), jnp.asarray(kernel)),
                thelper._depthwise_conv(torch.from_numpy(x), torch.from_numpy(kernel)))
    assert_same(jhelper._avg_pool(jnp.asarray(x)), thelper._avg_pool(torch.from_numpy(x)), atol=1e-6)


# ------------------------------------------------------------------ PSNR
PSNR_CASES = [
    {},
    {"data_range": 1.0},
    {"data_range": 1.0, "base": 2.718281828},
    {"data_range": 1.0, "dim": 1, "reduction": "none"},
    {"data_range": 1.0, "dim": (1, 2), "reduction": "sum"},
    {"data_range": 1.0, "dim": (2, 3), "reduction": "elementwise_mean"},
    {"dim": 1},  # refused: a dim needs a data_range
]


@pytest.mark.parametrize("kwargs", PSNR_CASES, ids=str)
def test_psnr_functional(kwargs):
    both(jF.peak_signal_noise_ratio, tF.peak_signal_noise_ratio, *images(), **kwargs)


@pytest.mark.parametrize("kwargs", PSNR_CASES[:-1], ids=str)
def test_psnr_module(kwargs):
    j, t = jmt.PeakSignalNoiseRatio(**kwargs), tmt.PeakSignalNoiseRatio(device="cpu", **kwargs)
    for seed in range(3):
        preds, target = images(seed=seed)
        assert_same(j(jnp.asarray(preds), jnp.asarray(target)), t(torch.from_numpy(preds), torch.from_numpy(target)))
    for name, value in j.metric_state.items():
        assert_same(value, getattr(t, name))
    assert_same(j.compute(), t.compute())


def test_psnr_refuses_what_jax_refuses():
    with pytest.raises(ValueError):
        tmt.PeakSignalNoiseRatio(dim=1, device="cpu")
    both(jF.peak_signal_noise_ratio, tF.peak_signal_noise_ratio, *images(shape=(2, 3, 8, 8)),
         **{"data_range": 1.0})
    with pytest.raises(RuntimeError):
        tF.peak_signal_noise_ratio(torch.zeros(2, 3), torch.zeros(3, 2))


# ------------------------------------------------------------------ SSIM
SSIM_CASES = [
    {},
    {"data_range": 1.0},
    {"gaussian_kernel": False, "kernel_size": 7},
    {"sigma": (1.0, 2.0), "reduction": "none"},
    {"reduction": "sum", "k1": 0.02, "k2": 0.05},
    {"return_full_image": True, "reduction": "none"},
    {"return_contrast_sensitivity": True, "data_range": 1.0},
    {"kernel_size": 8, "gaussian_kernel": False},  # refused: an even window
    {"sigma": -1.0},  # refused
]


@pytest.mark.parametrize("kwargs", SSIM_CASES, ids=str)
def test_ssim_functional_2d(kwargs):
    both(jF.structural_similarity_index_measure, tF.structural_similarity_index_measure,
         *images(shape=(3, 2, 28, 26)), **kwargs)


@pytest.mark.parametrize("kwargs", [{}, {"gaussian_kernel": False, "kernel_size": (3, 5, 3)},
                                    {"sigma": (0.8, 1.0, 0.6), "return_contrast_sensitivity": True},
                                    {"return_full_image": True}], ids=str)
def test_ssim_functional_3d(kwargs):
    # 5-D input: the reflection padding and the conv run over three spatial dims
    both(jF.structural_similarity_index_measure, tF.structural_similarity_index_measure,
         *images(shape=(2, 1, 14, 16, 15), seed=3), **kwargs)


def test_ssim_statistics_run_in_float32_for_half_inputs():
    both(jF.structural_similarity_index_measure, tF.structural_similarity_index_measure,
         *images(shape=(2, 3, 20, 20), dtype=np.float16))


def test_ssim_refuses_bad_shapes():
    both(jF.structural_similarity_index_measure, tF.structural_similarity_index_measure, *images(shape=(3, 20, 20)))


MS_SSIM_CASES = [
    {"data_range": 1.0},
    {},
    {"data_range": 1.0, "reduction": "none"},
    {"data_range": 1.0, "normalize": "relu"},
    {"data_range": 1.0, "normalize": "simple", "reduction": "sum"},
    {"data_range": 1.0, "betas": (0.3, 0.3, 0.4), "gaussian_kernel": False, "kernel_size": 5},
    {"betas": [0.5, 0.5]},  # refused: betas must be a tuple
    {"normalize": "max"},  # refused
]


@pytest.mark.parametrize("kwargs", MS_SSIM_CASES, ids=str)
def test_ms_ssim_functional(kwargs):
    both(jF.multiscale_structural_similarity_index_measure, tF.multiscale_structural_similarity_index_measure,
         *smooth_images((2, 2, 180, 184)), **kwargs)


def test_ms_ssim_functional_3d_and_small_images():
    both(jF.multiscale_structural_similarity_index_measure, tF.multiscale_structural_similarity_index_measure,
         *smooth_images((2, 1, 16, 36, 40), seed=4), betas=(0.6, 0.4), data_range=1.0)
    # too small for five scales: both refuse
    both(jF.multiscale_structural_similarity_index_measure, tF.multiscale_structural_similarity_index_measure,
         *smooth_images((1, 1, 64, 64)))


@pytest.mark.parametrize("ndim", [4, 5])
def test_ssim_module(ndim):
    shape = (2, 2, 20, 22) if ndim == 4 else (1, 1, 12, 14, 13)
    j, t = jmt.StructuralSimilarityIndexMeasure(data_range=1.0), tmt.StructuralSimilarityIndexMeasure(
        data_range=1.0, device="cpu")
    for seed in range(3):
        preds, target = images(shape=shape, seed=seed)
        assert_same(j(jnp.asarray(preds), jnp.asarray(target)), t(torch.from_numpy(preds), torch.from_numpy(target)))
    assert_same(j.compute(), t.compute())
    assert len(t.preds) == 3 and t.preds[0].shape == shape


def test_ms_ssim_module():
    kwargs = {"data_range": 1.0, "reduction": "none"}
    j, t = jmt.MultiScaleStructuralSimilarityIndexMeasure(**kwargs), tmt.MultiScaleStructuralSimilarityIndexMeasure(
        device="cpu", **kwargs)
    for seed in range(2):
        preds, target = smooth_images((1, 1, 180, 180), seed=seed)
        j.update(jnp.asarray(preds), jnp.asarray(target))
        t.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert_same(j.compute(), t.compute())
    for bad in ({"kernel_size": 1.5}, {"kernel_size": (3, 3, 3, 3)}, {"betas": [0.5]}, {"betas": (1, 2)},
                {"normalize": "max"}):
        with pytest.raises(ValueError):
            tmt.MultiScaleStructuralSimilarityIndexMeasure(device="cpu", **bad)


# ------------------------------------------------------------------ UQI, ERGAS, SAM, D-lambda, gradients
@pytest.mark.parametrize("kwargs", [{}, {"kernel_size": (5, 7), "sigma": (1.0, 0.5)}, {"reduction": "none"},
                                    {"reduction": "sum"}, {"kernel_size": (4, 5)}, {"kernel_size": (3, 3, 3)}],
                         ids=str)
def test_uqi(kwargs):
    both(jF.universal_image_quality_index, tF.universal_image_quality_index, *images(shape=(2, 3, 18, 20)), **kwargs)


@pytest.mark.parametrize("kwargs", [{}, {"ratio": 2}, {"reduction": "none"}, {"reduction": "sum"}], ids=str)
def test_ergas(kwargs):
    both(jF.error_relative_global_dimensionless_synthesis, tF.error_relative_global_dimensionless_synthesis,
         *images(shape=(3, 4, 16, 16), seed=5), atol=ERGAS_ATOL, **kwargs)


@pytest.mark.parametrize("kwargs", [{}, {"reduction": "none"}, {"reduction": "sum"}], ids=str)
def test_sam(kwargs):
    both(jF.spectral_angle_mapper, tF.spectral_angle_mapper, *images(shape=(2, 4, 12, 12), seed=6), **kwargs)
    both(jF.spectral_angle_mapper, tF.spectral_angle_mapper, *images(shape=(2, 1, 12, 12), seed=6), **kwargs)


@pytest.mark.parametrize("kwargs", [{}, {"p": 2}, {"p": 3, "reduction": "sum"}, {"reduction": "none"}, {"p": 0}],
                         ids=str)
def test_d_lambda(kwargs):
    both(jF.spectral_distortion_index, tF.spectral_distortion_index, *images(shape=(2, 4, 16, 16), seed=7), **kwargs)
    both(jF.spectral_distortion_index, tF.spectral_distortion_index, *images(shape=(2, 1, 16, 16), seed=7), **kwargs)


def test_image_gradients():
    x = np.random.RandomState(8).randn(2, 3, 7, 9).astype(np.float32)
    jdy, jdx = jF.image_gradients(jnp.asarray(x))
    tdy, tdx = tF.image_gradients(torch.from_numpy(x))
    assert_same(jdy, tdy, atol=GRADIENTS_ATOL)
    assert_same(jdx, tdx, atol=GRADIENTS_ATOL)
    ints = np.arange(25, dtype=np.int32).reshape(1, 1, 5, 5)
    assert_same(jF.image_gradients(jnp.asarray(ints))[0], tF.image_gradients(torch.from_numpy(ints))[0])
    with pytest.raises(RuntimeError):
        tF.image_gradients(torch.zeros(3, 4, 4))


SPECTRAL_MODULES = [
    ("UniversalImageQualityIndex", {}, ATOL),
    ("UniversalImageQualityIndex", {"reduction": "none"}, ATOL),
    ("ErrorRelativeGlobalDimensionlessSynthesis", {"ratio": 2}, ERGAS_ATOL),
    ("SpectralAngleMapper", {}, ATOL),
    ("SpectralDistortionIndex", {"p": 2}, ATOL),
]


@pytest.mark.parametrize("name,kwargs,atol", SPECTRAL_MODULES, ids=[f"{m[0]}-{m[1]}" for m in SPECTRAL_MODULES])
def test_spectral_modules(name, kwargs, atol):
    j, t = getattr(jmt, name)(**kwargs), getattr(tmt, name)(device="cpu", **kwargs)
    for seed in range(2):
        preds, target = images(shape=(2, 4, 16, 16), seed=10 + seed)
        assert_same(j(jnp.asarray(preds), jnp.asarray(target)), t(torch.from_numpy(preds), torch.from_numpy(target)),
                    atol=atol)
    # int rows are buffered raw and cast to float32 once, at compute
    preds, target = images(shape=(1, 4, 16, 16), seed=12)
    j.update(jnp.asarray(preds), jnp.asarray((target * 100).astype(np.int32)))
    t.update(torch.from_numpy(preds), torch.from_numpy((target * 100).astype(np.int32)))
    assert t.target[-1].dtype == torch.int32
    assert_same(j.compute(), t.compute(), atol=atol)


def test_spectral_module_checks():
    with pytest.raises(ValueError):
        tmt.SpectralDistortionIndex(p=0, device="cpu")
    with pytest.raises(ValueError):
        tmt.SpectralDistortionIndex(reduction="mean", device="cpu")
    with pytest.raises(ValueError):
        tmt.SpectralAngleMapper(device="cpu").update(torch.zeros(2, 3, 4), torch.zeros(2, 3, 4))


# ------------------------------------------------------------------ collections, sync, carried state
def restoration_suite(pkg):
    dev = {"device": "cpu"} if pkg is tmt else {}
    return pkg.MetricCollection({
        "psnr": pkg.PeakSignalNoiseRatio(data_range=1.0, **dev),
        "psnr_range": pkg.PeakSignalNoiseRatio(**dev),
        "ssim": pkg.StructuralSimilarityIndexMeasure(data_range=1.0, **dev),
        "ms_ssim": pkg.MultiScaleStructuralSimilarityIndexMeasure(data_range=1.0, **dev),
        "uqi": pkg.UniversalImageQualityIndex(**dev),
    })


def test_restoration_suite_shares_the_buffered_rows():
    j, t = restoration_suite(jmt), restoration_suite(tmt)
    for seed in range(2):
        preds, target = smooth_images((1, 3, 180, 180), seed=seed)
        j.update(jnp.asarray(preds), jnp.asarray(target))
        t.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert ["ms_ssim", "ssim", "uqi"] in [sorted(g) for g in t.compute_groups.values()]
    jv, tv = j.compute(), t.compute()
    assert sorted(jv) == sorted(tv)
    for k in jv:
        assert_same(jv[k], tv[k])


def test_ssim_rows_sync_in_one_metadata_and_one_payload_collective(monkeypatch):
    def rank(seed):
        m = tmt.StructuralSimilarityIndexMeasure(data_range=1.0, device="cpu")
        for s in range(2):
            preds, target = images(shape=(2, 1, 16, 16), seed=seed + s)
            m.update(torch.from_numpy(preds), torch.from_numpy(target))
        return m

    ranks = [rank(40 + 10 * r) for r in range(3)]
    want_preds = torch.cat([row for m in ranks for row in m.preds])
    install_world(monkeypatch, ranks[1:])
    reset_collective_stats()
    ranks[0].sync(distributed_available=lambda: True)
    stats = collective_stats()
    assert (stats["sync_shape_collectives"], stats["sync_payload_collectives"]) == (1, 1)
    assert torch.equal(ranks[0].preds, want_preds)
    synced = ranks[0].compute.__wrapped__()
    ranks[0].unsync()
    every = tmt.StructuralSimilarityIndexMeasure(data_range=1.0, device="cpu")
    for m in ranks:
        for p, q in zip(m.preds, m.target):
            every.update(p, q)
    torch.testing.assert_close(synced, every.compute(), atol=0, rtol=0)


@pytest.mark.parametrize("name,kwargs", [("StructuralSimilarityIndexMeasure", {"data_range": 1.0}),
                                         ("PeakSignalNoiseRatio", {}),
                                         ("PeakSignalNoiseRatio", {"data_range": 1.0, "dim": 1})], ids=str)
def test_load_a_jax_image_metric_state_dict(name, kwargs):
    j = getattr(jmt, name)(**kwargs)
    for seed in range(2):
        preds, target = images(shape=(2, 3, 16, 16), seed=20 + seed)
        j.update(jnp.asarray(preds), jnp.asarray(target))
    j.persistent(True)
    t = getattr(tmt, name)(device="cpu", **kwargs)
    load_reference_state(t, j.state_dict(), update_count=2)
    assert_same(j.compute(), t.compute())
