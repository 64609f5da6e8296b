"""The port's audio metrics against the JAX package on the same seeded signals.

SNR, SI-SNR, SI-SDR, SDR (the solve and conjugate gradient, ``load_diag``,
``zero_mean``; float32 against JAX's default, float64 against JAX under
``jax.enable_x64``), PIT with 2, 3 and 8 speakers (8: scipy's assignment on the
host), ``pit_permutate``, STOI and ESTOI at 10 and 16 kHz, and PESQ's checks,
in functional and module form. Tolerances in dB stand beside their
constants; PIT's permutations and the permuted speakers are exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jmt
import metrics_tpu.functional as jF
import metrics_tpu_torch as tmt
import metrics_tpu_torch.functional as tF
from metrics_tpu_torch.utils.imports import _PESQ_AVAILABLE

SNR_ATOL_DB = 1e-4  # float32 sums over the time axis in another order: about 1e-6 relative in each energy
SDR_F32_ATOL_DB = 2e-3  # float32 solve of an ill-conditioned Toeplitz system: LAPACK builds round differently
SDR_F64_ATOL_DB = 1e-9  # float64 solve
STOI_ATOL = 1e-6  # the same float64 numpy on each side, rounded to float32


def signals(seed, shape, snr_db=10.0, dtype=np.float32):
    """(preds, target): target noise with a slow envelope, preds the target plus white noise at ``snr_db``."""
    rng = np.random.RandomState(seed)
    target = rng.randn(*shape) * (1 + 0.5 * np.sin(np.linspace(0, 8, shape[-1])))
    noise = rng.randn(*shape) * np.sqrt((target**2).mean(-1, keepdims=True) / 10 ** (snr_db / 10))
    return (target + noise).astype(dtype), target.astype(dtype)


def close(got, want, atol, rtol=0.0):
    w = np.asarray(want)
    assert isinstance(got, torch.Tensor)
    g = got.detach().cpu().numpy()
    assert g.shape == w.shape and str(g.dtype) == str(w.dtype), (g.shape, w.shape, g.dtype, w.dtype)
    np.testing.assert_allclose(g, w, atol=atol, rtol=rtol)


def both(fn_name, *arrays, atol=SNR_ATOL_DB, **kwargs):
    want = getattr(jF, fn_name)(*[jnp.asarray(a) for a in arrays], **kwargs)
    got = getattr(tF, fn_name)(*[torch.from_numpy(a) for a in arrays], **kwargs)
    close(got, want, atol)
    return got


@pytest.mark.parametrize("shape", [(200,), (4, 300), (2, 3, 250)])
@pytest.mark.parametrize("fn_name, kwargs", [
    ("signal_noise_ratio", {}), ("signal_noise_ratio", {"zero_mean": True}),
    ("scale_invariant_signal_distortion_ratio", {}), ("scale_invariant_signal_distortion_ratio", {"zero_mean": True}),
    ("scale_invariant_signal_noise_ratio", {}),
])
def test_snr_family(fn_name, kwargs, shape):
    preds, target = signals(0, shape)
    both(fn_name, preds, target, **kwargs)


def test_snr_family_float64_and_checks():
    preds, target = signals(1, (3, 200), dtype=np.float64)
    with jax.enable_x64(True):
        for fn_name in ("signal_noise_ratio", "scale_invariant_signal_distortion_ratio"):
            both(fn_name, preds, target, atol=1e-9)
    for fn_name in ("signal_noise_ratio", "scale_invariant_signal_noise_ratio"):
        with pytest.raises(RuntimeError):
            getattr(tF, fn_name)(torch.zeros(3, 5), torch.zeros(3, 4))


SDR_CASES = [
    dict(filter_length=64),
    dict(filter_length=64, zero_mean=True),
    dict(filter_length=64, load_diag=1e-3),
    dict(filter_length=64, use_cg_iter=10),
    dict(filter_length=128, use_cg_iter=5, load_diag=1e-2, zero_mean=True),
]


@pytest.mark.parametrize("kwargs", SDR_CASES)
def test_sdr_float32_against_jax_default(kwargs):
    preds, target = signals(2, (3, 1000))
    got = both("signal_distortion_ratio", preds, target, atol=SDR_F32_ATOL_DB, **kwargs)
    assert got.dtype == torch.float32


@pytest.mark.parametrize("kwargs", SDR_CASES)
def test_sdr_float64_against_jax_x64(kwargs):
    preds, target = signals(3, (2, 800), dtype=np.float64)
    with jax.enable_x64(True):
        got = both("signal_distortion_ratio", preds, target, atol=SDR_F64_ATOL_DB, **kwargs)
    assert got.dtype == torch.float64


def test_sdr_half_inputs_compute_in_float32():
    preds, target = signals(4, (2, 600))
    for dtype in (torch.float16, torch.bfloat16):
        got = tF.signal_distortion_ratio(torch.from_numpy(preds).to(dtype), torch.from_numpy(target).to(dtype),
                                         filter_length=32)
        want = tF.signal_distortion_ratio(torch.from_numpy(preds).to(dtype).float(),
                                          torch.from_numpy(target).to(dtype).float(), filter_length=32)
        assert got.dtype == torch.float32 and torch.equal(got, want)


def test_sdr_internals_equal_jax():
    from metrics_tpu.functional.audio import sdr as jsdr
    from metrics_tpu_torch.functional.audio import sdr as tsdr

    rng = np.random.RandomState(5)
    v = rng.randn(2, 9).astype(np.float32)
    np.testing.assert_array_equal(tsdr._symmetric_toeplitz(torch.from_numpy(v)).numpy(),
                                  np.asarray(jsdr._symmetric_toeplitz(jnp.asarray(v))))
    x = rng.randn(2, 9).astype(np.float32)
    close(tsdr._toeplitz_matvec(torch.from_numpy(v), torch.from_numpy(x), 32),
          jsdr._toeplitz_matvec(jnp.asarray(v), jnp.asarray(x), 32), atol=1e-5)
    full = tsdr._symmetric_toeplitz(torch.from_numpy(v).double()) @ torch.from_numpy(x).double()[..., None]
    np.testing.assert_allclose(tsdr._toeplitz_matvec(torch.from_numpy(v), torch.from_numpy(x), 32).numpy(),
                               full[..., 0].numpy(), atol=1e-5)


@pytest.mark.parametrize("cls_name, kwargs", [
    ("SignalNoiseRatio", {}), ("SignalNoiseRatio", {"zero_mean": True}), ("ScaleInvariantSignalNoiseRatio", {}),
    ("ScaleInvariantSignalDistortionRatio", {}), ("SignalDistortionRatio", {"filter_length": 64}),
    ("SignalDistortionRatio", {"filter_length": 64, "use_cg_iter": 8}),
])
def test_mean_audio_modules(cls_name, kwargs):
    atol = SDR_F32_ATOL_DB if cls_name == "SignalDistortionRatio" else SNR_ATOL_DB
    jm, tm = getattr(jmt, cls_name)(**kwargs), getattr(tmt, cls_name)(**kwargs, device="cpu")
    for seed in (6, 7):
        preds, target = signals(seed, (3, 700))
        close(tm(torch.from_numpy(preds), torch.from_numpy(target)), jm(jnp.asarray(preds), jnp.asarray(target)), atol)
    close(tm.compute(), jm.compute(), atol)
    assert tm.total.dtype == torch.int32 and int(tm.total) == int(jm.total) == 6
    tm.persistent(True)
    assert sorted(tm.state_dict()) == sorted(jm.metric_state)
    tm.reset()
    assert int(tm.total) == 0


def speakers(seed, batch, spk, length=400):
    """(preds, target, perm): the estimates are the sources in a random order per mixture, plus noise at 10 dB."""
    rng = np.random.RandomState(seed)
    target = rng.randn(batch, spk, length).astype(np.float32)
    perm = np.stack([rng.permutation(spk) for _ in range(batch)])
    preds = np.take_along_axis(target, perm[:, :, None], axis=1)
    preds = (preds + rng.randn(*preds.shape) * np.sqrt(0.1)).astype(np.float32)
    return preds, target, perm


@pytest.mark.parametrize("eval_func", ["max", "min"])
@pytest.mark.parametrize("spk", [2, 3, 8])
def test_pit(spk, eval_func):
    preds, target, _ = speakers(8 + spk, 4, spk)
    fns = [(jF.scale_invariant_signal_distortion_ratio, tF.scale_invariant_signal_distortion_ratio),
           (jF.signal_noise_ratio, tF.signal_noise_ratio)]
    for jfn, tfn in fns:
        jbest, jperm = jF.permutation_invariant_training(jnp.asarray(preds), jnp.asarray(target), jfn, eval_func)
        tbest, tperm = tF.permutation_invariant_training(torch.from_numpy(preds), torch.from_numpy(target), tfn, eval_func)
        assert tperm.dtype == torch.int64
        np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))
        close(tbest, jbest, SNR_ATOL_DB)
        permuted = tF.pit_permutate(torch.from_numpy(preds), tperm)
        np.testing.assert_array_equal(permuted.numpy(), np.asarray(jF.pit_permutate(jnp.asarray(preds), jperm)))


def test_pit_finds_the_permutation_and_takes_the_first_of_ties():
    preds, target, perm = speakers(20, 6, 3)
    _, best = tF.permutation_invariant_training(torch.from_numpy(preds), torch.from_numpy(target),
                                                tF.scale_invariant_signal_distortion_ratio)
    # preds[b, i] is target[b, perm[b, i]]: target j is matched by the prediction i with perm[b, i] == j
    np.testing.assert_array_equal(best.numpy(), np.argsort(perm, axis=1))
    same = np.zeros((2, 3, 50), np.float32)  # every permutation scores the same: the first, identity, wins

    def zero(p, t):
        return (p * t).sum(-1) * 0.0

    _, tied = tF.permutation_invariant_training(torch.from_numpy(same), torch.from_numpy(same), zero)
    _, jtied = jF.permutation_invariant_training(jnp.asarray(same), jnp.asarray(same), lambda p, t: (p * t).sum(-1) * 0.0)
    np.testing.assert_array_equal(tied.numpy(), np.asarray(jtied))
    np.testing.assert_array_equal(tied.numpy(), [[0, 1, 2], [0, 1, 2]])


def test_pit_checks_and_module():
    for args in ((torch.zeros(2, 3, 5), torch.zeros(2, 2, 5)),):
        with pytest.raises(RuntimeError):
            tF.permutation_invariant_training(*args, tF.signal_noise_ratio)
    with pytest.raises(ValueError, match="eval_func"):
        tF.permutation_invariant_training(torch.zeros(2, 2, 5), torch.zeros(2, 2, 5), tF.signal_noise_ratio, "mean")
    jm = jmt.PermutationInvariantTraining(jF.scale_invariant_signal_distortion_ratio, "max", zero_mean=True)
    tm = tmt.PermutationInvariantTraining(tF.scale_invariant_signal_distortion_ratio, "max", zero_mean=True, device="cpu")
    assert tm.kwargs == {"zero_mean": True} and tm.device.type == "cpu"
    for seed in (21, 22):
        preds, target, _ = speakers(seed, 3, 2)
        close(tm(torch.from_numpy(preds), torch.from_numpy(target)), jm(jnp.asarray(preds), jnp.asarray(target)),
              SNR_ATOL_DB)
    close(tm.compute(), jm.compute(), SNR_ATOL_DB)


@pytest.mark.parametrize("fs", [10000, 16000])
@pytest.mark.parametrize("extended", [False, True])
def test_stoi(fs, extended):
    rng = np.random.RandomState(23)
    n = int(fs * 0.8)
    t = np.arange(n) / fs
    target = (np.sin(2 * np.pi * 440 * t) * (1 + 0.5 * rng.rand(n)) + 0.3 * rng.randn(n)).astype(np.float32)
    target = np.stack([target, target[::-1].copy()])
    preds = (target + 0.3 * rng.randn(*target.shape)).astype(np.float32)
    got = both("short_time_objective_intelligibility", preds, target, atol=STOI_ATOL, fs=fs, extended=extended)
    assert np.all((got.numpy() > 0) & (got.numpy() <= 1))
    jm = jmt.ShortTimeObjectiveIntelligibility(fs, extended)
    tm = tmt.ShortTimeObjectiveIntelligibility(fs, extended, device="cpu")
    close(tm(torch.from_numpy(preds), torch.from_numpy(target)), jm(jnp.asarray(preds), jnp.asarray(target)), STOI_ATOL)
    close(tm.compute(), jm.compute(), STOI_ATOL)


def test_stoi_short_clip_warns_like_jax():
    preds, target = signals(24, (1000,))
    with pytest.warns(UserWarning, match="Not enough non-silent frames"):
        got = tF.short_time_objective_intelligibility(torch.from_numpy(preds), torch.from_numpy(target), 10000)
    assert float(got) == pytest.approx(1e-5)


def test_pesq_checks():
    preds, target = signals(25, (8000,))
    if _PESQ_AVAILABLE:
        close(tF.perceptual_evaluation_speech_quality(torch.from_numpy(preds), torch.from_numpy(target), 8000, "nb"),
              jF.perceptual_evaluation_speech_quality(jnp.asarray(preds), jnp.asarray(target), 8000, "nb"), 1e-6)
        for fs, mode in ((44100, "nb"), (8000, "xx")):
            with pytest.raises(ValueError):
                tF.perceptual_evaluation_speech_quality(torch.from_numpy(preds), torch.from_numpy(target), fs, mode)
        return
    for call in (
        lambda F, x: F.perceptual_evaluation_speech_quality(x(preds), x(target), 8000, "nb"),
        lambda F, x: F.perceptual_evaluation_speech_quality(x(preds), x(target), 44100, "nb"),
    ):
        with pytest.raises(ModuleNotFoundError) as jerr:
            call(jF, jnp.asarray)
        with pytest.raises(ModuleNotFoundError) as terr:
            call(tF, torch.from_numpy)
        assert str(terr.value) == str(jerr.value)
    with pytest.raises(ModuleNotFoundError) as jerr:
        jmt.PerceptualEvaluationSpeechQuality(8000, "nb")
    with pytest.raises(ModuleNotFoundError) as terr:
        tmt.PerceptualEvaluationSpeechQuality(8000, "nb", device="cpu")
    assert str(terr.value) == str(jerr.value)
