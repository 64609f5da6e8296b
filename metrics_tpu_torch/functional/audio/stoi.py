"""STOI and ESTOI (Short-Time Objective Intelligibility), in numpy on the host.

A copy of `metrics_tpu/functional/audio/stoi.py:47-189`, which implements the
published algorithms and needs no ``pystoi``:

- STOI: C. H. Taal, R. C. Hendriks, R. Heusdens, J. Jensen, "An Algorithm
  for Intelligibility Prediction of Time-Frequency Weighted Noisy Speech",
  IEEE TASLP 2011.
- ESTOI (``extended=True``): J. Jensen, C. H. Taal, "An Algorithm for
  Predicting the Intelligibility of Speech Masked by Modulated Noise
  Maskers", IEEE TASLP 2016.

Resample to 10 kHz (``scipy.signal.resample_poly``), drop the silent frames
(40 dB below the clean signal's loudest 256-sample Hann frame, 50% overlap),
a 512-point STFT, 15 one-third-octave bands from 150 Hz, 30-frame (384 ms)
segments, then the clipped band correlations (STOI) or the row- and
column-normalised inner products (ESTOI). The silent-frame removal makes the
shapes depend on the data, so the work stays on the host.
"""
from __future__ import annotations

from functools import lru_cache
from math import gcd

import numpy as np

from metrics_tpu_torch.utils.prints import rank_zero_warn

FS = 10_000  # the algorithm is defined at 10 kHz
N_FRAME = 256  # frame length (25.6 ms)
NFFT = 512  # FFT size
NUMBAND = 15  # one-third-octave bands
MINFREQ = 150  # first band center (Hz)
N_SEG = 30  # frames per analysis segment (384 ms)
BETA = -15.0  # lower SDR clipping bound (dB)
DYN_RANGE = 40.0  # silent-frame dynamic range (dB)
_EPS = np.finfo(np.float64).eps


@lru_cache(maxsize=8)
def _third_octave_band_matrix(fs: int = FS, nfft: int = NFFT, num_bands: int = NUMBAND, min_freq: int = MINFREQ):
    """(num_bands, nfft//2 + 1) selection matrix; published band-edge rule:
    center f_c = min_freq * 2^(k/3), edges f_c * 2^(+-1/6) snapped to the
    nearest FFT bin."""
    f = np.linspace(0, fs, nfft + 1)[: nfft // 2 + 1]
    k = np.arange(num_bands, dtype=np.float64)
    cf = 2.0 ** (k / 3.0) * min_freq
    freq_low = cf * 2.0 ** (-1.0 / 6.0)
    freq_high = cf * 2.0 ** (1.0 / 6.0)
    obm = np.zeros((num_bands, len(f)))
    for i in range(num_bands):
        lo = int(np.argmin((f - freq_low[i]) ** 2))
        hi = int(np.argmin((f - freq_high[i]) ** 2))
        obm[i, lo:hi] = 1.0
    return obm, cf


def _resample_to_fs(x: np.ndarray, fs: int) -> np.ndarray:
    if fs == FS:
        return x
    try:
        from scipy.signal import resample_poly
    except ImportError as err:
        raise ModuleNotFoundError(
            f"STOI at fs={fs} needs resampling to 10 kHz, which requires scipy. "
            "Install scipy (`pip install scipy`) or resample the signals to 10000 Hz upstream."
        ) from err

    g = gcd(FS, int(fs))
    return resample_poly(x, FS // g, int(fs) // g)


def _frames(x: np.ndarray, framelen: int, hop: int, window: np.ndarray) -> np.ndarray:
    n = (len(x) - framelen) // hop + 1
    if n <= 0:
        return np.zeros((0, framelen))
    idx = np.arange(framelen)[None, :] + hop * np.arange(n)[:, None]
    return x[idx] * window[None, :]


def _remove_silent_frames(x: np.ndarray, y: np.ndarray, dyn_range: float, framelen: int, hop: int):
    """Drop frames whose CLEAN energy is more than ``dyn_range`` dB below the
    loudest clean frame; overlap-add the survivors back to signals."""
    # the published window: interior of a (framelen+2)-point Hann
    w = np.hanning(framelen + 2)[1:-1]
    x_frames = _frames(x, framelen, hop, w)
    y_frames = _frames(y, framelen, hop, w)
    energies = 20.0 * np.log10(np.linalg.norm(x_frames, axis=1) + _EPS)
    mask = energies > (np.max(energies) - dyn_range)
    x_frames, y_frames = x_frames[mask], y_frames[mask]

    n_kept = x_frames.shape[0]
    out_len = (n_kept - 1) * hop + framelen if n_kept else 0
    x_out = np.zeros(out_len)
    y_out = np.zeros(out_len)
    for i in range(n_kept):  # overlap-add (50% Hann overlap sums to unity)
        x_out[i * hop : i * hop + framelen] += x_frames[i]
        y_out[i * hop : i * hop + framelen] += y_frames[i]
    return x_out, y_out


def _stft_bands(x: np.ndarray, obm: np.ndarray) -> np.ndarray:
    """(num_bands, n_frames) one-third-octave band magnitudes."""
    w = np.hanning(N_FRAME + 2)[1:-1]
    frames = _frames(x, N_FRAME, N_FRAME // 2, w)
    spec = np.fft.rfft(frames, NFFT, axis=1)  # (n_frames, nfft//2+1)
    return np.sqrt(obm @ (np.abs(spec) ** 2).T)  # (bands, n_frames)


def _stoi_single(x: np.ndarray, y: np.ndarray, fs: int, extended: bool) -> float:
    """One (clean ``x``, degraded ``y``) pair -> scalar score."""
    if len(x) != len(y):
        raise ValueError("clean and degraded signals must have the same length")
    x = _resample_to_fs(np.asarray(x, np.float64), fs)
    y = _resample_to_fs(np.asarray(y, np.float64), fs)
    if len(x) >= N_FRAME:
        x, y = _remove_silent_frames(x, y, DYN_RANGE, N_FRAME, N_FRAME // 2)

    obm, _ = _third_octave_band_matrix()
    x_tob = _stft_bands(x, obm)
    y_tob = _stft_bands(y, obm)
    n_frames = x_tob.shape[1]
    if n_frames < N_SEG:
        # as pystoi does: warn and return the degenerate 1e-5 score rather than
        # abort the caller's loop over one short or mostly silent clip
        rank_zero_warn(
            f"Not enough non-silent frames for STOI ({n_frames} < {N_SEG}; signals need "
            "at least 384 ms of audible content at 10 kHz) — returning 1e-5, like the "
            "pystoi backend."
        )
        return 1e-5

    # all (bands, N_SEG) segments, sliding by one frame
    n_segs = n_frames - N_SEG + 1
    seg_idx = np.arange(N_SEG)[None, :] + np.arange(n_segs)[:, None]
    x_segs = x_tob[:, seg_idx].transpose(1, 0, 2)  # (n_segs, bands, N_SEG)
    y_segs = y_tob[:, seg_idx].transpose(1, 0, 2)

    if extended:
        # ESTOI: rows (bands) mean/norm-normalized, then columns, then the
        # mean inner product over columns
        def _row_col_norm(s):
            s = s - s.mean(axis=2, keepdims=True)
            s = s / (np.linalg.norm(s, axis=2, keepdims=True) + _EPS)
            s = s - s.mean(axis=1, keepdims=True)
            return s / (np.linalg.norm(s, axis=1, keepdims=True) + _EPS)

        xn = _row_col_norm(x_segs)
        yn = _row_col_norm(y_segs)
        return float(np.sum(xn * yn) / (N_SEG * n_segs))

    # STOI: per segment, scale the degraded bands to the clean energy, clip
    # at -BETA dB below clean, then band-row correlations
    norm_const = np.sqrt(
        np.sum(x_segs**2, axis=2, keepdims=True) / (np.sum(y_segs**2, axis=2, keepdims=True) + _EPS)
    )
    y_scaled = y_segs * norm_const
    clip_val = 10.0 ** (-BETA / 20.0)
    y_prime = np.minimum(y_scaled, x_segs * (1.0 + clip_val))

    xc = x_segs - x_segs.mean(axis=2, keepdims=True)
    yc = y_prime - y_prime.mean(axis=2, keepdims=True)
    corr = np.sum(xc * yc, axis=2) / (np.linalg.norm(xc, axis=2) * np.linalg.norm(yc, axis=2) + _EPS)
    return float(corr.sum() / (NUMBAND * n_segs))


def native_stoi(preds: np.ndarray, target: np.ndarray, fs: int, extended: bool = False) -> np.ndarray:
    """STOI/ESTOI of each clip over any leading batch shape, float32 on the host."""
    preds_np = np.asarray(preds, np.float64)
    target_np = np.asarray(target, np.float64)
    if preds_np.ndim == 1:
        return np.asarray(_stoi_single(target_np, preds_np, fs, extended), dtype=np.float32)
    flat_p = preds_np.reshape(-1, preds_np.shape[-1])
    flat_t = target_np.reshape(-1, target_np.shape[-1])
    vals = np.asarray([_stoi_single(t, p, fs, extended) for p, t in zip(flat_p, flat_t)], np.float32)
    return vals.reshape(preds_np.shape[:-1])


__all__ = ["native_stoi"]
