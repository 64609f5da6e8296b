"""SDR: the projection onto the span of the target's shifts, by a Toeplitz solve.

JAX counterpart: `metrics_tpu/functional/audio/sdr.py` (``_symmetric_toeplitz``
`:31`, ``_compute_autocorr_crosscorr`` `:38`, ``_toeplitz_matvec`` `:50`,
``_toeplitz_conjugate_gradient`` `:63`, ``signal_distortion_ratio`` `:90`):
FFT auto- and cross-correlation, the symmetric Toeplitz system ``R h = b``
solved batched (``torch.linalg.solve_ex``: no host read, and no error on a
singular system, as in JAX), or matrix-free by ``use_cg_iter`` steps of
conjugate gradient with a circulant FFT product, then coherence to dB.

Precision follows JAX's default: float32 for float16, bfloat16 and float32
input, float64 for float64 input (JAX under x64); the result is float32 unless
the input was float64. The float32 solve of a 512 x 512 Toeplitz system is
ill-conditioned, so cuSOLVER and the CPU's LAPACK round differently.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.compute import _l2_norm, high_precision


def _symmetric_toeplitz(vector: Tensor) -> Tensor:
    """The symmetric Toeplitz matrix of its first row: ``T[..., i, j] = v[..., |i - j|]``."""
    v_len = vector.shape[-1]
    pos = torch.arange(v_len, device=vector.device)
    return vector[..., (pos[:, None] - pos[None, :]).abs()]


def _compute_autocorr_crosscorr(target: Tensor, preds: Tensor, corr_len: int) -> Tuple[Tensor, Tensor]:
    """The target's FFT auto-correlation and its cross-correlation with ``preds``, ``corr_len`` lags each."""
    n_fft = 2 ** math.ceil(math.log2(preds.shape[-1] + target.shape[-1] - 1))
    t_fft = torch.fft.rfft(target, n=n_fft, dim=-1)
    r_0 = torch.fft.irfft(t_fft.real**2 + t_fft.imag**2, n=n_fft)[..., :corr_len]
    p_fft = torch.fft.rfft(preds, n=n_fft, dim=-1)
    b = torch.fft.irfft(torch.conj(t_fft) * p_fft, n=n_fft, dim=-1)[..., :corr_len]
    return r_0, b


def _toeplitz_matvec(r_0: Tensor, x: Tensor, n_fft: int) -> Tensor:
    """T(r_0) @ x by the circulant embedding: first column [r_0, zeros, reversed r_0[1:]]."""
    corr_len = r_0.shape[-1]
    pad = n_fft - (2 * corr_len - 1)
    c = torch.cat([r_0, r_0.new_zeros(r_0.shape[:-1] + (pad,)), torch.flip(r_0[..., 1:], dims=(-1,))], dim=-1)
    c_fft = torch.fft.rfft(c, dim=-1)
    x_fft = torch.fft.rfft(x, n=n_fft, dim=-1)
    return torch.fft.irfft(c_fft * x_fft, n=n_fft, dim=-1)[..., :corr_len]


def _toeplitz_conjugate_gradient(r_0: Tensor, b: Tensor, n_iter: int) -> Tensor:
    """``n_iter`` steps of matrix-free conjugate gradient on ``T(r_0) x = b``; zero denominators guarded."""
    corr_len = r_0.shape[-1]
    n_fft = 2 ** math.ceil(math.log2(2 * corr_len - 1))
    x = torch.zeros_like(b)
    r = b - _toeplitz_matvec(r_0, x, n_fft)
    p = r
    rs_old = torch.sum(r * r, dim=-1, keepdim=True)
    for _ in range(n_iter):
        ap = _toeplitz_matvec(r_0, p, n_fft)
        denom = torch.sum(p * ap, dim=-1, keepdim=True)
        alpha = rs_old / torch.where(denom == 0, torch.ones_like(denom), denom)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = torch.sum(r * r, dim=-1, keepdim=True)
        beta = rs_new / torch.where(rs_old == 0, torch.ones_like(rs_old), rs_old)
        p = r + beta * p
        rs_old = rs_new
    return x


@high_precision
def signal_distortion_ratio(
    preds: Tensor,
    target: Tensor,
    use_cg_iter: Optional[int] = None,
    filter_length: int = 512,
    zero_mean: bool = False,
    load_diag: Optional[float] = None,
) -> Tensor:
    """SDR of ``preds`` against the best ``filter_length``-tap filtering of ``target``.

    Example:
        >>> import numpy as np
        >>> import torch
        >>> from metrics_tpu_torch.functional import signal_distortion_ratio
        >>> rng = np.random.RandomState(1)
        >>> preds = torch.from_numpy(rng.randn(8000).astype(np.float32))
        >>> target = torch.from_numpy(rng.randn(8000).astype(np.float32))
        >>> float(signal_distortion_ratio(preds, target)) < -10
        True
    """
    _check_same_shape(preds, target)
    in_dtype = preds.dtype
    dtype = torch.float64 if in_dtype == torch.float64 else torch.float32
    preds = preds.to(dtype)
    target = target.to(dtype)

    if zero_mean:
        preds = preds - preds.mean(dim=-1, keepdim=True)
        target = target - target.mean(dim=-1, keepdim=True)

    target = target / torch.clamp(_l2_norm(target, dim=-1, keepdim=True), min=1e-6)
    preds = preds / torch.clamp(_l2_norm(preds, dim=-1, keepdim=True), min=1e-6)

    r_0, b = _compute_autocorr_crosscorr(target, preds, corr_len=filter_length)
    if load_diag is not None:
        r_0 = torch.cat([r_0[..., :1] + load_diag, r_0[..., 1:]], dim=-1)

    if use_cg_iter is not None:
        sol = _toeplitz_conjugate_gradient(r_0, b, n_iter=use_cg_iter)
    else:
        sol = torch.linalg.solve_ex(_symmetric_toeplitz(r_0), b[..., None])[0][..., 0]

    coh = torch.sum(b * sol, dim=-1)
    ratio = coh / (1 - coh)
    val = 10.0 * torch.log10(ratio)
    return val if in_dtype == torch.float64 else val.to(torch.float32)


__all__ = ["signal_distortion_ratio"]
