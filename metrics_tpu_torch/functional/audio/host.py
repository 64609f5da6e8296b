"""PESQ and STOI: host scores of each clip.

JAX counterpart: `metrics_tpu/functional/audio/host.py` (PESQ `:21`, STOI
`:59`). PESQ is the ``pesq`` package's ITU-T P.862 and raises
``ModuleNotFoundError`` without it; STOI is the in-tree numpy implementation
(:mod:`metrics_tpu_torch.functional.audio.stoi`). The inputs come to the host
in one copy; the scores go back, float32, to the inputs' device in one copy
(``keep_same_device`` is accepted for signature compatibility: the result is
always on the inputs' device).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.functional.audio.stoi import native_stoi
from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.imports import _PESQ_AVAILABLE


def _pesq_host(preds: np.ndarray, target: np.ndarray, fs: int, mode: str) -> np.ndarray:
    """PESQ of each clip, float32 on the host."""
    import pesq as pesq_backend

    if preds.ndim == 1:
        return np.asarray(pesq_backend.pesq(fs, target, preds, mode), dtype=np.float32)
    preds_2d = preds.reshape(-1, preds.shape[-1])
    target_2d = target.reshape(-1, preds.shape[-1])
    vals = np.empty(preds_2d.shape[0])
    for b in range(preds_2d.shape[0]):
        vals[b] = pesq_backend.pesq(fs, target_2d[b, :], preds_2d[b, :], mode)
    return vals.astype(np.float32).reshape(preds.shape[:-1])


def _check_pesq_arguments(fs: int, mode: str, what: str = "PESQ metric") -> None:
    """JAX's checks in its order: the package first, then ``fs``, then ``mode``."""
    if not _PESQ_AVAILABLE:
        raise ModuleNotFoundError(f"{what} requires that pesq is installed. Install it with `pip install pesq`.")
    if fs not in (8000, 16000):
        raise ValueError(f"Expected argument `fs` to either be 8000 or 16000 but got {fs}")
    if mode not in ("wb", "nb"):
        raise ValueError(f"Expected argument `mode` to either be 'wb' or 'nb' but got {mode}")


def perceptual_evaluation_speech_quality(
    preds: Tensor, target: Tensor, fs: int, mode: str, keep_same_device: bool = False
) -> Tensor:
    """PESQ through the ``pesq`` package (ITU-T P.862).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import perceptual_evaluation_speech_quality
        >>> preds = torch.zeros(8000)
        >>> perceptual_evaluation_speech_quality(preds, preds, 8000, 'nb')  # doctest: +SKIP
    """
    _check_pesq_arguments(fs, mode)
    _check_same_shape(preds, target)
    vals = _pesq_host(preds.detach().cpu().numpy(), target.detach().cpu().numpy(), fs, mode)
    return torch.from_numpy(vals).to(preds.device)


def short_time_objective_intelligibility(
    preds: Tensor, target: Tensor, fs: int, extended: bool = False, keep_same_device: bool = False
) -> Tensor:
    """STOI / ESTOI (Taal et al. 2010 / Jensen and Taal 2016), the in-tree implementation.

    Example:
        >>> import numpy as np
        >>> import torch
        >>> from metrics_tpu_torch.functional import short_time_objective_intelligibility
        >>> rng = np.random.RandomState(0)
        >>> target = torch.from_numpy(np.sin(2 * np.pi * 440 * np.arange(16000) / 10000) * (1 + 0.5 * rng.rand(16000)))
        >>> preds = target + 0.1 * torch.from_numpy(rng.randn(16000))
        >>> float(short_time_objective_intelligibility(preds, target, 10000)) > 0.5
        True
    """
    _check_same_shape(preds, target)
    vals = native_stoi(preds.detach().cpu().numpy(), target.detach().cpu().numpy(), fs, extended)
    return torch.from_numpy(np.asarray(vals)).to(preds.device)


__all__ = ["perceptual_evaluation_speech_quality", "short_time_objective_intelligibility"]
