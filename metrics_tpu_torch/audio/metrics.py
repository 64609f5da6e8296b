"""Audio module metrics: means of per-clip scores.

JAX counterpart: `metrics_tpu/audio/metrics.py` (``_MeanAudioMetric`` `:31`,
``SignalNoiseRatio`` `:49`, ``ScaleInvariantSignalNoiseRatio`` `:75`,
``SignalDistortionRatio`` `:97`, ``ScaleInvariantSignalDistortionRatio``
`:137`, ``PermutationInvariantTraining`` `:163`,
``PerceptualEvaluationSpeechQuality`` `:202`,
``ShortTimeObjectiveIntelligibility`` `:234`). Every module keeps a float32
``sum_<metric>`` and an int32 ``total``, both summed by a sync, and divides
at ``compute()``. PESQ and STOI score on the host: their inputs come to the
host in one copy an update, their sums stay on the metric's device.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.functional.audio.host import _check_pesq_arguments, _pesq_host
from metrics_tpu_torch.functional.audio.pit import permutation_invariant_training
from metrics_tpu_torch.functional.audio.sdr import signal_distortion_ratio
from metrics_tpu_torch.functional.audio.snr import (
    scale_invariant_signal_distortion_ratio,
    scale_invariant_signal_noise_ratio,
    signal_noise_ratio,
)
from metrics_tpu_torch.functional.audio.stoi import native_stoi
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.checks import _check_same_shape


class _MeanAudioMetric(Metric):
    """The sum and count states of an averaged audio metric."""

    _state_name: str = "sum_value"

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state(self._state_name, default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def _accumulate(self, batch_values: Tensor) -> None:
        setattr(self, self._state_name, getattr(self, self._state_name) + batch_values.sum())
        self.total = self.total + batch_values.numel()

    def _accumulate_host(self, values: np.ndarray) -> None:
        """Host scores of an update into the states: one copy to the device."""
        self._accumulate(torch.from_numpy(np.asarray(values, dtype=np.float32)).to(self.device))

    @staticmethod
    def _to_host(preds: Tensor, target: Tensor):
        """(preds, target) as numpy arrays, in one copy to the host."""
        _check_same_shape(preds, target)
        dtype = torch.promote_types(preds.dtype, target.dtype)  # lossless for both
        both = torch.stack([preds.detach().to(dtype), target.detach().to(dtype)]).cpu().numpy()
        return both[0], both[1]

    def compute(self) -> Tensor:
        return getattr(self, self._state_name) / self.total


class SignalNoiseRatio(_MeanAudioMetric):
    """Average SNR.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import SignalNoiseRatio
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> snr = SignalNoiseRatio(device="cpu")
        >>> round(float(snr(preds, target)), 2)
        16.18
    """

    full_state_update = False
    is_differentiable = True
    higher_is_better = True
    _state_name = "sum_snr"

    def __init__(self, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.zero_mean = zero_mean

    def update(self, preds: Tensor, target: Tensor) -> None:
        self._accumulate(signal_noise_ratio(preds=preds, target=target, zero_mean=self.zero_mean))


class ScaleInvariantSignalNoiseRatio(_MeanAudioMetric):
    """Average SI-SNR.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import ScaleInvariantSignalNoiseRatio
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> si_snr = ScaleInvariantSignalNoiseRatio(device="cpu")
        >>> si_snr(preds, target).round(decimals=4)
        tensor(15.0918)
    """

    full_state_update = False
    is_differentiable = True
    higher_is_better = True
    _state_name = "sum_si_snr"

    def update(self, preds: Tensor, target: Tensor) -> None:
        self._accumulate(scale_invariant_signal_noise_ratio(preds=preds, target=target))


class SignalDistortionRatio(_MeanAudioMetric):
    """Average SDR.

    Example:
        >>> import numpy as np
        >>> import torch
        >>> from metrics_tpu_torch import SignalDistortionRatio
        >>> rng = np.random.RandomState(1)
        >>> preds = torch.from_numpy(rng.randn(8000).astype(np.float32))
        >>> target = torch.from_numpy(rng.randn(8000).astype(np.float32))
        >>> sdr = SignalDistortionRatio(device="cpu")
        >>> float(sdr(preds, target)) < -10
        True
    """

    full_state_update = False
    is_differentiable = True
    higher_is_better = True
    _state_name = "sum_sdr"

    def __init__(
        self,
        use_cg_iter: Optional[int] = None,
        filter_length: int = 512,
        zero_mean: bool = False,
        load_diag: Optional[float] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.use_cg_iter = use_cg_iter
        self.filter_length = filter_length
        self.zero_mean = zero_mean
        self.load_diag = load_diag

    def update(self, preds: Tensor, target: Tensor) -> None:
        self._accumulate(
            signal_distortion_ratio(preds, target, self.use_cg_iter, self.filter_length, self.zero_mean, self.load_diag)
        )


class ScaleInvariantSignalDistortionRatio(_MeanAudioMetric):
    """Average SI-SDR.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import ScaleInvariantSignalDistortionRatio
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> si_sdr = ScaleInvariantSignalDistortionRatio(device="cpu")
        >>> si_sdr(preds, target).round(decimals=4)
        tensor(18.4030)
    """

    full_state_update = False
    is_differentiable = True
    higher_is_better = True
    _state_name = "sum_si_sdr"

    def __init__(self, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.zero_mean = zero_mean

    def update(self, preds: Tensor, target: Tensor) -> None:
        self._accumulate(scale_invariant_signal_distortion_ratio(preds=preds, target=target, zero_mean=self.zero_mean))


class PermutationInvariantTraining(_MeanAudioMetric):
    """Average metric of the best speaker permutation.

    Keyword arguments other than the ``Metric`` ones (``device``,
    ``dist_sync_on_step``, ``process_group``, ``dist_sync_fn``,
    ``sync_on_compute``, ``compute_on_cpu``) go to ``metric_func``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import PermutationInvariantTraining
        >>> from metrics_tpu_torch.functional import scale_invariant_signal_distortion_ratio
        >>> preds = torch.tensor([[[-0.0579,  0.3560, -0.9604], [-0.1719,  0.3205,  0.2951]]])
        >>> target = torch.tensor([[[ 1.0958, -0.1648,  0.5228], [-0.4100,  1.1942, -0.5103]]])
        >>> pit = PermutationInvariantTraining(scale_invariant_signal_distortion_ratio, 'max', device="cpu")
        >>> round(float(pit(preds, target)), 3)
        -5.109
    """

    full_state_update = False
    is_differentiable = True
    # the direction depends on eval_func
    higher_is_better = None
    _state_name = "sum_pit_metric"

    def __init__(self, metric_func: Callable, eval_func: str = "max", **kwargs: Any) -> None:
        base_kwargs: Dict[str, Any] = {
            k: kwargs.pop(k)
            for k in ("device", "compute_on_cpu", "dist_sync_on_step", "process_group", "dist_sync_fn", "sync_on_compute")
            if k in kwargs
        }
        super().__init__(**base_kwargs)
        self.metric_func = metric_func
        self.eval_func = eval_func
        self.kwargs = kwargs

    def update(self, preds: Tensor, target: Tensor) -> None:
        pit_metric = permutation_invariant_training(preds, target, self.metric_func, self.eval_func, **self.kwargs)[0]
        self._accumulate(pit_metric)


class PerceptualEvaluationSpeechQuality(_MeanAudioMetric):
    """Average PESQ through the ``pesq`` package.

    Example:
        >>> from metrics_tpu_torch import PerceptualEvaluationSpeechQuality
        >>> pesq = PerceptualEvaluationSpeechQuality(8000, 'nb')  # doctest: +SKIP
    """

    full_state_update = False
    is_differentiable = False
    higher_is_better = True
    _state_name = "sum_pesq"

    def __init__(self, fs: int, mode: str, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _check_pesq_arguments(fs, mode, "PerceptualEvaluationSpeechQuality metric")
        self.fs = fs
        self.mode = mode

    def update(self, preds: Tensor, target: Tensor) -> None:
        self._accumulate_host(_pesq_host(*self._to_host(preds, target), self.fs, self.mode))


class ShortTimeObjectiveIntelligibility(_MeanAudioMetric):
    """Average STOI over clips (the in-tree numpy implementation; no ``pystoi``).

    Example:
        >>> import numpy as np
        >>> import torch
        >>> from metrics_tpu_torch import ShortTimeObjectiveIntelligibility
        >>> rng = np.random.RandomState(0)
        >>> target = torch.from_numpy(np.sin(2 * np.pi * 440 * np.arange(16000) / 10000) * (1 + 0.5 * rng.rand(16000)))
        >>> stoi = ShortTimeObjectiveIntelligibility(10000, device="cpu")
        >>> float(stoi(target + 0.1 * torch.from_numpy(rng.randn(16000)), target)) > 0.5
        True
    """

    full_state_update = False
    is_differentiable = False
    higher_is_better = True
    _state_name = "sum_stoi"

    def __init__(self, fs: int, extended: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.fs = fs
        self.extended = extended

    def update(self, preds: Tensor, target: Tensor) -> None:
        self._accumulate_host(native_stoi(*self._to_host(preds, target), self.fs, self.extended))


__all__ = [
    "SignalNoiseRatio",
    "ScaleInvariantSignalNoiseRatio",
    "SignalDistortionRatio",
    "ScaleInvariantSignalDistortionRatio",
    "PermutationInvariantTraining",
    "PerceptualEvaluationSpeechQuality",
    "ShortTimeObjectiveIntelligibility",
]
