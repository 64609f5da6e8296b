"""Model-backed generative image metrics: FID, KID, InceptionScore, LPIPS.

JAX counterpart: `metrics_tpu/image/generative.py` (``_psd_sqrt`` `:52`,
``_trace_sqrtm_eigh`` `:73`, ``_compute_fid`` `:118`,
``_fid_from_features_host`` `:155`, ``_gate_random_weights`` `:181`,
``_resolve_extractor`` `:194`, ``_FeatureBufferMetric`` `:216`,
``FrechetInceptionDistance`` `:246`, ``poly_kernel`` `:326`,
``maximum_mean_discrepancy`` `:333`, ``poly_mmd`` `:342`,
``KernelInceptionDistance`` `:351`, ``InceptionScore`` `:444`, ``_valid_img``
`:511`, ``LearnedPerceptualImagePatchSimilarity`` `:516`); reference
`image/{fid,kid,inception,lpip}.py`.

- The networks (:mod:`metrics_tpu_torch.models`) run on the metric's device
  and move with ``.to()``; they are not registered submodules, so the
  metric's ``state_dict`` and sync hold the feature buffers and the LPIPS
  sums only, as in JAX.
- FID works in float64 on the device: covariances with ``n - 1``, then
  ``trace sqrtm(Σ₁Σ₂) = Σᵢ √λᵢ(√Σ₁ Σ₂ √Σ₁)`` from two ``torch.linalg.eigh``
  (the JAX route on CPU and GPU backends; with the autotuner armed its
  ``newton_schulz`` variant may serve instead, JAX's `:59-115`). The
  host-LAPACK route that JAX takes on a TPU (no native float64) is
  :func:`_fid_from_features_host`, kept as a numpy oracle: the CPU and the
  card never take it, so :func:`fid_stats` (JAX's `:33-49`) reads 0 here.
- KID and IS draw their subsets from ``np.random.RandomState(seed)`` in the
  JAX package's order, so both packages score the same subsets. KID's
  spread is the standard deviation with no correction (``jnp.std``), IS's
  with correction 1 (``std(ddof=1)``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.ops import autotune as _autotune
from metrics_tpu_torch.ops import telemetry as _telemetry
from metrics_tpu_torch.models.inception import INCEPTION_CONVERTER, InceptionV3Extractor, LazyParamsPickleExtractor
from metrics_tpu_torch.models.lpips import _BACKBONES, LPIPSExtractor, lpips_converter
from metrics_tpu_torch.utils.compute import high_precision
from metrics_tpu_torch.utils.data import dim_zero_cat
from metrics_tpu_torch.utils.prints import rank_zero_warn

_VALID_FEATURE_INTS = (64, 192, 768, 2048)

# FID's host-LAPACK route, JAX's on a TPU: the CPU and the card never take it, so these stay 0.
_counters: Dict[str, Any] = {"fid_host_sqrtm": 0, "fid_host_sqrtm_time_s": 0.0}


def fid_stats() -> Dict[str, Any]:
    """FID's host-route counters, merged into :func:`metrics_tpu_torch.ops.engine.engine_stats`."""
    return dict(_counters)


def _zero_counters() -> None:
    _counters["fid_host_sqrtm"] = 0
    _counters["fid_host_sqrtm_time_s"] = 0.0


_telemetry.register_reset("fid", _zero_counters)


def _psd_sqrt(mat: Tensor) -> Tensor:
    """Symmetric PSD square root by eigendecomposition (on the device)."""
    vals, vecs = torch.linalg.eigh(mat)
    vals = vals.clamp(min=0.0)
    return (vecs * torch.sqrt(vals)[None, :]) @ vecs.T


def _trace_sqrtm_eigh(sigma1: Tensor, sigma2: Tensor) -> Tensor:
    """trace(sqrtm(Σ₁ Σ₂)) for PSD Σ, from two symmetric eigendecompositions: JAX's reference
    variant, which its ``_trace_sqrtm_product`` serves with the autotuner off."""
    s1_half = _psd_sqrt(sigma1)
    inner = s1_half @ sigma2 @ s1_half
    vals = torch.linalg.eigvalsh(inner)
    return torch.sum(torch.sqrt(vals.clamp(min=0.0)))


def _trace_sqrtm_product(sigma1: Tensor, sigma2: Tensor) -> Tensor:
    """trace(sqrtm(Σ₁ Σ₂)) for PSD Σ: the variant the autotuner serves (the reference, ``eigh``, while it is off)."""
    if _autotune.dispatch("fid_sqrtm", (sigma1, sigma2)) == "newton_schulz":
        return _trace_sqrtm_newton_schulz(sigma1, sigma2)
    return _trace_sqrtm_eigh(sigma1, sigma2)


_NS_ITERS = 30
_NS_JITTER = 1e-6


def _trace_sqrtm_newton_schulz(sigma1: Tensor, sigma2: Tensor) -> Tensor:
    """Matrix products only: the coupled Newton-Schulz square-root iteration (JAX's variant).

    ``A = Σ₁Σ₂`` is similar to the PSD ``√Σ₂ Σ₁ √Σ₂``, so the spectrum of
    ``A / ‖A‖_F`` lies in ``[0, 1]``, inside the iteration's region of
    convergence: ``T = ½(3I − ZY); Y ← YT; Z ← TZ`` takes ``Y`` to its square
    root in :data:`_NS_ITERS` steps. The :data:`_NS_JITTER` diagonal shift
    keeps exact-zero eigenvalues off the unit circle of ``I − Y₀``; its effect
    on the trace is far below the declared 1e-2, and the sweep disqualifies
    the variant wherever the contract still fails."""
    a = sigma1 @ sigma2
    norm = torch.sqrt(torch.sum(a * a)).clamp(min=1e-30)
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    y, z = a / norm + _NS_JITTER * eye, eye
    for _ in range(_NS_ITERS):
        t = 0.5 * (3.0 * eye - z @ y)
        y, z = y @ t, t @ z
    return torch.trace(y) * torch.sqrt(norm)


_autotune.register_variant("fid_sqrtm", "eigh", _trace_sqrtm_eigh, reference=True)
_autotune.register_variant("fid_sqrtm", "newton_schulz", _trace_sqrtm_newton_schulz, tolerance=1e-2)


def _compute_fid(mu1: Tensor, sigma1: Tensor, mu2: Tensor, sigma2: Tensor) -> Tensor:
    """Fréchet distance ‖μ₁−μ₂‖² + tr(Σ₁+Σ₂−2·sqrtm(Σ₁Σ₂)) (reference `fid.py:98-126`)."""
    diff = mu1 - mu2
    tr_covmean = _trace_sqrtm_product(sigma1, sigma2)
    return diff @ diff + torch.trace(sigma1) + torch.trace(sigma2) - 2 * tr_covmean


def _fid_from_features_host(real: np.ndarray, fake: np.ndarray) -> float:
    """Fréchet distance in host numpy float64, the same math as the device path."""
    real = real.astype(np.float64)
    fake = fake.astype(np.float64)
    mu1, mu2 = real.mean(0), fake.mean(0)
    d1, d2 = real - mu1, fake - mu2
    cov1 = d1.T @ d1 / (real.shape[0] - 1)
    cov2 = d2.T @ d2 / (fake.shape[0] - 1)
    vals1, vecs1 = np.linalg.eigh(cov1)
    s1_half = (vecs1 * np.sqrt(np.clip(vals1, 0, None))[None, :]) @ vecs1.T
    inner = s1_half @ cov2 @ s1_half
    vals = np.linalg.eigvalsh(inner)
    tr_covmean = np.sum(np.sqrt(np.clip(vals, 0, None)))
    diff = mu1 - mu2
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2) - 2 * tr_covmean)


_RANDOM_WEIGHTS_MSG = (
    "No pretrained parameters supplied for the {net} — its scores would come from a RANDOM "
    "initialization and carry no meaning vs published numbers. Fetch and convert the reference "
    "checkpoint (see docs/weights.md):\n    {hint}\nthen pass `npz_path=\"out.npz\"` (or the "
    "loaded pytree via `params`). To intentionally run with random weights (pipeline smoke "
    "tests, wall-clock benchmarks), construct with `allow_random_weights=True`."
)


def _gate_random_weights(params: Any, npz_path: Optional[str], allow_random_weights: bool, net: str, hint: str) -> None:
    """Raise unless weights were supplied or random init explicitly waived."""
    if params is not None or npz_path is not None:
        return
    if not allow_random_weights:
        raise RuntimeError(_RANDOM_WEIGHTS_MSG.format(net=net, hint=hint))
    rank_zero_warn(
        f"No pretrained parameters supplied for the {net}; using a deterministic random"
        " initialization (allow_random_weights=True). Scores are NOT comparable to"
        " published numbers."
    )


def _resolve_extractor(
    feature: Union[int, str, Callable], valid: tuple, params: Any, seed: int,
    npz_path: Optional[str], allow_random_weights: bool, metric_name: str, device: torch.device,
) -> Callable:
    if isinstance(feature, (int, str)) and not callable(feature):
        if feature not in valid:
            raise ValueError(f"Input to argument `feature` must be one of {list(valid)}, but got {feature}.")
        _gate_random_weights(
            params,
            npz_path,
            allow_random_weights,
            net=f"InceptionV3 feature extractor of `{metric_name}`",
            hint=INCEPTION_CONVERTER,
        )
        return InceptionV3Extractor(feature=str(feature), params=params, npz_path=npz_path, seed=seed, device=device)
    if callable(feature):
        return feature
    raise TypeError("Got unknown input to argument `feature`")


class _NetworkMetric(Metric):
    """A metric that holds a network in ``_network_attr``: a plain attribute, not a submodule, so
    ``state_dict`` and sync skip its weights; ``.to()`` moves a network the metric built
    (a caller's own callable stays where the caller put it)."""

    _network_attr = "inception"

    def _set_network(self, net: Any) -> None:
        object.__setattr__(self, self._network_attr, net)

    def _apply(self, fn: Callable, recurse: bool = True) -> "_NetworkMetric":
        super()._apply(fn, recurse)
        net = self.__dict__.get(self._network_attr)
        if isinstance(net, LazyParamsPickleExtractor):
            net.to(self.device)
        return self


class _FeatureBufferMetric(_NetworkMetric):
    """Shared real/fake feature-buffer plumbing for FID and KID."""

    def __init__(self, reset_real_features: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(reset_real_features, bool):
            raise ValueError("Argument `reset_real_features` expected to be a bool")
        self.reset_real_features = reset_real_features
        self.add_state("real_features", default=[], dist_reduce_fx=None)
        self.add_state("fake_features", default=[], dist_reduce_fx=None)

    def update(self, imgs: Tensor, real: bool) -> None:
        features = self.inception(imgs)
        if real:
            self.real_features.append(features)
        else:
            self.fake_features.append(features)

    def reset(self) -> None:
        # keep the cached real-set features across resets (reference `fid.py:282-289`)
        kept = self.real_features
        super().reset()
        if not self.reset_real_features:
            self.real_features = kept


class FrechetInceptionDistance(_FeatureBufferMetric):
    """FID between accumulated real/fake feature distributions.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.image.generative import FrechetInceptionDistance
        >>> g = torch.Generator().manual_seed(123)
        >>> fid = FrechetInceptionDistance(feature=lambda x: x.reshape(x.shape[0], -1)[:, :8], device="cpu")
        >>> fid.update(torch.rand(16, 3, 2, 2, generator=g), real=True)
        >>> fid.update(torch.rand(16, 3, 2, 2, generator=g) + 0.5, real=False)
        >>> float(fid.compute()) > 0
        True
    """

    higher_is_better = False
    is_differentiable = False
    full_state_update = False

    def __init__(
        self,
        feature: Union[int, Callable] = 2048,
        reset_real_features: bool = True,
        params: Any = None,
        npz_path: Optional[str] = None,
        allow_random_weights: bool = False,
        seed: int = 0,
        **kwargs: Any,
    ) -> None:
        super().__init__(reset_real_features=reset_real_features, **kwargs)
        rank_zero_warn(
            "Metric `FrechetInceptionDistance` will save all extracted features in buffer."
            " For large datasets this may lead to large memory footprint.",
            UserWarning,
        )
        self._set_network(_resolve_extractor(
            feature, _VALID_FEATURE_INTS, params, seed, npz_path, allow_random_weights,
            "FrechetInceptionDistance", self.device,
        ))

    @high_precision
    def compute(self) -> Tensor:
        real_features = dim_zero_cat(self.real_features)
        fake_features = dim_zero_cat(self.fake_features)
        orig_dtype = real_features.dtype
        real64 = real_features.to(torch.float64)
        fake64 = fake_features.to(torch.float64)
        n = real64.shape[0]
        m = fake64.shape[0]
        mean1 = real64.mean(dim=0)
        mean2 = fake64.mean(dim=0)
        diff1 = real64 - mean1
        diff2 = fake64 - mean2
        cov1 = diff1.T @ diff1 / (n - 1)
        cov2 = diff2.T @ diff2 / (m - 1)
        return _compute_fid(mean1, cov1, mean2, cov2).to(orig_dtype)


def poly_kernel(f1: Tensor, f2: Tensor, degree: int = 3, gamma: Optional[float] = None, coef: float = 1.0) -> Tensor:
    """Polynomial kernel (γ·f₁f₂ᵀ + c)^d (reference `kid.py:49-54`)."""
    if gamma is None:
        gamma = 1.0 / f1.shape[1]
    return (f1 @ f2.T * gamma + coef) ** degree


def maximum_mean_discrepancy(k_xx: Tensor, k_xy: Tensor, k_yy: Tensor) -> Tensor:
    """Unbiased MMD² estimate from kernel matrices (reference `kid.py:29-46`)."""
    m = k_xx.shape[0]
    kt_xx_sum = (k_xx.sum(dim=-1) - torch.diagonal(k_xx)).sum()
    kt_yy_sum = (k_yy.sum(dim=-1) - torch.diagonal(k_yy)).sum()
    k_xy_sum = k_xy.sum()
    return (kt_xx_sum + kt_yy_sum) / (m * (m - 1)) - 2 * k_xy_sum / (m**2)


@high_precision
def poly_mmd(
    f_real: Tensor, f_fake: Tensor, degree: int = 3, gamma: Optional[float] = None, coef: float = 1.0
) -> Tensor:
    k_11 = poly_kernel(f_real, f_real, degree, gamma, coef)
    k_22 = poly_kernel(f_fake, f_fake, degree, gamma, coef)
    k_12 = poly_kernel(f_real, f_fake, degree, gamma, coef)
    return maximum_mean_discrepancy(k_11, k_12, k_22)


class KernelInceptionDistance(_FeatureBufferMetric):
    """KID: polynomial-kernel MMD over random feature subsets.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.image.generative import KernelInceptionDistance
        >>> g = torch.Generator().manual_seed(123)
        >>> kid = KernelInceptionDistance(
        ...     feature=lambda x: x.reshape(x.shape[0], -1)[:, :8], subsets=2, subset_size=8, device="cpu")
        >>> kid.update(torch.rand(16, 3, 2, 2, generator=g), real=True)
        >>> kid.update(torch.rand(16, 3, 2, 2, generator=g), real=False)
        >>> kid_mean, kid_std = kid.compute()
        >>> kid_mean.shape, kid_std.shape
        (torch.Size([]), torch.Size([]))
    """

    higher_is_better = False
    is_differentiable = False
    full_state_update = False

    def __init__(
        self,
        feature: Union[int, Callable] = 2048,
        subsets: int = 100,
        subset_size: int = 1000,
        degree: int = 3,
        gamma: Optional[float] = None,
        coef: float = 1.0,
        reset_real_features: bool = True,
        params: Any = None,
        npz_path: Optional[str] = None,
        allow_random_weights: bool = False,
        seed: int = 0,
        **kwargs: Any,
    ) -> None:
        super().__init__(reset_real_features=reset_real_features, **kwargs)
        rank_zero_warn(
            "Metric `Kernel Inception Distance` will save all extracted features in buffer."
            " For large datasets this may lead to large memory footprint.",
            UserWarning,
        )
        self._set_network(_resolve_extractor(
            feature, _VALID_FEATURE_INTS, params, seed, npz_path, allow_random_weights,
            "KernelInceptionDistance", self.device,
        ))

        if not (isinstance(subsets, int) and subsets > 0):
            raise ValueError("Argument `subsets` expected to be integer larger than 0")
        self.subsets = subsets
        if not (isinstance(subset_size, int) and subset_size > 0):
            raise ValueError("Argument `subset_size` expected to be integer larger than 0")
        self.subset_size = subset_size
        if not (isinstance(degree, int) and degree > 0):
            raise ValueError("Argument `degree` expected to be integer larger than 0")
        self.degree = degree
        if gamma is not None and not (isinstance(gamma, float) and gamma > 0):
            raise ValueError("Argument `gamma` expected to be `None` or float larger than 0")
        self.gamma = gamma
        if not (isinstance(coef, float) and coef > 0):
            raise ValueError("Argument `coef` expected to be float larger than 0")
        self.coef = coef
        self.seed = seed

    def compute(self) -> Tuple[Tensor, Tensor]:
        real_features = dim_zero_cat(self.real_features)
        fake_features = dim_zero_cat(self.fake_features)

        n_samples_real = real_features.shape[0]
        if n_samples_real < self.subset_size:
            raise ValueError("Argument `subset_size` should be smaller than the number of samples")
        n_samples_fake = fake_features.shape[0]
        if n_samples_fake < self.subset_size:
            raise ValueError("Argument `subset_size` should be smaller than the number of samples")

        # the draws of the JAX package, in its order (a real and a fake permutation a subset),
        # sent to the device in one copy; the MMD in float64, cast one subset at a time
        rng = np.random.RandomState(self.seed)
        draws = np.stack([
            np.stack([rng.permutation(n_samples_real)[: self.subset_size],
                      rng.permutation(n_samples_fake)[: self.subset_size]])
            for _ in range(self.subsets)
        ])
        draws = torch.from_numpy(draws).to(real_features.device)
        kid_scores_ = []
        for real_idx, fake_idx in draws:
            f_real = real_features[real_idx].to(torch.float64)
            f_fake = fake_features[fake_idx].to(torch.float64)
            kid_scores_.append(poly_mmd(f_real, f_fake, self.degree, self.gamma, self.coef))
        kid_scores = torch.stack(kid_scores_)
        mean, std = kid_scores.mean(), kid_scores.std(correction=0)
        return mean.to(real_features.dtype), std.to(real_features.dtype)


class InceptionScore(_NetworkMetric):
    """IS: exp(E KL(p(y|x) ‖ p(y))) over splits (reference `image/inception.py:25-162`).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.image.generative import InceptionScore
        >>> g = torch.Generator().manual_seed(123)
        >>> iscore = InceptionScore(feature=lambda x: x.reshape(x.shape[0], -1)[:, :8], splits=2, device="cpu")
        >>> iscore.update(torch.rand(16, 3, 2, 2, generator=g))
        >>> is_mean, is_std = iscore.compute()
        >>> float(is_mean) > 0
        True
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        feature: Union[str, int, Callable] = "logits_unbiased",
        splits: int = 10,
        params: Any = None,
        npz_path: Optional[str] = None,
        allow_random_weights: bool = False,
        seed: int = 0,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        rank_zero_warn(
            "Metric `InceptionScore` will save all extracted features in buffer."
            " For large datasets this may lead to large memory footprint.",
            UserWarning,
        )
        self._set_network(_resolve_extractor(
            feature, ("logits_unbiased",) + _VALID_FEATURE_INTS, params, seed, npz_path,
            allow_random_weights, "InceptionScore", self.device,
        ))
        self.splits = splits
        self.seed = seed
        self.add_state("features", default=[], dist_reduce_fx=None)

    def update(self, imgs: Tensor) -> None:
        self.features.append(self.inception(imgs))

    def compute(self) -> Tuple[Tensor, Tensor]:
        features = dim_zero_cat(self.features)
        idx = np.random.RandomState(self.seed).permutation(features.shape[0])
        features = features[torch.from_numpy(idx).to(features.device)]

        prob = torch.softmax(features, dim=1)
        log_prob = torch.log_softmax(features, dim=1)

        # numpy's array_split chunk sizes, as ``jnp.array_split``
        prob_chunks = torch.tensor_split(prob, self.splits, dim=0)
        log_prob_chunks = torch.tensor_split(log_prob, self.splits, dim=0)

        kl_ = []
        for p, log_p in zip(prob_chunks, log_prob_chunks):
            mean_p = p.mean(dim=0, keepdim=True)
            kl = p * (log_p - torch.log(mean_p))
            kl_.append(torch.exp(kl.sum(dim=1).mean()))
        kl = torch.stack(kl_)
        return kl.mean(), kl.std(correction=1)


def _valid_img(img: Tensor) -> bool:
    """Valid LPIPS input: NCHW, 3 channels, values in [-1, 1] (reference `lpip.py:43-45`).

    The minimum and the maximum come to the host in one read."""
    if not (img.ndim == 4 and img.shape[1] == 3):
        return False
    low, high = torch.aminmax(img)
    return bool(torch.stack([low >= -1.0, high <= 1.0]).all())


class LearnedPerceptualImagePatchSimilarity(_NetworkMetric):
    """LPIPS averaged over image pairs (reference `image/lpip.py:48-145`).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.image.generative import LearnedPerceptualImagePatchSimilarity
        >>> lpips = LearnedPerceptualImagePatchSimilarity(net_type='alex', allow_random_weights=True, device="cpu")
        >>> g = torch.Generator().manual_seed(0)
        >>> img1 = torch.rand(4, 3, 64, 64, generator=g)
        >>> img2 = torch.rand(4, 3, 64, 64, generator=g)
        >>> float(lpips(img1, img2)) >= 0
        True
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    _network_attr = "net"

    def __init__(
        self,
        net_type: str = "alex",
        reduction: str = "mean",
        params: Any = None,
        npz_path: Optional[str] = None,
        allow_random_weights: bool = False,
        seed: int = 0,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if callable(net_type):
            self._set_network(net_type)
        else:
            # the backbone is checked BEFORE the weights gate: an invalid net_type gets the
            # ValueError naming the valid choices, not a converter hint with the bogus name
            if net_type not in _BACKBONES:
                raise ValueError(f"Argument `net_type` must be one of {tuple(_BACKBONES)}, but got {net_type}.")
            _gate_random_weights(
                params,
                npz_path,
                allow_random_weights,
                net="LPIPS network",
                hint=lpips_converter(net_type),
            )
            self._set_network(LPIPSExtractor(net_type=net_type, params=params, npz_path=npz_path, seed=seed,
                                             device=self.device))
        valid_reduction = ("mean", "sum")
        if reduction not in valid_reduction:
            raise ValueError(f"Argument `reduction` must be one of {valid_reduction}, but got {reduction}")
        self.reduction = reduction
        self.add_state("sum_scores", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, img1: Tensor, img2: Tensor) -> None:
        if not (_valid_img(img1) and _valid_img(img2)):
            raise ValueError(
                "Expected both input arguments to be normalized tensors with shape [N, 3, H, W]"
                " and all values in range [-1,1]."
            )
        loss = self.net(img1, img2)
        self.sum_scores = self.sum_scores + loss.sum()
        self.total = self.total + img1.shape[0]

    def compute(self) -> Tensor:
        if self.reduction == "mean":
            return self.sum_scores / self.total
        return self.sum_scores


__all__ = [
    "FrechetInceptionDistance",
    "KernelInceptionDistance",
    "InceptionScore",
    "LearnedPerceptualImagePatchSimilarity",
    "poly_kernel",
    "poly_mmd",
    "maximum_mean_discrepancy",
]
