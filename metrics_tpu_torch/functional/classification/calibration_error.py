"""Calibration error (expected, maximum, root-mean-square) over uniform bins.

JAX counterpart: `metrics_tpu/functional/classification/calibration_error.py`
(``_bin_sums`` `:18`, ``_ce_compute`` `:67`, ``_ce_update`` `:88`);
reference `src/torchmetrics/functional/classification/calibration_error.py:20-185`.

Every norm is a function of three sums per bin: the samples, their
confidences and their correct predictions. The two counts come from one
``_bincount`` (the CUDA kernel on the card) over ``2 * n_bins`` ids, a
sample's bin plus ``n_bins`` where its prediction is right, so they are
exact int32. The confidence sums are a float ``index_add_``, which follows
``torch.use_deterministic_algorithms``; the kernel's float32 atomics would
not.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _classification_case
from metrics_tpu_torch.utils.data import _bincount
from metrics_tpu_torch.utils.enums import DataType


def _uniform_bin_boundaries(n_bins: int, device: torch.device) -> Tensor:
    """``n_bins + 1`` float32 boundaries from 0 to 1, as the JAX package's
    ``jnp.linspace(0, 1, n_bins + 1)`` computes them: ``i * float32(1 / n_bins)``, then 1."""
    step = float(torch.tensor(1.0, dtype=torch.float32) / n_bins)  # a float32 value, exact as a Python float
    inner = torch.arange(n_bins, dtype=torch.float32, device=device) * step
    return torch.cat([inner, torch.ones(1, device=device)])


def _bin_counts(
    confidences: Tensor, accuracies: Tensor, bin_boundaries: Tensor
) -> Tuple[Tensor, Tensor, Tensor]:
    """Per bin: the int32 sample count, the confidence sum, and the int32 count of right predictions."""
    n_bins = bin_boundaries.shape[0] - 1
    indices = torch.clamp(torch.searchsorted(bin_boundaries, confidences, right=False) - 1, 0, n_bins - 1)
    pair = _bincount(indices + n_bins * (accuracies != 0).to(indices.dtype), minlength=2 * n_bins)
    count_bin = pair[:n_bins] + pair[n_bins:]
    conf_bin = torch.zeros(n_bins, dtype=confidences.dtype, device=confidences.device)
    conf_bin.index_add_(0, indices, confidences)
    return count_bin, conf_bin, pair[n_bins:]


def _bin_sums(
    confidences: Tensor, accuracies: Tensor, bin_boundaries: Tensor
) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-bin (count, confidence sum, accuracy sum): the statistics every norm needs.
    The count is int32; both sums are in the confidences' dtype, as in the JAX package."""
    count_bin, conf_bin, acc_count = _bin_counts(confidences, accuracies, bin_boundaries)
    return count_bin, conf_bin, acc_count.to(confidences.dtype)


def _bin_means(count_bin: Tensor, conf_sum: Tensor, acc_sum: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """(accuracy, confidence, proportion) per bin from the sums; an empty bin gives 0."""
    counts = count_bin.to(conf_sum.dtype)
    empty = count_bin == 0
    safe = torch.where(empty, 1.0, counts)
    conf_bin = torch.where(empty, 0.0, conf_sum / safe)
    acc_bin = torch.where(empty, 0.0, acc_sum / safe)
    prop_bin = counts / counts.sum()
    return acc_bin, conf_bin, prop_bin


def _ce_from_bin_sums(count_bin: Tensor, conf_bin: Tensor, acc_bin: Tensor, norm: str = "l1") -> Tensor:
    """The calibration error of any norm from the per-bin sums."""
    acc, conf, prop = _bin_means(count_bin, conf_bin, acc_bin)
    if norm == "l1":
        return torch.sum(torch.abs(acc - conf) * prop)
    if norm == "max":
        return torch.max(torch.abs(acc - conf))
    ce = torch.sum((acc - conf) ** 2 * prop)
    return torch.where(ce > 0, torch.sqrt(torch.where(ce > 0, ce, 1.0)), 0.0)


def _binning_bucketize(
    confidences: Tensor, accuracies: Tensor, bin_boundaries: Tensor
) -> Tuple[Tensor, Tensor, Tensor]:
    return _bin_means(*_bin_sums(confidences, accuracies, bin_boundaries))


def _ce_compute(
    confidences: Tensor,
    accuracies: Tensor,
    bin_boundaries: Tensor,
    norm: str = "l1",
    debias: bool = False,
) -> Tensor:
    if norm not in ("l1", "l2", "max"):
        raise ValueError(f"Norm {norm} is not supported. Please select from l1, l2, or max. ")

    if norm == "l2" and debias:
        acc_bin, conf_bin, prop_bin = _binning_bucketize(confidences, accuracies, bin_boundaries)
        ce = torch.sum((acc_bin - conf_bin) ** 2 * prop_bin)
        debias_bins = (acc_bin * (acc_bin - 1) * prop_bin) / (prop_bin * accuracies.shape[0] - 1)
        ce = ce + torch.sum(torch.nan_to_num(debias_bins))
        return torch.where(ce > 0, torch.sqrt(torch.where(ce > 0, ce, 1.0)), 0.0)
    return _ce_from_bin_sums(*_bin_sums(confidences, accuracies, bin_boundaries), norm=norm)


def _ce_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """Top-1 confidences and 0/1 accuracies, both float32.

    The case is resolved with the validation of ``_input_format_classification``
    and nothing is formatted. Logits are told from probabilities on the card
    (``torch.where``), with no host read.
    """
    mode = _classification_case(preds, target)

    if mode == DataType.BINARY:
        is_prob = ((preds >= 0) & (preds <= 1)).all()
        preds = torch.where(is_prob, preds, torch.sigmoid(preds))
        confidences, accuracies = preds, target
    elif mode == DataType.MULTICLASS:
        if preds.ndim < 2:
            # integer-label preds have no class dim to take the confidence over
            raise ValueError(f"axis 1 is out of bounds for array of dimension {preds.ndim}")
        is_prob = ((preds >= 0) & (preds <= 1)).all()
        preds = torch.where(is_prob, preds, torch.softmax(preds, dim=1))
        confidences, predictions = preds.max(dim=1)
        accuracies = predictions == target
    elif mode == DataType.MULTIDIM_MULTICLASS:
        flat = torch.movedim(preds, 1, -1).reshape(-1, preds.shape[1])
        confidences, predictions = flat.max(dim=1)
        accuracies = predictions == target.reshape(-1)
    else:
        raise ValueError(
            f"Calibration error is not well-defined for data with size {preds.shape} and targets {target.shape}."
        )
    return confidences.to(torch.float32), accuracies.to(torch.float32)


def calibration_error(preds: Tensor, target: Tensor, n_bins: int = 15, norm: str = "l1") -> Tensor:
    """Top-1 calibration error.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import calibration_error
        >>> preds = torch.tensor([0.25, 0.25, 0.55, 0.75, 0.75])
        >>> target = torch.tensor([0, 0, 1, 1, 1])
        >>> calibration_error(preds, target, n_bins=2, norm='l1')
        tensor(0.2900)
    """
    if norm not in ("l1", "l2", "max"):
        raise ValueError(f"Norm {norm} is not supported. Please select from l1, l2, or max. ")
    if not isinstance(n_bins, int) or n_bins <= 0:
        raise ValueError(f"Expected argument `n_bins` to be a int larger than 0 but got {n_bins}")

    confidences, accuracies = _ce_update(preds, target)
    bin_boundaries = _uniform_bin_boundaries(n_bins, confidences.device)
    return _ce_compute(confidences, accuracies, bin_boundaries, norm=norm)


__all__ = ["calibration_error"]
