"""Cohen's kappa, unweighted or with linear/quadratic weights.

JAX counterpart: `metrics_tpu/functional/classification/cohen_kappa.py`
(reference `functional/classification/cohen_kappa.py`). The expected matrix
is the outer product ``sum1 @ sum0`` of the marginals, run under
:func:`~metrics_tpu_torch.utils.compute.high_precision` as in the JAX
package: in TF32 a product of counts above 2048 would lose its integer
exactness.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.confusion_matrix import (
    _confusion_matrix_compute,
    _confusion_matrix_update,
)
from metrics_tpu_torch.utils.compute import high_precision


def _cohen_kappa_update(preds, target, num_classes: int, threshold: float = 0.5) -> Tensor:
    return _confusion_matrix_update(preds, target, num_classes, threshold)


@high_precision
def _cohen_kappa_compute(confmat: Tensor, weights: Optional[str] = None) -> Tensor:
    confmat = _confusion_matrix_compute(confmat).to(torch.float32)
    n_classes = confmat.shape[0]
    sum0 = confmat.sum(dim=0, keepdim=True)
    sum1 = confmat.sum(dim=1, keepdim=True)
    expected = sum1 @ sum0 / sum0.sum()

    if weights is None or weights == "none":
        w_mat = 1.0 - torch.eye(n_classes, dtype=confmat.dtype, device=confmat.device)
    elif weights in ("linear", "quadratic"):
        grid = torch.arange(n_classes, dtype=confmat.dtype, device=confmat.device).expand(n_classes, n_classes)
        diff = grid - grid.T
        w_mat = diff.abs() if weights == "linear" else diff**2
    else:
        raise ValueError(
            f"Received {weights} for argument ``weights`` but should be either None, 'linear' or 'quadratic'"
        )

    k = torch.sum(w_mat * confmat) / torch.sum(w_mat * expected)
    return 1 - k


def cohen_kappa(
    preds,
    target,
    num_classes: int,
    weights: Optional[str] = None,
    threshold: float = 0.5,
) -> Tensor:
    """Cohen's kappa: the agreement of two raters beyond chance.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import cohen_kappa
        >>> target = torch.tensor([1, 1, 0, 0])
        >>> preds = torch.tensor([0, 1, 0, 0])
        >>> cohen_kappa(preds, target, num_classes=2)
        tensor(0.5000)
    """
    confmat = _cohen_kappa_update(preds, target, num_classes, threshold)
    return _cohen_kappa_compute(confmat, weights)


__all__ = ["cohen_kappa"]
