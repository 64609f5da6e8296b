"""Buffered rows for the image metrics that keep every input.

JAX counterpart: `metrics_tpu/image/base.py:14`. ``update`` checks shapes and
appends the raw tensors; the family's canonical transform (a float32 cast for
the spectral metrics, ``target`` cast to the dtype of ``preds`` for SSIM) runs
once on the concatenation in ``compute``, and row by row through
:meth:`_canonicalize_list_states` where rows are observed one by one (sync,
``state_dict``, pickling), as the curve metrics do.
"""
from __future__ import annotations

from typing import Any, Tuple

from torch import Tensor

from metrics_tpu_torch.functional.image.spectral import _image_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.data import dim_zero_cat
from metrics_tpu_torch.utils.prints import rank_zero_warn


class _CatImageMetric(Metric):
    """Image metrics whose ``preds`` and ``target`` are ``cat`` list states of raw rows."""

    _input_check = staticmethod(_image_update)
    _warn_name: str = ""

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        rank_zero_warn(
            f"Metric `{self._warn_name or type(self).__name__}` will save all targets and"
            " predictions in buffer. For large datasets this may lead"
            " to large memory footprint."
        )
        self.add_state("preds", default=[], dist_reduce_fx="cat")
        self.add_state("target", default=[], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds, target = self._input_check(preds, target, format_tensors=False)
        self.preds.append(preds)
        self.target.append(target)

    def _canonicalize_list_states(self) -> None:
        if not isinstance(self.preds, list):
            return  # after a sync the "cat" reduction left one canonical tensor
        for i in range(len(self.preds)):
            # a row already canonical stays the same tensor (``Tensor.to`` returns it)
            self.preds[i], self.target[i] = self._input_check(self.preds[i], self.target[i])

    def _cat_states(self) -> Tuple[Tensor, Tensor]:
        if not isinstance(self.preds, list):
            preds, target = self.preds, self.target
        else:
            preds, target = dim_zero_cat(self.preds), dim_zero_cat(self.target)
        return self._input_check(preds, target)


__all__ = ["_CatImageMetric"]
