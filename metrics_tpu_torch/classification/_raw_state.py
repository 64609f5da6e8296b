"""Raw-row buffering shared by the exact-curve metrics.

JAX counterpart: `metrics_tpu/classification/_raw_state.py`. PrecisionRecallCurve,
ROC, AUROC and AveragePrecision keep every score in list ("cat") states.
``update`` checks its inputs and appends the raw tensors; the layout
transform runs when the rows are observed:

- ``compute``: one concatenation per state, then one transform of the whole
  (the transform commutes with concatenation);
- sync, ``state_dict`` and pickling: row by row, through
  :meth:`Metric._canonicalize_list_states`, before anything observes a row.
  Rows of one state must share their rank to be concatenated and gathered.

Rows whose trailing shapes differ (a multi-dim extra dim that changes between
batches) cannot be concatenated raw: they are canonicalised row by row first.

The JAX package's host fast lane (``_build_update_lane``) belongs to its
dispatch engine and is not ported.
"""
from __future__ import annotations

from typing import Tuple

from torch import Tensor

from metrics_tpu_torch.utils.data import dim_zero_cat


class _RawPairStateMixin:
    """Deferred canonicalisation for metrics that buffer raw ``(preds, target)`` rows.

    Subclasses define ``_format_row(preds, target) -> (preds, target)``, the
    idempotent canonical transform of one row.
    """

    def _format_row(self, preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
        raise NotImplementedError

    def _canonicalize_list_states(self) -> None:
        if not isinstance(self.preds, list):
            # after a sync the "cat" reduction left one canonical tensor: nothing to do
            return
        for i, (preds, target) in enumerate(zip(self.preds, self.target)):
            p, t = self._format_row(preds, target)
            # a row already canonical stays the same tensor: the transforms only reshape, so an
            # unchanged shape is an unchanged row, and snapshots of the list keep comparing equal
            self.preds[i] = preds if p.shape == preds.shape else p
            self.target[i] = target if t.shape == target.shape else t

    def _cat_raw(self) -> Tuple[Tensor, Tensor]:
        """The buffered rows concatenated, canonicalised row by row first only where their shapes force it."""
        if not isinstance(self.preds, list):
            return self.preds, self.target
        if len({tuple(p.shape[1:]) for p in self.preds}) > 1 or len({tuple(t.shape[1:]) for t in self.target}) > 1:
            self._canonicalize_list_states()
        return dim_zero_cat(self.preds), dim_zero_cat(self.target)


__all__ = ["_RawPairStateMixin"]
