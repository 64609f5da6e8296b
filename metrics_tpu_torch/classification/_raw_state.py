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

The host fast lane (JAX ``_build_update_lane`` `:43`): after the first
validated update of a signature, a later one of the same shapes, dtypes and
device is two list appends and one guard.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

from torch import Tensor

from metrics_tpu_torch.ops import telemetry as _telemetry
from metrics_tpu_torch.utils.data import dim_zero_cat


class _RawPairStateMixin:
    """Deferred canonicalisation for metrics that buffer raw ``(preds, target)`` rows.

    Subclasses define ``_format_row(preds, target) -> (preds, target)``, the
    idempotent canonical transform of one row.
    """

    _has_update_lane_hook = True

    def _format_row(self, preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
        raise NotImplementedError

    def _build_update_lane(self, args: tuple, kwargs: dict) -> Optional[Callable]:
        """The steady-state update of the signature just validated: its shape
        checks are a function of the signature, and the attributes they infer
        are set. Bound only where the full path buffered the inputs as they
        came (the same tensors), so the lane's rows are the full path's."""
        if kwargs or len(args) != 2 or not all(isinstance(v, Tensor) for v in args):
            return None
        p0, t0 = args
        if not (isinstance(self.preds, list) and self.preds and self.preds[-1] is p0 and self.target[-1] is t0):
            return None
        shapes, device, guard = (p0.shape, p0.dtype, t0.shape, t0.dtype), p0.device, self._lane_guard()

        def lane(largs: tuple, lkwargs: dict) -> bool:
            if lkwargs or len(largs) != 2:
                return False
            p, t = largs
            if not (isinstance(p, Tensor) and isinstance(t, Tensor) and (p.shape, p.dtype, t.shape, t.dtype) == shapes
                    and p.device == device and t.device == device):
                return False
            if not guard() or not isinstance(self.preds, list):
                return False
            self._update_count += 1
            self._computed = None
            self.preds.append(p)
            self.target.append(t)
            return True

        return lane

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
        with _telemetry.trace_range("state-cat"):
            if len({tuple(p.shape[1:]) for p in self.preds}) > 1 or len({tuple(t.shape[1:]) for t in self.target}) > 1:
                self._canonicalize_list_states()
            return dim_zero_cat(self.preds), dim_zero_cat(self.target)


__all__ = ["_RawPairStateMixin"]
