"""MinMaxMetric: the running minimum and maximum of a wrapped metric's value.

JAX counterpart: `metrics_tpu/wrappers/minmax.py:16` (``forward`` `:67`,
``_try_fused_forward`` `:79`, ``compute`` `:179`); reference
`wrappers/minmax.py:23-102`.

The fused forward: after the first, eager and validated ``forward`` of an
input signature, in a validation mode other than ``full``, with no
``dist_sync_on_step`` and no live world of several processes, a ``forward``
is ONE cached step (``engine.acquire``): ``(min, max, batch) -> (child batch
state, min, max, {raw, max, min})`` over the child's pure functions, reading
no device value on the host. It leaves what the eager two-update forward
leaves: the child holding only this batch.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import Tensor

from metrics_tpu_torch.metric import Metric, _forward_signature
from metrics_tpu_torch.ops import engine as _engine
from metrics_tpu_torch.utils.prints import rank_zero_warn


class MinMaxMetric(Metric):
    """Returns ``{raw, max, min}`` of the base metric's value over the ``compute()`` calls.

    Each ``compute()`` moves the extrema to the value it computes, and ``forward``
    computes the batch value, so it moves them too. The extrema are buffers, not
    states: ``reset`` keeps them, as in JAX and the reference. As there, the
    wrapper has no states of its own, so the forward's reset empties the wrapped
    metric and restores nothing: after a ``forward`` it holds only that batch.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Accuracy, MinMaxMetric
        >>> metric = MinMaxMetric(Accuracy(device="cpu"))
        >>> _ = metric(torch.tensor([1, 1, 0, 0]), torch.tensor([1, 0, 0, 0]))
        >>> _ = metric(torch.tensor([1, 0, 0, 0]), torch.tensor([1, 0, 0, 0]))
        >>> {k: round(float(v), 4) for k, v in metric.compute().items()}
        {'raw': 1.0, 'max': 1.0, 'min': 0.75}
    """

    full_state_update: Optional[bool] = True

    def __init__(self, base_metric: Metric, **kwargs: Any) -> None:
        if not isinstance(base_metric, Metric):
            raise ValueError(
                f"Expected base metric to be an instance of `metrics_tpu_torch.Metric` but received {base_metric}"
            )
        kwargs.setdefault("device", base_metric.device)
        super().__init__(**kwargs)
        self._base_metric = base_metric
        self.register_buffer("min_val", torch.tensor(float("inf"), device=self.device), persistent=False)
        self.register_buffer("max_val", torch.tensor(float("-inf"), device=self.device), persistent=False)

    def update(self, *args: Any, **kwargs: Any) -> None:
        self._base_metric.update(*args, **kwargs)

    # the fused forward: built lazily, dropped on pickle and copy
    _mm_program = None
    _mm_versions = None
    _mm_ok = True
    _record_mm_signature_after = None

    def __getstate__(self) -> Dict[str, Any]:
        state = super().__getstate__()
        state.pop("_mm_program", None)
        return state

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        object.__setattr__(self, "_record_mm_signature_after", None)
        if self._try_fused_forward(args, kwargs):
            return self._forward_cache
        out = super().forward(*args, **kwargs)
        sig = self._record_mm_signature_after
        if sig is not None:
            object.__setattr__(self, "_record_mm_signature_after", None)
            self._record_fused_signature(sig)
        return out

    def _try_fused_forward(self, args: tuple, kwargs: dict) -> bool:
        """One cached step for the whole ``forward``; True when it ran."""
        from torch.utils import _pytree as pytree

        from metrics_tpu_torch.parallel.sync import distributed_available
        from metrics_tpu_torch.utils.checks import _get_validation_mode, _is_concrete

        child = self._base_metric
        leaves = pytree.tree_leaves((args, kwargs))
        if not (
            self._mm_ok
            and not self._is_synced
            # the eager forward syncs the batch state across processes before it
            # reads the value; the step is local to the process
            and not self.dist_sync_on_step
            and not distributed_available()
            and _get_validation_mode() != "full"
            and child._fusable_states()
            and all(isinstance(leaf, Tensor) for leaf in leaves)
            and _is_concrete(*leaves)
        ):
            return False
        if self._fused_seen_signatures is None:
            object.__setattr__(self, "_fused_seen_signatures", {})
        signature = ("__minmax__", _forward_signature(args, kwargs))
        if signature not in self._fused_seen_signatures:
            object.__setattr__(self, "_record_mm_signature_after", signature)
            return False
        versions = (self._fused_version, child._fused_version)
        try:
            if self._mm_program is None or self._mm_versions != versions:
                fns = child.as_functions()
                object.__setattr__(self, "_mm_program", _engine.acquire(self, "minmax-forward", lambda: _minmax_step(fns)))
                object.__setattr__(self, "_mm_versions", versions)
            new_state, new_mn, new_mx, out = self._mm_program.run(self.min_val, (self.max_val,) + args, kwargs)
        except Exception as exc:  # noqa: BLE001 - nothing consumed: the eager forward runs instead
            rank_zero_warn(
                f"Fused MinMaxMetric forward raised {type(exc).__name__}: {exc}. "
                "Falling back to the eager path permanently for this instance."
            )
            object.__setattr__(self, "_mm_ok", False)
            object.__setattr__(self, "_mm_program", None)
            return False
        for name, value in new_state.items():
            setattr(child, name, value)
        child._update_count = 1  # the eager forward's reset and update leave one
        child._computed = None
        self._set_extrema(new_mn, new_mx)
        self._update_count += 1
        self._computed = None
        self._forward_cache = out
        return True

    def _set_extrema(self, mn: Tensor, mx: Tensor) -> None:
        # value buffers, not hyperparameters: written past __setattr__'s version bump,
        # which would rebuild the fused forward at every step
        self._buffers["min_val"] = mn
        self._buffers["max_val"] = mx

    def compute(self) -> Dict[str, Tensor]:
        val = self._base_metric.compute()
        if not self._is_suitable_val(val):
            raise RuntimeError(f"Returned value from base metric should be a float or scalar tensor, but got {val}.")
        val32 = torch.as_tensor(val, dtype=torch.float32, device=self.device)
        self._set_extrema(torch.where(self.min_val < val32, self.min_val, val32),
                          torch.where(self.max_val > val32, self.max_val, val32))
        return {"raw": torch.as_tensor(val), "max": self.max_val, "min": self.min_val}

    def reset(self) -> None:
        super().reset()
        self._base_metric.reset()

    def as_functions(self) -> tuple:
        """Not exportable: ``compute`` moves the running extrema, which a pure
        ``(init, update, compute)`` cannot express."""
        raise NotImplementedError(
            "MinMaxMetric tracks extrema ACROSS compute() calls (stateful compute); export the wrapped "
            "metric's as_functions() and track min/max of the computed values in your evaluation loop instead."
        )

    @staticmethod
    def _is_suitable_val(val: Any) -> bool:
        if isinstance(val, (int, float)):
            return True
        if isinstance(val, Tensor):
            return val.numel() == 1
        return False


def _minmax_step(fns: tuple) -> Any:
    """The fused forward's step over the child's pure functions: one fresh-state
    update (the eager forward's reset leaves the child only the batch), its value,
    the extrema moved to it."""
    init_c, upd_c, cmp_c = fns

    def step(mn: Tensor, mx: Tensor, *a: Any, **k: Any) -> tuple:
        batch_state = upd_c(init_c(), *a, **k)
        batch_val = cmp_c(batch_state)
        val32 = torch.as_tensor(batch_val, dtype=torch.float32, device=mn.device).reshape(())
        new_mx = torch.where(mx > val32, mx, val32)
        new_mn = torch.where(mn < val32, mn, val32)
        return batch_state, new_mn, new_mx, {"raw": torch.as_tensor(batch_val), "max": new_mx, "min": new_mn}

    return step


__all__ = ["MinMaxMetric"]
