"""MultioutputWrapper: one clone of a metric for each output column.

JAX counterpart: `metrics_tpu/wrappers/multioutput.py:39` (``_get_nan_indices``
`:28`, ``_get_args_kwargs_by_output`` `:79`); reference
`wrappers/multioutput.py:24-145`.

The one-program column fan-out (`multioutput.py:138` ``_try_fused_columns``,
:mod:`metrics_tpu_torch.wrappers._fanout`): after the first, eager and
validated call of an input signature, in a validation mode other than
``full`` and with ``squeeze_outputs``, every column's clone updates in one
program, ``torch.func.vmap`` over (columns, clone states). With
``remove_nans`` and a base whose states all merge by sum, a row with a NaN is
weighted 0 instead of gathered out (per-row deltas of the NaN-scrubbed rows
contracted against the 0/1 keep mask), so no mask is read on the host; the
first fused steps are certified against the eager masked gather on state
copies, and a disagreement keeps the eager result and turns the path off.
"""
from __future__ import annotations

from copy import deepcopy
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
from torch import Tensor, nn
from torch.utils import _pytree as pytree

from metrics_tpu_torch.arena import stack_states, unstack_states
from metrics_tpu_torch.metric import Metric, _forward_signature
from metrics_tpu_torch.utils.data import apply_to_collection
from metrics_tpu_torch.utils.prints import rank_zero_warn
from metrics_tpu_torch.wrappers._fanout import (
    fanout_gate,
    run_fanout,
    states_allclose,
    sum_linear_base,
    weighted_rows_apply,
)


def _get_nan_indices(*tensors: Tensor) -> Tensor:
    """Rows holding a NaN in any of ``tensors``."""
    if len(tensors) == 0:
        raise ValueError("Must pass at least one tensor as argument")
    nan_idxs = torch.zeros(len(tensors[0]), dtype=torch.bool, device=tensors[0].device)
    for tensor in tensors:
        nan_idxs = nan_idxs | torch.isnan(tensor.reshape(len(tensor), -1)).any(dim=1)
    return nan_idxs


class MultioutputWrapper(Metric):
    """Evaluate one metric per output column and return the list of values.

    With ``remove_nans`` a row whose column slice holds a NaN is left out of
    that column's update. Which rows those are is data, so an update reads the
    masks of every column on the host, all in one read.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MultioutputWrapper, R2Score
        >>> preds = torch.tensor([[1.0, 10.0], [2.0, 20.0], [3.0, 30.0]])
        >>> target = torch.tensor([[1.0, 12.0], [2.0, 21.0], [3.5, 29.0]])
        >>> r2 = MultioutputWrapper(R2Score(device="cpu"), num_outputs=2)
        >>> [round(float(v), 4) for v in r2(preds, target)]
        [0.9211, 0.9585]
    """

    is_differentiable = False
    full_state_update: Optional[bool] = True

    def __init__(
        self,
        base_metric: Metric,
        num_outputs: int,
        output_dim: int = -1,
        remove_nans: bool = True,
        squeeze_outputs: bool = True,
        **kwargs: Any,
    ) -> None:
        kwargs.setdefault("device", base_metric.device)
        super().__init__(**kwargs)
        self.metrics = nn.ModuleList([deepcopy(base_metric) for _ in range(num_outputs)])
        self.output_dim = output_dim
        self.remove_nans = remove_nans
        self.squeeze_outputs = squeeze_outputs

    def _get_args_kwargs_by_output(self, *args: Tensor, **kwargs: Tensor) -> List[Tuple[list, dict]]:
        per_column: List[Tuple[list, dict]] = []
        masks: List[Optional[Tensor]] = []
        for i in range(len(self.metrics)):
            selected_args = apply_to_collection(args, Tensor, torch.narrow, self.output_dim, i, 1)
            selected_kwargs = apply_to_collection(kwargs, Tensor, torch.narrow, self.output_dim, i, 1)
            tensors = list(selected_args) + list(selected_kwargs.values())
            masks.append(_get_nan_indices(*tensors) if self.remove_nans and tensors else None)
            per_column.append((list(selected_args), dict(selected_kwargs)))

        # which rows to drop is data: one host read for every column's mask, and
        # no gather at all for a column without a NaN (the common case)
        host_masks = None
        if any(m is not None for m in masks):
            host_masks = torch.stack([m for m in masks if m is not None]).cpu().numpy()

        args_kwargs_by_output = []
        mask_pos = 0
        for (selected_args, selected_kwargs), mask in zip(per_column, masks):
            if mask is not None:
                host_mask = host_masks[mask_pos]
                mask_pos += 1
                if host_mask.any():
                    keep = torch.from_numpy(np.flatnonzero(~host_mask))
                    selected_args = [arg[keep.to(arg.device)] for arg in selected_args]
                    selected_kwargs = {k: v[keep.to(v.device)] for k, v in selected_kwargs.items()}
            if self.squeeze_outputs:
                selected_args = [arg.squeeze(self.output_dim) for arg in selected_args]
                selected_kwargs = {k: v.squeeze(self.output_dim) for k, v in selected_kwargs.items()}
            args_kwargs_by_output.append((selected_args, selected_kwargs))
        return args_kwargs_by_output

    # the one-program column fan-out: built lazily, dropped on pickle and copy
    _mo_program = None
    _mo_versions = None
    _mo_ok = True
    _record_mo_signature_after = None
    # the remove_nans weighted-row path: certified on its first fused steps and on
    # the first step of every new signature
    _MO_CERT_STEPS = 3
    _mo_cert_done = 0
    _mo_cert_sigs = None

    def __getstate__(self) -> dict:
        state = super().__getstate__()
        state.pop("_mo_program", None)
        return state

    def _try_fused_columns(self, args: tuple, kwargs: dict) -> bool:
        """Every column clone's (slice, update) as ONE program; True when it ran."""
        clones = list(self.metrics)
        if not self.squeeze_outputs or not fanout_gate(self, clones, args, kwargs, "_mo_ok"):
            return False
        if self.remove_nans and not sum_linear_base(clones[0]):
            return False
        if self._fused_seen_signatures is None:
            object.__setattr__(self, "_fused_seen_signatures", {})
        signature = ("__multioutput__", _forward_signature(args, kwargs))
        if signature not in self._fused_seen_signatures:
            object.__setattr__(self, "_record_mo_signature_after", signature)
            return False
        axis, remove_nans, clone0 = self.output_dim, self.remove_nans, clones[0]

        def build(upd):
            init_fn = clone0.as_functions()[0] if remove_nans else None

            def program(states, *a, **k):
                # the output axis first, then one vmap over (column, clone state):
                # the vmapped axis's removal IS the squeeze
                cols = pytree.tree_map(lambda x: x.movedim(axis, 0), (a, k))
                if remove_nans:
                    init_state = init_fn()

                    def one(state, col):
                        leaves = pytree.tree_leaves(col)
                        n = leaves[0].shape[0]
                        mask = torch.zeros(n, dtype=torch.bool, device=leaves[0].device)
                        for t in leaves:
                            if t.is_floating_point():
                                mask = mask | torch.isnan(t.reshape(n, -1)).any(dim=1)
                        # NaNs scrubbed, so the zero-weighted rows stay finite
                        ca, ck = pytree.tree_map(
                            lambda t: torch.where(torch.isnan(t), torch.ones((), dtype=t.dtype, device=t.device), t)
                            if t.is_floating_point() else t,
                            col,
                        )
                        # the 0/1 keep mask as integer weights: counts contract exactly
                        return weighted_rows_apply(state, upd, init_state, (~mask).to(torch.int32), ca, ck)

                else:

                    def one(state, col):
                        ca, ck = col
                        return upd(state, *ca, **ck)

                return unstack_states(torch.func.vmap(one)(stack_states(states), cols), len(states))

            return program

        certify = remove_nans and (self._mo_cert_done < self._MO_CERT_STEPS or signature not in (self._mo_cert_sigs or ()))
        oracle = deepcopy(clones) if certify else None
        ok = run_fanout(self, clones, build, args, kwargs, label="MultioutputWrapper", program_attr="_mo_program",
                        versions_attr="_mo_versions", ok_attr="_mo_ok")
        if ok and certify:
            for om, (sel_args, sel_kwargs) in zip(oracle, self._get_args_kwargs_by_output(*args, **kwargs)):
                om.update(*sel_args, **sel_kwargs)
            if states_allclose([m.metric_state for m in clones], [m.metric_state for m in oracle]):
                object.__setattr__(self, "_mo_cert_done", self._mo_cert_done + 1)
                if self._mo_cert_sigs is None:
                    object.__setattr__(self, "_mo_cert_sigs", set())
                self._mo_cert_sigs.add(signature)
            else:
                rank_zero_warn(
                    f"Weighted-row NaN masking disagreed with the eager path for "
                    f"`MultioutputWrapper({type(clones[0]).__name__})` (update is not row-additive); keeping the "
                    "eager result and falling back permanently for this instance."
                )
                for m, om in zip(clones, oracle):
                    for name in m._defaults:
                        setattr(m, name, getattr(om, name))
                object.__setattr__(self, "_mo_ok", False)
                object.__setattr__(self, "_mo_program", None)
        return ok

    def update(self, *args: Any, **kwargs: Any) -> None:
        object.__setattr__(self, "_record_mo_signature_after", None)
        if self._try_fused_columns(args, kwargs):
            return
        for metric, (selected_args, selected_kwargs) in zip(self.metrics, self._get_args_kwargs_by_output(*args, **kwargs)):
            metric.update(*selected_args, **selected_kwargs)
        sig = self._record_mo_signature_after
        if sig is not None:
            object.__setattr__(self, "_record_mo_signature_after", None)
            self._record_fused_signature(sig)

    def compute(self) -> List[Tensor]:
        return [m.compute() for m in self.metrics]

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        results = [
            metric(*selected_args, **selected_kwargs)
            for metric, (selected_args, selected_kwargs) in zip(self.metrics, self._get_args_kwargs_by_output(*args, **kwargs))
        ]
        if results[0] is None:
            return None
        return results

    def reset(self) -> None:
        for metric in self.metrics:
            metric.reset()
        super().reset()

    def as_functions(self) -> tuple:
        """The pure export over ``{output_i: clone_state}``, for ``remove_nans=False``:
        removing the NaN rows gives a shape that depends on the data."""
        if self.remove_nans:
            raise NotImplementedError(
                "MultioutputWrapper(remove_nans=True) filters rows by a data-dependent NaN mask and cannot be "
                "exported; construct with remove_nans=False for the pure export."
            )
        subs = [m.as_functions() for m in self.metrics]

        def init():
            return {f"output_{i}": fns[0]() for i, fns in enumerate(subs)}

        def update_fn(state, *args, **kwargs):
            columns = self._get_args_kwargs_by_output(*args, **kwargs)
            return {
                f"output_{i}": subs[i][1](state[f"output_{i}"], *col_args, **col_kwargs)
                for i, (col_args, col_kwargs) in enumerate(columns)
            }

        def compute_fn(state, axis_name=None):
            return [fns[2](state[f"output_{i}"], axis_name=axis_name) for i, fns in enumerate(subs)]

        return init, update_fn, compute_fn


__all__ = ["MultioutputWrapper"]
