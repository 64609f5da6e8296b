"""Canonical state-reduction specs.

JAX counterpart: `metrics_tpu/parallel/reductions.py` (``resolve_reduction``
`:33`, ``_SPEC_TO_FN``). A state declares how its replicas combine across
processes with a spec: ``"sum" | "mean" | "max" | "min" | "cat"``, ``None``
(stack the replicas) or a callable (``"custom"``), the reference's
``dist_reduce_fx``. The callable acts on the stack (or concatenation) of
every process's state.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

from metrics_tpu_torch.utils.data import dim_zero_cat, dim_zero_max, dim_zero_mean, dim_zero_min, dim_zero_sum

# spec values: "sum" | "mean" | "max" | "min" | "cat" | None | "custom"
ReductionSpec = Optional[str]

_SPEC_TO_FN = {
    "sum": dim_zero_sum,
    "mean": dim_zero_mean,
    "max": dim_zero_max,
    "min": dim_zero_min,
    "cat": dim_zero_cat,
}


def resolve_reduction(dist_reduce_fx: Union[str, Callable, None]) -> Tuple[ReductionSpec, Optional[Callable]]:
    """Normalise a user-provided reduction into ``(spec, fn)``.

    ``fn`` acts on the stack (or, for ``"cat"``, the list) of every process's
    state; ``spec`` selects the collective in
    :func:`metrics_tpu_torch.parallel.collectives.sync_array`.
    """
    if dist_reduce_fx is None:
        return None, None
    if isinstance(dist_reduce_fx, str):
        key = dist_reduce_fx.lower()
        if key not in _SPEC_TO_FN:
            raise ValueError(
                f"`dist_reduce_fx` must be one of {sorted(_SPEC_TO_FN)}, a callable, or None; got {dist_reduce_fx!r}"
            )
        return key, _SPEC_TO_FN[key]
    if callable(dist_reduce_fx):
        return "custom", dist_reduce_fx
    raise ValueError(f"`dist_reduce_fx` must be a string, callable, or None, got {type(dist_reduce_fx)}")


__all__ = ["ReductionSpec", "resolve_reduction"]
