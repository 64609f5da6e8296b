"""Stacking state trees on a leading axis (JAX counterpart: `metrics_tpu/arena.py:168-195`).

The one stacking code path: the clone fan-out (:mod:`metrics_tpu_torch.wrappers._fanout`)
stacks its clones' states through here before ``torch.func.vmap`` runs their
update as one program, and unstacks the result. ``MetricArena`` (the tenant
arena over these stacks) is not ported yet.
"""
from __future__ import annotations

from typing import Any, List, Sequence

import torch
from torch.utils import _pytree as pytree


def stack_states(states: Sequence[Any]) -> Any:
    """N state trees of one structure as one tree whose every leaf has a new leading axis.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import stack_states
        >>> stack_states([{"s": torch.ones(2)}, {"s": torch.zeros(2)}])["s"].shape
        torch.Size([2, 2])
    """
    first = states[0]
    if _flat(first):  # the common case, a metric's {state: tensor}: no tree walk
        return {k: torch.stack([s[k] for s in states]) for k in first}
    return pytree.tree_map(lambda *xs: torch.stack(xs), *states)


def unstack_states(stacked: Any, n: int) -> List[Any]:
    """The inverse of :func:`stack_states`: ``n`` trees, each leaf a view of row ``i`` (no copies).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import stack_states, unstack_states
        >>> rows = unstack_states(stack_states([{"s": torch.ones(2)}] * 3), 3)
        >>> len(rows), tuple(rows[0]["s"].shape)
        (3, (2,))
    """
    if _flat(stacked):
        rows = {k: v.unbind(0) for k, v in stacked.items()}
        return [{k: r[i] for k, r in rows.items()} for i in range(n)]
    leaves, spec = pytree.tree_flatten(stacked)
    rows = [leaf.unbind(0) for leaf in leaves]
    return [pytree.tree_unflatten([r[i] for r in rows], spec) for i in range(n)]


def _flat(tree: Any) -> bool:
    return type(tree) is dict and all(isinstance(v, torch.Tensor) for v in tree.values())


__all__ = ["stack_states", "unstack_states"]
