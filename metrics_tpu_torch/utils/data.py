"""Tensor helpers shared across metrics.

JAX counterpart: `metrics_tpu/utils/data.py` (reference
`src/torchmetrics/utilities/data.py`: dim_zero_* `:36-62`, ``to_onehot``,
``select_topk``, ``to_categorical``, ``apply_to_collection`` `:160`,
``_bincount`` `:244-264`). Every function here is a plain function on tensors
and keeps the device of its input.
"""
from __future__ import annotations

from collections.abc import Mapping, Sequence
from typing import Any, Callable, Dict, List, Optional, Union

import torch
from torch import Tensor

from metrics_tpu_torch.ops.histogram import fused_bincount

TensorOrList = Union[Tensor, List[Tensor]]


def dim_zero_cat(x: TensorOrList) -> Tensor:
    """Concatenate a (possibly list-kind) state along dim 0."""
    if isinstance(x, Tensor):
        return x
    x = [torch.atleast_1d(v) for v in x]
    if not x:
        raise ValueError("No samples to concatenate")
    return torch.cat(x, dim=0)


def dim_zero_sum(x: Tensor) -> Tensor:
    return torch.sum(x, dim=0)


def dim_zero_mean(x: Tensor) -> Tensor:
    return torch.mean(x, dim=0)


def dim_zero_max(x: Tensor) -> Tensor:
    return torch.max(x, dim=0).values


def dim_zero_min(x: Tensor) -> Tensor:
    return torch.min(x, dim=0).values


def _flatten(x: Sequence) -> list:
    """One-level list flatten."""
    return [item for sublist in x for item in sublist]


def _flatten_dict(x: Dict) -> Dict:
    """Flatten dict-of-dicts one level; non-dict values pass through."""
    out: Dict = {}
    for key, value in x.items():
        if isinstance(value, dict):
            out.update(value)
        else:
            out[key] = value
    return out


def to_onehot(label_tensor: Tensor, num_classes: int) -> Tensor:
    """Integer labels ``(N, ...)`` -> int32 one-hot ``(N, C, ...)``.

    A label outside ``[0, num_classes)`` gives an all-zero column, as
    ``jax.nn.one_hot`` does (``F.one_hot`` would raise, and reads the data on
    the host to do so).
    """
    classes = torch.arange(num_classes, device=label_tensor.device)
    classes = classes.reshape((1, num_classes) + (1,) * (label_tensor.ndim - 1))
    return (label_tensor.unsqueeze(1) == classes).to(torch.int32)


def select_topk(prob_tensor: Tensor, topk: int = 1, dim: int = 1) -> Tensor:
    """Int32 mask of the top-k entries along ``dim`` (reference `data.py:109-137`)."""
    if topk == 1:
        idx = torch.argmax(prob_tensor, dim=dim, keepdim=True)
    else:
        idx = torch.topk(prob_tensor, topk, dim=dim).indices
    mask = torch.zeros_like(prob_tensor, dtype=torch.int32)
    return mask.scatter_(dim, idx, 1)


def to_categorical(x: Tensor, argmax_dim: int = 1) -> Tensor:
    """Probabilities -> integer labels via argmax (reference `data.py:140-157`)."""
    return torch.argmax(x, dim=argmax_dim)


def apply_to_collection(
    data: Any,
    dtype: Union[type, tuple],
    function: Callable,
    *args: Any,
    wrong_dtype: Optional[Union[type, tuple]] = None,
    **kwargs: Any,
) -> Any:
    """Recursively apply ``function`` to all ``dtype`` leaves of a collection.

    Parity: reference `utilities/data.py:160-207`.
    """
    if isinstance(data, dtype) and (wrong_dtype is None or not isinstance(data, wrong_dtype)):
        return function(data, *args, **kwargs)
    if isinstance(data, Mapping):
        return type(data)({k: apply_to_collection(v, dtype, function, *args, **kwargs) for k, v in data.items()})
    if isinstance(data, tuple) and hasattr(data, "_fields"):  # namedtuple
        return type(data)(*(apply_to_collection(d, dtype, function, *args, **kwargs) for d in data))
    if isinstance(data, Sequence) and not isinstance(data, str):
        return type(data)(apply_to_collection(d, dtype, function, *args, **kwargs) for d in data)
    return data


def _bincount(x: Tensor, minlength: int) -> Tensor:
    """Bincount of ``x`` over ``minlength`` bins; ids outside ``[0, minlength)`` are dropped.

    Routes to :func:`metrics_tpu_torch.ops.histogram.fused_bincount`: the
    hand-written CUDA kernel for a tensor on the card, its plain PyTorch
    version for a tensor on the CPU.
    """
    return fused_bincount(x, minlength)


def allclose(x: Tensor, y: Tensor, rtol: float = 1e-5, atol: float = 1e-8) -> bool:
    if x.shape != y.shape:
        return False
    return bool(torch.allclose(x, y, rtol=rtol, atol=atol))


__all__ = [
    "dim_zero_cat",
    "dim_zero_sum",
    "dim_zero_mean",
    "dim_zero_max",
    "dim_zero_min",
    "to_onehot",
    "select_topk",
    "to_categorical",
    "apply_to_collection",
    "allclose",
]
