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

import numpy as np

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


def dim_zero_cat_ravel(x: TensorOrList) -> Tensor:
    """Flatten each buffered row, then concatenate (JAX counterpart `metrics_tpu/utils/data.py:41`).

    Buffered raw rows may have any rank; a state that a sync already
    reduced to one tensor is flattened and returned.
    """
    if isinstance(x, Tensor):
        return x.reshape(-1)
    if not x:
        raise ValueError("No samples to concatenate")
    return torch.cat([v.reshape(-1) for v in x])


def _keep_if_same(row: Tensor, canonical: Tensor) -> Tensor:
    """``row`` itself when ``canonical`` has its shape and dtype, else ``canonical``.

    A buffered row already in canonical form stays the same tensor (a
    reshape or a cast to its own dtype makes another), so that snapshots of a
    list state taken around a sync keep comparing equal.
    """
    return row if canonical.shape == row.shape and canonical.dtype == row.dtype else canonical


def dim_zero_sum(x: Tensor) -> Tensor:
    """Sum along dim 0, keeping the dtype as ``jnp.sum`` does: int32 and int64
    stay as they are (``torch.sum`` would widen int32 to int64), bool and the
    narrower integers sum to int32."""
    if x.dtype in (torch.int32, torch.int64) or x.is_floating_point() or x.is_complex():
        return torch.sum(x, dim=0, dtype=x.dtype)
    return torch.sum(x, dim=0, dtype=torch.int32)


def dim_zero_mean(x: Tensor) -> Tensor:
    """Mean along dim 0; bool and integer inputs give float32, as ``jnp.mean`` does."""
    if not (x.is_floating_point() or x.is_complex()):
        x = x.to(torch.float32)
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


# --------------------------------------------------------------- string states
# JAX counterpart `metrics_tpu/utils/data.py:195-216`. Text metrics that keep
# their sentences pack them into 1-D uint8 arrays, each string followed by the
# byte 0xFF (record separator) and each group of strings by 0xFE (group
# separator): neither byte occurs in UTF-8, so they never collide with text.
# Packed arrays are closed under concatenation, cat(pack(a), pack(b)) ==
# pack(a + b), which is the contract of a ``cat`` state: the module keeps them
# as uint8 tensors on its device, and the sync gathers them as any other.
_REC_SEP = 0xFF
_GRP_SEP = 0xFE


def _as_bytes(arr: Union[Tensor, np.ndarray]) -> bytes:
    if isinstance(arr, Tensor):
        arr = arr.detach().cpu().numpy()  # one copy to the host for a tensor on the card
    return np.asarray(arr, dtype=np.uint8).tobytes()


def pack_strings(strings: Sequence[str]) -> np.ndarray:
    """The strings as one uint8 array on the host (writable, so ``torch.from_numpy`` takes it as is)."""
    data = bytearray()
    for s in strings:
        data += s.encode("utf-8") + bytes([_REC_SEP])
    return np.frombuffer(data, dtype=np.uint8)


def unpack_strings(arr: Union[Tensor, np.ndarray]) -> List[str]:
    return [chunk.decode("utf-8") for chunk in _as_bytes(arr).split(bytes([_REC_SEP]))[:-1]]


def pack_string_groups(groups: Sequence[Sequence[str]]) -> np.ndarray:
    data = bytearray()
    for group in groups:
        for s in group:
            data += s.encode("utf-8") + bytes([_REC_SEP])
        data += bytes([_GRP_SEP])
    return np.frombuffer(data, dtype=np.uint8)


def unpack_string_groups(arr: Union[Tensor, np.ndarray]) -> List[List[str]]:
    return [
        [chunk.decode("utf-8") for chunk in group.split(bytes([_REC_SEP]))[:-1]]
        for group in _as_bytes(arr).split(bytes([_GRP_SEP]))[:-1]
    ]


__all__ = [
    "dim_zero_cat",
    "dim_zero_cat_ravel",
    "dim_zero_sum",
    "dim_zero_mean",
    "dim_zero_max",
    "dim_zero_min",
    "to_onehot",
    "select_topk",
    "to_categorical",
    "apply_to_collection",
    "allclose",
    "pack_strings",
    "unpack_strings",
    "pack_string_groups",
    "unpack_string_groups",
]
