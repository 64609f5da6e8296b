"""Bincount: the hand-written CUDA kernel and its plain PyTorch version.

Replaces the TPU kernel `metrics_tpu/ops/histogram.py` ``_bincount_kernel``
(launched by ``_pallas_weighted_bincount``, reached from ``fused_bincount``).
The function is the same: ``counts[l] = sum_i w[i] * [x[i] == l]`` over the
flattened ids, for ``0 <= l < length``. Ids outside ``[0, length)`` are
dropped, never clipped into bin 0 (the ``ignore_index`` / pad sentinel -1
convention). Unweighted calls return int32 counts, weighted calls float32.

Why atomics replace the one-hot product: the TPU kernel does O(N*L) compares
so that the MXU, not a serialising scatter, does the counting. On Hopper,
atomics resolve in L2 at full rate, so the kernel in ``csrc/bincount.cu`` is a
grid-stride loop with one ``atomicAdd`` per valid id: O(N) work, each id read
once. Unweighted counts are integer atomics and bit-exact; weighted counts are
float32 atomics whose summation order varies from run to run.

Bound on the card: ``4N`` bytes of ids read and ``4L`` bytes of counts zeroed
and written. For the headline suite's confusion matrix (N = 8192,
L = 128**2 = 16384) that is 96 KiB, about 0.03 us at 3.35 TB/s: the call is
bound by its launch.

A CPU tensor takes :func:`_bincount_plain`. A CUDA tensor launches the kernel
or raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch
from torch import Tensor

from metrics_tpu_torch.ops import _native

#: Kernel launches so far, counted where the kernel is launched and nowhere else.
KERNEL_LAUNCHES = 0

SOURCE = "bincount.cu"
_ENTRY = {torch.int32: "mt_bincount_i32", torch.int64: "mt_bincount_i64"}
_MAX_LENGTH = 2**31 - 1


def _bincount_plain(x: Tensor, length: int, weights: Optional[Tensor] = None) -> Tensor:
    """The kernel's function in plain PyTorch: mask the valid ids, then ``index_add_``.

    Invalid ids are redirected to bin 0 with a contribution of 0, which keeps
    every shape static (no boolean indexing, so no host read on the card).
    """
    x = x.reshape(-1)
    valid = (x >= 0) & (x < length)
    idx = torch.where(valid, x, torch.zeros_like(x))
    if weights is None:
        counts = torch.zeros(length, dtype=torch.int32, device=x.device)
        return counts.index_add_(0, idx, valid.to(torch.int32))
    w = weights.reshape(-1).to(torch.float32)
    counts = torch.zeros(length, dtype=torch.float32, device=x.device)
    return counts.index_add_(0, idx, torch.where(valid, w, torch.zeros_like(w)))


_bound: Dict[torch.dtype, ctypes._CFuncPtr] = {}


def _kernel(dtype: torch.dtype) -> ctypes._CFuncPtr:
    """The C entry point for ``dtype`` ids, built and bound on first use."""
    fn = _bound.get(dtype)
    if fn is None:
        fn = getattr(_native.load(SOURCE), _ENTRY[dtype])
        fn.argtypes = [
            ctypes.c_void_p,  # ids
            ctypes.c_void_p,  # weights or NULL
            ctypes.c_int64,  # n
            ctypes.c_void_p,  # counts
            ctypes.c_int64,  # length
            ctypes.c_void_p,  # cudaStream_t
        ]
        fn.restype = ctypes.c_int
        _bound[dtype] = fn
    return fn


def bincount_cuda(x: Tensor, length: int, weights: Optional[Tensor] = None) -> Tensor:
    """Launch the CUDA kernel on ``x`` (1-D, contiguous, int32 or int64, on the card).

    Allocates the zeroed counts, launches on the current stream and does not
    synchronise. Raises on anything the kernel does not take.
    """
    global KERNEL_LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"the bincount kernel takes a CUDA tensor, got one on {x.device}")
    if x.dtype not in _ENTRY:
        raise TypeError(f"the bincount kernel takes int32 or int64 ids, got {x.dtype}")
    if x.ndim != 1 or not x.is_contiguous():
        raise ValueError("the bincount kernel takes a contiguous 1-D tensor of ids")
    if not 0 <= length <= _MAX_LENGTH:
        raise ValueError(f"`length` must lie in [0, 2**31), got {length}")
    n = x.numel()
    if weights is not None:
        if weights.device != x.device or weights.dtype != torch.float32:
            raise TypeError("weights must be float32 on the ids' device")
        if weights.shape != (n,) or not weights.is_contiguous():
            raise ValueError(f"weights must be contiguous of shape ({n},), got {tuple(weights.shape)}")
    counts = torch.zeros(length, dtype=torch.int32 if weights is None else torch.float32, device=x.device)
    if n == 0:
        return counts
    fn = _kernel(x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(
            x.data_ptr(),
            None if weights is None else weights.data_ptr(),
            n,
            counts.data_ptr(),
            length,
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"the bincount kernel failed to launch: CUDA error {rc}")
    KERNEL_LAUNCHES += 1
    return counts


def fused_bincount(x: Tensor, length: int, weights: Optional[Tensor] = None) -> Tensor:
    """``bincount(x, weights, minlength=length)`` with out-of-range ids dropped.

    ``x`` is flattened. Returns int32 counts, or float32 sums when ``weights``
    is given. On the CPU this is :func:`_bincount_plain`; on the card it is
    the CUDA kernel.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops.histogram import fused_bincount
        >>> fused_bincount(torch.tensor([-1, 0, 1, 5, 99, 1]), 3)
        tensor([1, 2, 0], dtype=torch.int32)
    """
    x = torch.as_tensor(x).reshape(-1)
    if x.is_floating_point() or x.is_complex() or x.dtype == torch.bool:
        raise TypeError(f"bincount takes integer ids, got {x.dtype}")
    if x.dtype not in _ENTRY:
        x = x.to(torch.int64)  # widening: every narrower integer id keeps its value
    if weights is not None:
        weights = torch.as_tensor(weights, device=x.device).reshape(-1).to(torch.float32)
    if x.device.type == "cpu":
        return _bincount_plain(x, length, weights)
    return bincount_cuda(x.contiguous(), length, None if weights is None else weights.contiguous())


__all__ = ["bincount_cuda", "fused_bincount"]
