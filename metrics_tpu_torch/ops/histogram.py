"""Bincount: the hand-written CUDA kernel and its plain PyTorch version.

Replaces the TPU kernel `metrics_tpu/ops/histogram.py` ``_bincount_kernel``
(launched by ``_pallas_weighted_bincount``, reached from ``fused_bincount``).
The function is the same: ``counts[l] = sum_i w[i] * [x[i] == l]`` over the
flattened ids, for ``0 <= l < length``. Ids outside ``[0, length)`` are
dropped, never clipped into bin 0 (the ``ignore_index`` / pad sentinel -1
convention). Unweighted calls return int32 counts, weighted calls float32.

Why atomics replace the one-hot product: the TPU kernel does O(N*L) compares
so that the MXU, not a serialising scatter, does the counting. On Hopper a
bincount is a scatter of O(N) atomics. The kernel in ``csrc/bincount.cu``
(its source note gives the design) makes one launch per call and writes every
bin itself, so the wrapper allocates the counts with ``torch.empty`` and no
memset runs. Where ``length <= SHARED_MAX_BINS`` each block counts in a
private histogram in shared memory and flushes its non-zero bins; above it
the same launch adds with global atomics (:func:`kernel_path` picks). Lanes
of a warp with the same bin add with one atomic. Unweighted counts are
bit-exact; weighted sums are float32 in a run-dependent order.

Bound on the card: the ids read (``8N`` bytes for int64), the weights read
(``4N``) and ``4L`` bytes of counts written. For the headline suite's
confusion matrix (N = 8192, L = 128**2 = 16384) that is 128 KiB, about
0.04 us at 3.35 TB/s: the call is bound by its launch.

A CPU tensor takes :func:`_bincount_plain`. A CUDA tensor launches the kernel
or raises; nothing falls back.

The bincount is the operator ``metrics_tpu_torch::bincount``
(``torch.library.custom_op``): a fake-tensor shape rule, the plain version
for the CPU, the kernel for CUDA, and a ``torch.func.vmap`` rule. The vmap
rule is what ``jax.vmap`` makes of the ``pallas_call``, a grid axis over the
batch: a vmapped call is ONE call of ``metrics_tpu_torch::bincount_batched``,
whose CUDA form is one launch of ``mt_bincount_batched`` (one block a row of
``rows`` histograms, the row stride 0 where every row shares its ids) and
whose CPU form is :func:`_bincount_batched_plain`, one out-of-place
``index_add`` over ``rows * length`` bins with ids offset by ``row * length``.
Bound of the batched call: its ids and weights read once, ``4 * rows *
length`` bytes of counts written.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch import Tensor

from metrics_tpu_torch.ops import _native

#: Kernel launches so far, counted where the kernel is launched and nowhere else.
KERNEL_LAUNCHES = 0
#: Launches of the batched kernel (``mt_bincount_batched``), counted the same way.
BATCHED_LAUNCHES = 0

SOURCE = "bincount.cu"
#: The most bins the shared-memory path takes: 128 KiB of 4-byte bins, which
#: leaves room for one block of 1024 threads on each SM. The source's
#: ``kSharedMaxBins`` must agree; the binding checks that it does.
SHARED_MAX_BINS = 32768
_ID_BYTES = {torch.int32: 4, torch.int64: 8}
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


def _bincount_batched_plain(x: Tensor, length: int, weights: Optional[Tensor], rows: int) -> Tensor:
    """The batched kernel's function in plain PyTorch: ``rows`` histograms.

    ``x`` is ``(1, n)`` (ids shared by every row) or ``(rows, n)``, ``weights``
    the same or None. Ids are offset by ``row * length`` and counted by one
    out-of-place ``index_add`` over ``rows * length`` bins; an invalid id adds
    0 to its row's first bin. Returns ``(rows, length)`` int32 counts, or
    float32 sums when weighted.
    """
    n = x.shape[-1]
    x = x.to(torch.int64).expand(rows, n)
    valid = (x >= 0) & (x < length)
    offsets = torch.arange(rows, device=x.device, dtype=torch.int64).unsqueeze(1) * length
    idx = torch.where(valid, x + offsets, offsets).reshape(-1)
    if weights is None:
        src, dtype = valid.to(torch.int32), torch.int32
    else:
        w = weights.to(torch.float32).expand(rows, n)
        src, dtype = torch.where(valid, w, torch.zeros_like(w)), torch.float32
    counts = torch.zeros(rows * length, dtype=dtype, device=x.device)
    return counts.index_add(0, idx, src.reshape(-1)).reshape(rows, length)


def kernel_path(length: int) -> str:
    """The kernel's path for ``length`` bins: ``"shared"`` where they fit the
    shared-memory budget of ``SHARED_MAX_BINS`` bins, else ``"global"``."""
    return "shared" if length <= SHARED_MAX_BINS else "global"


_entry: Optional[ctypes._CFuncPtr] = None


def _kernel() -> ctypes._CFuncPtr:
    """The C entry point ``mt_bincount``, built and bound on first use."""
    global _entry
    if _entry is None:
        lib = _native.load(SOURCE)
        lib.mt_bincount_shared_max_bins.restype = ctypes.c_int64
        built = lib.mt_bincount_shared_max_bins()
        if built != SHARED_MAX_BINS:
            raise RuntimeError(f"{SOURCE} takes {built} bins in shared memory, the wrapper {SHARED_MAX_BINS}")
        fn = lib.mt_bincount
        fn.argtypes = [
            ctypes.c_void_p,  # ids
            ctypes.c_int,  # bytes per id: 4 or 8
            ctypes.c_void_p,  # weights or NULL
            ctypes.c_int64,  # n
            ctypes.c_void_p,  # counts, uninitialised
            ctypes.c_int64,  # length
            ctypes.c_int,  # 1: shared-memory path, 0: global path
            ctypes.c_int,  # device ordinal
            ctypes.c_void_p,  # cudaStream_t
        ]
        fn.restype = ctypes.c_int
        _entry = fn
    return _entry


def _launch(x: Tensor, length: int, weights: Optional[Tensor], shared: bool) -> Tensor:
    """Check the arguments, allocate the counts and launch the kernel once on
    the current stream, on the shared-memory path or the global one. Does not
    synchronise. ``length == 0`` has no bin to write and launches nothing."""
    global KERNEL_LAUNCHES
    if x.dtype not in _ID_BYTES:
        raise TypeError(f"the bincount kernel takes int32 or int64 ids, got {x.dtype}")
    if x.ndim != 1 or not x.is_contiguous():
        raise ValueError("the bincount kernel takes a contiguous 1-D tensor of ids")
    if not 0 <= length <= _MAX_LENGTH:
        raise ValueError(f"`length` must lie in [0, 2**31), got {length}")
    if shared and length > SHARED_MAX_BINS:
        raise ValueError(f"the shared-memory path takes at most {SHARED_MAX_BINS} bins, got {length}")
    if x.device.type != "cuda":
        raise ValueError(f"the bincount kernel takes a CUDA tensor, got one on {x.device}")
    n = x.numel()
    if weights is not None:
        if weights.device != x.device or weights.dtype != torch.float32:
            raise TypeError("weights must be float32 on the ids' device")
        if weights.shape != (n,) or not weights.is_contiguous():
            raise ValueError(f"weights must be contiguous of shape ({n},), got {tuple(weights.shape)}")
    counts = torch.empty(length, dtype=torch.int32 if weights is None else torch.float32, device=x.device)
    if length == 0:
        return counts
    fn = _kernel()
    device = x.get_device()
    args = (
        x.data_ptr(),
        _ID_BYTES[x.dtype],
        None if weights is None else weights.data_ptr(),
        n,
        counts.data_ptr(),
        length,
        int(shared),
        device,
    )
    if device == torch.cuda.current_device():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(device))
    else:
        with torch.cuda.device(device):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(device))
    if rc != 0:
        raise RuntimeError(f"the bincount kernel failed to launch: CUDA error {rc}")
    KERNEL_LAUNCHES += 1
    return counts


_batched_entry: Optional[ctypes._CFuncPtr] = None


def _batched_kernel() -> ctypes._CFuncPtr:
    """The C entry point ``mt_bincount_batched``, bound on first use."""
    global _batched_entry
    if _batched_entry is None:
        _kernel()  # builds the library and checks its shared-memory threshold
        fn = _native.load(SOURCE).mt_bincount_batched
        fn.argtypes = [
            ctypes.c_void_p,  # ids
            ctypes.c_int,  # bytes per id: 4 or 8
            ctypes.c_int64,  # ids between two rows: 0 when every row shares them
            ctypes.c_void_p,  # weights or NULL
            ctypes.c_int64,  # weights between two rows
            ctypes.c_int64,  # n: ids a row
            ctypes.c_int64,  # rows
            ctypes.c_void_p,  # counts, (rows, length), uninitialised
            ctypes.c_int64,  # length
            ctypes.c_int,  # 1: shared-memory path, 0: global path
            ctypes.c_int,  # device ordinal
            ctypes.c_void_p,  # cudaStream_t
        ]
        fn.restype = ctypes.c_int
        _batched_entry = fn
    return _batched_entry


def _row_stride(t: Tensor, rows: int, name: str) -> int:
    """The stride between rows of a ``(1, n)`` or ``(rows, n)`` operand: 0 when shared."""
    if t.ndim != 2 or t.shape[0] not in (1, rows) or not t.is_contiguous():
        raise ValueError(f"the batched bincount takes contiguous {name} of shape (1, n) or ({rows}, n), got {tuple(t.shape)}")
    return 0 if t.shape[0] == 1 else t.shape[1]


def bincount_batched_cuda(x: Tensor, length: int, weights: Optional[Tensor], rows: int) -> Tensor:
    """Launch the batched kernel once: ``rows`` histograms of ``length`` bins, ``(rows, length)`` out.

    ``x`` is ``(1, n)`` (shared by every row) or ``(rows, n)`` ids, int32 or
    int64, on the card; ``weights`` float32 laid out the same, or None. The
    path (shared memory or global) is :func:`kernel_path`'s. Does not
    synchronise. Raises on anything the kernel does not take.
    """
    global BATCHED_LAUNCHES
    if x.dtype not in _ID_BYTES:
        raise TypeError(f"the bincount kernel takes int32 or int64 ids, got {x.dtype}")
    if x.device.type != "cuda":
        raise ValueError(f"the bincount kernel takes a CUDA tensor, got one on {x.device}")
    if not 0 <= length <= _MAX_LENGTH or rows < 0:
        raise ValueError(f"`length` must lie in [0, 2**31) and `rows` be non-negative, got {length} and {rows}")
    x_stride = _row_stride(x, rows, "ids")
    n = x.shape[1]
    w_stride = 0
    if weights is not None:
        if weights.device != x.device or weights.dtype != torch.float32:
            raise TypeError("weights must be float32 on the ids' device")
        w_stride = _row_stride(weights, rows, "weights")
        if weights.shape[1] != n:
            raise ValueError(f"weights must have {n} columns, got {weights.shape[1]}")
    counts = torch.empty((rows, length), dtype=torch.int32 if weights is None else torch.float32, device=x.device)
    if length == 0 or rows == 0:
        return counts
    fn = _batched_kernel()
    device = x.get_device()
    args = (
        x.data_ptr(),
        _ID_BYTES[x.dtype],
        x_stride,
        None if weights is None else weights.data_ptr(),
        w_stride,
        n,
        rows,
        counts.data_ptr(),
        length,
        int(kernel_path(length) == "shared"),
        device,
    )
    with torch.cuda.device(device):
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(device))
    if rc != 0:
        raise RuntimeError(f"the batched bincount kernel failed to launch: CUDA error {rc}")
    BATCHED_LAUNCHES += 1
    return counts


def bincount_cuda(x: Tensor, length: int, weights: Optional[Tensor] = None) -> Tensor:
    """Launch the CUDA kernel on ``x`` (1-D, contiguous, int32 or int64, on the card),
    on the path :func:`kernel_path` picks for ``length``.

    One launch per call and no memset: the kernel writes every bin of the
    counts it is handed. Does not synchronise. Raises on anything the kernel
    does not take.
    """
    return _launch(x, length, weights, kernel_path(length) == "shared")


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
    if not isinstance(x, Tensor):
        x = torch.as_tensor(x)
    if x.dtype not in _ID_BYTES:
        if x.is_floating_point() or x.is_complex() or x.dtype == torch.bool:
            raise TypeError(f"bincount takes integer ids, got {x.dtype}")
        x = x.to(torch.int64)  # widening: every narrower integer id keeps its value
    x = x.reshape(-1).contiguous()
    if weights is not None:
        weights = torch.as_tensor(weights, device=x.device).reshape(-1).to(torch.float32).contiguous()
    if _transformed(x) or (weights is not None and _transformed(weights)):
        # under a transform (vmap, fake tensors): the operator, whose rules the transform runs
        return torch.ops.metrics_tpu_torch.bincount(x, int(length), weights)
    # a plain tensor: the operator's own kernel for its device, without the dispatcher's round trip
    return _bincount_plain(x, length, weights) if x.device.type == "cpu" else bincount_cuda(x, length, weights)


def _transformed(t: Tensor) -> bool:
    return type(t) is not Tensor or torch._C._functorch.is_functorch_wrapped_tensor(t)


# ----------------------------------------------------------------- the operators
@torch.library.custom_op("metrics_tpu_torch::bincount", mutates_args=(), device_types="cpu")
def _bincount_op(x: Tensor, length: int, weights: Optional[Tensor]) -> Tensor:
    return _bincount_plain(x, length, weights)


@_bincount_op.register_kernel("cuda")
def _bincount_op_cuda(x: Tensor, length: int, weights: Optional[Tensor]) -> Tensor:
    return bincount_cuda(x, length, weights)


@_bincount_op.register_fake
def _bincount_op_fake(x: Tensor, length: int, weights: Optional[Tensor]) -> Tensor:
    return x.new_empty((length,), dtype=torch.int32 if weights is None else torch.float32)


@torch.library.custom_op("metrics_tpu_torch::bincount_batched", mutates_args=(), device_types="cpu")
def _bincount_batched_op(x: Tensor, length: int, weights: Optional[Tensor], rows: int) -> Tensor:
    return _bincount_batched_plain(x, length, weights, rows)


@_bincount_batched_op.register_kernel("cuda")
def _bincount_batched_op_cuda(x: Tensor, length: int, weights: Optional[Tensor], rows: int) -> Tensor:
    return bincount_batched_cuda(x, length, weights, rows)


@_bincount_batched_op.register_fake
def _bincount_batched_op_fake(x: Tensor, length: int, weights: Optional[Tensor], rows: int) -> Tensor:
    return x.new_empty((rows, length), dtype=torch.int32 if weights is None else torch.float32)


def _batch_rows(t: Optional[Tensor], dim: Optional[int], batch: int) -> Optional[Tensor]:
    """A vmapped 1-D operand as ``(batch, n)`` rows, or ``(1, n)`` when it is not batched."""
    if t is None:
        return None
    if dim is None:
        return t.reshape(1, -1).contiguous()
    return t.movedim(dim, 0).reshape(batch, -1).contiguous()


def _bincount_vmap(info, in_dims, x: Tensor, length: int, weights: Optional[Tensor]):
    """``vmap`` of the bincount: one batched call over the batch (shared operands stay one row)."""
    x_dim, _, w_dim = in_dims
    rows = info.batch_size
    out = torch.ops.metrics_tpu_torch.bincount_batched(
        _batch_rows(x, x_dim, rows), length, _batch_rows(weights, w_dim, rows), rows)
    return out, 0


def _fold_rows(t: Optional[Tensor], dim: Optional[int], batch: int, rows: int) -> Optional[Tensor]:
    """A ``(1 | rows, n)`` operand of the batched call under another vmap of ``batch``, as
    ``(1 | batch * rows, n)`` rows of one batched call."""
    if t is None:
        return None
    if dim is None:
        return t if t.shape[0] == 1 else t.repeat(batch, 1)
    t = t.movedim(dim, 0)
    return t.expand(batch, rows, t.shape[-1]).reshape(batch * rows, t.shape[-1]).contiguous()


def _bincount_batched_vmap(info, in_dims, x: Tensor, length: int, weights: Optional[Tensor], rows: int):
    """``vmap`` of the batched call (a vmap inside a vmap): the outer batch folds into the rows."""
    x_dim, _, w_dim, _ = in_dims
    batch = info.batch_size
    out = torch.ops.metrics_tpu_torch.bincount_batched(
        _fold_rows(x, x_dim, batch, rows), length, _fold_rows(weights, w_dim, batch, rows), batch * rows)
    return out.reshape(batch, rows, length), 0


torch.library.register_vmap("metrics_tpu_torch::bincount", _bincount_vmap)
torch.library.register_vmap("metrics_tpu_torch::bincount_batched", _bincount_batched_vmap)


__all__ = ["bincount_batched_cuda", "bincount_cuda", "fused_bincount", "kernel_path"]
