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
whose CUDA form is one launch of ``mt_bincount_batched`` and whose CPU form
is :func:`_bincount_batched_plain`, one out-of-place ``index_add`` over
``rows * length`` bins with ids offset by ``row * length``. The batched
launch runs in one of three regimes that :func:`batched_plan` picks from
``(rows, n, length)``: ``packed`` (several small rows a block, their ids
counted as one flat range), ``cluster`` (a thread-block cluster of up to 16
CTAs a row, the row's histogram spread over their shared memory, for ids
that contend) and ``global`` (the cluster zeroes the row in device memory,
then adds with global atomics).
Bound of the batched call: its ids and weights read once, ``4 * rows *
length`` bytes of counts written.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

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

#: The batched form's regimes (``batched_plan``); the source's ``Regime`` codes are their indices.
REGIMES = ("packed", "cluster", "global")
#: The most bins of a packed block, all its rows side by side (64 KiB); the source's ``kPackedMaxBins`` must agree.
PACKED_MAX_BINS = 16384
PACKED_ROW_MAX_BINS = 2048  # rows up to this many bins are packed, where they have few ids or fill the card
PACKED_MAX_IDS = 2048
CLUSTER_IDS_PER_BIN = 64  # a row with this many ids a bin contends: its cluster counts in shared memory
MIN_SLICE_BINS = 2048  # a row is spread over more CTAs while each still owns this many bins ...
MIN_CTA_IDS = 8192  # ... or counts this many ids (16 rounds of a 512-thread CTA)
SMS = 132  # the H100's SMs
MIN_BLOCKS = 4 * SMS  # blocks a packed or global launch is given where the rows allow: 4 resident a SM
MAX_GRID = 65535
SLICE_ALIGN = 4


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


class BatchedPlan(NamedTuple):
    """How one launch of the batched kernel covers ``rows`` histograms of ``length`` bins.

    ``regime`` is ``"packed"``, ``"cluster"`` or ``"global"``. ``split`` is the
    rows a block takes at a time (packed) or the CTAs of a row's cluster
    (cluster, global). ``grid`` is the launch's row axis: blocks along x
    (packed) or clusters along y (the others), which walk the groups of rows
    (packed) or the rows in steps of ``grid``. ``slice`` is the bins each CTA
    owns of its row in shared memory (cluster), else a row's (``length``).
    """

    regime: str
    split: int
    grid: int
    slice: int

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory a block asks for (4-byte bins)."""
        if self.regime == "packed":
            return 4 * self.split * self.slice
        return 4 * self.slice if self.regime == "cluster" else 0

    def rows_of(self, slot: int, rows: int) -> list:
        """The rows that block (packed) or cluster ``slot`` of the row axis counts, in order."""
        if self.regime != "packed":
            return list(range(slot, rows, self.grid))
        groups = range(slot, -(-rows // self.split), self.grid)
        return [r for g in groups for r in range(g * self.split, min((g + 1) * self.split, rows))]

    def bins_of(self, rank: int, length: int) -> list:
        """The bins of a row that CTA ``rank`` of its cluster zeroes (packed: the block's, all): a slice
        (cluster), or every ``split``-th group of 4 (global: the cluster's threads write the row together,
        16 bytes each, here for a row that starts on 16 bytes)."""
        if self.regime == "packed":
            return list(range(length))
        if self.regime == "cluster":
            return list(range(min(rank * self.slice, length), min((rank + 1) * self.slice, length)))
        groups = range(rank, -(-length // SLICE_ALIGN), self.split)
        return [b for g in groups for b in range(g * SLICE_ALIGN, min((g + 1) * SLICE_ALIGN, length))]

    def ids_of(self, rank: int, n: int) -> range:
        """The ids of a row that CTA ``rank`` of its cluster counts (packed: the block's, all)."""
        if self.regime == "packed":
            return range(n)
        per = -(-n // self.split)
        return range(min(rank * per, n), min((rank + 1) * per, n))


def _slice_bins(length: int, split: int) -> int:
    """Bins each of ``split`` CTAs owns: ``ceil(length / split)`` rounded up to 4 (the source's ``slice_bins``)."""
    per = -(-length // split)
    return -(-per // SLICE_ALIGN) * SLICE_ALIGN


def batched_plan(rows: int, n: int, length: int, max_cluster: int = 16) -> BatchedPlan:
    """The batched kernel's regime, split and grid for ``rows`` rows of ``n`` ids into ``length`` bins.

    - packed: rows of up to ``PACKED_ROW_MAX_BINS`` bins with up to
      ``PACKED_MAX_IDS`` ids, or enough rows to give each SM one. A block
      takes the largest power of two of rows whose bins fit
      ``PACKED_MAX_BINS``, fewer where that would leave fewer than
      ``MIN_BLOCKS`` blocks.
    - cluster: rows whose ids contend, ``CLUSTER_IDS_PER_BIN`` or more a bin,
      where a cluster's shared memory holds the row: the row's histogram is
      spread over the cluster's CTAs and counted with shared-memory atomics.
    - global: the rest (sparse ids, as many as the bins or fewer, and rows
      too wide for a cluster): the cluster zeroes the row and adds with
      global atomics, which on the H100 beat the distributed shared memory
      wherever few ids share a bin (``tools/torch_bincount_batched_sweep.py``).

    A cluster or global row takes ``split`` CTAs: the smallest power of two
    that fills the card (``rows * split >= SMS``, or ``MIN_BLOCKS`` where the
    row is zeroed in device memory) while each CTA still has
    ``MIN_SLICE_BINS`` bins or ``MIN_CTA_IDS`` ids, at least enough
    for a cluster's slices to fit ``SHARED_MAX_BINS`` each, and at most
    ``max_cluster`` (what the card takes: ``mt_bincount_batched_max_cluster``).
    A pure function: the CPU tests check its coverage.

    Example:
        >>> from metrics_tpu_torch.ops.histogram import batched_plan
        >>> batched_plan(8, 8192, 16384)
        BatchedPlan(regime='global', split=8, grid=8, slice=16384)
        >>> batched_plan(65536, 8, 100)
        BatchedPlan(regime='packed', split=64, grid=1024, slice=100)
        >>> batched_plan(8, 2**17, 4)
        BatchedPlan(regime='cluster', split=16, grid=8, slice=4)
    """
    if rows < 1 or length < 1 or n < 0 or max_cluster < 1:
        raise ValueError(f"a batched plan takes rows >= 1, length >= 1, n >= 0, got {rows}, {length}, {n}")
    if length <= PACKED_ROW_MAX_BINS and (n <= PACKED_MAX_IDS or rows >= SMS):
        split = 1
        while (2 * split * length <= PACKED_MAX_BINS and -(-rows // (2 * split)) >= MIN_BLOCKS
               and 2 * split * n <= _MAX_LENGTH):  # a block's ids are indexed in 32 bits
            split *= 2
        return BatchedPlan("packed", split, min(-(-rows // split), MAX_GRID), length)
    fits = _slice_bins(length, max_cluster) <= SHARED_MAX_BINS
    regime = "cluster" if fits and n >= CLUSTER_IDS_PER_BIN * length else "global"
    fill = SMS if regime == "cluster" else MIN_BLOCKS
    split = 1
    while split < max_cluster and (
        (regime == "cluster" and _slice_bins(length, split) > SHARED_MAX_BINS)
        or (rows * split < fill and (length // (2 * split) >= MIN_SLICE_BINS or n // (2 * split) >= MIN_CTA_IDS))
    ):
        split *= 2
    return BatchedPlan(regime, split, min(rows, MAX_GRID), _slice_bins(length, split) if regime == "cluster" else length)


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
_max_cluster: dict = {}


def _batched_kernel() -> ctypes._CFuncPtr:
    """The C entry point ``mt_bincount_batched``, bound on first use."""
    global _batched_entry
    if _batched_entry is None:
        _kernel()  # builds the library and checks its shared-memory threshold
        lib = _native.load(SOURCE)
        lib.mt_bincount_batched_packed_max_bins.restype = ctypes.c_int64
        built = lib.mt_bincount_batched_packed_max_bins()
        if built != PACKED_MAX_BINS:
            raise RuntimeError(f"{SOURCE} packs {built} bins a block, the wrapper {PACKED_MAX_BINS}")
        lib.mt_bincount_batched_max_cluster.argtypes = [ctypes.c_int]
        lib.mt_bincount_batched_max_cluster.restype = ctypes.c_int
        fn = lib.mt_bincount_batched
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
            ctypes.c_int,  # regime: the index of BatchedPlan.regime in REGIMES
            ctypes.c_int,  # split: rows a block (packed) or CTAs a row (cluster, global)
            ctypes.c_int64,  # grid: the launch's row axis
            ctypes.c_int,  # device ordinal
            ctypes.c_void_p,  # cudaStream_t
        ]
        fn.restype = ctypes.c_int
        _batched_entry = fn
    return _batched_entry


def max_cluster(device: int) -> int:
    """The largest cluster the batched kernel may take on ``device``: one of them fits at the largest slice."""
    if device not in _max_cluster:
        _batched_kernel()
        with torch.cuda.device(device):
            found = _native.load(SOURCE).mt_bincount_batched_max_cluster(device)
        if found < 1:
            raise RuntimeError(f"the batched bincount kernel fits no thread-block cluster on device {device}")
        _max_cluster[device] = found
    return _max_cluster[device]


def _row_stride(t: Tensor, rows: int, name: str) -> int:
    """The stride between rows of a ``(1, n)`` or ``(rows, n)`` operand: 0 when shared."""
    if t.ndim != 2 or t.shape[0] not in (1, rows) or not t.is_contiguous():
        raise ValueError(f"the batched bincount takes contiguous {name} of shape (1, n) or ({rows}, n), got {tuple(t.shape)}")
    return 0 if t.shape[0] == 1 else t.shape[1]


def bincount_batched_cuda(x: Tensor, length: int, weights: Optional[Tensor], rows: int) -> Tensor:
    """Launch the batched kernel once: ``rows`` histograms of ``length`` bins, ``(rows, length)`` out.

    ``x`` is ``(1, n)`` (shared by every row) or ``(rows, n)`` ids, int32 or
    int64, on the card; ``weights`` float32 laid out the same, or None. The
    regime, split and grid are :func:`batched_plan`'s. Does not synchronise.
    Raises on anything the kernel does not take, and where the launch is
    refused.
    """
    return _launch_batched(x, length, weights, rows)


def _launch_batched(x: Tensor, length: int, weights: Optional[Tensor], rows: int,
                    plan: Optional[BatchedPlan] = None) -> Tensor:
    """:func:`bincount_batched_cuda` under ``plan`` (default: :func:`batched_plan`'s), one launch."""
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
    if plan is None:
        plan = batched_plan(rows, n, length, max_cluster(device))
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
        REGIMES.index(plan.regime),
        plan.split,
        plan.grid,
        device,
    )
    with torch.cuda.device(device):
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(device))
    if rc != 0:
        raise RuntimeError(f"the batched bincount kernel failed to launch ({plan}): CUDA error {rc}")
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


__all__ = ["BatchedPlan", "batched_plan", "bincount_batched_cuda", "bincount_cuda", "fused_bincount", "kernel_path"]
