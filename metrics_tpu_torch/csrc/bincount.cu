// Bincount for Hopper (sm_90a): one launch per call, a privatised
// shared-memory histogram where the bins fit, warp-aggregated atomics.
//
// Replaces the Pallas kernel `_bincount_kernel` in metrics_tpu/ops/histogram.py
// (launched by `_pallas_weighted_bincount`). Same function:
//     counts[l] = sum_i w[i] * [x[i] == l]   for 0 <= l < length,
// with ids outside [0, length) dropped (the pad sentinel -1 among them). The
// range test runs at 64 bits, so an int64 id of 2**32 + 5 is dropped, not
// counted in bin 5. Unweighted counts are int32 and exact in any order;
// weighted sums are float32 and their order changes from run to run.
//
// What bounds it. The data moved is small: 8N bytes of int64 ids (4N for
// int32), 4N of weights and 4L of counts. At the main-path shape (N = 8192,
// L = 16384) that is 128 KiB, 0.04 us at 3.35 TB/s, so a call is bound by
// launches and latency; with many ids in few bins (the multilabel and binary
// confusion matrices, N = 2**20, L <= 512) by atomics that serialise on a
// handful of addresses. The design answers each:
//
// 1. One launch, no memset. The caller hands over uninitialised memory and the
//    kernel writes every bin. Blocks zero the output in a grid-strided
//    pattern, meet at a grid-wide barrier (cooperative launch:
//    cooperative_groups::this_grid().sync(), which needs no -rdc since
//    CUDA 11), then add. The grid never exceeds the co-resident limit
//    (occupancy x SMs), computed once per device and kernel and cached. A grid
//    of one block needs no barrier and is launched plainly: it writes every
//    bin with a plain store and never touches the output with an atomic.
// 2. A private histogram in shared memory where L <= kSharedMaxBins (32768
//    bins, 128 KiB: one block of 1024 threads per SM still fits in the 227
//    KiB). Each block zeroes it, counts its ids there with shared-memory
//    atomics, and flushes only its non-zero bins to the output, one global
//    atomic each. The zeroing of the output overlaps the counting: the grid
//    barrier comes after the count, just before the flush. Each block pays
//    O(L) to zero and flush, so the grid scales with N: one block per
//    max(L, kTile) ids. Where L does not fit (the C=1000 confusion matrix,
//    L = 10**6), the same single launch zeroes the output, syncs the grid and
//    adds with global atomics.
// 3. Warp aggregation. Lanes of a warp that hold the same bin find each other
//    with __match_any_sync; the group's lowest lane adds the group's count
//    (or its sum of weights, a tree of shuffles) in one atomic. The match is
//    slow when the warp's bins are all distinct, so a vote on lane 0's bin
//    decides first: a warp of one bin adds once without it, a warp where
//    lane 0's bin appears once adds lane by lane without it. The key is the
//    bin after the 64-bit range test, and every dropped id or lane past the
//    ragged edge carries kNoBin (-1), which is never a bin: so the match on
//    the 32-bit bin groups exactly the lanes whose 64-bit ids are equal and
//    in range, and a kNoBin group adds nothing.
// 4. Each thread loads kIdsPerThread ids before it counts any of them, so
//    one round trip to memory covers kTile = 8192 ids of a block.
//
// mt_bincount launches on the caller's stream, does not synchronise and
// returns a cudaError_t, which the Python wrapper checks.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

namespace {

constexpr int kThreads = 1024;
constexpr int kIdsPerThread = 8;
constexpr int64_t kTile = (int64_t)kThreads * kIdsPerThread;
constexpr int64_t kSharedMaxBins = 32768;  // 4 bytes a bin: 128 KiB of dynamic shared memory
constexpr int64_t kZeroBinsPerThread = 4;  // the global path sizes its grid to zero the output in a few stores a thread
constexpr int kNoBin = -1;
constexpr int kMaxDevices = 64;
constexpr unsigned kFullWarp = 0xffffffffu;

// Sum of v over the lanes in `peers` (this lane's group), left in the group's
// lowest lane. All 32 lanes call it together. Each round, every lane adds the
// value of the next peer above it still in play, then the peers at odd rank
// drop out: a tree of at most 5 rounds, none when every group has one lane.
__device__ __forceinline__ float group_sum(unsigned peers, float v) {
  const int lane = threadIdx.x & 31;
  int rank = __popc(peers & ((1u << lane) - 1u));
  unsigned above = peers & (0xfffffffeu << lane);
  while (__any_sync(kFullWarp, above != 0)) {
    const int next = __ffs(above);  // 1 + the lane of the next peer above, or 0
    const float t = __shfl_sync(kFullWarp, v, (next - 1) & 31);
    if (next) v += t;
    above &= ~__ballot_sync(kFullWarp, rank & 1);
    rank >>= 1;
  }
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) v += __shfl_xor_sync(kFullWarp, v, offset);
  return v;
}

// Adds this lane's id (bin, weight) to target[]. All 32 lanes call it
// together. __match_any_sync costs more the more distinct bins the warp
// holds (on an H100, calling it on every warp of 32 distinct bins took a
// call at N = 8192, L = 16384 from 4.6 to 12.0 us, see PERF.md), so one
// broadcast and one vote first sort the warp three ways, uniformly:
// every lane holds lane 0's bin (one atomic for the warp); lane 0's bin is
// held by no other lane (taken as cold: one atomic a lane, no match); else
// the lanes with equal bins are grouped with __match_any_sync and each
// group's lowest lane adds the group's count or sum of weights.
template <typename CountT>
__device__ __forceinline__ void add_aggregated(CountT* target, int bin, float weight) {
  constexpr bool kWeighted = std::is_same<CountT, float>::value;
  const int lane = threadIdx.x & 31;
  const int first = __shfl_sync(kFullWarp, bin, 0);
  const unsigned same = __ballot_sync(kFullWarp, bin == first);
  if (same == kFullWarp) {
    if constexpr (kWeighted) {
      const float sum = warp_sum(weight);
      if (lane == 0 && first != kNoBin) atomicAdd(target + first, sum);
    } else {
      if (lane == 0 && first != kNoBin) atomicAdd(target + first, 32);
    }
    return;
  }
  if (same == 1u) {
    if (bin != kNoBin) {
      if constexpr (kWeighted) {
        atomicAdd(target + bin, weight);
      } else {
        atomicAdd(target + bin, 1);
      }
    }
    return;
  }
  const unsigned peers = __match_any_sync(kFullWarp, bin);
  const bool leader = lane == __ffs(peers) - 1;
  if constexpr (kWeighted) {
    const float sum = group_sum(peers, weight);
    if (leader && bin != kNoBin) atomicAdd(target + bin, sum);
  } else {
    if (leader && bin != kNoBin) atomicAdd(target + bin, (int)__popc(peers));
  }
}

__device__ __forceinline__ void grid_barrier() {
  if (gridDim.x > 1) {
    cooperative_groups::this_grid().sync();
  } else {
    __syncthreads();
  }
}

// CountT is int (unweighted, w unused) or float (weighted). kShared: count in
// a private shared-memory histogram of `length` bins, else in global memory.
template <typename IdT, typename CountT, bool kShared>
__global__ void __launch_bounds__(kThreads)
    bincount_kernel(const IdT* __restrict__ x, const float* __restrict__ w, int64_t n,
                    CountT* __restrict__ counts, int64_t length) {
  constexpr bool kWeighted = std::is_same<CountT, float>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  CountT* hist = reinterpret_cast<CountT*>(smem);
  const bool one_block = gridDim.x == 1;

  if (kShared) {
    for (int64_t b = threadIdx.x; b < length; b += kThreads) hist[b] = 0;
  }
  if (!(kShared && one_block)) {  // a lone block of the shared path stores every bin at the end
    const int64_t stride = (int64_t)gridDim.x * kThreads;
    for (int64_t b = (int64_t)blockIdx.x * kThreads + threadIdx.x; b < length; b += stride) counts[b] = 0;
  }
  if (kShared) {
    __syncthreads();
  } else {
    grid_barrier();  // every bin is zero before the first atomic lands
  }

  CountT* target = kShared ? hist : counts;
  // The loop bound is uniform across the block, so every lane of a warp takes
  // every round: the warp intrinsics below always see all 32 lanes.
  for (int64_t tile = (int64_t)blockIdx.x * kTile; tile < n; tile += (int64_t)gridDim.x * kTile) {
    int bin[kIdsPerThread];
    float weight[kIdsPerThread];
#pragma unroll
    for (int k = 0; k < kIdsPerThread; ++k) {
      const int64_t i = tile + (int64_t)k * kThreads + threadIdx.x;
      bin[k] = kNoBin;
      weight[k] = 0.0f;
      if (i < n) {
        const int64_t v = (int64_t)x[i];  // compared at 64 bits
        if (v >= 0 && v < length) {
          bin[k] = (int)v;
          if constexpr (kWeighted) weight[k] = w[i];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kIdsPerThread; ++k) add_aggregated(target, bin[k], weight[k]);
  }

  if (kShared) {
    __syncthreads();
    if (!one_block) grid_barrier();  // every stripe of the output is zero
    for (int64_t b = threadIdx.x; b < length; b += kThreads) {
      const CountT c = hist[b];
      if (one_block) {
        counts[b] = c;
      } else if (c != 0) {
        atomicAdd(counts + b, c);
      }
    }
  }
}

// Per device and kernel: whether it can be launched, and how many of its
// blocks fit on the card at once (the cooperative launch's limit).
struct Setup {
  cudaError_t error;
  int max_blocks;
};

template <typename IdT, typename CountT, bool kShared>
Setup make_setup(int device) {
  const void* kernel = (const void*)bincount_kernel<IdT, CountT, kShared>;
  // occupancy only falls as shared memory grows, so the limit at the largest
  // histogram holds for every smaller one
  const size_t smem = kShared ? kSharedMaxBins * sizeof(CountT) : 0;
  int coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess && smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e == cudaSuccess && per_sm < 1) e = cudaErrorInvalidConfiguration;
  return Setup{e, per_sm * sms};
}

template <typename IdT, typename CountT, bool kShared>
const Setup& setup(int device) {
  static Setup table[kMaxDevices];
  static std::once_flag once[kMaxDevices];
  std::call_once(once[device], [device] { table[device] = make_setup<IdT, CountT, kShared>(device); });
  return table[device];
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

template <typename IdT, typename CountT, bool kShared>
cudaError_t launch(const void* x, const void* w, int64_t n, void* counts, int64_t length, int device,
                   cudaStream_t stream) {
  const Setup& s = setup<IdT, CountT, kShared>(device);
  if (s.error != cudaSuccess) return s.error;
  int64_t want;
  if (kShared) {
    want = n / (length > kTile ? length : kTile);  // each block pays O(L): give it at least max(L, kTile) ids
  } else {
    const int64_t count_blocks = ceil_div(n, kTile);
    const int64_t zero_blocks = ceil_div(length, kThreads * kZeroBinsPerThread);
    want = count_blocks > zero_blocks ? count_blocks : zero_blocks;
  }
  const int blocks = (int)(want < 1 ? 1 : (want > s.max_blocks ? s.max_blocks : want));
  const size_t smem = kShared ? (size_t)length * sizeof(CountT) : 0;
  const IdT* xp = (const IdT*)x;
  const float* wp = (const float*)w;
  CountT* cp = (CountT*)counts;
  if (blocks == 1) {
    bincount_kernel<IdT, CountT, kShared><<<1, kThreads, smem, stream>>>(xp, wp, n, cp, length);
    return cudaGetLastError();
  }
  void* args[] = {(void*)&xp, (void*)&wp, (void*)&n, (void*)&cp, (void*)&length};
  const cudaError_t e = cudaLaunchCooperativeKernel((const void*)bincount_kernel<IdT, CountT, kShared>,
                                                    dim3(blocks), dim3(kThreads), args, smem, stream);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename IdT>
cudaError_t dispatch(const void* x, const void* w, int64_t n, void* counts, int64_t length, bool shared,
                     int device, cudaStream_t stream) {
  if (w == nullptr) {
    return shared ? launch<IdT, int, true>(x, w, n, counts, length, device, stream)
                  : launch<IdT, int, false>(x, w, n, counts, length, device, stream);
  }
  return shared ? launch<IdT, float, true>(x, w, n, counts, length, device, stream)
                : launch<IdT, float, false>(x, w, n, counts, length, device, stream);
}


// ---------------------------------------------------------------- batched
// The batched form: `rows` histograms of `length` bins in one launch, what
// jax.vmap makes of the Pallas kernel (a grid axis over the batch). Row r
// counts ids x[r * x_row_stride + i], i < n, with weights
// w[r * w_row_stride + i]; a stride of 0 shares one id (or weight) row among
// every output row. One block owns a row, so no grid barrier is needed and the
// launch is a plain one: the grid's second axis walks the rows (a block takes
// row blockIdx.y, then every gridDim.y-th after it, for more than 65,535
// rows). Where length <= kSharedMaxBins the block counts in a private
// histogram in shared memory and stores every bin of its row; above that it
// zeroes its row, syncs the block and adds with global atomics. Either way
// the kernel writes every bin of the (rows, length) output: no memset.
template <typename IdT, typename CountT, bool kShared>
__global__ void __launch_bounds__(kThreads)
    bincount_batched_kernel(const IdT* __restrict__ x, int64_t x_row_stride, const float* __restrict__ w,
                            int64_t w_row_stride, int64_t n, int64_t rows, CountT* __restrict__ counts,
                            int64_t length) {
  constexpr bool kWeighted = std::is_same<CountT, float>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  CountT* hist = reinterpret_cast<CountT*>(smem);
  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    const IdT* xr = x + row * x_row_stride;
    const float* wr = kWeighted ? w + row * w_row_stride : nullptr;
    CountT* out = counts + row * length;
    CountT* target = kShared ? hist : out;
    for (int64_t b = threadIdx.x; b < length; b += kThreads) target[b] = 0;
    __syncthreads();  // every bin is zero before the first add (global stores included: one block)
    // the loop bound is uniform across the block: every lane of a warp takes every round
    for (int64_t base = 0; base < n; base += kThreads) {
      const int64_t i = base + threadIdx.x;
      int bin = kNoBin;
      float weight = 0.0f;
      if (i < n) {
        const int64_t v = (int64_t)xr[i];  // compared at 64 bits
        if (v >= 0 && v < length) {
          bin = (int)v;
          if constexpr (kWeighted) weight = wr[i];
        }
      }
      add_aggregated(target, bin, weight);
    }
    __syncthreads();
    if (kShared) {
      for (int64_t b = threadIdx.x; b < length; b += kThreads) out[b] = hist[b];
      __syncthreads();  // the histogram is read out before the next row zeroes it
    }
  }
}

template <typename IdT, typename CountT, bool kShared>
cudaError_t batched_setup(int device) {
  static cudaError_t table[kMaxDevices];
  static std::once_flag once[kMaxDevices];
  std::call_once(once[device], [device] {
    const size_t smem = kShared ? kSharedMaxBins * sizeof(CountT) : 0;
    table[device] = smem > 48 * 1024 ? cudaFuncSetAttribute((const void*)bincount_batched_kernel<IdT, CountT, kShared>,
                                                            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)
                                     : cudaSuccess;
  });
  return table[device];
}

constexpr int64_t kMaxGridY = 65535;

template <typename IdT, typename CountT, bool kShared>
cudaError_t launch_batched(const void* x, int64_t x_row_stride, const void* w, int64_t w_row_stride, int64_t n,
                           int64_t rows, void* counts, int64_t length, int device, cudaStream_t stream) {
  const cudaError_t e = batched_setup<IdT, CountT, kShared>(device);
  if (e != cudaSuccess) return e;
  const size_t smem = kShared ? (size_t)length * sizeof(CountT) : 0;
  const dim3 grid(1, (unsigned)(rows < kMaxGridY ? rows : kMaxGridY));
  bincount_batched_kernel<IdT, CountT, kShared><<<grid, kThreads, smem, stream>>>(
      (const IdT*)x, x_row_stride, (const float*)w, w_row_stride, n, rows, (CountT*)counts, length);
  return cudaGetLastError();
}

template <typename IdT>
cudaError_t dispatch_batched(const void* x, int64_t x_row_stride, const void* w, int64_t w_row_stride, int64_t n,
                             int64_t rows, void* counts, int64_t length, bool shared, int device, cudaStream_t s) {
  if (w == nullptr) {
    return shared ? launch_batched<IdT, int, true>(x, x_row_stride, w, 0, n, rows, counts, length, device, s)
                  : launch_batched<IdT, int, false>(x, x_row_stride, w, 0, n, rows, counts, length, device, s);
  }
  return shared ? launch_batched<IdT, float, true>(x, x_row_stride, w, w_row_stride, n, rows, counts, length, device, s)
                : launch_batched<IdT, float, false>(x, x_row_stride, w, w_row_stride, n, rows, counts, length, device, s);
}

}  // namespace

// The most bins the shared-memory path takes; the Python wrapper checks that
// its own threshold is this one.
extern "C" int64_t mt_bincount_shared_max_bins() { return kSharedMaxBins; }

// x: n >= 0 ids of id_bytes (4: int32, 8: int64); w: n float32 weights or
// NULL; counts: `length` >= 1 bins of uninitialised memory, int32 when w is
// NULL, float32 otherwise, all written by the kernel; shared: count in shared
// memory (length <= mt_bincount_shared_max_bins()) or in global memory;
// device: the ordinal of the current device, which holds every pointer.
extern "C" int mt_bincount(const void* x, int id_bytes, const void* w, int64_t n, void* counts, int64_t length,
                           int shared, int device, void* stream) {
  if (n < 0 || length < 1 || length > INT32_MAX || (shared && length > kSharedMaxBins) ||
      (id_bytes != 4 && id_bytes != 8)) {
    return (int)cudaErrorInvalidValue;
  }
  if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e = id_bytes == 4 ? dispatch<int32_t>(x, w, n, counts, length, shared != 0, device, s)
                                      : dispatch<int64_t>(x, w, n, counts, length, shared != 0, device, s);
  return (int)e;
}

// The batched form. x: ids of id_bytes, row r at x + r * x_row_stride (in ids;
// 0 shares one row), n ids a row; w: float32 weights laid out the same with
// w_row_stride, or NULL; counts: rows x length bins of uninitialised memory,
// int32 when w is NULL, float32 otherwise, all written by the kernel; shared:
// count in shared memory (length <= mt_bincount_shared_max_bins()) or in
// global memory. One launch on `stream`, no synchronisation.
extern "C" int mt_bincount_batched(const void* x, int id_bytes, int64_t x_row_stride, const void* w,
                                   int64_t w_row_stride, int64_t n, int64_t rows, void* counts, int64_t length,
                                   int shared, int device, void* stream) {
  if (n < 0 || rows < 1 || length < 1 || length > INT32_MAX || x_row_stride < 0 || w_row_stride < 0 ||
      (shared && length > kSharedMaxBins) || (id_bytes != 4 && id_bytes != 8)) {
    return (int)cudaErrorInvalidValue;
  }
  if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e =
      id_bytes == 4 ? dispatch_batched<int32_t>(x, x_row_stride, w, w_row_stride, n, rows, counts, length, shared != 0, device, s)
                    : dispatch_batched<int64_t>(x, x_row_stride, w, w_row_stride, n, rows, counts, length, shared != 0, device, s);
  return (int)e;
}
