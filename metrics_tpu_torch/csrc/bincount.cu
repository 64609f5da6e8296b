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

// The plain sink: one atomic into target[bin] (global or this block's shared memory).
template <typename CountT>
struct PointerSink {
  CountT* target;
  __device__ __forceinline__ void operator()(int bin, CountT v) const { atomicAdd(target + bin, v); }
};

// Adds this lane's id (bin, weight) through sink(bin, value). All 32 lanes
// call it together. __match_any_sync costs more the more distinct bins the
// warp holds (on an H100, calling it on every warp of 32 distinct bins took a
// call at N = 8192, L = 16384 from 4.6 to 12.0 us, see PERF.md), so one
// broadcast and one vote first sort the warp three ways, uniformly:
// every lane holds lane 0's bin (one atomic for the warp); lane 0's bin is
// held by no other lane (taken as cold: one atomic a lane, no match); else
// the lanes with equal bins are grouped with __match_any_sync and each
// group's lowest lane adds the group's count or sum of weights.
template <typename CountT, typename Sink>
__device__ __forceinline__ void add_aggregated_to(const Sink& sink, int bin, float weight) {
  constexpr bool kWeighted = std::is_same<CountT, float>::value;
  const int lane = threadIdx.x & 31;
  const int first = __shfl_sync(kFullWarp, bin, 0);
  const unsigned same = __ballot_sync(kFullWarp, bin == first);
  if (same == kFullWarp) {
    if constexpr (kWeighted) {
      const float sum = warp_sum(weight);
      if (lane == 0 && first != kNoBin) sink(first, sum);
    } else {
      if (lane == 0 && first != kNoBin) sink(first, 32);
    }
    return;
  }
  if (same == 1u) {
    if (bin != kNoBin) {
      if constexpr (kWeighted) {
        sink(bin, weight);
      } else {
        sink(bin, 1);
      }
    }
    return;
  }
  const unsigned peers = __match_any_sync(kFullWarp, bin);
  const bool leader = lane == __ffs(peers) - 1;
  if constexpr (kWeighted) {
    const float sum = group_sum(peers, weight);
    if (leader && bin != kNoBin) sink(bin, sum);
  } else {
    if (leader && bin != kNoBin) sink(bin, (int)__popc(peers));
  }
}

template <typename CountT>
__device__ __forceinline__ void add_aggregated(CountT* target, int bin, float weight) {
  add_aggregated_to<CountT>(PointerSink<CountT>{target}, bin, weight);
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
// every output row. The kernel writes every bin of the (rows, length) output:
// no memset. A call is one launch in one of three regimes, which the Python
// launcher picks from (rows, n, length) (`batched_plan` in ops/histogram.py)
// and this file checks:
//
// - packed: small rows (split x length <= kPackedMaxBins). A block takes
//   `split` rows at a time, their histograms side by side in its shared
//   memory, and counts the group's split x n ids as one flat range, keyed on
//   row x length + bin, so a row of 8 ids is 8 lanes' work, not a block's.
//   It then stores the group's rows, which are contiguous in the output, in
//   one coalesced sweep. The grid's x axis walks the groups. (The arena's
//   chunks: 65,536 rows of 8 ids into 100 bins.)
// - cluster: a thread-block cluster of `split` CTAs a row (cudaLaunchKernelEx
//   with a cluster dimension), so rows x split CTAs fill the SMs where one
//   block a row kept only `rows` of them busy. The row's histogram is
//   distributed over the cluster's shared memory: CTA c owns bins
//   [c * slice, (c + 1) * slice), slice <= kSharedMaxBins. Each CTA counts
//   1/split of the row's ids and adds each into the owning CTA's slice
//   through distributed shared memory (map_shared_rank), after the same warp
//   aggregation as the plain kernel. Each CTA stores its own slice. So a row
//   takes up to split x 32768 bins, and no SM stores a whole row alone. The
//   launcher takes it where many ids share a bin (64 a bin or more), whose
//   global atomics would serialise.
// - global: the rest. The `split` CTAs of a row zero it in global memory
//   together, interleaved 16 bytes a thread, meet at the cluster barrier,
//   whose release/acquire order makes every zero visible to the cluster
//   before any add, then add their 1/split of the ids with global atomics. No
//   grid barrier, no cooperative launch. Where few ids share a bin this beats
//   the cluster regime on the H100 (8 rows of 8192 ids into 16384 bins: 3.4
//   against 5.0 us; PERF.md): one barrier, not two, and no store of a shared
//   histogram. The row deltas (10**6 bins) are bound by the zeroing: 132 MB
//   written.
//
// Cluster and global: the grid is (split, grid) with clusters of (split, 1, 1),
// and the y axis walks the rows (row blockIdx.y, then every gridDim.y-th),
// the same rows for every CTA of a cluster. In the cluster regime a CTA
// re-zeroes its slice for the next row only after the barrier that ends the
// current row's adds, and exits only after it, so no CTA touches the shared
// memory of one that has left.
constexpr int kPackedThreads = 512;
constexpr int64_t kPackedMaxBins = 16384;  // bins of a packed block, all its rows: 64 KiB
constexpr int kClusterThreads = 512;
constexpr int kGlobalThreads = 512;
constexpr int kMaxCluster = 16;  // 8 is portable; 16 needs cudaFuncAttributeNonPortableClusterSizeAllowed
constexpr int64_t kMaxGrid = 65535;
constexpr int64_t kSliceAlign = 4;  // bins: a slice starts on 16 bytes of its row

enum Regime { kPacked = 0, kCluster = 1, kGlobal = 2 };

// Bins each CTA of a `split`-CTA cluster owns: ceil(length / split), rounded up to kSliceAlign.
__host__ __device__ __forceinline__ int64_t slice_bins(int64_t length, int64_t split) {
  const int64_t s = (length + split - 1) / split;
  return (s + kSliceAlign - 1) / kSliceAlign * kSliceAlign;
}

// Adds into the cluster's distributed histogram: bin b lives in CTA b / slice, at b % slice.
template <typename CountT>
struct ClusterSink {
  CountT* hist;  // this CTA's slice
  int slice;
  unsigned rank;
  __device__ __forceinline__ void operator()(int bin, CountT v) const {
    const unsigned owner = (unsigned)(bin / slice);
    CountT* base = owner == rank ? hist : cooperative_groups::this_cluster().map_shared_rank(hist, owner);
    atomicAdd(base + (bin - (int)owner * slice), v);
  }
};

// The lane's id i of row xr as a bin (kNoBin when i >= end or out of range) and its weight.
template <typename IdT, bool kWeighted>
__device__ __forceinline__ void load_id(const IdT* __restrict__ xr, const float* __restrict__ wr, int64_t i,
                                        int64_t end, int64_t length, int& bin, float& weight) {
  bin = kNoBin;
  weight = 0.0f;
  if (i < end) {
    const int64_t v = (int64_t)xr[i];  // compared at 64 bits
    if (v >= 0 && v < length) {
      bin = (int)v;
      if constexpr (kWeighted) weight = wr[i];
    }
  }
}

// Zeroes p[0, count) with 16-byte stores where aligned; `threads` threads from `tid`.
template <typename CountT>
__device__ __forceinline__ void zero_span(CountT* p, int64_t count, int tid, int threads) {
  int64_t head = (int64_t)(((16 - ((uintptr_t)p & 15)) & 15) / sizeof(CountT));
  if (head > count) head = count;
  for (int64_t b = tid; b < head; b += threads) p[b] = 0;
  int4* v = reinterpret_cast<int4*>(p + head);
  const int64_t nv = (count - head) / 4;
#pragma unroll 4
  for (int64_t b = tid; b < nv; b += threads) v[b] = make_int4(0, 0, 0, 0);
  for (int64_t b = head + nv * 4 + tid; b < count; b += threads) p[b] = 0;
}

template <typename IdT, typename CountT>
__global__ void __launch_bounds__(kPackedThreads)
    batched_packed_kernel(const IdT* __restrict__ x, int64_t x_row_stride, const float* __restrict__ w,
                          int64_t w_row_stride, int64_t n, int64_t rows, CountT* __restrict__ counts,
                          int64_t length, int per_block) {
  constexpr bool kWeighted = std::is_same<CountT, float>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  CountT* hists = reinterpret_cast<CountT*>(smem);  // per_block rows of `length` bins
  const int64_t groups = (rows + per_block - 1) / per_block;
  const unsigned row_ids = (unsigned)n;  // per_block * n < 2**31: the C entry checks it
  for (int64_t g = blockIdx.x; g < groups; g += gridDim.x) {
    const int64_t first = g * per_block;
    const int live = (int)(rows - first < per_block ? rows - first : per_block);  // rows of this group
    const int bins = live * (int)length;
    for (int b = threadIdx.x; b < bins; b += kPackedThreads) hists[b] = 0;
    __syncthreads();
    // the group's ids in one flat range, row-major: a row of 8 ids is 8 lanes' work, not a block's
    const unsigned ids = (unsigned)live * row_ids;
    for (unsigned base = 0; base < ids; base += kPackedThreads) {  // uniform bound: every lane takes every round
      const unsigned j = base + threadIdx.x;
      int bin = kNoBin;
      float weight = 0.0f;
      if (j < ids) {
        const unsigned r = j / row_ids, i = j - r * row_ids;
        const int64_t row = first + r;
        const int64_t v = (int64_t)x[row * x_row_stride + i];  // compared at 64 bits
        if (v >= 0 && v < length) {
          bin = (int)(r * length + v);  // the key is the block's bin: row and bin together
          if constexpr (kWeighted) weight = w[row * w_row_stride + i];
        }
      }
      add_aggregated(hists, bin, weight);
    }
    __syncthreads();
    CountT* out = counts + first * length;  // the group's rows are contiguous in the output
    for (int b = threadIdx.x; b < bins; b += kPackedThreads) out[b] = hists[b];
    __syncthreads();  // the histograms are read out before the next group zeroes them
  }
}

template <typename IdT, typename CountT>
__global__ void __launch_bounds__(kClusterThreads)
    batched_cluster_kernel(const IdT* __restrict__ x, int64_t x_row_stride, const float* __restrict__ w,
                           int64_t w_row_stride, int64_t n, int64_t rows, CountT* __restrict__ counts,
                           int64_t length, int slice) {
  constexpr bool kWeighted = std::is_same<CountT, float>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  CountT* hist = reinterpret_cast<CountT*>(smem);
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const unsigned split = cluster.num_blocks(), rank = cluster.block_rank();
  const int64_t lo = (int64_t)rank * slice;
  const int64_t own = lo >= length ? 0 : (length - lo < slice ? length - lo : slice);
  const int64_t per_cta = (n + split - 1) / split;
  const int64_t id_lo = rank * per_cta < n ? rank * per_cta : n;
  const int64_t id_hi = id_lo + per_cta < n ? id_lo + per_cta : n;
  const ClusterSink<CountT> sink{hist, slice, rank};
  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    for (int64_t b = threadIdx.x; b < own; b += kClusterThreads) hist[b] = 0;
    cluster.sync();  // every slice of the cluster is zero before the first add
    const IdT* xr = x + row * x_row_stride;
    const float* wr = kWeighted ? w + row * w_row_stride : nullptr;
    // the loop bound is uniform across the block: every lane of a warp takes every round
    for (int64_t base = id_lo; base < id_hi; base += kClusterThreads) {
      int bin;
      float weight;
      load_id<IdT, kWeighted>(xr, wr, base + threadIdx.x, id_hi, length, bin, weight);
      add_aggregated_to<CountT>(sink, bin, weight);
    }
    cluster.sync();  // every add of the row has landed, in every slice
    CountT* out = counts + row * length + lo;
    for (int64_t b = threadIdx.x; b < own; b += kClusterThreads) out[b] = hist[b];
  }
}

template <typename IdT, typename CountT>
__global__ void __launch_bounds__(kGlobalThreads)
    batched_global_kernel(const IdT* __restrict__ x, int64_t x_row_stride, const float* __restrict__ w,
                          int64_t w_row_stride, int64_t n, int64_t rows, CountT* __restrict__ counts,
                          int64_t length) {
  constexpr bool kWeighted = std::is_same<CountT, float>::value;
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const unsigned split = cluster.num_blocks(), rank = cluster.block_rank();
  const int64_t per_cta = (n + split - 1) / split;
  const int64_t id_lo = rank * per_cta < n ? rank * per_cta : n;
  const int64_t id_hi = id_lo + per_cta < n ? id_lo + per_cta : n;
  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    CountT* out = counts + row * length;
    // the cluster's threads zero the row together, neighbouring CTAs on neighbouring 16-byte stores: one
    // stream of writes a row, which the H100 takes faster than one stream a CTA's contiguous slice
    zero_span(out, length, (int)(rank * kGlobalThreads + threadIdx.x), (int)(split * kGlobalThreads));
    cluster.sync();  // release/acquire at cluster scope: the whole row is zero before any add
    const IdT* xr = x + row * x_row_stride;
    const float* wr = kWeighted ? w + row * w_row_stride : nullptr;
    for (int64_t base = id_lo; base < id_hi; base += kGlobalThreads) {
      int bin;
      float weight;
      load_id<IdT, kWeighted>(xr, wr, base + threadIdx.x, id_hi, length, bin, weight);
      add_aggregated(out, bin, weight);
    }
    // the next row is other memory: no barrier before its zeroing
  }
}

// Per device and kernel: the attributes set once (shared memory above 48 KiB,
// clusters of 16), or the error that setting them gave.
template <typename IdT, typename CountT>
cudaError_t batched_setup(int device) {
  static cudaError_t table[kMaxDevices];
  static std::once_flag once[kMaxDevices];
  std::call_once(once[device], [device] {
    cudaError_t e = cudaFuncSetAttribute((const void*)batched_packed_kernel<IdT, CountT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)(kPackedMaxBins * sizeof(CountT)));
    const void* clustered[] = {(const void*)batched_cluster_kernel<IdT, CountT>,
                               (const void*)batched_global_kernel<IdT, CountT>};
    for (const void* k : clustered) {
      if (e == cudaSuccess) e = cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(clustered[0], cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)(kSharedMaxBins * sizeof(CountT)));
    }
    table[device] = e;
  });
  return table[device];
}

template <typename Kernel, typename... Args>
cudaError_t launch_clustered(Kernel kernel, int split, int64_t grid, int threads, size_t smem, cudaStream_t stream,
                             Args... args) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)split, (unsigned)grid, 1);
  config.blockDim = dim3((unsigned)threads, 1, 1);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&config, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename IdT, typename CountT>
cudaError_t launch_batched(int regime, int split, int64_t grid, const void* x, int64_t x_row_stride, const void* w,
                           int64_t w_row_stride, int64_t n, int64_t rows, void* counts, int64_t length, int device,
                           cudaStream_t stream) {
  const cudaError_t e = batched_setup<IdT, CountT>(device);
  if (e != cudaSuccess) return e;
  const IdT* xp = (const IdT*)x;
  const float* wp = (const float*)w;
  CountT* cp = (CountT*)counts;
  if (regime == kPacked) {
    const size_t smem = (size_t)split * length * sizeof(CountT);
    batched_packed_kernel<IdT, CountT><<<(unsigned)grid, kPackedThreads, smem, stream>>>(
        xp, x_row_stride, wp, w_row_stride, n, rows, cp, length, split);
    return cudaGetLastError();
  }
  if (regime == kCluster) {
    const int64_t slice = slice_bins(length, split);
    return launch_clustered(batched_cluster_kernel<IdT, CountT>, split, grid, kClusterThreads,
                            (size_t)slice * sizeof(CountT), stream, xp, x_row_stride, wp, w_row_stride, n, rows, cp,
                            length, (int)slice);
  }
  return launch_clustered(batched_global_kernel<IdT, CountT>, split, grid, kGlobalThreads, 0, stream, xp,
                          x_row_stride, wp, w_row_stride, n, rows, cp, length);
}

template <typename IdT>
cudaError_t dispatch_batched(int regime, int split, int64_t grid, const void* x, int64_t x_row_stride, const void* w,
                             int64_t w_row_stride, int64_t n, int64_t rows, void* counts, int64_t length, int device,
                             cudaStream_t s) {
  if (w == nullptr) {
    return launch_batched<IdT, int>(regime, split, grid, x, x_row_stride, w, 0, n, rows, counts, length, device, s);
  }
  return launch_batched<IdT, float>(regime, split, grid, x, x_row_stride, w, w_row_stride, n, rows, counts, length,
                                    device, s);
}

// The largest cluster (16, 8, ... 1) of which one fits on the card at the
// cluster regime's largest slice, 128 KiB of shared memory a CTA
// (cudaOccupancyMaxActiveClusters), for the heaviest variant; 0 on an error.
int max_cluster(int device) {
  using IdT = int64_t;
  using CountT = float;
  if (batched_setup<IdT, CountT>(device) != cudaSuccess) return 0;
  for (int split = kMaxCluster; split >= 1; split /= 2) {
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3((unsigned)split, 1, 1);
    config.blockDim = dim3(kClusterThreads, 1, 1);
    config.dynamicSmemBytes = kSharedMaxBins * sizeof(CountT);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)split;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.attrs = attr;
    config.numAttrs = 1;
    int active = 0;
    if (cudaOccupancyMaxActiveClusters(&active, (const void*)batched_cluster_kernel<IdT, CountT>, &config) !=
        cudaSuccess) {
      cudaGetLastError();  // clear the refusal: the next size is asked
      continue;
    }
    if (active >= 1) return split;
  }
  return 0;
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

// The largest cluster size the batched form may be given on `device`: one
// such cluster fits at the largest slice (cudaOccupancyMaxActiveClusters). 0
// when none does or the device cannot be asked.
extern "C" int mt_bincount_batched_max_cluster(int device) {
  if (device < 0 || device >= kMaxDevices) return 0;
  static int table[kMaxDevices];
  static std::once_flag once[kMaxDevices];
  std::call_once(once[device], [device] { table[device] = max_cluster(device); });
  return table[device];
}

// The most bins of a block (all its rows) the packed regime takes.
extern "C" int64_t mt_bincount_batched_packed_max_bins() { return kPackedMaxBins; }

// The batched form. x: ids of id_bytes, row r at x + r * x_row_stride (in ids;
// 0 shares one row), n ids a row; w: float32 weights laid out the same with
// w_row_stride, or NULL; counts: rows x length bins of uninitialised memory,
// int32 when w is NULL, float32 otherwise, all written by the kernel. regime:
// 0 packed (split rows a block, split x length <= kPackedMaxBins and
// split x n < 2**31; grid blocks along x), 1 cluster (split CTAs a row, a power of two up to 16, each
// owning slice_bins(length, split) <= kSharedMaxBins bins; grid clusters along
// y), 2 global (split CTAs a row, a power of two up to 16, no limit on
// length). 1 <= grid <= 65535. One launch on `stream`, no synchronisation;
// cudaErrorInvalidValue for anything outside these limits.
extern "C" int mt_bincount_batched(const void* x, int id_bytes, int64_t x_row_stride, const void* w,
                                   int64_t w_row_stride, int64_t n, int64_t rows, void* counts, int64_t length,
                                   int regime, int split, int64_t grid, int device, void* stream) {
  const bool pow2 = split >= 1 && (split & (split - 1)) == 0;
  bool ok = n >= 0 && rows >= 1 && length >= 1 && length <= INT32_MAX && x_row_stride >= 0 && w_row_stride >= 0 &&
            (id_bytes == 4 || id_bytes == 8) && split >= 1 && grid >= 1 && grid <= kMaxGrid;
  if (regime == kPacked) {
    ok = ok && (int64_t)split * length <= kPackedMaxBins && (int64_t)split * n <= INT32_MAX;
  } else if (regime == kCluster) {
    ok = ok && pow2 && split <= kMaxCluster && slice_bins(length, split) <= kSharedMaxBins;
  } else {
    ok = ok && regime == kGlobal && pow2 && split <= kMaxCluster;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e =
      id_bytes == 4
          ? dispatch_batched<int32_t>(regime, split, grid, x, x_row_stride, w, w_row_stride, n, rows, counts, length,
                                      device, s)
          : dispatch_batched<int64_t>(regime, split, grid, x, x_row_stride, w, w_row_stride, n, rows, counts, length,
                                      device, s);
  return (int)e;
}
