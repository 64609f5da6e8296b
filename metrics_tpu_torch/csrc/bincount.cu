// Bincount by global atomics, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_bincount_kernel` in metrics_tpu/ops/histogram.py
// (launched by `_pallas_weighted_bincount`). Same function:
//     counts[l] = sum_i w[i] * [x[i] == l]   for 0 <= l < length,
// with ids outside [0, length) dropped (the pad sentinel -1 among them).
// Unweighted counts are int32 atomics, so they are exact and independent of
// the order the atomics land in. Weighted counts are float32 atomics whose
// order changes from run to run.
//
// Design. The TPU kernel forms a one-hot tile per 512 ids x 512 labels and
// feeds it to the MXU: O(N*L) compares to avoid scatters, which serialise
// there. Hopper has fast atomics in L2, so a bincount is a scatter: one pass
// over x, a grid-stride loop, one atomicAdd per valid id. Every id is read
// once and every touched bin updated in L2.
//
// Bound. Bytes: 4N (or 8N for int64 ids) read, plus 4N of weights, plus 4L
// written by the caller's zero fill. At the confusion-matrix shape of the
// headline suite (N = 8192, L = 16384) that is 96 KiB, about 0.03 us at
// 3.35 TB/s, so the call is bound by its launch, not by the card.
//
// Each entry point launches on the caller's stream, does not synchronise and
// returns cudaGetLastError(), which the Python wrapper checks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 resident blocks of 256 threads on each of 132 SMs

template <typename IdT>
__global__ void bincount_unweighted_kernel(const IdT* __restrict__ x, int64_t n,
                                           int* __restrict__ counts, int64_t length) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    // compared at 64 bits: an int64 id of 2**32 + 5 is out of range, not bin 5
    const int64_t v = (int64_t)x[i];
    if (v >= 0 && v < length) atomicAdd(counts + v, 1);
  }
}

template <typename IdT>
__global__ void bincount_weighted_kernel(const IdT* __restrict__ x, const float* __restrict__ w,
                                         int64_t n, float* __restrict__ counts, int64_t length) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int64_t v = (int64_t)x[i];
    if (v >= 0 && v < length) atomicAdd(counts + v, w[i]);
  }
}

int grid_for(int64_t n) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  return (int)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

template <typename IdT>
int launch(const void* x, const void* w, int64_t n, void* counts, int64_t length, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (w == nullptr) {
    bincount_unweighted_kernel<IdT><<<grid_for(n), kThreads, 0, s>>>(
        (const IdT*)x, n, (int*)counts, length);
  } else {
    bincount_weighted_kernel<IdT><<<grid_for(n), kThreads, 0, s>>>(
        (const IdT*)x, (const float*)w, n, (float*)counts, length);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x: n ids (int32 or int64); w: n float32 weights or NULL; counts: length
// zeroed bins, int32 when w is NULL, float32 otherwise. n must be > 0.
extern "C" int mt_bincount_i32(const void* x, const void* w, int64_t n, void* counts,
                               int64_t length, void* stream) {
  return launch<int32_t>(x, w, n, counts, length, stream);
}

extern "C" int mt_bincount_i64(const void* x, const void* w, int64_t n, void* counts,
                               int64_t length, void* stream) {
  return launch<int64_t>(x, w, n, counts, length, stream);
}
