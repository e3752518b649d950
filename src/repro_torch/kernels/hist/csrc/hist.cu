// Histogram kernel: linear bins (bin = value) or log2 bins (bin 0 holds 0,
// bin 1 + k holds [2^k, 2^(k+1))), int64 counts added into the output.
//
// Replaces repro/kernels/hist/hist.py::hist_counts (pallas_call at line 76,
// body _hist_kernel at line 30).  The TPU kernel expands each value tile
// into a one-hot tile and column-sums it, because the TPU has no scatter;
// Hopper has fast integer atomics, so each value is one atomic add.
//
// Semantics: negative values are padding and count nowhere.  A bin past
// the last is clamped into it (hist_counts) or, with drop set, counted
// nowhere (bincount_ids).  Integer atomics commute, so the counts are exact
// and do not depend on the order the threads run in.
//
// Bound on an H100: 8 bytes read per value plus the bins touched; a few
// integer operations per value, so it is bound by memory (and by atomic
// throughput where many values share a bin).  Design: for up to
// kSharedBins bins each block counts into shared memory (int32) and adds
// its nonzero counts to the output with one global 64-bit atomic per bin;
// above that (a degree section of 2^22 vertices) each value is one global
// 64-bit atomic straight into the output.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kSharedBins = 8192;  // 32 KB of int32 counters
constexpr int64_t kMaxBlocks = 132 * 16;

__device__ __forceinline__ int64_t bin_of(int64_t x, int64_t num_bins, int log2,
                                          int drop) {
  if (x < 0) return -1;
  const int64_t b = log2 ? (x == 0 ? 0 : 64 - __clzll(x)) : x;
  if (b >= num_bins) return drop ? -1 : num_bins - 1;
  return b;
}

__global__ void hist_shared_kernel(const int64_t* __restrict__ values, int64_t n,
                                   int64_t num_bins, int log2, int drop,
                                   unsigned long long* __restrict__ out) {
  extern __shared__ unsigned int counts[];
  for (int64_t b = threadIdx.x; b < num_bins; b += blockDim.x) counts[b] = 0;
  __syncthreads();
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t b = bin_of(values[i], num_bins, log2, drop);
    if (b >= 0) atomicAdd(&counts[b], 1u);
  }
  __syncthreads();
  for (int64_t b = threadIdx.x; b < num_bins; b += blockDim.x)
    if (counts[b]) atomicAdd(&out[b], (unsigned long long)counts[b]);
}

__global__ void hist_global_kernel(const int64_t* __restrict__ values, int64_t n,
                                   int64_t num_bins, int log2, int drop,
                                   unsigned long long* __restrict__ out) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t b = bin_of(values[i], num_bins, log2, drop);
    if (b >= 0) atomicAdd(&out[b], 1ull);
  }
}

}  // namespace

// values int64 [n]; out int64 [num_bins], added into (not overwritten).
// Returns the launch's cudaError_t.
extern "C" int hist(const void* values, long long n, long long num_bins, int log2,
                    int drop, void* out, void* stream) {
  if (n == 0 || num_bins == 0) return 0;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  cudaStream_t s = (cudaStream_t)stream;
  if (num_bins <= kSharedBins) {
    hist_shared_kernel<<<(unsigned)blocks, kThreads, num_bins * sizeof(unsigned int), s>>>(
        (const int64_t*)values, n, num_bins, log2, drop, (unsigned long long*)out);
  } else {
    hist_global_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        (const int64_t*)values, n, num_bins, log2, drop, (unsigned long long*)out);
  }
  return (int)cudaGetLastError();
}
