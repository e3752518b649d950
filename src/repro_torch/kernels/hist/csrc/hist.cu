// Histogram kernel: linear bins (bin = value) or log2 bins (bin 0 holds 0,
// bin 1 + k holds [2^k, 2^(k+1))), int64 counts added into the output.
//
// Replaces repro/kernels/hist/hist.py::hist_counts (pallas_call at line 76,
// body _hist_kernel at line 30).  The TPU kernel expands each value tile
// into a one-hot tile and column-sums it, because the TPU has no scatter;
// Hopper has fast integer atomics, so values are counted by atomic adds.
//
// Semantics: negative values are padding and count nowhere.  A bin past
// the last is clamped into it (hist_counts) or, with drop set, counted
// nowhere (bincount_ids).  Integer atomics commute, so the counts are exact
// and do not depend on the order the threads run in.
//
// Bound on an H100: 8 bytes read per value plus the bins touched; a few
// integer operations per value, so it is bound by memory, and by atomic
// throughput where many values share a bin.  Design: each thread reads two
// values with one 16-byte load (a scalar head and tail where the array is
// not 16-byte aligned or of odd length), and a warp adds equal bins
// together, one atomic per group with its count.  Up to kSharedBins bins
// (histograms of degrees: a few hot bins in any order) each block counts
// into shared memory (int32), grouping every equal bin of the warp
// (__match_any_sync), and adds its nonzero counts to the output with one
// global 64-bit atomic per bin.  Above that (the 2^22-vertex degree
// scatter) the warp's atomics go straight to the output, grouping runs of
// equal bins in adjacent lanes (a shuffle and a ballot): an edge list
// [u0, v0, u1, v1, ...] puts the sorted sources u in one lane's first
// value, so its runs of one u become one atomic; on an H100, at the ER
// collect's chunk, __match_any_sync there took longer than the atomics it
// saved.  The grid is sized to the card: at most kBlocksPerSM blocks per
// SM, each striding over the values.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kSharedBins = 8192;  // 32 KB of int32 counters
constexpr int kBlocksPerSM = 8;

__device__ __forceinline__ int64_t bin_of(int64_t x, int64_t num_bins, int log2,
                                          int drop) {
  if (x < 0) return -1;
  const int64_t b = log2 ? (x == 0 ? 0 : 64 - __clzll(x)) : x;
  if (b >= num_bins) return drop ? -1 : num_bins - 1;
  return b;
}

// Count one bin per lane (-1: nothing); every lane of the warp calls it.
// Into shared counters, lanes with equal bins add once, with their count;
// into the output, each run of equal bins in adjacent lanes does, from
// its first lane.
template <bool Shared>
__device__ __forceinline__ void count(int64_t b, unsigned* scount, unsigned long long* out) {
  const int lane = threadIdx.x & 31;
  if (Shared) {
    const unsigned peers = __match_any_sync(~0u, (unsigned long long)b);
    if (b >= 0 && lane == __ffs(peers) - 1) atomicAdd(&scount[b], (unsigned)__popc(peers));
  } else {
    const int64_t prev = __shfl_up_sync(~0u, b, 1);
    const unsigned heads = __ballot_sync(~0u, lane == 0 || b != prev);
    if (b >= 0 && ((heads >> lane) & 1)) {
      const unsigned above = heads >> lane >> 1;
      atomicAdd(&out[b], (unsigned long long)(above ? __ffs(above) : 32 - lane));
    }
  }
}

template <bool Shared>
__global__ void __launch_bounds__(kThreads)
hist_kernel(const int64_t* __restrict__ values, int64_t n, int64_t num_bins, int log2, int drop,
            unsigned long long* __restrict__ out) {
  extern __shared__ unsigned int counts[];
  if (Shared) {
    for (int64_t b = threadIdx.x; b < num_bins; b += blockDim.x) counts[b] = 0;
    __syncthreads();
  }
  // a scalar head up to 16-byte alignment, pairs, a scalar tail
  const int64_t head = ((uintptr_t)values & 15) && n ? 1 : 0;
  const int64_t pairs = (n - head) / 2;
  const int64_t tail = head + 2 * pairs < n ? head + 2 * pairs : -1;
  const longlong2* body = reinterpret_cast<const longlong2*>(values + head);
  const int64_t lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * (kThreads / 32);
  const int64_t gwarp = (int64_t)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (gwarp == 0) {
    // the warp-uniform edge cases: the head and the tail value
    const int64_t i = lane == 0 && head ? 0 : (lane == 1 && tail >= 0 ? tail : -1);
    count<Shared>(i >= 0 ? bin_of(values[i], num_bins, log2, drop) : -1, counts, out);
  }
  // every lane of a warp runs the same number of steps
  for (int64_t base = gwarp * 32; base < pairs; base += warps * 32) {
    const int64_t i = base + lane;
    longlong2 v = make_longlong2(-1, -1);
    if (i < pairs) v = __ldg(body + i);
    count<Shared>(bin_of(v.x, num_bins, log2, drop), counts, out);
    count<Shared>(bin_of(v.y, num_bins, log2, drop), counts, out);
  }
  if (Shared) {
    __syncthreads();
    for (int64_t b = threadIdx.x; b < num_bins; b += blockDim.x)
      if (counts[b]) atomicAdd(&out[b], (unsigned long long)counts[b]);
  }
}

// the current card's grid cap, read once a card (a process may launch on
// several cards); 0 when the card cannot be read
constexpr int kMaxCards = 64;

int max_blocks() {
  static int cached[kMaxCards] = {};
  int dev, sms;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < kMaxCards && cached[dev]) return cached[dev];
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  if (dev < kMaxCards) cached[dev] = sms * kBlocksPerSM;
  return sms * kBlocksPerSM;
}

}  // namespace

// values int64 [n]; out int64 [num_bins], added into (not overwritten).
// Returns the launch's cudaError_t.
extern "C" int hist(const void* values, long long n, long long num_bins, int log2,
                    int drop, void* out, void* stream) {
  if (n == 0 || num_bins == 0) return 0;
  const int cap = max_blocks();
  if (!cap) return (int)cudaGetLastError();
  long long blocks = (n / 2 + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > cap) blocks = cap;
  cudaStream_t s = (cudaStream_t)stream;
  if (num_bins <= kSharedBins)
    hist_kernel<true><<<(unsigned)blocks, kThreads, num_bins * sizeof(unsigned int), s>>>(
        (const int64_t*)values, n, num_bins, log2, drop, (unsigned long long*)out);
  else
    hist_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const int64_t*)values, n, num_bins, log2, drop, (unsigned long long*)out);
  return (int)cudaGetLastError();
}
