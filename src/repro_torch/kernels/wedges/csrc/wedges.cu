// close_wedges: the wedge-closing membership test of sampled clustering,
// pass 2.  For every sample s and every valid slot (u, v) of one stream
// buffer, count the slots whose two endpoints are both in s's sorted,
// sentinel-padded neighbour row, and add the count into out[s].
//
// Replaces repro/stats/accumulate.py::_close_wedges (lines 42-57), jitted
// jnp (a vmapped searchsorted over samples x edges); it reaches no Pallas
// kernel.
//
// What bounds it on an H100, and what the design does about it: the
// work is two binary searches per valid slot and sample (integer issue),
// the bytes are the buffer's validity and its valid edges, read once.  A
// block takes a group of samples whose rows fit in shared memory together
// (8 bytes a neighbour: all 64 default samples at up to about 440
// neighbours each, 3 at the default cap of 8192, past the 48 KiB default
// by the opt-in limit; rows too wide for one are searched in place in
// global memory, 16 samples a group) and a slice of the buffer.  A lane
// takes 16 slots at a time, their validity in one 16-byte load (or the
// prefix length of a chunk buffer); then the warp walks its valid slots
// one at a time, each lane searching its own rows of the group for the
// slot's edge (one broadcast 16-byte load).  So the cost follows the
// edges, not the slots (pair buffers hold an edge in about 1 % of
// theirs), no lane waits on another's searches, and a group reads the
// mask once.  Rows that are all sentinel (no neighbours, or past the
// cap) are skipped.  Hits go to a shared counter per sample; one atomic
// per block and sample at the end.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 16;                  // slots a thread takes at a time
constexpr int kGlobalGroup = 16;            // samples a block, rows in global memory
constexpr int64_t kSentinel = 1LL << 62;   // stats/accumulate.py _NB_SENTINEL

__device__ __forceinline__ bool member(const int64_t* row, int64_t width, int64_t q) {
  int64_t lo = 0, hi = width;   // first position whose value is >= q
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (row[mid] < q) lo = mid + 1; else hi = mid;
  }
  return lo < width && row[lo] == q;
}

template <bool kShared>
__global__ void close_wedges_kernel(const longlong2* __restrict__ edges,
                                    const uint8_t* __restrict__ mask, bool mask_vec,
                                    int64_t n, const int64_t* __restrict__ nb,
                                    int64_t samples, int64_t width, int64_t group,
                                    int64_t slices, unsigned long long* __restrict__ out) {
  extern __shared__ int64_t smem[];
  const int64_t g0 = (blockIdx.x / slices) * group;
  const int64_t slice = blockIdx.x % slices;
  const int G = (int)(samples - g0 < group ? samples - g0 : group);
  const int64_t* rows = kShared ? smem : nb + g0 * width;
  unsigned long long* hits = (unsigned long long*)(smem + (kShared ? group * width : 0));
  if (kShared)
    for (int64_t j = threadIdx.x; j < G * width; j += kThreads) smem[j] = nb[g0 * width + j];
  for (int g = threadIdx.x; g < G; g += kThreads) hits[g] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t warps = slices * (kThreads / 32);
  const int64_t warp = slice * (kThreads / 32) + (threadIdx.x >> 5);
  // a warp takes 32 x 16 consecutive slots at a time, a lane 16 of them
  for (int64_t wbase = warp * 32 * kSlots; wbase < n; wbase += warps * 32 * kSlots) {
    const int64_t base = wbase + lane * kSlots;
    uint32_t valid = 0;   // bit k: slot base + k holds an edge
    if (base < n) {
      if (mask == nullptr) {
        const int64_t left = n - base;
        valid = left >= kSlots ? 0xFFFFu : (1u << left) - 1u;
      } else if (mask_vec && base + kSlots <= n) {
        const uint4 m = *reinterpret_cast<const uint4*>(mask + base);
        const uint32_t w[4] = {m.x, m.y, m.z, m.w};
        for (int k = 0; k < kSlots; ++k)
          valid |= (((w[k >> 2] >> (8 * (k & 3))) & 0xFFu) ? 1u : 0u) << k;
      } else {
        for (int k = 0; k < kSlots && base + k < n; ++k) valid |= (mask[base + k] ? 1u : 0u) << k;
      }
    }
    // the warp's valid slots one at a time, every lane searching its rows
    for (uint32_t pending = __ballot_sync(0xffffffffu, valid != 0); pending;
         pending &= pending - 1) {
      const int src = __ffs(pending) - 1;
      uint32_t v = __shfl_sync(0xffffffffu, valid, src);
      const int64_t sbase = wbase + src * kSlots;
      while (v) {
        const longlong2 uv = edges[sbase + __ffs(v) - 1];
        v &= v - 1;
        for (int g = lane; g < G; g += 32) {
          const int64_t* row = rows + g * width;
          if (row[0] == kSentinel) continue;
          if (member(row, width, uv.x) && member(row, width, uv.y)) atomicAdd(hits + g, 1ull);
        }
      }
    }
  }
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += kThreads)
    if (hits[g]) atomicAdd(out + g0 + g, hits[g]);
}

}  // namespace

// edges int64 [N, 2] (16-byte aligned); mask bool [N] or null, when null
// the first n slots are valid; nb int64 [S, width] sorted rows padded with
// 2^62; out int64 [S], added into.  Returns the launch's cudaError_t.
extern "C" int close_wedges(const void* edges, const void* mask, long long n,
                            const void* nb, long long samples, long long width,
                            void* out, void* stream) {
  if (n <= 0 || samples <= 0 || width <= 0) return 0;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const long long per_sample = width * (long long)sizeof(int64_t) + 8;   // its row, its counter
  const bool shared = per_sample <= optin;
  long long group = shared ? optin / per_sample : kGlobalGroup;
  if (group > samples) group = samples;
  const long long groups = (samples + group - 1) / group;
  // enough blocks to fill the card several times over, none with fewer
  // than 4096 slots
  long long slices = (n + kThreads * kSlots - 1) / (kThreads * kSlots);
  const long long most = (1056 + groups - 1) / groups;
  if (slices > most) slices = most;
  if (groups * slices > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  const size_t bytes = (size_t)group * (shared ? per_sample : 8);
  const unsigned grid = (unsigned)(groups * slices);
  const bool vec = mask != nullptr && (uintptr_t)mask % 16 == 0;
  if (shared) {
    if (bytes > 48 * 1024)
      err = cudaFuncSetAttribute(close_wedges_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    close_wedges_kernel<true><<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
        (const longlong2*)edges, (const uint8_t*)mask, vec, n, (const int64_t*)nb, samples,
        width, group, slices, (unsigned long long*)out);
  } else {
    close_wedges_kernel<false><<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
        (const longlong2*)edges, (const uint8_t*)mask, vec, n, (const int64_t*)nb, samples,
        width, group, slices, (unsigned long long*)out);
  }
  return (int)cudaGetLastError();
}
