// close_wedges: the wedge-closing membership test of sampled clustering,
// pass 2.  For every valid slot (u, v) of one stream buffer, add one to
// out[s] for each sample s whose neighbour row holds both u and v.
//
// Replaces repro/stats/accumulate.py::_close_wedges (lines 41-57), jitted
// jnp (a vmapped searchsorted over samples x edges); it reaches no Pallas
// kernel.
//
// What bounds it on an H100, and what the design does about it: the
// function must read the buffer's validity and its valid edges once (16
// bytes an edge); the sample rows hold a few thousand of the graph's
// millions of vertices, so nearly every edge has an endpoint in none of
// them.  So the loop is edge-major, over the union of the rows, built
// once per sampler (table.py): its keys by linear probing in 2^log_t
// slots, each slot's samples as an ascending list, and a filter of two
// bits in one 32-bit word a key.  A lane takes one valid slot at a time:
// it looks u up in the filter, staged in shared memory (one load), and
// on a miss (nearly always) it is done; else it probes u's keys in global
// memory (L2), then v, and on a second hit merges the two sample lists,
// counting each common sample.  A warp takes 512 slots of a masked buffer
// at a time: a lane reads the mask of 16 in one 16-byte load, a tile ahead
// of their use, the warp lists its valid slots in shared memory and its
// lanes take them 32 at a time, four edge loads in flight each, so a dense
// stripe costs a probe a slot and a sparse one no more lane steps than it
// has edges; a chunk buffer's prefix goes 128 slots a warp at a time.  Persistent blocks, as many as
// fit on the SMs, walk the buffer, so the filter is staged once a block
// (cp.async).  Hits go to shared per-sample counters (to out itself past
// kCountBytes), one atomic per block and sample at the end.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 16;                   // slots whose mask a lane reads at once
constexpr int kTile = 32 * kSlots;           // slots a warp takes at a time, masked
constexpr int kInFlight = 4;                 // edge loads a lane has in flight
constexpr int kPrefixTile = 32 * kInFlight;  // slots a warp takes at a time, a prefix
constexpr long long kCountBytes = 16 * 1024; // shared per-sample counters up to this
constexpr long long kEmpty = -1;                                  // table.py EMPTY
constexpr unsigned long long kMulSlot = 0x9E3779B97F4A7C15ull;    // table.py MUL_SLOT
constexpr unsigned long long kMulFilter = 0xC2B2AE3D27D4EB4Full;  // table.py MUL_FILTER

// q's filter entry (table.py filter_entry): the top log_f + 5 bits of q *
// kMulFilter are its word, then two bit positions in it
__device__ __forceinline__ bool listed(long long q, const unsigned* filt, int log_f) {
  const unsigned x = (unsigned)(((unsigned long long)q * kMulFilter) >> (59 - log_f));
  const unsigned w = filt[x >> 10];
  return (w >> ((x >> 5) & 31)) & (w >> (x & 31)) & 1u;
}

// the slot of q among the table's keys, or -1 (table.py probe; at most
// every slot once, should a table have no empty one)
__device__ __forceinline__ int find(long long q, const long long* __restrict__ keys, int log_t,
                                    const unsigned* filt, int log_f) {
  if (!listed(q, filt, log_f)) return -1;
  const unsigned m = (1u << log_t) - 1u;
  unsigned h = (unsigned)(((unsigned long long)q * kMulSlot) >> (64 - log_t));
  for (unsigned i = 0; i <= m; ++i, h = (h + 1) & m) {
    const long long k = __ldg(keys + h);
    if (k == kEmpty) return -1;
    if (k == q) return (int)h;
  }
  return -1;
}

// the mask bytes of slots [base, base + kSlots) that lie below n (0 past it)
__device__ __forceinline__ uint4 mask_bytes(const uint8_t* mask, int64_t base, int64_t n,
                                            bool vec) {
  if (vec && base + kSlots <= n) return *reinterpret_cast<const uint4*>(mask + base);
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int k = 0; k < kSlots; ++k)
    if (base + k < n) w[k >> 2] |= (uint32_t)mask[base + k] << (8 * (k & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// bit k: byte k of w is non-zero
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t w) {
  const uint32_t high = (((w & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | w) & 0x80808080u;
  return ((high >> 7) * 0x01020408u) >> 24;   // byte 3 gathers the four bits
}

// bit k: mask byte k is non-zero
__device__ __forceinline__ uint32_t valid_bits(uint4 m) {
  return nonzero_bytes(m.x) | nonzero_bytes(m.y) << 4 | nonzero_bytes(m.z) << 8 |
         nonzero_bytes(m.w) << 12;
}

__global__ void __launch_bounds__(kThreads)
close_wedges_kernel(const longlong2* __restrict__ edges, const uint8_t* __restrict__ mask,
                    bool mask_vec, int64_t n, const long long* __restrict__ hkey, int log_t,
                    const int64_t* __restrict__ off, const int* __restrict__ ids,
                    const unsigned* __restrict__ filt, int log_f, int samples,
                    bool shared_counts, unsigned long long* __restrict__ out) {
  // shared memory: [the filter][per-sample counters][a slot list a warp]
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* filt_sh = smem;
  const int filt_bytes = 1 << (log_f - 3);
  unsigned long long* counts = shared_counts ? (unsigned long long*)(smem + filt_bytes) : out;
  unsigned short* list = (unsigned short*)(smem + filt_bytes +
                                           (shared_counts ? (size_t)samples * 8 : 0)) +
                         (threadIdx.x >> 5) * kTile;
  for (int j = 16 * threadIdx.x; j < filt_bytes; j += 16 * kThreads)
    __pipeline_memcpy_async(filt_sh + j, (const unsigned char*)filt + j, 16);
  __pipeline_commit();
  if (shared_counts)
    for (int s = threadIdx.x; s < samples; s += kThreads) counts[s] = 0;
  __pipeline_wait_prior(0);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const bool prefix = mask == nullptr;
  const int tile = prefix ? kPrefixTile : kTile;
  const int64_t step = (int64_t)gridDim.x * kWarps * tile;
  int64_t wbase = ((int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5)) * tile;
  // a masked tile's bytes are loaded a tile ahead, in flight while the warp
  // works on the one before
  uint4 ahead = prefix ? make_uint4(0, 0, 0, 0)
                       : mask_bytes(mask, wbase + lane * kSlots, n, mask_vec);
  for (; wbase < n; wbase += step) {
    // this tile's valid slots: list[0, total) (a mask), or its first total (a prefix)
    int total;
    if (prefix) {
      total = n - wbase < tile ? (int)(n - wbase) : tile;
    } else {
      uint32_t valid = valid_bits(ahead);
      ahead = mask_bytes(mask, wbase + step + lane * kSlots, n, mask_vec);
      const int mine = __popc(valid);
      int scan = mine;   // inclusive prefix sum over the lanes
      for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, scan, d);
        if (lane >= d) scan += t;
      }
      total = __shfl_sync(0xffffffffu, scan, 31);
      for (int at = scan - mine; valid; valid &= valid - 1)
        list[at++] = (unsigned short)(lane * kSlots + __ffs(valid) - 1);
      __syncwarp();
    }
    for (int j0 = 0; j0 < total; j0 += kPrefixTile) {
      longlong2 e[kInFlight];
#pragma unroll
      for (int k = 0; k < kInFlight; ++k) {
        const int j = j0 + k * 32 + lane;
        if (j < total) e[k] = edges[wbase + (prefix ? j : list[j])];
      }
#pragma unroll
      for (int k = 0; k < kInFlight; ++k) {
        if (j0 + k * 32 + lane >= total) break;
        const int hu = find(e[k].x, hkey, log_t, (const unsigned*)filt_sh, log_f);
        if (hu < 0) continue;
        const int hv = find(e[k].y, hkey, log_t, (const unsigned*)filt_sh, log_f);
        if (hv < 0) continue;
        // the samples listed under both: merge the two ascending lists
        for (int64_t a = off[hu], a_end = off[hu + 1], b = off[hv], b_end = off[hv + 1];
             a < a_end && b < b_end;) {
          const int x = ids[a], y = ids[b];
          if (x == y) atomicAdd(counts + x, 1ull);
          a += x <= y;
          b += y <= x;
        }
      }
    }
    __syncwarp();   // the next tile rewrites the list
  }
  if (!shared_counts) return;
  __syncthreads();
  for (int s = threadIdx.x; s < samples; s += kThreads)
    if (counts[s]) atomicAdd(out + s, counts[s]);
}

// The current card's SM count and the blocks of `bytes` of shared memory
// an SM holds, read once a card and shared size: a process may launch on
// several cards, each with an entry of its own (a thread's own, so that two
// threads launching at two shared sizes do not mix their entries).
constexpr int kMaxCards = 64;

struct Occupancy {
  int sms = 0, per_sm = 0;
  size_t bytes = 0;
};

cudaError_t occupancy(size_t bytes, int* sms, int* per_sm) {
  static thread_local Occupancy cached[kMaxCards];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  Occupancy fresh, *o = dev < kMaxCards ? &cached[dev] : &fresh;
  if (o->sms == 0) err = cudaDeviceGetAttribute(&o->sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && (o->per_sm == 0 || o->bytes != bytes)) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o->per_sm, close_wedges_kernel,
                                                        kThreads, bytes);
    o->bytes = bytes;
  }
  *sms = o->sms;
  *per_sm = o->per_sm;
  return err;
}

}  // namespace

// edges int64 [N, 2] (16-byte aligned); mask bool [N] or null, when null
// the first n slots are valid; the table (table.py WedgeTable): hkey int64
// [2^log_t], off int64 [2^log_t + 1], ids int32, filt int32 [2^log_f /
// 32] (16-byte aligned); out int64 [samples], added into.  Returns the
// launch's cudaError_t.
extern "C" int close_wedges(const void* edges, const void* mask, long long n, const void* hkey,
                            long long log_t, const void* off, const void* ids, const void* filt,
                            long long log_f, long long samples, void* out, void* stream) {
  if (n <= 0 || samples <= 0) return 0;
  if (log_t < 4 || log_t > 31 || log_f < 10 || log_f > 27 || samples > INT_MAX ||
      (uintptr_t)filt % 16)
    return (int)cudaErrorInvalidValue;
  const bool shared_counts = samples * 8 <= kCountBytes;
  const size_t bytes = (shared_counts ? (size_t)samples * 8 : 0) + ((size_t)1 << (log_f - 3)) +
                       (size_t)kWarps * kTile * sizeof(unsigned short);
  cudaError_t err = cudaSuccess;
  if (bytes > 48 * 1024)
    err = cudaFuncSetAttribute(close_wedges_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
  int sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = occupancy(bytes, &sms, &per_sm);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long per_block = (long long)kWarps * (mask ? kTile : kPrefixTile);
  long long blocks = (n + per_block - 1) / per_block;
  if (blocks > (long long)per_sm * sms) blocks = (long long)per_sm * sms;
  const bool vec = mask != nullptr && (uintptr_t)mask % 16 == 0;
  close_wedges_kernel<<<(unsigned)blocks, kThreads, bytes, (cudaStream_t)stream>>>(
      (const longlong2*)edges, (const uint8_t*)mask, vec, n, (const long long*)hkey, log_t,
      (const int64_t*)off, (const int*)ids, (const unsigned*)filt, log_f, (int)samples,
      shared_counts, (unsigned long long*)out);
  return (int)cudaGetLastError();
}
