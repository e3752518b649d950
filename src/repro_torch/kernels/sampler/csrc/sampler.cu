// Chunk sampler kernels for the engine's sampled chunk kinds
// (DIRECTED / TRI / RECT), one launch over every row of a [R, cap] batch.
//
// chunk_draw replaces the draw of repro/core/sampling.py::_sample_collision
// (lines 110-113) over repro/core/prng.py::counter_bits64 (line 129), in its
// first round and in its duplicate-redraw rounds (lines 125-130).
// chunk_decode replaces decode_directed / decode_tri / decode_rect
// (repro/core/sampling.py:155-184) and the keep mask of
// repro/distrib/engine.py::_edge_chunk_fn (lines 404-424, 468).  XLA lowers
// that reference path from jnp; it reaches no Pallas kernel.
//
// What bounds them on an H100, and what the design does about it:
// * chunk_draw does three Threefry-2x32 (20 rounds each) and one 64-bit
//   modulo per slot, some 300 integer instructions, against 8 bytes
//   written: it is bound by integer issue, not by memory.  One thread per
//   slot, no shared state but the row's round key, which thread 0 of each
//   block derives once; redraw rounds skip the Threefry work on every slot
//   that is not a duplicate and only copy it.
// * chunk_decode reads 8 bytes and writes 17 per slot with a handful of
//   integer operations (one f64 sqrt on TRI rows): it is bound by memory.
//   Edges are stored as one 16-byte longlong2 per slot, so a warp writes
//   512 contiguous bytes.
//
// Exactness: the draws are JAX's bits (threefry.cuh), and the TRI decode
// keeps the reference's f64 estimate and its three int64 fix-up steps.
// The library is compiled with -fmad=false so that 1 + 8x is not
// contracted into an FMA; the products of the fix-up wrap in int64 as
// XLA's do (computed unsigned, then shifted arithmetically).
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kKindEmpty = 0, kKindDirected = 1, kKindTri = 2, kKindRect = 3;

__global__ void chunk_draw_kernel(const uint32_t* __restrict__ key,
                                  const int64_t* __restrict__ universe,
                                  const int64_t* __restrict__ count,
                                  uint32_t t, int64_t capacity,
                                  int64_t blocks_per_row,
                                  const int64_t* __restrict__ sorted_in,
                                  const bool* __restrict__ active,
                                  int64_t* __restrict__ out) {
  const int64_t r = blockIdx.x / blocks_per_row;
  const int64_t i = (blockIdx.x % blocks_per_row) * kThreads + threadIdx.x;
  __shared__ Key2x32 round_key;
  if (threadIdx.x == 0) round_key = tf_fold_in(Key2x32{key[2 * r], key[2 * r + 1]}, t);
  __syncthreads();
  if (i >= capacity) return;
  const int64_t at = r * capacity + i;
  if (sorted_in != nullptr) {
    // redraw by sorted position: only a value equal to its predecessor
    // takes a fresh draw, finished rows stay as they are
    const int64_t s = sorted_in[at];
    if (!active[r] || i == 0 || s != sorted_in[at - 1]) {
      out[at] = s;
      return;
    }
  }
  const int64_t u = universe[r];
  if (i < count[r]) {
    const uint64_t m = u > 1 ? (uint64_t)u : 1ull;
    out[at] = (int64_t)(tf_bits64(round_key, (uint32_t)i) % m);
  } else {
    out[at] = u + i;  // sentinel: unique and out of range
  }
}

// k (k - 1) / 2 with int64 wraparound, floor division by 2
__device__ __forceinline__ int64_t tri(int64_t k) {
  return ((int64_t)((uint64_t)k * (uint64_t)(k - 1))) >> 1;
}

__global__ void chunk_decode_kernel(const int64_t* __restrict__ vals,
                                    const int32_t* __restrict__ kind,
                                    const int64_t* __restrict__ params,
                                    const int64_t* __restrict__ count,
                                    const bool* __restrict__ owned,
                                    int64_t capacity, int64_t blocks_per_row,
                                    longlong2* __restrict__ edges,
                                    bool* __restrict__ keep) {
  const int64_t r = blockIdx.x / blocks_per_row;
  const int64_t i = (blockIdx.x % blocks_per_row) * kThreads + threadIdx.x;
  if (i >= capacity) return;
  const int64_t at = r * capacity + i;
  const int64_t idx = vals[at];  // >= 0: a draw or a sentinel
  const int k = kind[r];
  const int64_t p0 = params[3 * r], p1 = params[3 * r + 1], p2 = params[3 * r + 2];
  int64_t u = 0, v = 0;
  if (k == kKindDirected) {  // p0 = row_lo, p1 = n
    const int64_t n1 = p1 > 1 ? p1 - 1 : 1;
    const int64_t c = idx % n1;
    u = p0 + idx / n1;
    v = c + (c >= u ? 1 : 0);
  } else if (k == kKindTri) {  // p0 = lo
    const double e = __dadd_rn(1.0, __dmul_rn(8.0, (double)idx));
    int64_t row = (int64_t)floor(__dadd_rn(1.0, sqrt(e)) / 2.0);
    for (int s = 0; s < 3; ++s)
      row = row - (tri(row) > idx ? 1 : 0) + (tri(row + 1) <= idx ? 1 : 0);
    u = p0 + row;
    v = p0 + idx - tri(row);
  } else if (k == kKindRect) {  // p0 = width, p1 = row_lo, p2 = col_lo
    const int64_t w = p0 > 1 ? p0 : 1;
    u = p1 + idx / w;
    v = p2 + idx % w;
  }
  edges[at] = make_longlong2(u, v);
  keep[at] = i < count[r] && owned[r] && k != kKindEmpty;
}

int grid_for(long long rows, long long capacity, long long* blocks_per_row,
             unsigned* grid) {
  *blocks_per_row = (capacity + kThreads - 1) / kThreads;
  const long long blocks = rows * *blocks_per_row;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  *grid = (unsigned)blocks;
  return 0;
}

}  // namespace

// key uint32 [R, 2]; universe, count int64 [R]; out int64 [R, capacity].
// Redraw mode: sorted_in int64 [R, capacity] and active bool [R], both
// non-null.  Returns the launch's cudaError_t.
extern "C" int chunk_draw(const void* key, const void* universe, const void* count,
                          long long t, long long rows, long long capacity,
                          const void* sorted_in, const void* active, void* out,
                          void* stream) {
  if (rows == 0 || capacity == 0) return 0;
  long long bpr;
  unsigned grid;
  if (int err = grid_for(rows, capacity, &bpr, &grid)) return err;
  chunk_draw_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)key, (const int64_t*)universe, (const int64_t*)count,
      (uint32_t)t, capacity, bpr, (const int64_t*)sorted_in, (const bool*)active,
      (int64_t*)out);
  return (int)cudaGetLastError();
}

// vals int64 [R, capacity]; kind int32 [R]; params int64 [R, 3];
// count int64 [R]; owned bool [R]; edges int64 [R, capacity, 2];
// keep bool [R, capacity].  Returns the launch's cudaError_t.
extern "C" int chunk_decode(const void* vals, const void* kind, const void* params,
                            const void* count, const void* owned, long long rows,
                            long long capacity, void* edges, void* keep,
                            void* stream) {
  if (rows == 0 || capacity == 0) return 0;
  long long bpr;
  unsigned grid;
  if (int err = grid_for(rows, capacity, &bpr, &grid)) return err;
  chunk_decode_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)vals, (const int32_t*)kind, (const int64_t*)params,
      (const int64_t*)count, (const bool*)owned, capacity, bpr,
      (longlong2*)edges, (bool*)keep);
  return (int)cudaGetLastError();
}
