// Chunk kernels of the engine's edge program, one launch over every row of
// a [R, cap] batch: the sampler for the sampled kinds (DIRECTED / TRI /
// RECT), and the per-edge programs of R-MAT and BA rows.
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
// chunk_rmat replaces the RMAT branch of repro/distrib/engine.py::
// _edge_chunk_fn (lines 426-444), the quadrant descent of
// repro/core/rmat.py::_rmat_edges (lines 26-40).  chunk_ba replaces its BA
// branch (lines 446-465), the chain resolution of
// repro/core/ba.py::_resolve_targets (lines 33-48).  Both are jitted jnp in
// the reference; neither reaches a Pallas kernel.
// * chunk_rmat: one thread per edge slot; fold_in64 (2 Threefry blocks)
//   and log_n blocks for the uniforms, against 17 bytes written: bound by
//   integer issue (about 65 ms of Threefry for RMAT(26, 2^30) at the int32
//   peak of 128 lanes a SM, against 5.4 ms of stores).  Rows of other kinds are skipped, or
//   written as (0, 0) and not kept when the launch fills the output.
// * chunk_ba: one thread per edge slot walks its position chain; a step is
//   fold_in64, a split and two 64-bit words (6 blocks) and four unsigned
//   64-bit remainders.  Chains are short (O(log) w.h.p.) but a warp waits
//   for its longest one; the launch can count the steps it took and the
//   steps its warps issued (32 times each warp's longest chain; a warp
//   sum and max, two atomics a warp), so the bound and the cost of the
//   waiting are read from the run.
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
constexpr int kKindRmat = 4, kKindBa = 5;

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

__global__ void chunk_rmat_kernel(const uint32_t* __restrict__ key,
                                  const int32_t* __restrict__ kind,
                                  const int64_t* __restrict__ params,
                                  const double* __restrict__ fparams,
                                  const int64_t* __restrict__ count,
                                  const bool* __restrict__ owned, int log_n,
                                  int64_t capacity, int64_t blocks_per_row, bool fill,
                                  longlong2* __restrict__ edges,
                                  bool* __restrict__ keep) {
  const int64_t r = blockIdx.x / blocks_per_row;
  const int64_t i = (blockIdx.x % blocks_per_row) * kThreads + threadIdx.x;
  if (i >= capacity) return;
  const int64_t at = r * capacity + i;
  if (kind[r] != kKindRmat) {
    if (fill) {
      edges[at] = make_longlong2(0, 0);
      keep[at] = false;
    }
    return;
  }
  const double a = fparams[4 * r], b = fparams[4 * r + 1], c = fparams[4 * r + 2];
  const double ab = a + b, abc = ab + c;   // (a + b) + c, as the reference sums
  const Key2x32 k = tf_fold_in64(Key2x32{key[2 * r], key[2 * r + 1]}, params[3 * r + 1] + i);
  int64_t src = 0, dst = 0;   // most significant bit first
  for (int j = 0; j < log_n; ++j) {
    const double u = tf_uniform64(k, (uint64_t)j);
    const int quad = (u >= a) + (u >= ab) + (u >= abc);
    src = (src << 1) | (quad >= 2);
    dst = (dst << 1) | (quad & 1);
  }
  edges[at] = make_longlong2(src, dst);
  keep[at] = i < count[r] && owned[r];
}

__global__ void chunk_ba_kernel(const uint32_t* __restrict__ key,
                                const int32_t* __restrict__ kind,
                                const int64_t* __restrict__ params,
                                const int64_t* __restrict__ count,
                                const bool* __restrict__ owned, int64_t capacity,
                                int64_t blocks_per_row, bool fill,
                                longlong2* __restrict__ edges, bool* __restrict__ keep,
                                unsigned long long* __restrict__ steps) {
  const int64_t r = blockIdx.x / blocks_per_row;
  const int64_t i = (blockIdx.x % blocks_per_row) * kThreads + threadIdx.x;
  const int64_t at = r * capacity + i;
  const bool mine = i < capacity && kind[r] == kKindBa;
  unsigned long long walked = 0;
  if (mine) {
    const Key2x32 k{key[2 * r], key[2 * r + 1]};
    const int64_t p0 = params[3 * r];
    const int64_t d = p0 > 1 ? p0 : 1;
    const int64_t eid = params[3 * r + 1] + i;
    int64_t pos = 2 * eid + 1;
    while (pos & 1) {   // Batagelj-Brandes: an odd position copies an earlier one
      pos = tf_randint64(tf_fold_in64(k, pos), 0, pos);
      ++walked;
    }
    edges[at] = make_longlong2(eid / d, (pos / 2) / d);
    keep[at] = i < count[r] && owned[r];
  } else if (fill && i < capacity) {
    edges[at] = make_longlong2(0, 0);
    keep[at] = false;
  }
  if (steps != nullptr) {   // every thread of the block reaches the sums
    unsigned long long longest = walked;
    for (int o = 16; o > 0; o >>= 1) {
      walked += __shfl_down_sync(0xffffffffu, walked, o);
      const unsigned long long other = __shfl_down_sync(0xffffffffu, longest, o);
      longest = other > longest ? other : longest;
    }
    if ((threadIdx.x & 31) == 0 && walked) {
      atomicAdd(steps, walked);
      atomicAdd(steps + 1, 32 * longest);   // the steps the warp issued
    }
  }
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

// key uint32 [R, 2]; kind int32 [R]; params int64 [R, 3] (p1 = first edge
// id); fparams float64 [R, 4] (a, b, c); count int64 [R]; owned bool [R];
// edges int64 [R, capacity, 2]; keep bool [R, capacity].  fill != 0 also
// writes the rows of other kinds as (0, 0), not kept.
extern "C" int chunk_rmat(const void* key, const void* kind, const void* params,
                          const void* fparams, const void* count, const void* owned,
                          int log_n, long long rows, long long capacity, int fill,
                          void* edges, void* keep, void* stream) {
  if (rows == 0 || capacity == 0) return 0;
  long long bpr;
  unsigned grid;
  if (int err = grid_for(rows, capacity, &bpr, &grid)) return err;
  chunk_rmat_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)key, (const int32_t*)kind, (const int64_t*)params,
      (const double*)fparams, (const int64_t*)count, (const bool*)owned, log_n,
      capacity, bpr, fill != 0, (longlong2*)edges, (bool*)keep);
  return (int)cudaGetLastError();
}

// As chunk_rmat, for BA rows (params p0 = d, p1 = first edge id); steps,
// when not null, is a uint64 [2] the launch adds into: its chain steps,
// and 32 times the longest chain of each warp.
extern "C" int chunk_ba(const void* key, const void* kind, const void* params,
                        const void* count, const void* owned, long long rows,
                        long long capacity, int fill, void* edges, void* keep,
                        void* steps, void* stream) {
  if (rows == 0 || capacity == 0) return 0;
  long long bpr;
  unsigned grid;
  if (int err = grid_for(rows, capacity, &bpr, &grid)) return err;
  chunk_ba_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)key, (const int32_t*)kind, (const int64_t*)params,
      (const int64_t*)count, (const bool*)owned, capacity, bpr, fill != 0,
      (longlong2*)edges, (bool*)keep, (unsigned long long*)steps);
  return (int)cudaGetLastError();
}
