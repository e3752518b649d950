// Chunk kernels of the engine's edge program, one launch over every row of
// a [R, cap] batch: the decode of the sampled kinds (DIRECTED / TRI /
// RECT; collision.cu draws and sorts them), and the per-edge programs of
// R-MAT and BA rows.
//
// chunk_decode replaces decode_directed / decode_tri / decode_rect
// (repro/core/sampling.py:155-184) and the keep mask of
// repro/distrib/engine.py::_edge_chunk_fn (lines 404-424, 468).  XLA lowers
// that reference path from jnp; it reaches no Pallas kernel.
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
// * chunk_ba: a step of a position chain is fold_in64, a split and two
//   64-bit words (6 Threefry blocks) and five remainders by the same
//   span, which share one reciprocal (threefry.cuh's Mod64).  Chains are
//   short (about 2 steps) but their lengths vary, so lanes are kept on
//   chains: a warp owns a batch of 1024 consecutive slots, each lane walks
//   one chain, and a lane whose chain ends stores that slot's edge and
//   takes the batch's next slot (ranked within the warp by a ballot, no
//   atomics); the warp stops when the batch is drained.  Stores leave lane
//   order but stay within the batch's 16 KB window.  The launch can count
//   the steps its lanes walked and the steps its warps issued (32 times
//   each warp's loop trips; one warp sum, two atomics a warp), so the
//   bound and the cost of the waiting are read from the run.
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

constexpr int kBaBatch = 1024;   // slots a warp of chunk_ba owns

__global__ void chunk_ba_kernel(const uint32_t* __restrict__ key,
                                const int32_t* __restrict__ kind,
                                const int64_t* __restrict__ params,
                                const int64_t* __restrict__ count,
                                const bool* __restrict__ owned, int64_t rows, int64_t capacity,
                                int64_t batches_per_row, bool fill,
                                longlong2* __restrict__ edges, bool* __restrict__ keep,
                                unsigned long long* __restrict__ steps) {
  const int64_t warp = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= rows * batches_per_row) return;     // whole warps
  const int64_t r = warp / batches_per_row;
  const int64_t b0 = (warp % batches_per_row) * kBaBatch;
  const int len = (int)(capacity - b0 < kBaBatch ? capacity - b0 : kBaBatch);
  const int64_t at = r * capacity + b0;
  if (kind[r] != kKindBa) {
    if (fill)
      for (int i = lane; i < len; i += 32) {
        edges[at + i] = make_longlong2(0, 0);
        keep[at + i] = false;
      }
    return;
  }
  const Key2x32 k{key[2 * r], key[2 * r + 1]};
  const int64_t p0 = params[3 * r];
  const Mod64 d = mod64_init(p0 > 1 ? (uint64_t)p0 : 1ull);
  const int64_t e0 = params[3 * r + 1] + b0;   // edge id of the batch's slot 0
  const int64_t counted = count[r] - b0;
  const bool own = owned[r];
  unsigned walked = 0, trips = 0;
  int i = lane, next = 32;                     // batch slot of this lane, next slot to take
  bool live = i < len;
  int64_t pos = live ? 2 * (e0 + i) + 1 : 0;
  while (__any_sync(0xffffffffu, live)) {
    ++trips;
    bool done = false;
    if (live) {   // Batagelj-Brandes: an odd position copies an earlier one
      pos = tf_randint64(tf_fold_in64(k, pos), 0, pos);
      ++walked;
      if (!(pos & 1)) {
        edges[at + i] = make_longlong2((int64_t)div64((uint64_t)(e0 + i), d),
                                       (int64_t)div64((uint64_t)(pos >> 1), d));
        keep[at + i] = i < counted && own;
        done = true;
      }
    }
    const unsigned ended = __ballot_sync(0xffffffffu, done);
    if (done) {   // take the batch's next slots, in lane order
      i = next + __popc(ended & ((1u << lane) - 1u));
      live = i < len;
      if (live) pos = 2 * (e0 + i) + 1;
    }
    next += __popc(ended);
  }
  if (steps != nullptr) {
    const unsigned total = __reduce_add_sync(0xffffffffu, walked);
    if (lane == 0 && total) {
      atomicAdd(steps, (unsigned long long)total);
      atomicAdd(steps + 1, 32ull * trips);   // the steps the warp issued
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
// when not null, is a uint64 [2] the launch adds into: the chain steps its
// lanes walked, and 32 times the loop trips of each warp (the steps it
// issued).
extern "C" int chunk_ba(const void* key, const void* kind, const void* params,
                        const void* count, const void* owned, long long rows,
                        long long capacity, int fill, void* edges, void* keep,
                        void* steps, void* stream) {
  if (rows == 0 || capacity == 0) return 0;
  const long long batches = (capacity + kBaBatch - 1) / kBaBatch;
  const long long blocks = (rows * batches * 32 + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  chunk_ba_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)key, (const int32_t*)kind, (const int64_t*)params,
      (const int64_t*)count, (const bool*)owned, rows, capacity, batches, fill != 0,
      (longlong2*)edges, (bool*)keep, (unsigned long long*)steps);
  return (int)cudaGetLastError();
}
