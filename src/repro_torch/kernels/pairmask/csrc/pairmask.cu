// Pair-mask kernel: int8 mask[b, i, j] of a threshold test between row i of
// a[b] and row j of b[b], for the RGG Euclidean test (float32, "euclid") and
// the RHG hyperbolic Eq. 9 test (float64 features, "hyp").
//
// Replaces repro/kernels/pairmask/pairmask.py::pair_mask (pallas_call at
// line 87; tiles _euclid_tile at line 34 and _hyp_tile at line 43), which
// the facades pairdist/pairdist.py:17 and hypdist/hypdist.py:17 call.  The
// TPU kernel holds a 128 x 128 tile of pairs in VMEM per grid step; here a
// batch dimension is added so that many small cell pairs run in one launch.
//
// Bound on an H100: per pair the kernel writes one byte and does a handful
// of float operations, so it is bound by the bytes it writes.  Design: one
// block per 128 x 128 tile of pairs of one batch item, the TPU kernel's
// tile.  The block stages the tile's a-rows in shared memory; each thread
// holds four adjacent b-rows in registers and walks the tile's rows,
// testing four pairs a step and writing them as one 4-byte word, so a warp
// stores 128 contiguous bytes of one output row.  Indices are split per
// block, not per pair: a 64-bit division per pair cost more than the
// writes.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "tiles.cuh"

namespace {

constexpr int kTile = 128;  // rows and columns of pairs per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRun = 4;  // adjacent columns per thread: one 4-byte store

template <int kCols>
__device__ __forceinline__ bool tile_test(const float* a, const float* b, float r2, double) {
  return euclid_tile(a, b, kCols, r2);
}
template <int kCols>
__device__ __forceinline__ bool tile_test(const double* q, const double* c, float,
                                          double cosh_r) {
  return hyp_tile(q, c, cosh_r);
}

// T float with kCols = dim (euclid), or double with kCols = 4 (hyp)
template <typename T, int kCols>
__global__ void __launch_bounds__(kThreads)
    pair_mask_kernel(const T* __restrict__ a, const T* __restrict__ b, int64_t M,
                     int64_t N, int64_t F, int64_t tiles_m, int64_t tiles_n, float r2,
                     double cosh_r, int8_t* __restrict__ out) {
  __shared__ T sa[kTile * kCols];
  const int64_t t = blockIdx.x;
  const int64_t i0 = (t / tiles_n) % tiles_m * kTile, j0 = t % tiles_n * kTile;
  const int64_t batch = t / tiles_n / tiles_m;
  const int rows_a = (int)(M - i0 < kTile ? M - i0 : kTile);
  const int rows_b = (int)(N - j0 < kTile ? N - j0 : kTile);
  const T* ta = a + (batch * M + i0) * F;
  for (int k = threadIdx.x; k < rows_a * kCols; k += kThreads)
    sa[k] = ta[(k / kCols) * F + k % kCols];
  const int j = (threadIdx.x % 32) * kRun;
  const T* tb = b + (batch * N + j0) * F;
  T bv[kRun][kCols];
#pragma unroll
  for (int q = 0; q < kRun; ++q)
#pragma unroll
    for (int c = 0; c < kCols; ++c) bv[q][c] = j + q < rows_b ? tb[(j + q) * F + c] : T(0);
  __syncthreads();
  if (j >= rows_b) return;
  int8_t* o = out + (batch * M + i0) * N + j0 + j;
  // word stores stay 4-byte aligned when N is a multiple of 4
  const bool whole = j + kRun <= rows_b && N % kRun == 0;
  for (int i = threadIdx.x / 32; i < rows_a; i += kWarps) {
    uint32_t word = 0;
#pragma unroll
    for (int q = 0; q < kRun; ++q)
      word |= (uint32_t)tile_test<kCols>(sa + i * kCols, bv[q], r2, cosh_r) << (8 * q);
    if (whole) {
      *(uint32_t*)(o + i * N) = word;
    } else {
      for (int q = 0; q < rows_b - j && q < kRun; ++q) o[i * N + q] = (word >> (8 * q)) & 1;
    }
  }
}

template <typename T, int kCols>
int launch(const void* a, const void* b, long long B, long long M, long long N,
           long long F, float r2, double cosh_r, void* out, void* stream) {
  const long long tiles_m = (M + kTile - 1) / kTile, tiles_n = (N + kTile - 1) / kTile;
  const long long blocks = B * tiles_m * tiles_n;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  pair_mask_kernel<T, kCols><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)a, (const T*)b, M, N, F, tiles_m, tiles_n, r2, cosh_r, (int8_t*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// a [B, M, F], b [B, N, F] (float32 for euclid, float64 for hyp, C order;
// F >= dim for euclid, F >= 4 for hyp); out int8 [B, M, N], 4-byte
// aligned.  Returns the launch's cudaError_t.
extern "C" int pair_mask(const void* a, const void* b, long long B, long long M,
                         long long N, long long F, int hyp, int dim, float r2,
                         double cosh_r, void* out, void* stream) {
  if (B * M * N == 0) return 0;
  if (hyp) return launch<double, 4>(a, b, B, M, N, F, r2, cosh_r, out, stream);
  if (dim == 3) return launch<float, 3>(a, b, B, M, N, F, r2, cosh_r, out, stream);
  return launch<float, 2>(a, b, B, M, N, F, r2, cosh_r, out, stream);
}

// ---------------------------------------------------------------------------
// hyp_edges: the hyp test over many ragged segments in one launch sequence,
// the hits compacted on the card.
//
// Replaces, on the path through repro/core/rhg.py:293 _adjacency (rhg_pe, the
// LM data pipeline's graph), the reference's pair_mask (pairmask.py:56, tile
// _hyp_tile at line 43) and the host's np.nonzero of its mask.  Segment s
// tests rows q[q_off, q_off + q_len) against c[c_off, c_off + c_len); the
// output is every pair (q_gid[i], c_gid[j]) whose hyp_tile holds and whose
// gids differ, segment by segment, row-major in (i, j) within a segment: the
// order in which the reference's emit concatenates them.
//
// Bound on an H100: 6 float64 operations a pair (two products, three FMAs,
// the compare), against 40 bytes a row read once and 16 bytes a hit written;
// a graph of the pipeline has some 10^7 pairs and 10^5 hits, so it is bound
// by float64 operations, a few microseconds, below a launch's latency.
//
// Design: the pairs of all segments, in output order, form one sequence, and
// a fixed grid of as many blocks as the SMs hold at once (every SM busy,
// however the segments are sized: one dense launch a segment gave the
// largest of rhg_pe's calls 68 blocks of 128 x 128 pairs on 132 SMs) splits
// it into one contiguous span of equal length a warp.  A warp walks its span
// 32 pairs a step, a lane a pair, across row ends; __ballot_sync/__popc count
// the hits.  Passes: (1)
// one block checks the table and scans the segments' pair counts; (2) every
// warp counts the hits of its span; (3) one block scans the warps' counts into
// offsets and the total; the host reads the total (the call's one read) and
// sizes the output; (4) every warp recomputes its hits (6 FMAs a pair cost
// less than a stored mask) and writes them from its offset, in order, at the
// ballot's prefix.  Spans, offsets and counts are int64.  No atomic decides
// the order, so the output equals the plain version (ref.py hyp_edges_ref)
// element for element.

namespace {

constexpr int kScanThreads = 1024;  // one block: 32 warps
constexpr int kPassThreads = 256;
constexpr int kPassWarps = kPassThreads / 32;

// exclusive scan of get(0 .. n) into out[0 .. n) by one block of
// kScanThreads threads, a contiguous run of elements a thread; returns the
// total to every thread
template <typename Get>
__device__ int64_t block_scan(Get get, int64_t n, int64_t* __restrict__ out) {
  __shared__ int64_t sums[kScanThreads / 32];
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int64_t per = (n + kScanThreads - 1) / kScanThreads;
  const int64_t lo = min(n, t * per), hi = min(n, lo + per);
  int64_t own = 0;
  for (int64_t k = lo; k < hi; ++k) own += get(k);
  int64_t x = own;  // inclusive scan over the warp
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int64_t y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int64_t s = sums[lane];
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int64_t y = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += y;
    }
    sums[lane] = s;
  }
  __syncthreads();
  int64_t run = x - own + (warp ? sums[warp - 1] : 0);
  for (int64_t k = lo; k < hi; ++k) {
    const int64_t v = get(k);
    out[k] = run;
    run += v;
  }
  return sums[kScanThreads / 32 - 1];
}

// pass 1.  info: [0] the pairs of all segments, [1] the hits (pass 3), [2] 1 +
// the first segment out of range, or 0.  A table out of range tests no pair.
__global__ void __launch_bounds__(kScanThreads)
    hyp_plan_kernel(const int64_t* __restrict__ seg, int64_t S, int64_t Q, int64_t C,
                    int64_t* __restrict__ pair_start, int64_t* __restrict__ info) {
  __shared__ unsigned long long bad;
  if (threadIdx.x == 0) bad = ULLONG_MAX;
  __syncthreads();
  for (int64_t s = threadIdx.x; s < S; s += kScanThreads) {
    const int64_t qo = seg[4 * s], ql = seg[4 * s + 1], co = seg[4 * s + 2],
                  cl = seg[4 * s + 3];
    if (qo < 0 || ql < 0 || co < 0 || cl < 0 || qo > Q || ql > Q - qo || co > C ||
        cl > C - co)
      atomicMin(&bad, (unsigned long long)s);
  }
  __syncthreads();
  const bool ok = bad == ULLONG_MAX;
  const int64_t total = block_scan(
      [&](int64_t s) { return ok ? seg[4 * s + 1] * seg[4 * s + 3] : (int64_t)0; }, S,
      pair_start);
  if (threadIdx.x == 0) {
    pair_start[S] = total;
    info[0] = total;
    info[1] = 0;
    info[2] = ok ? 0 : (int64_t)bad + 1;
  }
}

// passes 2 (kWrite false: the hits of each warp's span into hits[w]) and 4
// (kWrite true: hits[w] holds the warp's offset; the pairs are written there,
// those at or past `capacity` dropped).  A step tests the next 32 pairs of the
// span within one segment, a lane a pair, across row ends: most of rhg_pe's
// segments have fewer than 64 candidates (the core, the sparse outer rings),
// and a step a row left most lanes idle and waited on a load of the query
// row each time.
template <bool kWrite>
__global__ void __launch_bounds__(kPassThreads)
    hyp_pass_kernel(const double* __restrict__ q, const double* __restrict__ c,
                    const int64_t* __restrict__ q_gid, const int64_t* __restrict__ c_gid,
                    const int64_t* __restrict__ seg, int64_t S,
                    const int64_t* __restrict__ pair_start, double cosh_r,
                    int64_t* __restrict__ hits, int64_t capacity,
                    longlong2* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  const int64_t W = (int64_t)gridDim.x * kPassWarps;
  const int64_t w = (int64_t)blockIdx.x * kPassWarps + threadIdx.x / 32;
  const int64_t P = pair_start[S];
  const int64_t each = P / W, extra = P % W;
  const int64_t p = w * each + min(w, extra);  // the warp's span [p, p + left)
  int64_t left = each + (w < extra ? 1 : 0);
  int64_t base = kWrite ? hits[w] : 0;
  if (left > 0) {
    // the segment of pair p: pair_start[s] <= p < pair_start[s + 1]
    int64_t s = 0, hi = S;
    while (hi - s > 1) {
      const int64_t mid = (s + hi) / 2;
      if (pair_start[mid] <= p) s = mid; else hi = mid;
    }
    int64_t qo = seg[4 * s], co = seg[4 * s + 2], cl = seg[4 * s + 3];
    int64_t rest = pair_start[s + 1] - p;  // the segment's pairs from (i, j) on
    int64_t i = (p - pair_start[s]) / cl, j = (p - pair_start[s]) % cl;
    for (;;) {
      const int64_t n = min(min(left, rest), (int64_t)32);  // this step's pairs
      bool hit = false;
      int64_t qg = 0, cg = 0;
      if (lane < n) {
        // pair (i, j) + lane in row-major order: past the row's end when
        // j + lane >= cl (once if cl >= 32; a 32-bit division if not)
        int64_t li = i, lj = j + lane;
        if (cl >= 32) {
          if (lj >= cl) ++li, lj -= cl;
        } else {
          li += (uint32_t)lj / (uint32_t)cl;
          lj = (uint32_t)lj % (uint32_t)cl;
        }
        // a row is 32 bytes: two 16-byte loads (rows start 16-byte aligned)
        const double2* qr = reinterpret_cast<const double2*>(q + 4 * (qo + li));
        const double2* cr = reinterpret_cast<const double2*>(c + 4 * (co + lj));
        const double2 q01 = qr[0], q23 = qr[1], c01 = cr[0], c23 = cr[1];
        const double qv[4] = {q01.x, q01.y, q23.x, q23.y};
        const double cv[4] = {c01.x, c01.y, c23.x, c23.y};
        qg = q_gid[qo + li];
        cg = c_gid[co + lj];
        hit = hyp_tile(qv, cv, cosh_r) && cg != qg;
      }
      const unsigned m = __ballot_sync(0xffffffffu, hit);
      if (kWrite && hit) {
        const int64_t at = base + __popc(m & ((1u << lane) - 1u));
        if (at < capacity) out[at] = make_longlong2(qg, cg);
      }
      base += __popc(m);
      left -= n;
      if (left == 0) break;
      rest -= n;
      if (rest == 0) {  // the next segment with pairs
        do ++s; while (pair_start[s + 1] == pair_start[s]);
        qo = seg[4 * s], co = seg[4 * s + 2], cl = seg[4 * s + 3];
        rest = pair_start[s + 1] - pair_start[s];
        i = j = 0;
      } else if (cl >= 32) {
        j += n;
        if (j >= cl) ++i, j -= cl;
      } else {
        i += (uint32_t)(j + n) / (uint32_t)cl;
        j = (uint32_t)(j + n) % (uint32_t)cl;
      }
    }
  }
  if (!kWrite && lane == 0) hits[w] = base;
}

// pass 3: the warps' hits into offsets, the total into info[1]
__global__ void __launch_bounds__(kScanThreads)
    hyp_scan_kernel(const int64_t* __restrict__ hits, int64_t W, int64_t* __restrict__ offsets,
                    int64_t* __restrict__ info) {
  const int64_t total = block_scan([&](int64_t k) { return hits[k]; }, W, offsets);
  if (threadIdx.x == 0) info[1] = total;
}

// the scratch of a call: info [4] | pair_start [S + 1] | hits [W] | offsets [W]
struct HypScratch {
  int64_t *info, *pair_start, *hits, *offsets;
  HypScratch(void* p, long long S, long long W)
      : info((int64_t*)p), pair_start(info + 4), hits(pair_start + S + 1), offsets(hits + W) {}
};

}  // namespace

// The pass kernels' grid on `device`: every block resident at once.
// *blocks blocks of *warps / *blocks warps each.
extern "C" int hyp_edges_grid(int device, long long* blocks, long long* warps) {
  int sms = 0, per_sm = 0, per_sm_write = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hyp_pass_kernel<false>,
                                                        kPassThreads, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm_write, hyp_pass_kernel<true>,
                                                        kPassThreads, 0);
  if (err != cudaSuccess) return (int)err;
  *blocks = (long long)sms * (per_sm < per_sm_write ? per_sm : per_sm_write);
  if (*blocks < 1) *blocks = 1;
  *warps = *blocks * kPassWarps;
  return 0;
}

// Passes 1-3.  q [Q, 4], c [C, 4] float64; q_gid [Q], c_gid [C] int64;
// seg [S, 4] int64 (q_off, q_len, c_off, c_len), S >= 1; scratch int64 of
// 4 + S + 1 + 2 W slots, W = blocks * 8 (hyp_edges_grid).  After them,
// scratch[0..3) holds the pairs, the hits and the bad-segment flag.
extern "C" int hyp_edges_count(const void* q, const void* c, const void* q_gid,
                               const void* c_gid, const void* seg, long long S, long long Q,
                               long long C, double cosh_r, long long blocks, void* scratch,
                               void* stream) {
  const long long W = blocks * kPassWarps;
  HypScratch sc(scratch, S, W);
  cudaStream_t st = (cudaStream_t)stream;
  hyp_plan_kernel<<<1, kScanThreads, 0, st>>>((const int64_t*)seg, S, Q, C, sc.pair_start,
                                               sc.info);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  hyp_pass_kernel<false><<<(unsigned)blocks, kPassThreads, 0, st>>>(
      (const double*)q, (const double*)c, (const int64_t*)q_gid, (const int64_t*)c_gid,
      (const int64_t*)seg, S, sc.pair_start, cosh_r, sc.hits, 0, nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  hyp_scan_kernel<<<1, kScanThreads, 0, st>>>(sc.hits, W, sc.offsets, sc.info);
  return (int)cudaGetLastError();
}

// Pass 4 into out int64 [capacity, 2], on the scratch of hyp_edges_count.
extern "C" int hyp_edges_write(const void* q, const void* c, const void* q_gid,
                               const void* c_gid, const void* seg, long long S, double cosh_r,
                               long long blocks, void* scratch, long long capacity, void* out,
                               void* stream) {
  HypScratch sc(scratch, S, blocks * kPassWarps);
  hyp_pass_kernel<true><<<(unsigned)blocks, kPassThreads, 0, (cudaStream_t)stream>>>(
      (const double*)q, (const double*)c, (const int64_t*)q_gid, (const int64_t*)c_gid,
      (const int64_t*)seg, S, sc.pair_start, cosh_r, sc.offsets, capacity, (longlong2*)out);
  return (int)cudaGetLastError();
}
