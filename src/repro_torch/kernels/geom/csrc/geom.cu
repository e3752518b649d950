// Geometric engine kernels: the candidate-pair program (pair_edges) of RGG
// (GEOM_TORUS), RHG (GEOM_HYP) and RDG (GEOM_CERT) plans, and the cell
// program (cell_points) of cube and polar point plans.
//
// pair_edges replaces repro/distrib/engine.py::_pair_fn (line 1050) for
// GEOM_TORUS and GEOM_HYP rows, which evaluates the pair_mask TPU kernel's
// tiles inline (engine.py:1093-1109; repro/kernels/pairmask/pairmask.py:34,
// :43), and for GEOM_CERT rows (engine.py:1111-1117), which re-certify one
// Delaunay simplex with the shared Cramer predicate
// (../../delaunay/csrc/predicates.cuh) and emit its host-masked edges.
// cell_points replaces engine.py::_point_cell_fn (line 644).  XLA lowers
// both from jnp; the threshold tests are the pair_mask tiles
// (../../pairmask/csrc/tiles.cuh), shared with the pair_mask kernel.
//
// What bounds them on an H100, and what the designs do about it:
// * pair_edges writes 17 bytes per slot (a 16-byte edge and a keep byte)
//   over cap^2 slots per row; at the plans' capacities that is most of
//   its time, so it is bound by memory, and the design keeps the stores
//   streaming.  A persistent grid (as many CTAs as fit on the SMs) walks
//   tiles of TR consecutive rows, about 4096 slots a tile, TR chosen so
//   that a tile's slots start on a 512-slot boundary where the capacity
//   allows (8 rows at cap 24, 256 CERT rows at cap 4).  Decode: one thread
//   a row fills a shared-memory record of the row's scalars (a CERT row
//   also evaluates its circumsphere-in-box test and copies its vertex
//   ids); then the tile's points, only the slots that hold one, are spread
//   evenly over all threads by a block prefix of the rows' counts: float32
//   cube points, or the float64 features [cos t, sin t, coth r, 1/sinh r]
//   of polar ones.  Write: the tile's slots are contiguous in the output,
//   so thread t takes slots t, t + 256, ... (a warp instruction stores 512
//   contiguous bytes of edges) and stages each keep byte in shared memory;
//   the staged bytes leave as 16-byte vectors one tile later.  Shared
//   memory holds two tiles: the decode of tile k+1 (and tile k-1's keep
//   bytes) go through the other half while tile k's stores drain, with one
//   barrier a tile.  Row, i and j come from 32-bit multiply-high
//   divisions.  Rows too wide for a staged tile in 48 KB (capacity 128 on
//   HYP rows, 142 on TORUS rows) go one a tile and store their keep bytes
//   as they compute them (an instance of their own, so that the staged
//   one's keep stores stay shared-memory stores); a row whose two halves
//   do not fit in the card's 227 KB (HYP from capacity 1815) takes the
//   whole of it, with a second barrier before the next decode.  A row
//   stages its kind's `stage` points a side, 32 bytes each on HYP rows and
//   16 on TORUS rows: each kind's stage bounds its rows' counts, and is
//   the capacity unless the caller knows a smaller bound from its host
//   tables (a serving slab runs its rows at a power-of-two class above
//   their own capacity).  A row's area is the larger kind's, so a launch
//   takes a HYP stage up to 3630 and a TORUS stage up to 7261 (not both),
//   at any capacity.  A live row whose count exceeds its kind's stage is
//   refused, never clamped: a launch given stages below the capacity
//   first runs a check kernel whose device assertion fails it (a kernel of
//   its own, so that the assertion's call costs pair_edges no registers).
//   Only such a launch runs the instance that reads the stages
//   (pair_edges_kernel<STAGE, BELOW = true>): every other one runs the
//   BELOW = false instance, which bounds its rows by the capacity, finds
//   side b of a row after side a's cap points and reads nothing of its
//   Stage argument.  The stages are that argument, not fields of
//   PairArgs: a grown PairArgs cost every path 8-12 % (a stack frame in
//   the no-stage instance), so the paths that stage nothing compile to the
//   same per-row work as before stages existed.
// * cell_points writes 8 dim + 1 bytes per slot and draws 1 + 2 dim
//   Threefry blocks (72 integer operations each) per point.  Threads map
//   to points, not slots: a persistent CTA takes tiles of cells (about 16
//   KB of points), prefixes their counts in shared memory, and each thread
//   draws points of the tile (binary search for its cell) into a shared
//   staging tile; padding slots draw nothing and are written as 0.  The
//   tile then leaves as 16-byte stores of two doubles, and the mask as
//   bytes, while the next tile's points are drawn into the other half of
//   shared memory.  Cells too wide for two staged tiles in shared memory
//   (capacity x dim above 7260) draw their points straight into the
//   output, which then takes the mask and the padding's 0 (an instance of
//   their own: a pointer that may address either memory cost the staged
//   instance 15 registers a thread and a tenth of its time).
//
// Exactness: the draws are JAX's Threefry bits (threefry.cuh), the uniform
// is (bits >> 11) * 2^-53, and the decodes use the operations XLA uses on
// the CPU, in the same order, with fma only where XLA contracts (see
// repro_torch/kernels/geom/ref.py).  The transcendentals are libm.cuh's:
// XLA-CPU's own exp, expm1 and log1p and glibc's log, sin and cos, the
// functions the reference's compiled programs run, in the same operations
// as libm.py's plain versions.  The library is built with -fmad=false, so
// the kernels equal their plain PyTorch versions, and the reference, bit
// for bit.
#include <cuda_runtime.h>
#include <assert.h>
#include <stdint.h>

#include "../../delaunay/csrc/predicates.cuh"
#include "../../pairmask/csrc/tiles.cuh"
#include "../../sampler/csrc/threefry.cuh"
#include "libm.cuh"

namespace {

namespace L = repro_libm;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileAlign = 512;  // a tile's slots start on a multiple of this where they can
constexpr int kGeomHyp = 1, kGeomTorus = 2, kGeomCert = 3;
constexpr int kHyp = 1, kTorus = 2, kCert = 4;  // bits of the kinds a launch runs
constexpr double kLog2 = 0.69314718055994529;
constexpr double kAcoshLarge = 8.9884656743115785e+307;  // 2^1023
constexpr double kTwoM53 = 1.1102230246251565e-16;       // 2^-53

// uniform j of a slot: the top 53 bits of 64-bit word j of the slot's key
__device__ __forceinline__ double uniform53(Key2x32 slot, uint32_t j) {
  const Key2x32 a = threefry2x32(slot, 0u, 2u * j);
  const Key2x32 b = threefry2x32(slot, 0u, 2u * j + 1u);
  const uint64_t hi = a.k0 ^ a.k1, lo = b.k0 ^ b.k1;
  return (double)((hi << 21) | (lo >> 11)) * kTwoM53;
}

__device__ __forceinline__ double acosh_xla(double x) {
  if (x >= kAcoshLarge) return L::glibc_log(x) + kLog2;
  const double sm = sqrt(x - 1.0);
  return L::xla_log1p(sm * (sqrt(x + 1.0) + sm));
}

// polar draw of a slot: alpha r = arccosh(clo + u0 (chi - clo)) and the
// angle (ci + u1) w, for ci the angular cell index and w its width
__device__ __forceinline__ void polar_draw(Key2x32 slot, double clo, double chi,
                                           double ci, double w, double* ar,
                                           double* theta) {
  const double u0 = uniform53(slot, 0u), u1 = uniform53(slot, 1u);
  *ar = acosh_xla(fma(u0, chi - clo, clo));
  *theta = (ci + u1) * w;
}

// [cos t, sin t, coth r, 1/sinh r] of a polar slot (geom = clo, chi, ci, w)
__device__ __forceinline__ void hyp_features(Key2x32 slot, const double* geom,
                                             double alpha, double* f) {
  double ar, theta;
  polar_draw(slot, geom[0], geom[1], geom[2], geom[3], &ar, &theta);
  double r = ar / alpha;
  r = r < 1e-12 ? 1e-12 : r;  // max(r, 1e-12), NaN passes through
  const double e_hi = L::xla_exp(r - kLog2), e_lo = L::xla_exp(-kLog2 - r);
  const double em1 = L::xla_expm1(r);
  const double sh = fabs(r) < 1.0 ? (em1 + em1 / (em1 + 1.0)) * 0.5 : e_hi - e_lo;
  f[0] = L::glibc_cos(theta);
  f[1] = L::glibc_sin(theta);
  f[2] = (e_hi + e_lo) / sh;
  f[3] = 1.0 / sh;
}

// floor(s / d) for s, d < 2^16, with m = ceil(2^32 / d) (0 for d = 1,
// whose 2^32 does not fit): the multiply-high overshoots by at most one
__device__ __forceinline__ uint32_t div_small(uint32_t s, uint32_t d, uint32_t m) {
  if (d == 1) return s;
  const uint32_t q = __umulhi(s, m);
  return q * d > s ? q - 1 : q;
}

// one candidate-pair row of a tile, in shared memory
struct alignas(16) RowRec {
  long long ga, gb;  // gid_a[0], gid_b[0] (a CERT row's emit mask)
  double thr;        // HYP: cosh R; TORUS: r^2 (rounded to float when used)
  int ca, cb;        // counts, 0 on a row that keeps nothing
  int flags;         // kRowSelf | effective kind << 1 | kRowCert
};
constexpr int kRowSelf = 1, kRowCert = 8;

// a launch whose stages are below the capacity (a serving slab's): the
// points staged a side by kind, and the byte offset of side b in a row's
// area.  A kernel argument of its own beside PairArgs, which is as it was
// before stages existed
struct Stage {
  int hyp, torus;        // points staged a side by kind (<= cap)
  int half;              // bytes of the area before side b (16-aligned)
};

struct PairArgs {
  const int32_t* kind;
  const uint32_t *key_a, *key_b;
  const int64_t *count_a, *count_b, *gid_a, *gid_b;
  const double *geom_a, *geom_b, *fparams;
  const bool *self_pair, *active;
  int64_t K, G, F, rows;
  int cap, dim, kinds;   // kinds: the bits of the row kinds the launch runs
  int tile_rows, area;   // rows a tile, bytes of a row's point area (16-aligned)
  int stage_keep;        // 1: keep bytes staged in shared memory, 0: stored as computed
  int halves;            // shared-memory halves: 2, or 1 for rows too wide for two
  uint32_t m_cap;        // ceil(2^32 / cap)
  int step_row, step_i, step_j;  // kThreads = (step_row cap + step_i) cap + step_j
  longlong2* edges;
  uint8_t* keep;
};

// the kind a row runs as: its kind when the launch runs it, else 0
__device__ __forceinline__ int effective_kind(int k, int kinds) {
  if (k == kGeomHyp && (kinds & kHyp)) return kGeomHyp;
  if (k == kGeomTorus && (kinds & kTorus)) return kGeomTorus;
  if (k == kGeomCert && (kinds & kCert)) return kGeomCert;
  return 0;
}

// exclusive prefix of each thread's v over the block (v = 0 on threads
// past the items): off[t] for t < n, off[n] = the total.  Ends on a barrier.
__device__ void block_prefix(int v, int n, int* off, int* warp_sum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  int base = 0;
  for (int w = 0; w < warp; ++w) base += warp_sum[w];
  if (threadIdx.x < n) off[threadIdx.x] = base + incl - v;
  if (threadIdx.x == kThreads - 1) off[n] = base + incl;
  __syncthreads();
}

// the last item whose offset is <= p, of n items with offsets off[]
__device__ __forceinline__ int find_item(const int* off, int n, int p) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (off[mid] <= p) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// a tile's half of the shared memory: TR row records, the prefix of the
// rows' point counts, one keep byte a slot (when staged), and the rows'
// point areas
struct TileBuf {
  RowRec* rec;
  int* off;
  uint8_t* keep;
  char* area;
};

__device__ __forceinline__ TileBuf tile_buf(const PairArgs& a, char* base) {
  const int TR = a.tile_rows;
  TileBuf b;
  b.rec = (RowRec*)base;
  b.off = (int*)(base + TR * sizeof(RowRec));
  b.keep = (uint8_t*)b.off + ((TR + 1) * sizeof(int) + 15) / 16 * 16;
  b.area = (char*)b.keep + (a.stage_keep ? (TR * a.cap * a.cap + 15) / 16 * 16 : 0);
  return b;
}

__host__ __device__ __forceinline__ size_t tile_buf_bytes(int TR, int cap, int area,
                                                          bool stage_keep) {
  return TR * sizeof(RowRec) + ((TR + 1) * sizeof(int) + 15) / 16 * 16 +
         (stage_keep ? ((size_t)TR * cap * cap + 15) / 16 * 16 : 0) + (size_t)TR * area;
}

// decode tile `tile` into `b`: one thread a row fills the row's record
// (and a CERT row's test and ids), then the rows' points (only slots that
// hold one) are spread over all threads by a prefix of their counts.
// BELOW: a kind's stage may be below the capacity, so it bounds the counts
// and side b starts at byte `half` whatever the row's kind; else the
// capacity bounds them and side b follows side a's `cap` points
template <bool BELOW>
__device__ void pair_decode(const PairArgs& a, const Stage& st, int64_t tile, TileBuf b,
                            int* warp_sum) {
  const int TR = a.tile_rows, cap = a.cap;
  const int64_t r0 = tile * TR;
  const int nr = (int)(a.rows - r0 < TR ? a.rows - r0 : TR);
  int npts = 0;
  if (threadIdx.x < nr) {  // TR <= kThreads
    const int t = threadIdx.x;
    const int64_t r = r0 + t;
    const int ek = effective_kind(a.kind[r], a.kinds);
    const bool live = a.active[r] && ek != 0;
    RowRec rr;
    rr.ga = a.gid_a[r * a.K];
    rr.gb = a.gid_b[r * a.K];
    const int64_t ca = a.count_a[r], cb = a.count_b[r];
    // the kind's stage bounds the counts (stage_check_kernel refuses a
    // launch whose rows pass it; the clamp keeps the staging in bounds)
    if constexpr (BELOW) {
      const int lim = ek == kGeomHyp ? st.hyp : ek == kGeomTorus ? st.torus : cap;
      rr.ca = live ? (int)(ca < 0 ? 0 : (ca > lim ? lim : ca)) : 0;
      rr.cb = live ? (int)(cb < 0 ? 0 : (cb > lim ? lim : cb)) : 0;
    } else {
      rr.ca = live ? (int)(ca < 0 ? 0 : (ca > cap ? cap : ca)) : 0;
      rr.cb = live ? (int)(cb < 0 ? 0 : (cb > cap ? cap : cb)) : 0;
    }
    rr.thr = ek == kGeomHyp || ek == kGeomTorus ? a.fparams[r * a.F + 1] : 0.0;
    int flags = (a.self_pair[r] ? kRowSelf : 0) | ek << 1;
    if (ek == kGeomCert) {
      // the simplex in geom_a[:(dim+1) dim], the region box in geom_b[:2 dim]
      if (live) {
        const double* box = a.geom_b + r * a.G;
        const bool ok = a.dim == 2 ? dt_circumsphere_in_box<2>(a.geom_a + r * a.G, box, box + 2)
                                   : dt_circumsphere_in_box<3>(a.geom_a + r * a.G, box, box + 3);
        flags |= ok ? kRowCert : 0;
      }
      long long* ids = (long long*)(b.area + (size_t)t * a.area);
      for (int k = 0; k < a.K; ++k) ids[k] = a.gid_a[r * a.K + k];
    } else if (ek == kGeomHyp || ek == kGeomTorus) {
      npts = rr.ca + rr.cb;
    }
    rr.flags = flags;
    b.rec[t] = rr;
  }
  block_prefix(npts, nr, b.off, warp_sum);
  const int total = b.off[nr];
  for (int p = threadIdx.x; p < total; p += kThreads) {
    const int t = find_item(b.off, nr, p);
    const int k = p - b.off[t];
    const int64_t r = r0 + t;
    const RowRec& rr = b.rec[t];
    const bool side_b = k >= rr.ca;
    const int i = side_b ? k - rr.ca : k;
    const uint32_t* key = (side_b ? a.key_b : a.key_a) + 2 * r;
    const double* geom = (side_b ? a.geom_b : a.geom_a) + r * a.G;
    const Key2x32 slot = tf_fold_in(Key2x32{key[0], key[1]}, (uint32_t)i);
    const double g0 = a.fparams[r * a.F];
    // slot s of the row's area (side b after side a's cap points), or
    // (BELOW) slot i of its side, side b at byte st.half
    char* base = b.area + (size_t)t * a.area;
    int s = side_b ? cap + i : i;
    if constexpr (BELOW) {
      base += side_b ? st.half : 0;
      s = i;
    }
    if (((rr.flags >> 1) & 3) == kGeomHyp) {
      hyp_features(slot, geom, g0, (double*)base + 4 * s);
    } else {
      float* pt = (float*)base + 4 * s;
      for (int d = 0; d < a.dim; ++d)
        pt[d] = (float)((geom[d] + uniform53(slot, (uint32_t)d)) / g0);
    }
  }
}

// write the edges of tile `tile` from `b`, slots spread evenly over the
// threads (a warp instruction stores 512 contiguous bytes), and stage
// their keep bytes in b.keep (STAGE) or store them; BELOW as in pair_decode
template <bool STAGE, bool BELOW>
__device__ void pair_write(const PairArgs& a, const Stage& st, int64_t tile, TileBuf b) {
  const int TR = a.tile_rows, cap = a.cap, cc = cap * cap;
  const int64_t r0 = tile * TR;
  const int nr = (int)(a.rows - r0 < TR ? a.rows - r0 : TR);
  longlong2* edges = a.edges + r0 * cc;
  uint8_t* keep = a.keep + r0 * cc;
  // slot s = (row cap + i) cap + j, stepped by kThreads with carries
  const uint32_t q0 = div_small(threadIdx.x, (uint32_t)cap, a.m_cap);
  int j = (int)(threadIdx.x - q0 * cap);
  int row = (int)div_small(q0, (uint32_t)cap, a.m_cap);
  int i = (int)(q0 - row * cap);
  for (int s = threadIdx.x; s < nr * cc; s += kThreads) {
    const RowRec& rr = b.rec[row];
    const int ek = (rr.flags >> 1) & 3;
    const bool valid = i < rr.ca && j < rr.cb && (!(rr.flags & kRowSelf) || i < j);
    long long u = rr.ga + i, v = rr.gb + j;
    const char* pts = b.area + (size_t)row * a.area;
    bool kp = false;
    if (ek == kGeomCert) {
      const long long* ids = (const long long*)pts;
      const int kmax = (int)a.K - 1;
      u = ids[i < kmax ? i : kmax];
      v = ids[j < kmax ? j : kmax];
      if (valid) {
        int bit = i * (cap - 1) - i * (i - 1) / 2 + (j - i - 1);
        bit = bit < 0 ? 0 : (bit > 62 ? 62 : bit);
        kp = (rr.flags & kRowCert) && ((rr.gb >> bit) & 1);
      }
    } else if (valid) {
      if constexpr (BELOW) {
        if (ek == kGeomHyp) {
          kp = hyp_tile((const double*)pts + 4 * i, (const double*)(pts + st.half) + 4 * j,
                        rr.thr);
        } else {
          kp = euclid_tile((const float*)pts + 4 * i, (const float*)(pts + st.half) + 4 * j,
                           a.dim, (float)rr.thr);
        }
      } else if (ek == kGeomHyp) {
        kp = hyp_tile((const double*)pts + 4 * i, (const double*)pts + 4 * (cap + j), rr.thr);
      } else {
        kp = euclid_tile((const float*)pts + 4 * i, (const float*)pts + 4 * (cap + j), a.dim,
                         (float)rr.thr);
      }
    }
    edges[s] = make_longlong2(u > v ? u : v, u > v ? v : u);
    if (STAGE) b.keep[s] = kp;
    else keep[s] = kp;
    j += a.step_j;
    const int cj = j >= cap;
    j -= cj ? cap : 0;
    i += a.step_i + cj;
    const int ci = i >= cap;
    i -= ci ? cap : 0;
    row += a.step_row + ci;
  }
}

// store tile `tile`'s staged keep bytes: 16 a thread where the tile's
// slots start on a 16-byte boundary, else one at a time
__device__ void pair_keep(const PairArgs& a, int64_t tile, TileBuf b) {
  const int TR = a.tile_rows, cc = a.cap * a.cap;
  const int64_t r0 = tile * TR;
  const int n = (int)(a.rows - r0 < TR ? a.rows - r0 : TR) * cc;
  uint8_t* keep = a.keep + r0 * cc;
  int done = 0;
  if (((uintptr_t)keep & 15) == 0) {
    for (int v = threadIdx.x; v < n / 16; v += kThreads)
      ((uint4*)keep)[v] = ((const uint4*)b.keep)[v];
    done = n / 16 * 16;
  }
  for (int s = done + threadIdx.x; s < n; s += kThreads) keep[s] = b.keep[s];
}

// STAGE: keep bytes staged in shared memory (a separate instance from the
// wide rows', which store them as computed, so that its stores stay
// shared-memory stores).  BELOW: a launch whose stages are below the
// capacity (a serving slab's): each kind's stage bounds its rows' counts,
// and side b starts at byte st.half whatever the kind.  Every other launch
// runs the !BELOW instance, which reads nothing of `st`: its rows are
// bounded by the capacity and side b of a row follows side a's cap points
template <bool STAGE, bool BELOW>
__global__ void __launch_bounds__(kThreads) pair_edges_kernel(PairArgs a, Stage st,
                                                              int64_t tiles) {
  extern __shared__ __align__(16) char smem[];
  __shared__ int warp_sum[kWarps];
  const size_t half = a.halves == 2 ? tile_buf_bytes(a.tile_rows, a.cap, a.area, STAGE) : 0;
  int64_t tile = blockIdx.x;
  if (tile >= tiles) return;
  pair_decode<BELOW>(a, st, tile, tile_buf(a, smem), warp_sum);
  __syncthreads();
  int k = 0;
  for (; tile < tiles; ++k, tile += gridDim.x) {
    // tile k's edges and staged keep bytes from one half; tile k-1's keep
    // and tile k+1's decode in the other; one barrier (two with one half)
    const TileBuf cur = tile_buf(a, smem + (k & 1) * half);
    const TileBuf other = tile_buf(a, smem + ((k + 1) & 1) * half);
    pair_write<STAGE, BELOW>(a, st, tile, cur);
    if (STAGE && k > 0) pair_keep(a, tile - gridDim.x, other);
    if (tile + gridDim.x < tiles) {
      if (a.halves == 1) __syncthreads();
      pair_decode<BELOW>(a, st, tile + gridDim.x, other, warp_sum);
    }
    __syncthreads();
  }
  if (STAGE) pair_keep(a, tile - gridDim.x, tile_buf(a, smem + ((k + 1) & 1) * half));
}

// the current card's SM count, read once a card (a process may launch on
// several cards; a card's count is the same whichever thread reads it)
constexpr int kMaxCards = 64;

cudaError_t sm_count(int* sms) {
  static int cached[kMaxCards] = {};
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxCards && cached[dev]) {
    *sms = cached[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < kMaxCards) cached[dev] = *sms;
  return err;
}

// the dynamic shared memory a block of `fn` may take (227 KB on an H100,
// less the kernel's static shared memory)
template <typename F>
cudaError_t shared_room(F* fn, size_t* room) {
  cudaFuncAttributes fa;
  int dev, optin = 0;
  cudaError_t err = cudaFuncGetAttributes(&fa, fn);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *room = (size_t)optin - fa.sharedSizeBytes;
  return err;
}

// launch a persistent kernel fn(args..., tiles): as many CTAs as fit on the
// SMs, at most one a tile, with `shared` bytes of dynamic shared memory each
template <typename F, typename... A>
int launch_persistent(F* fn, int64_t tiles, size_t shared, void* stream, const A&... args) {
  cudaError_t err = cudaSuccess;
  if (shared > 48 * 1024)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
  int sms, per_sm = 0;
  if (err == cudaSuccess) err = sm_count(&sms);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, shared);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int64_t grid = tiles < (int64_t)sms * per_sm ? tiles : (int64_t)sms * per_sm;
  fn<<<(unsigned)grid, kThreads, shared, (cudaStream_t)stream>>>(args..., tiles);
  return (int)cudaGetLastError();
}

// refuse a launch whose live HYP or TORUS row holds more points (at most
// cap) than its kind's stage: the assertion fails the launch, and the
// CUDA context with it, before pair_edges_kernel runs on the stream
__global__ void stage_check_kernel(PairArgs a, Stage st) {
  for (int64_t r = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; r < a.rows;
       r += (int64_t)gridDim.x * blockDim.x) {
    const int ek = effective_kind(a.kind[r], a.kinds);
    if (!a.active[r] || (ek != kGeomHyp && ek != kGeomTorus)) continue;
    const int64_t lim = ek == kGeomHyp ? st.hyp : st.torus;
    const int64_t ca = a.count_a[r] < a.cap ? a.count_a[r] : a.cap;
    const int64_t cb = a.count_b[r] < a.cap ? a.count_b[r] : a.cap;
    assert(ca <= lim && cb <= lim);
  }
}

template <bool STAGE, bool BELOW>
int launch_pair_edges_as(PairArgs a, const Stage& st, void* stream) {
  size_t room;
  const cudaError_t err = shared_room(pair_edges_kernel<STAGE, BELOW>, &room);
  if (err != cudaSuccess) return (int)err;
  const size_t half = tile_buf_bytes(a.tile_rows, a.cap, a.area, STAGE);
  if (half > room) return (int)cudaErrorInvalidValue;
  a.halves = 2 * half <= room ? 2 : 1;
  const int64_t tiles = (a.rows + a.tile_rows - 1) / a.tile_rows;
  return launch_persistent(pair_edges_kernel<STAGE, BELOW>, tiles, a.halves * half, stream,
                           a, st);
}

// the no-stage instance, or (a stage below the capacity) the staged one
template <bool STAGE>
int launch_pair_edges(const PairArgs& a, const Stage& st, bool below, void* stream) {
  return below ? launch_pair_edges_as<STAGE, true>(a, st, stream)
               : launch_pair_edges_as<STAGE, false>(a, st, stream);
}

// cell_points ----------------------------------------------------------

struct CellArgs {
  const uint32_t* key;
  const int64_t *count, *cell;
  const double* geom;
  int64_t Kc, G, rows;
  int polar, cap, dim, tile_cells;
  double inv_scale;
  uint32_t m_cap;
  double* out;
  bool* mask;
};

// a tile's half of cell_points' shared memory: the cells' counts, their
// prefix, and the staged points (none when direct)
struct CellBuf {
  int* cnt;
  int* off;
  double* stage;
};

__host__ __device__ __forceinline__ size_t cell_buf_bytes(int TC, int cap, int dim,
                                                          bool direct) {
  return ((2 * TC + 1) * sizeof(int) + 15) / 16 * 16 + (direct ? 0 : (size_t)TC * cap * dim * 8);
}

__device__ __forceinline__ CellBuf cell_buf(const CellArgs& a, char* base) {
  CellBuf b;
  b.cnt = (int*)base;
  b.off = b.cnt + a.tile_cells;
  b.stage = (double*)(base + ((2 * a.tile_cells + 1) * sizeof(int) + 15) / 16 * 16);
  return b;
}

// draw tile `tile`'s points into `b` (into out when DIRECT): the cells'
// counts and their prefix, then one thread a point (the last cell whose
// offset is <= its index)
template <bool DIRECT>
__device__ void cell_draw(const CellArgs& a, int64_t tile, CellBuf b, int* warp_sum) {
  const int TC = a.tile_cells, cap = a.cap, dim = a.dim;
  const int64_t c0 = tile * TC;
  const int nc = (int)(a.rows - c0 < TC ? a.rows - c0 : TC);
  int c = 0;
  if (threadIdx.x < nc) {  // TC <= kThreads
    const int64_t v = a.count[c0 + threadIdx.x];
    c = (int)(v < 0 ? 0 : (v > cap ? cap : v));
    b.cnt[threadIdx.x] = c;
  }
  block_prefix(c, nc, b.off, warp_sum);
  const int total = b.off[nc];
  for (int p = threadIdx.x; p < total; p += kThreads) {
    const int cl = find_item(b.off, nc, p);
    const int i = p - b.off[cl];
    const int64_t r = c0 + cl;
    const Key2x32 slot = tf_fold_in(Key2x32{a.key[2 * r], a.key[2 * r + 1]}, (uint32_t)i);
    double* dst = (DIRECT ? a.out + (size_t)c0 * cap * dim : b.stage) +
                  ((size_t)cl * cap + i) * dim;
    // the reference divides by the plan's constant scale, which XLA
    // compiles as a multiplication by its float64 reciprocal
    if (a.polar) {
      const double* g = a.geom + r * a.G;  // (clo, chi, width)
      double ar;
      polar_draw(slot, g[0], g[1], (double)a.cell[r * a.Kc + 1], g[2], &ar, dst + 1);
      dst[0] = ar * a.inv_scale;
    } else {
      for (int d = 0; d < dim; ++d)
        dst[d] = ((double)a.cell[r * a.Kc + d] + uniform53(slot, (uint32_t)d)) * a.inv_scale;
    }
  }
}

// store tile `tile` from `b`: its slots in units of one slot (even dim)
// or two (odd dim), so that a unit is whole 16-byte pairs of doubles (c0
// cap is even: TC is), 0 on padding slots, and the mask; (cell, slot) is
// stepped with carries, not divided
template <int DIM>
__device__ void cell_store(const CellArgs& a, int64_t tile, CellBuf b) {
  constexpr int U = DIM & 1 ? 2 : 1;
  const int TC = a.tile_cells, cap = a.cap;
  const int64_t c0 = tile * TC;
  const int nc = (int)(a.rows - c0 < TC ? a.rows - c0 : TC);
  const int slots = nc * cap;
  double* out = a.out + c0 * cap * DIM;
  bool* mask = a.mask + c0 * cap;
  const int first = U * threadIdx.x, step = U * kThreads;
  int cl = (int)div_small((uint32_t)first, (uint32_t)cap, a.m_cap);
  int i = first - cl * cap;
  const int step_cl = step / cap, step_i = step - step_cl * cap;
  for (int s = first; s < slots; s += step) {
    double v[U * DIM];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      int ci = cl, ii = i + u;
      if (ii >= cap) ii -= cap, ++ci;
      const bool live = s + u < slots && ii < b.cnt[ci];
      if (s + u < slots) mask[s + u] = live;
#pragma unroll
      for (int d = 0; d < DIM; ++d) v[u * DIM + d] = live ? b.stage[(s + u) * DIM + d] : 0.0;
    }
    double2* o = (double2*)(out + (size_t)s * DIM);
    if (s + U <= slots) {
#pragma unroll
      for (int h = 0; h < U * DIM / 2; ++h) o[h] = make_double2(v[2 * h], v[2 * h + 1]);
    } else {  // an odd dim's last single slot
#pragma unroll
      for (int h = 0; h < DIM / 2; ++h) o[h] = make_double2(v[2 * h], v[2 * h + 1]);
      out[(size_t)s * DIM + DIM - 1] = v[DIM - 1];
    }
    i += step_i;
    const int ci = i >= cap;
    i -= ci ? cap : 0;
    cl += step_cl + ci;
  }
}

// the mask of tile `tile`, and 0 on its padding slots, of cells drawn
// straight into out
__device__ void cell_pad(const CellArgs& a, int64_t tile, CellBuf b) {
  const int TC = a.tile_cells, cap = a.cap, dim = a.dim;
  const int64_t c0 = tile * TC;
  const int nc = (int)(a.rows - c0 < TC ? a.rows - c0 : TC);
  for (int s = threadIdx.x; s < nc * cap; s += kThreads) {
    const bool live = s % cap < b.cnt[s / cap];
    a.mask[c0 * cap + s] = live;
    if (!live)
      for (int d = 0; d < dim; ++d) a.out[(c0 * cap + s) * dim + d] = 0.0;
  }
}

// two halves: tile k+1's draws go into one while tile k's stores drain
// from the other, one barrier a tile.  DIRECT: the cells are too wide to
// stage; their points go straight to out (a separate instance, so that
// the staged one addresses its tile as shared memory)
template <bool DIRECT>
__global__ void __launch_bounds__(kThreads) cell_points_kernel(CellArgs a, int64_t tiles) {
  extern __shared__ __align__(16) char smem[];
  __shared__ int warp_sum[kWarps];
  const size_t half = cell_buf_bytes(a.tile_cells, a.cap, a.dim, DIRECT);
  int64_t tile = blockIdx.x;
  if (tile >= tiles) return;
  cell_draw<DIRECT>(a, tile, cell_buf(a, smem), warp_sum);
  __syncthreads();
  for (int k = 0; tile < tiles; ++k, tile += gridDim.x) {
    const CellBuf cur = cell_buf(a, smem + (k & 1) * half);
    if (DIRECT) cell_pad(a, tile, cur);
    else if (a.dim == 2) cell_store<2>(a, tile, cur);
    else if (a.dim == 3) cell_store<3>(a, tile, cur);
    else cell_store<1>(a, tile, cur);
    if (tile + gridDim.x < tiles)
      cell_draw<DIRECT>(a, tile + gridDim.x, cell_buf(a, smem + ((k + 1) & 1) * half), warp_sum);
    __syncthreads();
  }
}

__device__ double libm_apply(int fn, double x) {
  switch (fn) {
    case 0: return L::xla_exp(x);
    case 1: return L::xla_expm1(x);
    case 2: return L::xla_log1p(x);
    case 3: return L::glibc_log(x);
    case 4: return L::glibc_sin(x);
    default: return L::glibc_cos(x);
  }
}

__global__ void libm_kernel(int fn, const double* __restrict__ x, double* __restrict__ y,
                            int64_t n) {
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < n;
       t += (int64_t)gridDim.x * blockDim.x)
    y[t] = libm_apply(fn, x[t]);
}

uint32_t magic(uint32_t d) { return (uint32_t)((((uint64_t)1 << 32) + d - 1) / d); }


}  // namespace

// Candidate-pair rows: kind int32 [R]; key_a, key_b uint32 [R, 2]; count_a,
// count_b int64 [R]; gid_a, gid_b int64 [R, K]; geom_a, geom_b float64
// [R, G]; fparams float64 [R, F]; self_pair, active bool [R]; kinds = the
// bits of the row kinds the launch runs (1 HYP, 2 TORUS, 4 CERT); a row of
// another kind keeps nothing, as in the plain version.  Out: edges int64
// [R, cap^2, 2], keep bool [R, cap^2] (16-byte aligned).  stage_hyp and
// stage_torus (0..cap) bound the counts of the live HYP and TORUS rows: a
// row's points are staged in shared memory for that many a side, and a
// count past its bound fails the launch with a device assertion (of a
// check kernel launched first where a stage is below cap).  Returns
// the cudaError_t: cudaErrorInvalidValue for a stage too wide for shared
// memory.
extern "C" int pair_edges(const void* kind, const void* key_a, const void* key_b,
                          const void* count_a, const void* count_b, const void* gid_a,
                          const void* gid_b, long long K, const void* geom_a,
                          const void* geom_b, long long G, const void* fparams,
                          long long F, const void* self_pair, const void* active,
                          long long rows, long long cap, long long stage_hyp,
                          long long stage_torus, int dim,
                          int kinds, void* edges,
                          void* keep, void* stream) {
  if (rows == 0 || cap == 0) return 0;
  if (cap > 32768 || stage_hyp < 0 || stage_hyp > cap || stage_torus < 0 ||
      stage_torus > cap || kinds < 0 || kinds > 7 ||
      ((uintptr_t)keep & 15) ||
      ((uintptr_t)edges & 15))
    return (int)cudaErrorInvalidValue;
  PairArgs a;
  a.kind = (const int32_t*)kind;
  a.key_a = (const uint32_t*)key_a;
  a.key_b = (const uint32_t*)key_b;
  a.count_a = (const int64_t*)count_a;
  a.count_b = (const int64_t*)count_b;
  a.gid_a = (const int64_t*)gid_a;
  a.gid_b = (const int64_t*)gid_b;
  a.geom_a = (const double*)geom_a;
  a.geom_b = (const double*)geom_b;
  a.fparams = (const double*)fparams;
  a.self_pair = (const bool*)self_pair;
  a.active = (const bool*)active;
  a.K = K, a.G = G, a.F = F, a.rows = rows;
  a.cap = (int)cap, a.dim = dim, a.kinds = kinds;
  // a stage below the capacity of a kind the launch runs picks the staged
  // instance and the check kernel; any other launch runs the no-stage one
  const bool below = ((kinds & kHyp) && stage_hyp < cap) || ((kinds & kTorus) && stage_torus < cap);
  Stage st;
  st.hyp = below ? (int)stage_hyp : (int)cap;
  st.torus = below ? (int)stage_torus : (int)cap;
  a.edges = (longlong2*)edges;
  a.keep = (uint8_t*)keep;
  const int cc = (int)(cap * cap);
  a.m_cap = magic((uint32_t)cap);
  a.step_j = kThreads % (int)cap;
  a.step_i = kThreads / (int)cap % (int)cap;
  a.step_row = kThreads / (int)cap / (int)cap;
  // a row's point area: two sides of st.hyp float64 features x 4 (HYP) or
  // of st.torus float32 x 4 points (TORUS), side b at byte st.half
  // whatever the row's kind (staged), else after side a's cap points of
  // the row's own kind (the stages are then cap); K ids (CERT)
  int half = 0;
  if (kinds & kHyp) half = st.hyp * 32;
  if ((kinds & kTorus) && st.torus * 16 > half) half = st.torus * 16;
  st.half = (half + 15) / 16 * 16;
  int area = 2 * st.half;
  if ((kinds & kCert) && 8 * (int)K > area) area = 8 * (int)K;
  a.area = (area + 15) / 16 * 16;
  // about 4096 slots a tile, in whole 512-slot windows where a multiple of
  // a few rows makes one; at most 256 rows and 48 KB for the two halves
  // with their keep bytes staged.  Wider rows (capacity above about 120)
  // go one a tile with their keep bytes stored as they are computed, in
  // two halves where the card's shared memory holds them, else in one
  int g = cc, w = kTileAlign;
  while (w) { const int t = g % w; g = w; w = t; }  // gcd(cc, 512)
  const int unit = kTileAlign / g;
  int tr;
  if (unit <= 256 && unit * cc <= 8192) {
    int m = 4096 / (unit * cc);
    m = m < 1 ? 1 : (m > 256 / unit ? 256 / unit : m);
    tr = unit * m;
  } else {
    tr = 4096 / cc < 1 ? 1 : (4096 / cc > 256 ? 256 : 4096 / cc);
  }
  while (tr > 1 && 2 * tile_buf_bytes(tr, (int)cap, a.area, true) > 48 * 1024) tr /= 2;
  a.stage_keep = 2 * tile_buf_bytes(tr, (int)cap, a.area, true) <= 48 * 1024;
  a.tile_rows = a.stage_keep ? tr : 1;
  if (below) {
    const long long blocks = (rows + 255) / 256 < 1024 ? (rows + 255) / 256 : 1024;
    stage_check_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(a, st);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return a.stage_keep ? launch_pair_edges<true>(a, st, below, stream)
                      : launch_pair_edges<false>(a, st, below, stream);
}

// Point-plan cells: key uint32 [R, 2]; count int64 [R]; cell int64 [R, Kc];
// geom float64 [R, G].  Out: points float64 [R, cap, dim] (0 on padding
// slots), mask bool [R, cap].  polar = 0 for cube cells, 1 for polar cells
// (dim 2); inv_scale = 1 / the plan's scale.
extern "C" int cell_points(const void* key, const void* count, const void* cell,
                           long long Kc, const void* geom, long long G, int polar,
                           double inv_scale, long long rows, long long cap, int dim,
                           void* out, void* mask, void* stream) {
  if (rows == 0 || cap == 0) return 0;
  if (cap > (1 << 24) || dim < 1 || dim > 3 || ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  CellArgs a;
  a.key = (const uint32_t*)key;
  a.count = (const int64_t*)count;
  a.cell = (const int64_t*)cell;
  a.geom = (const double*)geom;
  a.Kc = Kc, a.G = G, a.rows = rows;
  a.polar = polar, a.cap = (int)cap, a.dim = dim;
  a.inv_scale = inv_scale;
  a.m_cap = magic((uint32_t)cap);
  a.out = (double*)out;
  a.mask = (bool*)mask;
  // an even number of cells a tile, about 16 KB of staging, at most 256;
  // cells whose two staged tiles the card's shared memory cannot hold
  // (cap dim above about 7000) are drawn straight into out
  int tc = (int)(16 * 1024 / (cap * dim * 8));
  tc = tc > 256 ? 256 : tc;
  tc = tc < 2 ? 2 : tc & ~1;
  a.tile_cells = tc;
  size_t room;
  const cudaError_t err = shared_room(cell_points_kernel<false>, &room);
  if (err != cudaSuccess) return (int)err;
  const int64_t tiles = (rows + tc - 1) / tc;
  if (2 * cell_buf_bytes(tc, (int)cap, dim, false) <= room)
    return launch_persistent(cell_points_kernel<false>, tiles,
                             2 * cell_buf_bytes(tc, (int)cap, dim, false), stream, a);
  return launch_persistent(cell_points_kernel<true>, tiles,
                           2 * cell_buf_bytes(tc, (int)cap, dim, true), stream, a);
}

// The device libm functions on a float64 array, for holding them against
// their plain versions: fn 0 xla_exp, 1 xla_expm1, 2 xla_log1p, 3
// glibc_log, 4 glibc_sin, 5 glibc_cos.
extern "C" int libm_eval(int fn, const void* x, void* y, long long n, void* stream) {
  if (n == 0) return 0;
  if (fn < 0 || fn > 5) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096;
  libm_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(fn, (const double*)x,
                                                                  (double*)y, n);
  return (int)cudaGetLastError();
}
