// The collision sampler of the engine's sampled chunk rows (DIRECTED / TRI /
// RECT) over a [R, cap] batch, in eight launches and no host read.
//
// It replaces repro/core/sampling.py::_sample_collision (lines 91-133): per
// row, slot i < n = min(count, cap) draws bits64(fold_in(key, 0), i) mod
// max(universe, 1), slot i >= n holds universe + i, the row is sorted, and
// round t = 1..63 gives each value equal to its sorted predecessor the draw
// of round t at its sorted position and sorts again, until the row has no
// duplicate.  XLA lowers the reference from jnp; it reaches no Pallas
// kernel.
//
// What bounds it on an H100, and what the design does about it: the three
// Threefry-2x32 blocks a drawn slot (integer issue, about 1.7 ms for
// GNM(2^24, 2^28) generate's [136, 2,100,416]) against 8 bytes a slot
// written (0.7 ms); a general 64-bit sort (torch.sort's radix sort, 47.6
// ms there) would cost far more than both.  The draws are uniform, so a
// row is sorted by value ranges:
// 1. sample_draw_kernel draws each slot (the remainder by one reciprocal a
//    row, threefry.cuh's mod64), stores it in slot order in the scratch
//    buffer and counts its bucket v >> s in shared memory; s makes about
//    n / 2048 buckets of 2048-4096 expected values (at most 8192 buckets,
//    so rows past 2^24 draws have larger ones).  Sentinels are stored
//    in place: sorted position i >= n holds universe + i, larger than
//    every draw, so only the first n positions are ever sorted and a row
//    of count 0 costs its sentinel stores.
// 2. sample_offsets_kernel turns each row's counts into bucket starts.
// 3. sample_scatter_kernel moves a tile of 8192 draws into their buckets:
//    grouped by bucket in shared memory, each group's place reserved by
//    one atomic, then stored in runs (values within a bucket are in no
//    particular order: the next pass sorts them).  It and the bucket sort
//    keep two blocks on each SM.
// 4. sample_bucket_kernel sorts each bucket in shared memory (4096
//    sub-buckets by the next bits, then each value's rank within its
//    sub-bucket, a handful of values) and writes it back in place.  Equal
//    values share a bucket, so each bucket flags its own duplicates: the
//    sorted positions go to a per-row list (1024 kept).  A bucket past
//    shared memory is a run of one value (already in order) or, never
//    with uniform draws but handled all the same, sorted by one block in
//    global memory: tiles in shared memory, then pairwise merges through
//    the scratch buffer.
// 5. the redraw rounds; a clean row is not touched again.  With the
//    duplicate positions listed, a round draws the few fresh values at
//    those sorted positions, sorts them, and merges them with the
//    survivors: a survivor moves by at most the number redrawn, so a tile
//    of the new row needs only its old neighbourhood, and only the stretch
//    between the first and the last change moves.  Round 1, the one nearly
//    every row of a sparse plan needs once, runs across the card:
//    sample_plan_kernel (the fresh values and where they land, a block a
//    row), sample_copy_kernel (the old values at the edges of each tile of
//    the stretch, which its neighbours overwrite, into the scratch buffer)
//    and sample_merge_kernel (each tile of the stretch from its own old
//    values and those edges, flagging the next round's duplicates), so one
//    long row of a streamed wave does not wait on one SM.  sample_rounds_kernel runs the
//    rounds after it, one block a row, merging in place tile by tile (the
//    old stretch before each tile carried in shared memory).  A universe
//    of at most 8192 values is redrawn by counting values; a row with more
//    duplicates than the list holds takes the reference's round as it is:
//    replace the duplicates, sort the row in one block.
// Exactness: every value is the reference's draw, and the result is its
// sorted row; values are compared as signed int64.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 512;                   // every kernel of the sampler
constexpr int kPerThread = 16;
constexpr int kTile = kThreads * kPerThread;    // the largest block sorted in shared memory
constexpr int kTarget = 2048;                   // buckets a row: ceil(n / kTarget)
constexpr int kSubBits = 12;                    // sub-buckets of a shared-memory sort
constexpr int kHistMax = 8192;                  // buckets a row at most (counted in shared memory)
constexpr int kListMax = 1024;                  // duplicate positions listed per row
constexpr int kSpan = 4096;                     // output tile of a listed round
constexpr int kSmallUniverse = 8192;            // universes redrawn by counting values
constexpr int kDrawTile = kThreads * 32;        // slots a draw block takes
constexpr int kMaxRounds = 64;                  // rounds 1..63 (ref.MAX_FIX_ROUNDS)

// shared memory (bytes) of the kernels that take it dynamically
constexpr int kSortSmem = kTile * 8 + (2 << kSubBits) * 4 + 16;
constexpr int kScatterSmem = kTile * 8 + (kHistMax + 1) * 4;
constexpr int kMergeWords = 2 * kSpan + 2 * kListMax + 2;     // a listed round's window and tile
constexpr int kRegionBytes =
    ((kSortSmem > kMergeWords * 8 ? kSortSmem : kMergeWords * 8) + 15) / 16 * 16;
constexpr int kRoundsSmem = kRegionBytes + kListMax * 8 + 3 * kListMax * 4;
constexpr int kMergeBytes = (kMergeWords * 8 + 15) / 16 * 16;
constexpr int kMergeSmem = kMergeBytes + kListMax * 8 + 2 * kListMax * 4;
static_assert((kSmallUniverse + 1) * 4 <= kRegionBytes, "counting round fits the region");
static_assert(kSpan >= kListMax, "a listed round carries at most one tile");

// One row's draws and buckets (repro_torch.kernels.sampler.ref.row_buckets
// is the plain twin): n draws modulo m; bucket of v is v >> s, nb buckets,
// nb <= min(ceil(cap / kTarget), kHistMax).
struct RowPlan {
  int64_t n;
  uint64_t m;
  int s;
  int64_t nb;
};

__device__ RowPlan row_plan(int64_t universe, int64_t count, int64_t cap) {
  RowPlan p;
  p.n = count < 0 ? 0 : (count > cap ? cap : count);
  p.m = universe > 1 ? (uint64_t)universe : 1ull;
  uint64_t limit = p.n > 0 ? (uint64_t)((p.n + kTarget - 1) / kTarget) : 1ull;
  if (limit > kHistMax) limit = kHistMax;
  p.s = 0;
  while (((p.m - 1) >> p.s) >= limit) ++p.s;
  p.nb = p.n > 0 ? (int64_t)((p.m - 1) >> p.s) + 1 : 0;
  return p;
}

__device__ __forceinline__ int bit_length(uint64_t x) {
  return x ? 64 - __clzll((long long)x) : 0;
}

// Exclusive prefix sum of a[0, len) in place (shared or global memory),
// by every thread of the block; returns the total.  Starts and ends with
// a barrier.
__device__ long long block_scan(int* a, long long len) {
  __shared__ long long warp_sum[kThreads / 32];
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long per = (len + kThreads - 1) / kThreads;
  const long long lo = (long long)threadIdx.x * per < len ? (long long)threadIdx.x * per : len;
  const long long hi = lo + per < len ? lo + per : len;
  long long sum = 0;
  for (long long j = lo; j < hi; ++j) sum += a[j];
  long long x = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    long long w = lane < kThreads / 32 ? warp_sum[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kThreads / 32) warp_sum[lane] = w;
  }
  __syncthreads();
  long long run = x - sum + (warp ? warp_sum[warp - 1] : 0);
  for (long long j = lo; j < hi; ++j) {
    const int c = a[j];
    a[j] = (int)run;
    run += c;
  }
  const long long total = warp_sum[kThreads / 32 - 1];
  __syncthreads();
  return total;
}

// Sorts the n <= kTile values held in registers (v[k] where k * kThreads +
// thread < n), all in [base, base + 2^s): counted into 2^min(s, kSubBits)
// sub-buckets by their top bits, staged by sub-bucket, then each staged
// value's rank within its sub-bucket (values below it, and equal ones
// staged before it).  Calls emit(q, v, dup) with each value's sorted
// position q and whether it equals its sorted predecessor; consecutive
// threads emit neighbouring positions.  cnt and cursor hold 2^kSubBits + 1
// ints each, stage kTile values.  Starts and ends with a barrier.
template <typename Emit>
__device__ void block_sort_range(const int64_t (&v)[kPerThread], int n, int64_t base, int s,
                                 int* cnt, int* cursor, int64_t* stage, Emit emit) {
  const int ks = s < kSubBits ? s : kSubBits;
  const int sh = s - ks;
  const int K = 1 << ks;
  __syncthreads();
  for (int j = threadIdx.x; j <= K; j += kThreads) cnt[j] = 0;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kPerThread; ++k)
    if (k * kThreads + (int)threadIdx.x < n) atomicAdd(&cnt[(uint64_t)(v[k] - base) >> sh], 1);
  block_scan(cnt, K + 1);     // cnt[j]: first staged position of sub-bucket j
  for (int j = threadIdx.x; j < K; j += kThreads) cursor[j] = cnt[j];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kPerThread; ++k)
    if (k * kThreads + (int)threadIdx.x < n)
      stage[atomicAdd(&cursor[(uint64_t)(v[k] - base) >> sh], 1)] = v[k];
  __syncthreads();
  for (int x = threadIdx.x; x < n; x += kThreads) {
    const int64_t val = stage[x];
    const int j = (int)((uint64_t)(val - base) >> sh);
    const int lo = cnt[j], hi = cnt[j + 1];
    int less = 0, before = 0;
    for (int y = lo; y < hi; ++y) {
      const int64_t w = stage[y];
      less += w < val;
      before += (w == val) & (y < x);
    }
    emit(lo + less + before, val, before > 0);
  }
  __syncthreads();
}

// Values of a among the first diag of merge(a, b), a first on ties.
__device__ long long co_rank(long long diag, const int64_t* a, long long na,
                             const int64_t* b, long long nb) {
  long long lo = diag > nb ? diag - nb : 0, hi = diag < na ? diag : na;
  while (lo < hi) {
    const long long i = (lo + hi) >> 1;
    if (a[i] <= b[diag - i - 1])
      lo = i + 1;
    else
      hi = i;
  }
  return lo;
}

// out[0, na + nb) = merge(a, b) by every thread of the block, each a
// contiguous stretch of the output; out overlaps neither input.
__device__ void block_merge(const int64_t* a, long long na, const int64_t* b, long long nb,
                            int64_t* out) {
  const long long total = na + nb, per = (total + kThreads - 1) / kThreads;
  const long long d0 = (long long)threadIdx.x * per < total ? (long long)threadIdx.x * per : total;
  const long long d1 = d0 + per < total ? d0 + per : total;
  if (d0 >= d1) return;
  long long i = co_rank(d0, a, na, b, nb), j = d0 - i;
  for (long long o = d0; o < d1; ++o) {
    if (j >= nb || (i < na && a[i] <= b[j]))
      out[o] = a[i++];
    else
      out[o] = b[j++];
  }
}

// Sorts a[0, n) (values in [base, base + 2^s)) by one block: tiles of
// `tile` <= kTile values sorted in shared memory into tmp, then runs merged
// pairwise between tmp and a until one is left, which ends in a.
__device__ void block_merge_sort(int64_t* a, int64_t* tmp, long long n, int64_t base, int s,
                                 int tile, int* cnt, int* cursor, int64_t* stage) {
  for (long long x = 0; x < n; x += tile) {
    const int len = (int)(n - x < tile ? n - x : tile);
    int64_t v[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int i = k * kThreads + threadIdx.x;
      v[k] = i < len ? a[x + i] : 0;
    }
    int64_t* dst = tmp + x;
    block_sort_range(v, len, base, s, cnt, cursor, stage,
                     [&](int q, int64_t val, bool) { dst[q] = val; });
  }
  int64_t* src = tmp;
  int64_t* dst = a;
  for (long long w = tile; w < n; w *= 2) {
    for (long long lo = 0; lo < n; lo += 2 * w) {
      const long long mid = lo + w < n ? lo + w : n, hi = lo + 2 * w < n ? lo + 2 * w : n;
      block_merge(src + lo, mid - lo, src + mid, hi - mid, dst + lo);
    }
    __syncthreads();
    int64_t* t = src;
    src = dst;
    dst = t;
  }
  if (src != a)
    for (long long i = threadIdx.x; i < n; i += kThreads) a[i] = src[i];
  __syncthreads();
}

// Sorts a[0, len) in shared memory, len a power of two, by every thread.
template <typename T>
__device__ void bitonic(T* a, int len) {
  for (int k = 2; k <= len; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      __syncthreads();
      for (int i = threadIdx.x; i < len; i += kThreads) {
        const int l = i ^ j;
        if (l > i && (a[i] > a[l]) == ((i & k) == 0)) {
          const T t = a[i];
          a[i] = a[l];
          a[l] = t;
        }
      }
    }
  __syncthreads();
}

__device__ __forceinline__ long long count_below(const int64_t* a, long long n, int64_t v) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (a[mid] < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int count_below(const int* a, int n, long long v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int count_upto(const int64_t* a, int n, int64_t v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__device__ __forceinline__ void add_dup(int* ndup, int* list, int list_cap, int q) {
  const int idx = atomicAdd(ndup, 1);
  if (idx < list_cap) list[idx] = q;
}

__device__ __forceinline__ int64_t draw(Key2x32 k, int64_t i, Mod64 m) {
  return (int64_t)mod64(tf_bits64(k, (uint32_t)i), m);
}

// 1. draws in slot order into `drawn`, bucket counts; sentinels into out
__global__ void __launch_bounds__(kThreads) sample_draw_kernel(
    const uint32_t* __restrict__ key, const int64_t* __restrict__ universe,
    const int64_t* __restrict__ count, int64_t cap, int64_t tiles_per_row, int nb_max,
    int64_t* __restrict__ out, int64_t* __restrict__ drawn, int* __restrict__ counts) {
  __shared__ int hist[kHistMax];
  __shared__ Key2x32 round_key;
  const int64_t r = blockIdx.x / tiles_per_row;
  const int64_t lo = (blockIdx.x % tiles_per_row) * (int64_t)kDrawTile;
  const int64_t hi = lo + kDrawTile < cap ? lo + kDrawTile : cap;
  const RowPlan p = row_plan(universe[r], count[r], cap);
  const int64_t at = r * cap;
  for (int64_t i = (lo > p.n ? lo : p.n) + threadIdx.x; i < hi; i += kThreads)
    out[at + i] = universe[r] + i;     // sentinel: its slot is its sorted position
  if (lo >= p.n) return;
  if (threadIdx.x == 0) round_key = tf_fold_in(Key2x32{key[2 * r], key[2 * r + 1]}, 0u);
  for (int j = threadIdx.x; j < p.nb; j += kThreads) hist[j] = 0;
  __syncthreads();
  const Mod64 mod = mod64_init(p.m);
  const int64_t end = hi < p.n ? hi : p.n;
  for (int64_t i = lo + threadIdx.x; i < end; i += kThreads) {
    const int64_t v = draw(round_key, i, mod);
    drawn[at + i] = v;
    atomicAdd(&hist[v >> p.s], 1);
  }
  __syncthreads();
  int* row_counts = counts + r * nb_max;
  for (int j = threadIdx.x; j < p.nb; j += kThreads)
    if (hist[j]) atomicAdd(&row_counts[j], hist[j]);
}

// 2. bucket counts -> bucket starts, one block a row
__global__ void __launch_bounds__(kThreads) sample_offsets_kernel(
    const int64_t* __restrict__ universe, const int64_t* __restrict__ count, int64_t cap,
    int nb_max, int* __restrict__ counts) {
  const RowPlan p = row_plan(universe[blockIdx.x], count[blockIdx.x], cap);
  if (p.nb) block_scan(counts + (int64_t)blockIdx.x * nb_max, p.nb);
}

// 3. a tile of draws into its buckets of out; offsets advance to the ends
__global__ void __launch_bounds__(kThreads, 2) sample_scatter_kernel(
    const int64_t* __restrict__ universe, const int64_t* __restrict__ count, int64_t cap,
    int64_t tiles_per_row, int nb_max, const int64_t* __restrict__ drawn,
    int* __restrict__ offsets, int64_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* stage = (int64_t*)smem;
  int* first = (int*)(stage + kTile);         // per bucket: first staged position
  const int64_t r = blockIdx.x / tiles_per_row;
  const int64_t t0 = (blockIdx.x % tiles_per_row) * (int64_t)kTile;
  const RowPlan p = row_plan(universe[r], count[r], cap);
  if (t0 >= p.n) return;
  const int len = (int)(p.n - t0 < kTile ? p.n - t0 : kTile);
  const int nb = (int)p.nb;
  const int64_t at = r * cap;
  for (int j = threadIdx.x; j <= nb; j += kThreads) first[j] = 0;
  __syncthreads();
  int64_t v[kPerThread];
  int rank[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int i = k * kThreads + threadIdx.x;
    if (i < len) {
      v[k] = drawn[at + t0 + i];
      rank[k] = atomicAdd(&first[v[k] >> p.s], 1);
    }
  }
  block_scan(first, nb + 1);
#pragma unroll
  for (int k = 0; k < kPerThread; ++k)
    if (k * kThreads + (int)threadIdx.x < len) stage[first[v[k] >> p.s] + rank[k]] = v[k];
  // each thread reserves a contiguous range of buckets in the row (one
  // atomic a bucket with values), right to left, and leaves in first[b]
  // the row position of the tile's staged index 0 within bucket b
  const int per = (nb + kThreads - 1) / kThreads;
  const int b_lo = (int)threadIdx.x * per < nb ? (int)threadIdx.x * per : nb;
  const int b_hi = b_lo + per < nb ? b_lo + per : nb;
  int next = b_hi > b_lo ? first[b_hi] : 0;
  __syncthreads();
  int* row_off = offsets + r * nb_max;
  for (int b = b_hi - 1; b >= b_lo; --b) {
    const int f = first[b];
    first[b] = next > f ? atomicAdd(&row_off[b], next - f) - f : 0;
    next = f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < len; i += kThreads) {
    const int64_t x = stage[i];
    out[at + first[x >> p.s] + i] = x;
  }
}

// 4. one bucket sorted in place; its duplicates listed
__global__ void __launch_bounds__(kThreads, 2) sample_bucket_kernel(
    const int64_t* __restrict__ universe, const int64_t* __restrict__ count, int64_t cap,
    int nb_max, int bucket_cap, int list_cap, const int* __restrict__ offsets,
    int64_t* __restrict__ out, int64_t* __restrict__ tmp, int* __restrict__ ndup,
    int* __restrict__ dups) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int first_dup;
  int64_t* stage = (int64_t*)smem;
  int* cnt = (int*)(stage + kTile);
  int* cursor = cnt + (1 << kSubBits) + 1;
  const int64_t r = blockIdx.x / nb_max;
  const int b = (int)(blockIdx.x % nb_max);
  const RowPlan p = row_plan(universe[r], count[r], cap);
  if (b >= p.nb) return;
  const int* row_off = offsets + r * nb_max;     // after the scatter: each bucket's end
  const int64_t start = b ? row_off[b - 1] : 0, len = row_off[b] - start;
  if (len == 0) return;
  int64_t* seg = out + r * cap + start;
  const int64_t base = (int64_t)b << p.s;
  int* rd = ndup + r;
  int* rl = dups + r * kListMax;
  if (len <= bucket_cap) {
    int64_t v[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int i = k * kThreads + threadIdx.x;
      v[k] = i < len ? seg[i] : 0;
    }
    block_sort_range(v, (int)len, base, p.s, cnt, cursor, stage,
                     [&](int q, int64_t x, bool dup) {
                       seg[q] = x;
                       if (dup) add_dup(rd, rl, list_cap, (int)(start + q));
                     });
  } else if (p.s == 0) {     // one value a bucket: in order already
    for (int64_t i = threadIdx.x; i < len; i += kThreads) seg[i] = base;
    if (threadIdx.x == 0) first_dup = atomicAdd(rd, (int)(len - 1));
    __syncthreads();
    for (int64_t j = threadIdx.x; j < len - 1 && first_dup + j < list_cap; j += kThreads)
      rl[first_dup + j] = (int)(start + 1 + j);
  } else {
    block_merge_sort(seg, tmp + r * cap + start, len, base, p.s, bucket_cap, cnt, cursor, stage);
    for (int64_t i = 1 + threadIdx.x; i < len; i += kThreads)
      if (seg[i] == seg[i - 1]) add_dup(rd, rl, list_cap, (int)(start + i));
  }
}

struct Row {
  int64_t* x;      // the row: sorted, its first n positions the draws
  int64_t* tmp;    // the row's scratch
  int64_t n;
  Mod64 mod;
  int s_all;       // every value < 2^s_all
};

// The plan of a listed round (d <= kListMax duplicates, their positions in
// P in any order): P sorted, the fresh values drawn at those positions and
// sorted in F, and DF[j], the position fresh value j lands at (after j fresh
// values and the survivors below it).  Positions outside [a0, stop) keep
// their values.  P, F, DF have room for kListMax entries.
__device__ void listed_plan(const Row& row, Key2x32 kt, int d, int64_t* F, int* P, int* DF,
                            int64_t& a0, int64_t& stop) {
  int pw = 1;
  while (pw < d) pw <<= 1;
  __syncthreads();
  for (int j = threadIdx.x; j < pw; j += kThreads) {
    F[j] = j < d ? draw(kt, P[j], row.mod) : INT64_MAX;
    if (j >= d) P[j] = INT_MAX;
  }
  bitonic(P, pw);
  bitonic(F, pw);
  for (int j = threadIdx.x; j < d; j += kThreads) {
    const long long below = count_below(row.x, row.n, F[j]);
    DF[j] = (int)(j + below - count_below(P, d, below));
  }
  __syncthreads();
  a0 = P[0] < DF[0] ? P[0] : DF[0];
  const int64_t last = P[d - 1] > DF[d - 1] ? P[d - 1] : DF[d - 1];
  stop = last + 2 < row.n ? last + 2 : row.n;
}

// The new values of positions [lo, lo + len) after a listed round, into T,
// from W[w] = the old value at lo - d + w for w < len + 2d (a survivor
// moves by at most d; W entries outside [0, n) are not read).
__device__ void listed_tile(const Row& row, int d, const int64_t* F, const int* P,
                            const int* DF, const int64_t* W, int64_t lo, int len, int64_t* T) {
  for (int w = threadIdx.x; w < len + 2 * d; w += kThreads) {
    const int64_t q = lo - d + w;
    if (q < 0 || q >= row.n) continue;
    const int j = count_below(P, d, q);      // duplicates before q
    if (j < d && P[j] == q) continue;        // a duplicate: a fresh value replaces it
    const int64_t dst = q - j + count_upto(F, d, W[w]);
    if (dst >= lo && dst < lo + len) T[dst - lo] = W[w];
  }
  for (int j = threadIdx.x; j < d; j += kThreads)
    if (DF[j] >= lo && DF[j] < lo + len) T[DF[j] - lo] = F[j];
}

// A listed round by one block: merged in place, tile by tile, the old
// values of the stretch before each tile carried in shared memory.
// Returns the new duplicates' count; NP lists them.
__device__ int round_listed(const Row& row, Key2x32 kt, int d, int list_cap, int64_t* region,
                            int64_t* F, int* P, int* NP, int* DF) {
  __shared__ int new_dups;
  __shared__ int64_t prev;
  int64_t a0, stop;
  listed_plan(row, kt, d, F, P, DF, a0, stop);
  int64_t* W = region;                              // old values of [a - d, a + kSpan + d)
  int64_t* T = region + kSpan + 2 * kListMax + 1;   // the new values of [a, a + kSpan)
  if (threadIdx.x == 0) {
    new_dups = 0;
    prev = a0 > 0 ? row.x[a0 - 1] : -1;
  }
  for (int w = threadIdx.x; w < d; w += kThreads) W[w] = a0 - d + w >= 0 ? row.x[a0 - d + w] : -1;
  for (int64_t a = a0; a < stop; a += kSpan) {
    for (int w = threadIdx.x; w < kSpan + d; w += kThreads)
      W[d + w] = a + w < row.n ? row.x[a + w] : -1;
    __syncthreads();
    listed_tile(row, d, F, P, DF, W, a, kSpan, T);
    __syncthreads();
    const int lim = (int)(stop - a < kSpan ? stop - a : kSpan);
    for (int o = threadIdx.x; o < lim; o += kThreads) {
      const int64_t v = T[o];
      if (v == (o ? T[o - 1] : prev)) {
        const int idx = atomicAdd(&new_dups, 1);
        if (idx < list_cap) NP[idx] = (int)(a + o);
      }
      row.x[a + o] = v;
    }
    // the old values of [a + kSpan - d, a + kSpan) lead the next window
    for (int w = threadIdx.x; w < d; w += kThreads) W[w] = W[kSpan + w];
    __syncthreads();
    if (threadIdx.x == 0) prev = T[lim - 1];
  }
  __syncthreads();
  const int nd = new_dups;
  __syncthreads();
  return nd;
}

// A round of the reference as it is: each duplicate takes its fresh value
// in place, then the row is sorted by one block.
__device__ int round_sorted(const Row& row, Key2x32 kt, int list_cap, int tile,
                            int64_t* region, int* NP) {
  __shared__ int new_dups;
  __shared__ int64_t last;
  if (threadIdx.x == 0) last = -1;
  for (int64_t t0 = 0; t0 < row.n; t0 += kThreads) {
    const int64_t i = t0 + threadIdx.x;
    int64_t v = 0, pv = 0;
    __syncthreads();
    if (i < row.n) {
      v = row.x[i];
      pv = threadIdx.x ? row.x[i - 1] : last;
    }
    __syncthreads();     // the tile's old values are read
    if (i < row.n && v == pv) row.x[i] = draw(kt, i, row.mod);
    if (i < row.n && (threadIdx.x == kThreads - 1 || i == row.n - 1)) last = v;
  }
  __syncthreads();
  int* cnt = (int*)(region + kTile);
  block_merge_sort(row.x, row.tmp, row.n, 0, row.s_all, tile, cnt, cnt + (1 << kSubBits) + 1,
                   region);
  if (threadIdx.x == 0) new_dups = 0;
  __syncthreads();
  for (int64_t i = 1 + threadIdx.x; i < row.n; i += kThreads)
    if (row.x[i] == row.x[i - 1]) {
      const int idx = atomicAdd(&new_dups, 1);
      if (idx < list_cap) NP[idx] = (int)i;
    }
  __syncthreads();
  const int nd = new_dups;
  __syncthreads();
  return nd;
}

// A round of a universe of at most kSmallUniverse values: survivors (one
// per distinct value) and fresh values counted by value, the row rewritten
// from the counts.
__device__ int round_counted(const Row& row, Key2x32 kt, int64_t* region) {
  __shared__ int distinct;
  int* H = (int*)region;
  const int m = (int)row.mod.d;
  for (int j = threadIdx.x; j <= m; j += kThreads) H[j] = 0;
  if (threadIdx.x == 0) distinct = 0;
  __syncthreads();
  for (int64_t i = threadIdx.x; i < row.n; i += kThreads) {
    const int64_t v = row.x[i];
    atomicAdd(&H[i > 0 && v == row.x[i - 1] ? draw(kt, i, row.mod) : v], 1);
  }
  block_scan(H, m + 1);      // H[v]: first position of value v; H[m] = n
  int mine = 0;
  for (int v = threadIdx.x; v < m; v += kThreads) mine += H[v + 1] > H[v];
  atomicAdd(&distinct, mine);
  for (int64_t o = threadIdx.x; o < row.n; o += kThreads) {
    int lo = 0, hi = m;      // the last value whose first position is <= o
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (H[mid] <= o)
        lo = mid;
      else
        hi = mid;
    }
    row.x[o] = lo;
  }
  __syncthreads();
  const int nd = (int)(row.n - distinct);
  __syncthreads();
  return nd;
}

// The first redraw round of a listed row spread over the card (5a-5c): the
// plan per row, the changed stretch copied aside, then each tile of it
// merged from the copy.  plan: per row {taken, d, a0, stop} int32 and P,
// DF int32, F int64 of kListMax entries; the new duplicates go to ndup1,
// dups1.
struct FirstRound {
  int* meta;
  int* P;
  int* DF;
  int64_t* F;
  int* ndup1;
  int* dups1;
};

__device__ __forceinline__ Row row_of(const RowPlan& p, int64_t* out, int64_t* tmp,
                                      int64_t r, int64_t cap) {
  return Row{out + r * cap, tmp + r * cap, p.n, mod64_init(p.m), bit_length(p.m - 1)};
}

// 5a. the plan of round 1, one block a row with listed duplicates
__global__ void __launch_bounds__(kThreads) sample_plan_kernel(
    const uint32_t* __restrict__ key, const int64_t* __restrict__ universe,
    const int64_t* __restrict__ count, int64_t cap, int list_cap, int64_t* __restrict__ out,
    const int* __restrict__ ndup, const int* __restrict__ dups, FirstRound fr) {
  __shared__ int64_t F[kListMax];
  __shared__ int P[kListMax], DF[kListMax];
  const int64_t r = blockIdx.x;
  const RowPlan p = row_plan(universe[r], count[r], cap);
  const int d = ndup[r];
  if (d == 0 || d > list_cap || p.m <= (uint64_t)kSmallUniverse) return;
  for (int j = threadIdx.x; j < d; j += kThreads) P[j] = dups[r * kListMax + j];
  const Row row = row_of(p, out, out, r, cap);
  const Key2x32 kt = tf_fold_in(Key2x32{key[2 * r], key[2 * r + 1]}, 1u);
  int64_t a0, stop;
  listed_plan(row, kt, d, F, P, DF, a0, stop);
  for (int j = threadIdx.x; j < d; j += kThreads) {
    fr.P[r * kListMax + j] = P[j];
    fr.F[r * kListMax + j] = F[j];
    fr.DF[r * kListMax + j] = DF[j];
  }
  if (threadIdx.x == 0) {
    fr.meta[4 * r] = 1;
    fr.meta[4 * r + 1] = d;
    fr.meta[4 * r + 2] = (int)a0;
    fr.meta[4 * r + 3] = (int)stop;
  }
}

// 5b. the old values a merge tile [a, a + kSpan) of the stretch [a0, stop)
// reads outside its own positions, which its neighbours overwrite: [a - 1
// - d, a) and [a + kSpan, a + kSpan + d), within the stretch, copied to tmp
__global__ void __launch_bounds__(kThreads) sample_copy_kernel(
    int64_t cap, int64_t tiles_per_row, const int64_t* __restrict__ out,
    int64_t* __restrict__ tmp, FirstRound fr) {
  const int64_t r = blockIdx.x / tiles_per_row;
  const int* meta = fr.meta + 4 * r;
  if (!meta[0]) return;
  const int d = meta[1];
  const int64_t a0 = meta[2], stop = meta[3];
  const int64_t a = a0 + (blockIdx.x % tiles_per_row) * (int64_t)kSpan;
  if (a >= stop) return;
  for (int w = threadIdx.x; w < 2 * d + 1; w += kThreads) {
    const int64_t q = w <= d ? a - 1 - d + w : a + kSpan + (w - d - 1);
    if (q >= a0 && q < stop) tmp[r * cap + q] = out[r * cap + q];
  }
}

// 5c. one tile [a, a + kSpan) of the stretch merged from the copy
__global__ void __launch_bounds__(kThreads) sample_merge_kernel(
    const int64_t* __restrict__ universe, const int64_t* __restrict__ count, int64_t cap,
    int64_t tiles_per_row, int list_cap, int64_t* __restrict__ out,
    const int64_t* __restrict__ tmp, FirstRound fr) {
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* W = (int64_t*)smem;                 // old values of [a - 1 - d, a + kSpan + d)
  int64_t* T = W + kSpan + 2 * kListMax + 1;   // the new values of [a - 1, a + kSpan)
  int64_t* F = (int64_t*)(smem + kMergeBytes);
  int* P = (int*)(F + kListMax);
  int* DF = P + kListMax;
  const int64_t r = blockIdx.x / tiles_per_row;
  const int* meta = fr.meta + 4 * r;
  if (!meta[0]) return;
  const int d = meta[1];
  const int64_t a0 = meta[2], stop = meta[3];
  const int64_t a = a0 + (blockIdx.x % tiles_per_row) * (int64_t)kSpan;
  if (a >= stop) return;
  const RowPlan p = row_plan(universe[r], count[r], cap);
  const Row row = row_of(p, out, out, r, cap);
  const int64_t* old = tmp + r * cap;
  for (int j = threadIdx.x; j < d; j += kThreads) {
    P[j] = fr.P[r * kListMax + j];
    F[j] = fr.F[r * kListMax + j];
    DF[j] = fr.DF[r * kListMax + j];
  }
  const int64_t lo = a - 1;
  for (int w = threadIdx.x; w < kSpan + 1 + 2 * d; w += kThreads) {
    // positions of the stretch outside this tile are its neighbours': their
    // old values are in the copy
    const int64_t q = lo - d + w;
    const bool copied = q >= a0 && q < stop && (q < a || q >= a + kSpan);
    W[w] = q < 0 || q >= row.n ? -1 : (copied ? old[q] : row.x[q]);
  }
  __syncthreads();
  listed_tile(row, d, F, P, DF, W, lo, kSpan + 1, T);
  __syncthreads();
  const int lim = (int)(stop - a < kSpan ? stop - a : kSpan);
  for (int o = threadIdx.x; o < lim; o += kThreads) {
    const int64_t v = T[o + 1];
    if (a + o > 0 && v == T[o]) add_dup(fr.ndup1 + r, fr.dups1 + r * kListMax, list_cap,
                                        (int)(a + o));
    row.x[a + o] = v;
  }
}

// 5. the remaining redraw rounds, one block a row; rounds[r] = rounds taken
__global__ void __launch_bounds__(kThreads) sample_rounds_kernel(
    const uint32_t* __restrict__ key, const int64_t* __restrict__ universe,
    const int64_t* __restrict__ count, int64_t cap, int bucket_cap, int list_cap,
    int64_t* __restrict__ out, int64_t* __restrict__ tmp, const int* __restrict__ ndup,
    const int* __restrict__ dups, FirstRound fr, int* __restrict__ rounds) {
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* region = (int64_t*)smem;
  int64_t* F = (int64_t*)(smem + kRegionBytes);
  int* P = (int*)(F + kListMax);
  int* NP = P + kListMax;
  int* DF = NP + kListMax;
  const int64_t r = blockIdx.x;
  const RowPlan p = row_plan(universe[r], count[r], cap);
  const bool first_taken = fr.meta[4 * r] != 0;      // round 1 ran across the card
  int d = first_taken ? fr.ndup1[r] : ndup[r], done = first_taken ? 1 : 0;
  const int* list = first_taken ? fr.dups1 + r * kListMax : dups + r * kListMax;
  if (d > 0 && p.m == 1) {
    done = kMaxRounds - 1;   // every draw is 0: no round changes the row
  } else if (d > 0) {
    const Row row = row_of(p, out, tmp, r, cap);
    const Key2x32 k{key[2 * r], key[2 * r + 1]};
    const bool counted = p.m <= (uint64_t)kSmallUniverse;
    bool listed = d <= list_cap;
    if (listed)
      for (int j = threadIdx.x; j < d; j += kThreads) P[j] = list[j];
    __syncthreads();
    for (int t = done + 1; t < kMaxRounds && d > 0; ++t) {
      const Key2x32 kt = tf_fold_in(k, (uint32_t)t);
      if (counted)
        d = round_counted(row, kt, region);
      else if (listed)
        d = round_listed(row, kt, d, list_cap, region, F, P, NP, DF);
      else
        d = round_sorted(row, kt, list_cap, bucket_cap, region, NP);
      ++done;
      listed = d <= list_cap;
      if (listed && !counted)
        for (int j = threadIdx.x; j < d; j += kThreads) P[j] = NP[j];
      __syncthreads();
    }
  }
  if (rounds != nullptr && threadIdx.x == 0) rounds[r] = done;
}

bool grid_ok(long long blocks) { return blocks > 0 && blocks <= INT_MAX; }

}  // namespace

// key uint32 [R, 2]; universe (>= 0), count int64 [R]; out int64 [R,
// capacity] (the sorted rows); scratch int64 [R, capacity]; work int32
// zeros of R * (nb_max + 4 * 1024 + 6) + 1 + 2 * R * 1024 words (bucket
// counts, duplicate counts and lists, the first round's plan), nb_max =
// min(ceil(capacity / 2048), 8192); rounds int32 [R] or null (each row's
// redraw rounds).
// bucket_cap (1..8192) and list_cap (0..1024) bound the buckets sorted in
// shared memory and the duplicates listed a row; smaller values send more
// rows through the paths for large ones.  Returns the first launch error.
extern "C" int chunk_sample(const void* key, const void* universe, const void* count,
                            long long rows, long long capacity, int nb_max, int bucket_cap,
                            int list_cap, void* out, void* scratch, void* work, void* rounds,
                            void* stream) {
  if (rows == 0 || capacity == 0) return 0;
  const long long want_nb = (capacity + kTarget - 1) / kTarget;
  if (capacity > INT_MAX || nb_max != (want_nb < kHistMax ? want_nb : kHistMax) ||
      bucket_cap < 1 || bucket_cap > kTile || list_cap < 0 || list_cap > kListMax)
    return (int)cudaErrorInvalidValue;
  const long long draw_tiles = (capacity + kDrawTile - 1) / kDrawTile;
  const long long tiles = (capacity + kTile - 1) / kTile;
  const long long spans = (capacity + kSpan - 1) / kSpan;
  if (!grid_ok(rows * draw_tiles) || !grid_ok(rows * tiles) || !grid_ok(rows * nb_max) ||
      !grid_ok(rows * spans))
    return (int)cudaErrorInvalidConfiguration;
  int err;
  const cudaFuncAttribute smem_attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  if ((err = (int)cudaFuncSetAttribute(sample_scatter_kernel, smem_attr, kScatterSmem)) ||
      (err = (int)cudaFuncSetAttribute(sample_bucket_kernel, smem_attr, kSortSmem)) ||
      (err = (int)cudaFuncSetAttribute(sample_merge_kernel, smem_attr, kMergeSmem)) ||
      (err = (int)cudaFuncSetAttribute(sample_rounds_kernel, smem_attr, kRoundsSmem)))
    return err;
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* k = (const uint32_t*)key;
  const int64_t* u = (const int64_t*)universe;
  const int64_t* c = (const int64_t*)count;
  int64_t* o = (int64_t*)out;
  int64_t* x = (int64_t*)scratch;
  // work: counts [R, nb_max], ndup [R], dups [R, 1024], meta [R, 4],
  // P [R, 1024], DF [R, 1024], ndup1 [R], dups1 [R, 1024], F [R, 1024] int64
  int* counts = (int*)work;
  int* ndup = counts + rows * nb_max;
  int* dups = ndup + rows;
  FirstRound fr;
  fr.meta = dups + rows * kListMax;
  fr.P = fr.meta + 4 * rows;
  fr.DF = fr.P + rows * kListMax;
  fr.ndup1 = fr.DF + rows * kListMax;
  fr.dups1 = fr.ndup1 + rows;
  int* end = fr.dups1 + rows * kListMax;
  fr.F = (int64_t*)(end + ((end - counts) & 1));
  sample_draw_kernel<<<(unsigned)(rows * draw_tiles), kThreads, 0, s>>>(
      k, u, c, capacity, draw_tiles, nb_max, o, x, counts);
  if ((err = (int)cudaGetLastError())) return err;
  sample_offsets_kernel<<<(unsigned)rows, kThreads, 0, s>>>(u, c, capacity, nb_max, counts);
  if ((err = (int)cudaGetLastError())) return err;
  sample_scatter_kernel<<<(unsigned)(rows * tiles), kThreads, kScatterSmem, s>>>(
      u, c, capacity, tiles, nb_max, x, counts, o);
  if ((err = (int)cudaGetLastError())) return err;
  sample_bucket_kernel<<<(unsigned)(rows * nb_max), kThreads, kSortSmem, s>>>(
      u, c, capacity, nb_max, bucket_cap, list_cap, counts, o, x, ndup, dups);
  if ((err = (int)cudaGetLastError())) return err;
  sample_plan_kernel<<<(unsigned)rows, kThreads, 0, s>>>(k, u, c, capacity, list_cap, o, ndup,
                                                          dups, fr);
  if ((err = (int)cudaGetLastError())) return err;
  sample_copy_kernel<<<(unsigned)(rows * spans), kThreads, 0, s>>>(capacity, spans, o, x, fr);
  if ((err = (int)cudaGetLastError())) return err;
  sample_merge_kernel<<<(unsigned)(rows * spans), kThreads, kMergeSmem, s>>>(
      u, c, capacity, spans, list_cap, o, x, fr);
  if ((err = (int)cudaGetLastError())) return err;
  sample_rounds_kernel<<<(unsigned)rows, kThreads, kRoundsSmem, s>>>(
      k, u, c, capacity, bucket_cap, list_cap, o, x, ndup, dups, fr, (int*)rounds);
  return (int)cudaGetLastError();
}
