// Batched Bowyer-Watson triangulation (triangulate) and the batched Cramer
// circumsphere (circumspheres) of the RDG planning pass.
//
// triangulate replaces the delaunay_call TPU kernel
// (repro/kernels/delaunay/delaunay.py:39, body _dt_kernel :24 running
// ref.py:119 triangulate); circumspheres replaces the predicate that
// repro/core/rdg.py::circumspheres (:99) runs, outside jit, on every halo
// round's certificate batch.  Both compute what the plain PyTorch versions
// in repro_torch/kernels/delaunay (ref.py, predicates.py) compute, bit for
// bit: the same slot layout, the same tie rules, the same arithmetic (the
// predicate in predicates.cuh, fused in the loop and unfused in
// circumspheres; the slot scan's |cc|^2 unfused, its dot an fma chain).
// The library is built with -fmad=false.
//
// Design.  Rows are independent; one thread-block cluster of C CTAs runs
// one row (C in {1, 2, 4, 8, 16}: the largest for which the B rows'
// clusters are resident on the card together, as the occupancy query
// says).  The rank-0 CTA, the leader, owns the row's insertion state; a
// row stops when every point is in or as soon as its ok flag clears
// (nothing reads the triangulation of a row that is not ok).  The slot
// table lives in global scratch sized [B, S] by the wrapper, one record
// per slot: {cc0, cc1, |cc|^2, r^2} (32 bytes, 2-D) or {cc0, cc1, cc2,
// |cc|^2, r^2, pad} (48 bytes, 3-D), r^2 = -inf for a dead slot; vertex
// ids live in the simp output itself.  A trip of the insertion loop:
//  1. the leader finds the G candidates, the uninserted points at ranks 0,
//     s, 2s, ... of the remainder, by a block scan over the popcounts of
//     an N-bit bitmap of uninserted points in its shared memory, and
//     publishes them (p, |p|^2, the candidate mask), top and a go flag
//     there; cluster barrier;
//  2. every CTA reads the publication through distributed shared memory
//     and scans its contiguous C-th of the slots in use, [0, top): each
//     warp walks a contiguous range, every lane keeping U records' 16-byte
//     loads in flight (dead slots masked after the load), and a ballot
//     appends the slots bad for any candidate to the warp's list, in slot
//     order; cluster barrier;
//  3. every CTA has stored its per-warp counts and tie flags in the
//     leader's shared memory before the barrier; the leader concatenates
//     the warp lists in (CTA, warp) order into the union
//     cavity, which is then in ascending slot order (prefix counts, no
//     atomics); each candidate's cavity is the union entries with its
//     bit; its facets are sorted vertex triples in shared memory, and a
//     facet is on the boundary when it occurs once among the candidate's
//     facets (a count, no sort), ranked by a warp ballot scan in (cavity
//     position, facet) order;
//  4. stage-1 and stage-2 acceptance run on one thread over G = 4
//     candidates, after the block has computed the new simplices'
//     circumspheres and the candidates' distances to them;
//  5. killed slots are reused in cavity order, the rest append past top.
// Two cluster barriers a trip; the barrier's release/acquire orders step
// 5's global writes before the next trip's scan in the other CTAs, and the
// scan reads the records with ld.global.cg (L2, never a stale L1 line).
// Bound: each trip scans every slot in use for G candidates in float64 (a
// dot of d terms and a compare per pair), so the in-sphere scan bounds the
// kernel by float64 operations; steps 1 and 3-5 run on the leader alone
// and are latency, not throughput.  With parts non-null, thread 0 of the
// leader sums clock64 cycles per trip part into parts [B, 6]: candidates,
// scan (barrier to barrier, the slowest CTA's), union gather, cavities and
// facets, acceptance, write-back.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "predicates.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kG = 4;  // insertion group width (ops.group_size)
constexpr int kMaxCluster = 16;
constexpr int kParts = 6;
constexpr double kSuperScale = 512.0;
constexpr double kSqrt3 = 1.7320508075688772;

// doubles per slot record: centre, |cc|^2, r^2 (and one pad in 3-D, so a
// record is three 16-byte loads)
template <int D>
constexpr int kRec = D == 2 ? 4 : 6;
// bits per vertex id in a packed facet key (ids < 2^21 in 3-D)
template <int D>
constexpr int kKeyBits = D == 2 ? 32 : 21;
// records in flight per lane in the scan
template <int D>
constexpr int kUnroll = D == 2 ? 4 : 2;

template <int D, int CAV>
struct Shared {
  static constexpr int F = CAV * (D + 1);      // facet slots of one cavity
  static constexpr int W = (D - 1) * CAV + 2;  // new simplices of a group
  static constexpr int UC = 3 * CAV;           // union-cavity window
  // published by the leader: p and |p|^2 per candidate, then meta =
  // top << 8 | candidate mask << 1 | go
  double pub[kG * (D + 1)];
  long long meta;
  unsigned long long scanned_total;
  double sup[(D + 1) * D];
  double wctr[W][D];
  double wr2[W];
  double red[kWarps][2 * D];
  int64_t scan[kWarps];
  int64_t cand[kG];
  int64_t top, nins;
  // every CTA: its warps' lists
  int32_t wlist[kWarps][UC];  // (slot << 4) | candidate mask
  // the leader: every (CTA, warp) count, tie flag and offset, the counts
  // and flags stored there by the CTAs themselves
  int32_t allc[kMaxCluster * kWarps], alltie[kMaxCluster * kWarps];
  int32_t alloff[kMaxCluster * kWarps];
  int32_t uni[UC];
  int32_t badidx[kG][CAV];
  int32_t fac[kG][F][D];
  unsigned long long fkey[kG][F];  // the sorted ids packed, for the counts
  int16_t lpos[kG][F];
  int32_t wv[W][D + 1];
  int16_t wowner[W], wlp[W];
  int32_t nb[kG], nnew[kG], goff[kG], aoff[kG];
  int32_t nu, nw, sum_a, facc_mask;
  uint8_t bflag[kG][F];
  uint8_t wnok[W];
  uint8_t hg[kG][kG], tg[kG][kG];
  uint8_t cm[kG], acc[kG], facc[kG];
  int ok;
};

template <int D, int CAV>
constexpr size_t shared_bytes(long long N) {
  return (sizeof(Shared<D, CAV>) + 15) / 16 * 16 + (size_t)((N + 127) / 128) * 16;
}

__device__ __forceinline__ unsigned lanes_below(int lane) { return (1u << lane) - 1u; }

// block-wide exclusive prefix sum of one count per thread; *total gets the sum
__device__ int64_t block_exclusive_scan(int64_t v, int64_t* total, int64_t* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int64_t x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int64_t y = __shfl_up_sync(~0u, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int64_t w = lane < kWarps ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int64_t y = __shfl_up_sync(~0u, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) warp_sums[lane] = w;
  }
  __syncthreads();
  const int64_t excl = x - v + (warp ? warp_sums[warp - 1] : 0);
  *total = warp_sums[kWarps - 1];
  __syncthreads();
  return excl;
}

// |c|^2 as the reference's vectorised slot scan rounds it: no fusion
template <int D>
__device__ __forceinline__ double slot_norm2(const double* c) {
  double s = c[0] * c[0] + c[1] * c[1];
  if (D == 3) s = s + c[D - 1] * c[D - 1];
  return s;
}

// one slot record: the centre, its |cc|^2 and the squared radius
template <int D>
__device__ __forceinline__ void put_record(double* rec, const double* c, double r2) {
  double2* dst = reinterpret_cast<double2*>(rec);
  if constexpr (D == 2) {
    dst[0] = make_double2(c[0], c[1]);
    dst[1] = make_double2(slot_norm2<D>(c), r2);
  } else {
    dst[0] = make_double2(c[0], c[1]);
    dst[1] = make_double2(c[2], slot_norm2<D>(c));
    dst[2] = make_double2(r2, 0.0);
  }
}

template <int D>
__device__ __forceinline__ void sort_ids(int32_t* v) {
  for (int i = 1; i < D; ++i)
    for (int j = i; j > 0 && v[j - 1] > v[j]; --j) {
      const int32_t t = v[j];
      v[j] = v[j - 1];
      v[j - 1] = t;
    }
}

__device__ __forceinline__ void tick(long long* parts, int k, long long& last) {
  const long long now = clock64();
  parts[k] += now - last;
  last = now;
}

// Step 1 on the leader: the candidates of this trip and the publication.
template <int D, int CAV>
__device__ void leader_candidates(Shared<D, CAV>& sh, const uint32_t* unins, int64_t nwords,
                                  const double* P, int64_t N, int64_t cnt) {
  const int tid = threadIdx.x;
  const int64_t rem = cnt - sh.nins;
  const int64_t stride = rem / kG > 1 ? rem / kG : 1;
  if (tid < kG) {
    sh.cm[tid] = tid * stride < rem;
    sh.cand[tid] = N;
  }
  if (tid < kG * kG) {
    sh.hg[tid / kG][tid % kG] = 0;
    sh.tg[tid / kG][tid % kG] = 0;
  }
  const int64_t per = (nwords + kThreads - 1) / kThreads;
  const int64_t w0 = tid * per, w1 = w0 + per < nwords ? w0 + per : nwords;
  int64_t mine = 0;
  for (int64_t w = w0; w < w1; ++w) mine += __popc(unins[w]);
  int64_t total;
  const int64_t before = block_exclusive_scan(mine, &total, sh.scan);
  for (int g = 0; g < kG; ++g) {
    const int64_t rank = g * stride;
    if (rank < rem && before <= rank && rank < before + mine) {
      int64_t seen = before;
      for (int64_t w = w0; w < w1; ++w) {
        uint32_t m = unins[w];
        const int pc = __popc(m);
        if (rank < seen + pc) {
          for (int64_t r = rank - seen; r > 0; --r) m &= m - 1;
          sh.cand[g] = w * 32 + __ffs(m) - 1;
          break;
        }
        seen += pc;
      }
    }
  }
  __syncthreads();
  if (tid < kG) {
    const int64_t c = sh.cand[tid] < N + D ? sh.cand[tid] : N + D;
    const double* src = c < N ? P + c * D : sh.sup + (c - N) * D;
    double* pg = sh.pub + tid * (D + 1);
    double s = src[0] * src[0];
    pg[0] = src[0];
    for (int k = 1; k < D; ++k) {
      pg[k] = src[k];
      s = fma(src[k], src[k], s);
    }
    pg[D] = s;
  }
}

// Steps 3-5 on the leader, after the scan: the union cavity, the
// cavities and facets, acceptance and the write-back.  Returns with
// sh.ok cleared at the point where the reference's row stops being ok.
template <int D, int CAV>
__device__ void leader_accept(Shared<D, CAV>& sh, cg::cluster_group& cluster, int C,
                              uint32_t* unins, const double* P, int64_t N, int64_t S,
                              int32_t* vid, double* rec, int64_t top, long long* parts,
                              long long& last) {
  using Sh = Shared<D, CAV>;
  constexpr int F = Sh::F, W = Sh::W, UC = Sh::UC, R = kRec<D>;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // the offsets of every (CTA, warp) list, and any tie
  const int NE = C * kWarps;
  if (warp == 0) {
    constexpr int kPer = kMaxCluster * kWarps / 32;
    int32_t sum = 0;
    bool tie = false;
    for (int j = 0; j < kPer; ++j) {
      const int e = lane * kPer + j;
      sum += e < NE ? sh.allc[e] : 0;
      tie = tie || (e < NE && sh.alltie[e]);
    }
    tie = __any_sync(~0u, tie);
    int32_t x = sum;
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t y = __shfl_up_sync(~0u, x, o);
      if (lane >= o) x += y;
    }
    int32_t off = x - sum;
    for (int j = 0; j < kPer; ++j) {
      const int e = lane * kPer + j;
      if (e < NE) {
        sh.alloff[e] = off;
        off += sh.allc[e];
      }
    }
    if (lane == 31) {
      sh.nu = x;
      if (x > UC || tie) sh.ok = 0;
    }
  }
  __syncthreads();
  if (!sh.ok) return;
  for (int e = warp; e < NE; e += kWarps) {
    const Sh& src = *cluster.map_shared_rank(&sh, e / kWarps);
    const int32_t n = sh.allc[e], off = sh.alloff[e];
    for (int i = lane; i < n; i += 32) sh.uni[off + i] = src.wlist[e % kWarps][i];
  }
  __syncthreads();
  const int32_t nu = sh.nu;
  if (parts && tid == 0) tick(parts, 2, last);

  // 3. each candidate's cavity, in union order
  if (warp < kG) {
    const int g = warp;
    int32_t n = 0;
    for (int base = 0; base < nu; base += 32) {
      const int i = base + lane;
      const bool has = i < nu && ((sh.uni[i] >> g) & 1);
      const unsigned bal = __ballot_sync(~0u, has);
      if (has) {
        const int32_t pos = n + __popc(bal & lanes_below(lane));
        if (pos < CAV) sh.badidx[g][pos] = sh.uni[i] >> 4;
      }
      n += __popc(bal);
    }
    if (lane == 0) sh.nb[g] = n;
  }
  __syncthreads();
  for (int item = tid; item < kG * F; item += kThreads) {
    const int g = item / F, f = item % F, c = f / (D + 1), k = f % (D + 1);
    if (c < (sh.nb[g] < CAV ? sh.nb[g] : CAV)) {
      const int32_t* sv = vid + (int64_t)sh.badidx[g][c] * (D + 1);
      int32_t ids[D];
      for (int j = 0; j < D; ++j) ids[j] = sv[j + (j >= k)];
      sort_ids<D>(ids);
      unsigned long long key = 0;
      for (int j = 0; j < D; ++j) {
        sh.fac[g][f][j] = ids[j];
        key = key << kKeyBits<D> | (unsigned)ids[j];
      }
      sh.fkey[g][f] = key;
    }
  }
  __syncthreads();
  for (int item = tid; item < kG * F; item += kThreads) {
    const int g = item / F, f = item % F;
    const int nf = (sh.nb[g] < CAV ? sh.nb[g] : CAV) * (D + 1);
    int count = 0;
    if (f < nf) {
      const unsigned long long key = sh.fkey[g][f];
      for (int f2 = 0; f2 < nf; ++f2) count += sh.fkey[g][f2] == key;
    }
    sh.bflag[g][f] = count == 1;
  }
  __syncthreads();
  if (warp < kG) {
    const int g = warp;
    int32_t n = 0;
    for (int base = 0; base < F; base += 32) {
      const int f = base + lane;
      const bool bd = f < F && sh.bflag[g][f];
      const unsigned bal = __ballot_sync(~0u, bd);
      if (f < F) sh.lpos[g][f] = bd ? (int16_t)(n + __popc(bal & lanes_below(lane))) : -1;
      n += __popc(bal);
    }
    if (lane == 0) sh.nnew[g] = n;
  }
  __syncthreads();
  if (parts && tid == 0) tick(parts, 3, last);

  // 4a. stage 1: disjoint cavities within the new-simplex budget (the
  // overlaps by one warp, the rest on one thread)
  unsigned ov[kG] = {0, 0, 0, 0};
  if (warp == 0) {
    for (int i = lane; i < nu; i += 32) {
      const unsigned m = sh.uni[i] & 15;
      for (int j = 0; j < kG; ++j)
        if ((m >> j) & 1) ov[j] |= m;
    }
    for (int j = 0; j < kG; ++j) ov[j] = __reduce_or_sync(~0u, ov[j]);
  }
  if (tid == 0) {
    sh.acc[0] = sh.cm[0];
    int32_t newsum = sh.cm[0] ? sh.nnew[0] : 0;
    for (int j = 1; j < kG; ++j) {
      bool take = sh.cm[j] && newsum + sh.nnew[j] <= W;
      for (int i = 0; i < j; ++i) take = take && !(sh.acc[i] && ((ov[i] >> j) & 1));
      sh.acc[j] = take;
      if (take) newsum += sh.nnew[j];
    }
    int32_t off = 0;
    for (int g = 0; g < kG; ++g) {
      sh.goff[g] = off;
      if (sh.acc[g]) off += sh.nnew[g];
    }
    sh.nw = off;
    if (off > W) sh.ok = 0;  // only candidate 0 can overflow W, and it is always taken
  }
  __syncthreads();
  if (!sh.ok) return;
  const int32_t nw = sh.nw;
  for (int item = tid; item < kG * F; item += kThreads) {
    const int g = item / F, f = item % F;
    if (sh.acc[g] && sh.lpos[g][f] >= 0) {
      const int w = sh.goff[g] + sh.lpos[g][f];
      for (int j = 0; j < D; ++j) sh.wv[w][j] = sh.fac[g][f][j];
      sh.wv[w][D] = (int32_t)sh.cand[g];
      sh.wowner[w] = (int16_t)g;
      sh.wlp[w] = sh.lpos[g][f];
    }
  }
  __syncthreads();
  for (int w = tid; w < nw; w += kThreads) {
    double v[(D + 1) * D];
    for (int j = 0; j <= D; ++j) {
      const int64_t id = sh.wv[w][j];
      const double* src = id < N ? P + id * D : sh.sup + (id - N) * D;
      for (int k = 0; k < D; ++k) v[j * D + k] = src[k];
    }
    sh.wnok[w] = dt_circumsphere<D, true>(v, sh.wctr[w], &sh.wr2[w]);
  }
  __syncthreads();

  // 4b. stage 2: a survivor inside an earlier survivor's new sphere waits
  for (int item = tid; item < nw * kG; item += kThreads) {
    const int w = item / kG, g = item % kG;
    const double* pg = sh.pub + g * (D + 1);
    double dk = sh.wctr[w][0] - pg[0];
    double pw = dk * dk;
    for (int k = 1; k < D; ++k) {
      dk = sh.wctr[w][k] - pg[k];
      pw = fma(dk, dk, pw);
    }
    if (pw < sh.wr2[w]) sh.hg[sh.wowner[w]][g] = 1;
    if (pw == sh.wr2[w]) sh.tg[sh.wowner[w]][g] = 1;
  }
  __syncthreads();
  if (warp == 0) {
    if (lane == 0) {
      int ok = 1, fm = 0;
      int32_t sum_a = 0;
      for (int j = 0; j < kG; ++j) {
        bool take = sh.acc[j];
        for (int i = 0; i < j; ++i) take = take && !(sh.facc[i] && sh.hg[i][j]);
        sh.facc[j] = take;
        if (take) {
          fm |= 1 << j;
          ok = ok && sh.nb[j] > 0 && sh.nb[j] <= CAV && sh.nnew[j] <= W;
        }
        const int32_t a = take && sh.nnew[j] > sh.nb[j] ? sh.nnew[j] - sh.nb[j] : 0;
        sh.aoff[j] = sum_a;
        sum_a += a;
      }
      for (int i = 0; i < kG; ++i)
        for (int j = 0; j < kG; ++j)
          ok = ok && !(i != j && sh.facc[i] && sh.facc[j] && sh.tg[i][j]);
      ok = ok && top + sum_a <= S;
      sh.ok = ok;
      sh.sum_a = sum_a;
      sh.facc_mask = fm;
    }
    __syncwarp();
    // a degenerate new simplex of a survivor
    bool bad = false;
    for (int w = lane; w < nw; w += 32) bad = bad || (sh.facc[sh.wowner[w]] && !sh.wnok[w]);
    if (__any_sync(~0u, bad) && lane == 0) sh.ok = 0;
  }
  __syncthreads();
  if (parts && tid == 0) tick(parts, 4, last);
  if (!sh.ok) return;

  // 5. kill the accepted cavities, then write the new simplices
  for (int i = tid; i < nu; i += kThreads)
    if (sh.uni[i] & sh.facc_mask) rec[(int64_t)(sh.uni[i] >> 4) * R + D + 1] = -INFINITY;
  __syncthreads();
  for (int w = tid; w < nw; w += kThreads) {
    const int o = sh.wowner[w];
    if (!sh.facc[o]) continue;
    const int32_t lp = sh.wlp[w];
    const int64_t slot = lp < sh.nb[o] ? (int64_t)sh.badidx[o][lp]
                                       : top + sh.aoff[o] + lp - sh.nb[o];
    for (int j = 0; j <= D; ++j) vid[slot * (D + 1) + j] = sh.wv[w][j];
    put_record<D>(rec + slot * R, sh.wctr[w], sh.wnok[w] ? sh.wr2[w] : INFINITY);
  }
  if (tid < kG && sh.facc[tid]) {
    const int64_t c = sh.cand[tid];
    atomicAnd(&unins[c >> 5], ~(1u << (c & 31)));
  }
  __syncthreads();
  if (tid == 0) {
    sh.top = top + sh.sum_a;
    sh.nins += __popc(sh.facc_mask);
  }
}

template <int D, int CAV>
__global__ void __launch_bounds__(kThreads)
triangulate_kernel(const double* __restrict__ pts, const int64_t* __restrict__ counts, int64_t N,
                   int64_t S, int32_t* __restrict__ simp, bool* __restrict__ alive,
                   bool* __restrict__ ok_out, double* recs, int64_t* __restrict__ work,
                   int64_t* __restrict__ parts_out) {
  using Sh = Shared<D, CAV>;
  constexpr int UC = Sh::UC, R = kRec<D>, U = kUnroll<D>, NP = kG * (D + 1);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Sh& sh = *reinterpret_cast<Sh*>(smem_raw);
  uint32_t* unins = reinterpret_cast<uint32_t*>(smem_raw + (sizeof(Sh) + 15) / 16 * 16);
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const bool leader = rank == 0;
  Sh& lead = *cluster.map_shared_rank(&sh, 0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t b = blockIdx.x / C;
  const double* P = pts + b * N * D;
  int32_t* vid = simp + b * S * (D + 1);
  double* rec = recs + b * S * R;
  const int64_t cnt = counts[b];
  const int64_t nwords = (N + 31) / 32;

  // every CTA clears its share of the slots
  for (int64_t s = (int64_t)rank * kThreads + tid; s < S; s += (int64_t)C * kThreads) {
    for (int k = 0; k <= D; ++k) vid[s * (D + 1) + k] = 0;
    rec[s * R + D + 1] = -INFINITY;
  }
  if (leader) {
    // the uninserted points: bits [0, cnt)
    for (int64_t w = tid; w < nwords; w += kThreads) {
      const int64_t lo = w * 32;
      unins[w] = lo + 32 <= cnt ? ~0u : (lo >= cnt ? 0u : (1u << (cnt - lo)) - 1u);
    }
    // the bounding box of the row's points
    double lo[D], hi[D];
    for (int k = 0; k < D; ++k) {
      lo[k] = INFINITY;
      hi[k] = -INFINITY;
    }
    for (int64_t i = tid; i < cnt; i += kThreads)
      for (int k = 0; k < D; ++k) {
        lo[k] = fmin(lo[k], P[i * D + k]);
        hi[k] = fmax(hi[k], P[i * D + k]);
      }
    for (int k = 0; k < D; ++k)
      for (int o = 16; o > 0; o >>= 1) {
        lo[k] = fmin(lo[k], __shfl_xor_sync(~0u, lo[k], o));
        hi[k] = fmax(hi[k], __shfl_xor_sync(~0u, hi[k], o));
      }
    if (lane == 0)
      for (int k = 0; k < D; ++k) {
        sh.red[warp][k] = lo[k];
        sh.red[warp][D + k] = hi[k];
      }
    if (tid == 0) sh.scanned_total = 0;
  }
  cluster.sync();
  if (leader && tid == 0) {
    // the super-simplex in slot 0
    double center[D], mx = -INFINITY;
    for (int k = 0; k < D; ++k) {
      double l = INFINITY, h = -INFINITY;
      for (int w = 0; w < kWarps; ++w) {
        l = fmin(l, sh.red[w][k]);
        h = fmax(h, sh.red[w][D + k]);
      }
      l = isfinite(l) ? l : 0.0;
      h = isfinite(h) ? h : 0.0;
      center[k] = (l + h) * 0.5;
      mx = fmax(mx, h - l);
    }
    const double scale = kSuperScale * (mx * 0.5 + 1.0);
    for (int v = 0; v <= D; ++v)
      for (int k = 0; k < D; ++k) {
        double u;
        if (D == 2) {
          const double ux = v == 0 ? 0.0 : (v == 1 ? -kSqrt3 : kSqrt3);
          u = k == 0 ? ux : (v == 0 ? 2.0 : -1.0);
        } else {
          u = (v == 0 || v == k + 1) ? 1.0 : -1.0;
        }
        sh.sup[v * D + k] = fma(scale, u, center[k]);
      }
    double c0[D], r20;
    const bool nd0 = dt_circumsphere<D, true>(sh.sup, c0, &r20);
    for (int k = 0; k <= D; ++k) vid[k] = (int32_t)(N + k);
    put_record<D>(rec, c0, nd0 ? r20 : INFINITY);
    sh.top = 1;
    sh.nins = 0;
    sh.ok = 1;
  }
  __syncthreads();

  int64_t trips = 0, scanned = 0;
  long long parts[kParts] = {0, 0, 0, 0, 0, 0};
  long long last = clock64();
  while (true) {
    if (leader) {
      const bool go = sh.nins < cnt && sh.ok;
      if (go) leader_candidates<D, CAV>(sh, unins, nwords, P, N, cnt);
      if (tid == 0) {
        unsigned m = 0;
        for (int g = 0; g < kG; ++g) m |= (unsigned)sh.cm[g] << g;
        sh.meta = (long long)sh.top << 8 | (long long)m << 1 | (go ? 1 : 0);
        if (parts_out) tick(parts, 0, last);
      }
    }
    cluster.sync();

    // 2. read the publication, then scan this CTA's C-th of [0, top)
    const long long meta = __shfl_sync(~0u, lane == 0 ? lead.meta : 0, 0);
    if (!(meta & 1)) break;
    const double pv = lane < NP ? lead.pub[lane] : 0.0;
    double p[kG][D], sp[kG];
    for (int g = 0; g < kG; ++g) {
      for (int k = 0; k < D; ++k) p[g][k] = __shfl_sync(~0u, pv, g * (D + 1) + k);
      sp[g] = __shfl_sync(~0u, pv, g * (D + 1) + D);
    }
    const unsigned cmask = (unsigned)(meta >> 1) & 15u;
    const int64_t top = meta >> 8;
    ++trips;
    {
      const int64_t units = (top + 31) / 32;
      const int64_t pc = (units + C - 1) / C * 32;
      const int64_t c0 = rank * pc, c1 = c0 + pc < top ? c0 + pc : top;
      const int64_t cu = c1 > c0 ? (c1 - c0 + 31) / 32 : 0;
      const int64_t pw = (cu + kWarps - 1) / kWarps * 32;
      const int64_t s0 = c0 + warp * pw, s1 = s0 + pw < c1 ? s0 + pw : c1;
      int32_t wc = 0;
      bool tie = false;
      for (int64_t base = s0; base < s1; base += 32 * U) {
        double r[U][R];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int64_t s = base + u * 32 + lane;
          const double2* src = reinterpret_cast<const double2*>(rec + (s < s1 ? s : s1 - 1) * R);
#pragma unroll
          for (int h = 0; h < R / 2; ++h) {
            const double2 x = __ldcg(src + h);
            r[u][2 * h] = x.x;
            r[u][2 * h + 1] = x.y;
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int64_t s = base + u * 32 + lane;
          const double sv = r[u][D], rv = r[u][D + 1];
          const bool live = s < s1 && rv != -INFINITY;
          unsigned mask = 0;
          bool t = false;
#pragma unroll
          for (int g = 0; g < kG; ++g) {
            double dot = fma(r[u][0], p[g][0], 0.0);
            for (int k = 1; k < D; ++k) dot = fma(r[u][k], p[g][k], dot);
            const double d2 = (sv - dot * 2.0) + sp[g];
            const bool on = (cmask >> g) & 1;
            if (on && d2 < rv) mask |= 1u << g;
            t = t || (on && d2 == rv);
          }
          mask = live ? mask : 0u;
          tie = tie || (live && t);
          scanned += live;
          const unsigned bal = __ballot_sync(~0u, mask != 0);
          if (mask) {
            const int32_t pos = wc + __popc(bal & lanes_below(lane));
            if (pos < UC) sh.wlist[warp][pos] = (int32_t)((s << 4) | mask);
          }
          wc += __popc(bal);
        }
      }
      const bool anytie = __any_sync(~0u, tie);
      if (lane == 0) {
        lead.allc[rank * kWarps + warp] = wc;
        lead.alltie[rank * kWarps + warp] = anytie;
      }
    }
    cluster.sync();
    if (leader) {
      if (parts_out && tid == 0) tick(parts, 1, last);
      leader_accept<D, CAV>(sh, cluster, C, unins, P, N, S, vid, rec, top,
                            parts_out ? parts : nullptr, last);
      if (parts_out && tid == 0) tick(parts, 5, last);
      __syncthreads();
    }
  }

  // the trips' scanned slots, summed into the leader
  int64_t total;
  block_exclusive_scan(scanned, &total, sh.scan);
  if (tid == 0)
    atomicAdd(&lead.scanned_total, (unsigned long long)total);
  for (int64_t s = (int64_t)rank * kThreads + tid; s < S; s += (int64_t)C * kThreads)
    alive[b * S + s] = __ldcg(rec + s * R + D + 1) != -INFINITY;
  cluster.sync();
  if (leader && tid == 0) {
    ok_out[b] = sh.ok != 0;
    work[2 * b] = trips;
    work[2 * b + 1] = (int64_t)sh.scanned_total;
    if (parts_out)
      for (int k = 0; k < kParts; ++k) parts_out[kParts * b + k] = parts[k];
  }
}

template <int D>
__global__ void circumspheres_kernel(const double* __restrict__ simp, int64_t R,
                                     double* __restrict__ center, double* __restrict__ r2,
                                     bool* __restrict__ nondeg) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  nondeg[i] = dt_circumsphere<D, false>(simp + i * (D + 1) * D, center + i * D, r2 + i);
}

// Shared memory and the cluster attributes; refuses a row whose bitmap
// does not fit beside the leader's state.
template <int D, int CAV>
cudaError_t configure(long long N, size_t* shared) {
  int dev, optin;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  *shared = shared_bytes<D, CAV>(N);
  if (*shared > (size_t)optin) return cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(triangulate_kernel<D, CAV>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*shared);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(triangulate_kernel<D, CAV>,
                              cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

cudaLaunchConfig_t launch_config(long long B, int C, size_t shared, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * C), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = shared;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int D, int CAV>
int cluster_size(long long B, long long N, int* out) {
  size_t shared;
  cudaError_t e = configure<D, CAV>(N, &shared);
  if (e != cudaSuccess) return (int)e;
  for (int c = kMaxCluster; c > 1; c >>= 1) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = launch_config(B, c, shared, 0, &attr);
    int n = 0;
    e = cudaOccupancyMaxActiveClusters(&n, triangulate_kernel<D, CAV>, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (n >= B) {
      *out = c;
      return 0;
    }
  }
  *out = 1;
  return 0;
}

template <int D, int CAV>
int launch_triangulate(const void* pts, const void* cnt, long long B, long long N, long long S,
                       int C, void* simp, void* alive, void* ok, void* rec, void* work,
                       void* parts, cudaStream_t stream) {
  size_t shared;
  const cudaError_t e = configure<D, CAV>(N, &shared);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(B, C, shared, stream, &attr);
  const cudaError_t l = cudaLaunchKernelEx(
      &cfg, triangulate_kernel<D, CAV>, (const double*)pts, (const int64_t*)cnt, (int64_t)N,
      (int64_t)S, (int32_t*)simp, (bool*)alive, (bool*)ok, (double*)rec, (int64_t*)work,
      (int64_t*)parts);
  if (l != cudaSuccess) return (int)l;
  return (int)cudaGetLastError();
}

bool known_shape(int dim, int cavity, int group) {
  return group == kG && ((dim == 2 && cavity == 32) || (dim == 3 && cavity == 96));
}

}  // namespace

// The cluster size triangulate takes for B rows of N points: the largest
// C in {16, 8, 4, 2} for which cudaOccupancyMaxActiveClusters admits B
// clusters of C CTAs at once, else 1.  Returns the cudaError_t of the
// queries (cudaErrorInvalidValue when a row's bitmap does not fit in
// shared memory).
extern "C" int triangulate_cluster(long long B, long long N, int dim, int cavity, int group,
                                   int* out) {
  if (B <= 0 || B * kMaxCluster > INT_MAX || !known_shape(dim, cavity, group))
    return (int)cudaErrorInvalidValue;
  if (dim == 2) return cluster_size<2, 32>(B, N, out);
  return cluster_size<3, 96>(B, N, out);
}

// Triangulate B padded rows with clusters of C CTAs: pts float64 [B, N,
// dim], cnt int64 [B].  Out: simp int32 [B, S, dim+1], alive bool [B, S],
// ok bool [B], work int64 [B, 2] (trips, alive slots scanned), and, when
// parts is not null, int64 [B, 6] clock64 cycles per trip part.  Scratch:
// rec float64 [B, S, 4] (2-D) or [B, S, 6] (3-D).  (dim, cavity, group)
// must be (2, 32, 4) or (3, 96, 4).  Returns the cudaError_t of the launch.
extern "C" int triangulate(const void* pts, const void* cnt, long long B, long long N,
                           long long S, int dim, int cavity, int group, int C, void* simp,
                           void* alive, void* ok, void* rec, void* work, void* parts,
                           void* stream) {
  if (B == 0) return 0;
  if (B * C > INT_MAX || S * 16 > INT_MAX || N + 4 > (dim == 2 ? INT_MAX : 1 << 21) ||
      !known_shape(dim, cavity, group) ||
      C < 1 || C > kMaxCluster || (C & (C - 1)))
    return (int)cudaErrorInvalidValue;
  if (dim == 2)
    return launch_triangulate<2, 32>(pts, cnt, B, N, S, C, simp, alive, ok, rec, work, parts,
                                     (cudaStream_t)stream);
  return launch_triangulate<3, 96>(pts, cnt, B, N, S, C, simp, alive, ok, rec, work, parts,
                                   (cudaStream_t)stream);
}

// Circumspheres of R simplices: simp float64 [R, dim+1, dim].  Out: center
// float64 [R, dim], r2 float64 [R], nondeg bool [R].
extern "C" int circumspheres(const void* simp, long long R, int dim, void* center, void* r2,
                             void* nondeg, void* stream) {
  if (R == 0) return 0;
  const long long blocks = (R + 255) / 256;
  if (blocks > INT_MAX || (dim != 2 && dim != 3)) return (int)cudaErrorInvalidValue;
  if (dim == 2)
    circumspheres_kernel<2><<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
        (const double*)simp, R, (double*)center, (double*)r2, (bool*)nondeg);
  else
    circumspheres_kernel<3><<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
        (const double*)simp, R, (double*)center, (double*)r2, (bool*)nondeg);
  return (int)cudaGetLastError();
}
