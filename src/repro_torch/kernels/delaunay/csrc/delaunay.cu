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
// Design.  Rows are independent, so one block runs one row and no block
// waits for another: a row stops when every point is in or as soon as its
// ok flag clears (nothing reads the triangulation of a row that is not ok).
// The slot table (vertex ids in the simp output itself, circumcenters,
// |cc|^2 and the squared radius, -inf for a dead slot) lives in global
// scratch sized [B, S] by the wrapper.  A trip of the insertion loop:
//  1. the G candidates: a block-wide scan of the uninserted flags finds the
//     uninserted points at ranks 0, s, 2s, ... of the remainder;
//  2. one in-sphere scan of the slots in use, [0, top): each warp walks a
//     contiguous range 32 slots at a time, and a ballot appends the slots
//     bad for any candidate to the warp's list, in slot order; the warp
//     lists, concatenated in warp order, are the union cavity in ascending
//     slot order (prefix counts, no atomics);
//  3. each candidate's cavity is the union entries with its bit, compacted
//     by one warp per candidate; its facets are sorted vertex triples in
//     shared memory, and a facet is on the boundary when it occurs once
//     among the candidate's facets (a count, no sort), ranked by a warp
//     ballot scan in (cavity position, facet) order;
//  4. stage-1 and stage-2 acceptance run on one thread over G = 4
//     candidates, after the block has computed the new simplices'
//     circumspheres and the candidates' distances to them;
//  5. killed slots are reused in cavity order, the rest append past top.
// Bound: each trip scans every slot in use for G candidates in float64 (a
// dot of d terms and a compare per pair), so the in-sphere scan bounds the
// kernel by float64 operations, and only B of the 132 SMs work (B = 16 2-D
// or 8 3-D rows on the main path).  The per-trip block synchronisations and
// the serial acceptance add latency on top; neither is hidden.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "predicates.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kG = 4;  // insertion group width (ops.group_size)
constexpr double kSuperScale = 512.0;
constexpr double kSqrt3 = 1.7320508075688772;

template <int D, int CAV>
struct Shared {
  static constexpr int F = CAV * (D + 1);      // facet slots of one cavity
  static constexpr int W = (D - 1) * CAV + 2;  // new simplices of a group
  static constexpr int UC = 3 * CAV;           // union-cavity window
  double sup[(D + 1) * D];
  double p[kG][D];
  double sp[kG];
  double wctr[W][D];
  double wr2[W];
  double red[kWarps][2 * D];
  int64_t scan[kWarps];
  int64_t cand[kG];
  int64_t top, nins;
  int32_t wlist[kWarps][UC];  // (slot << 4) | candidate mask
  int32_t wcount[kWarps], woff[kWarps];
  int32_t uni[UC];
  int32_t badidx[kG][CAV];
  int32_t fac[kG][F][D];
  int16_t lpos[kG][F];
  int32_t wv[W][D + 1];
  int16_t wowner[W], wlp[W];
  int32_t nb[kG], nnew[kG], goff[kG], aoff[kG];
  int32_t nu, nw, sum_a, facc_mask;
  uint8_t bflag[kG][F];
  uint8_t wnok[W];
  uint8_t hg[kG][kG], tg[kG][kG];
  uint8_t cm[kG], acc[kG], facc[kG];
  int tie, ok;
};

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

template <int D>
__device__ __forceinline__ void sort_ids(int32_t* v) {
  for (int i = 1; i < D; ++i)
    for (int j = i; j > 0 && v[j - 1] > v[j]; --j) {
      const int32_t t = v[j];
      v[j] = v[j - 1];
      v[j - 1] = t;
    }
}

template <int D, int CAV>
__global__ void __launch_bounds__(kThreads)
triangulate_kernel(const double* __restrict__ pts, const int64_t* __restrict__ counts, int64_t N,
                   int64_t S, int32_t* __restrict__ simp, bool* __restrict__ alive,
                   bool* __restrict__ ok_out, double* __restrict__ ccs, double* __restrict__ rrs,
                   double* __restrict__ sss, uint8_t* __restrict__ inss,
                   int64_t* __restrict__ work) {
  using Sh = Shared<D, CAV>;
  constexpr int F = Sh::F, W = Sh::W, UC = Sh::UC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Sh& sh = *reinterpret_cast<Sh*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t b = blockIdx.x;
  const double* P = pts + b * N * D;
  int32_t* vid = simp + b * S * (D + 1);
  double* cc = ccs + b * S * D;
  double* rr = rrs + b * S;
  double* ss = sss + b * S;
  uint8_t* ins = inss + b * N;
  const int64_t cnt = counts[b];

  for (int64_t s = tid; s < S; s += kThreads) {
    for (int k = 0; k <= D; ++k) vid[s * (D + 1) + k] = 0;
    rr[s] = -INFINITY;
  }
  for (int64_t i = tid; i < N; i += kThreads) ins[i] = 0;

  // the bounding box of the row's points, then the super-simplex
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
  __syncthreads();
  if (tid == 0) {
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
    for (int k = 0; k < D; ++k) cc[k] = c0[k];
    ss[0] = slot_norm2<D>(c0);
    rr[0] = nd0 ? r20 : INFINITY;
    sh.top = 1;
    sh.nins = 0;
    sh.ok = 1;
  }
  __syncthreads();

  int64_t trips = 0, scanned = 0;
  const int64_t chunk = (N + kThreads - 1) / kThreads;
  while (sh.nins < cnt && sh.ok) {
    ++trips;
    const int64_t rem = cnt - sh.nins;
    const int64_t stride = rem / kG > 1 ? rem / kG : 1;
    const int64_t top = sh.top;
    if (tid < kG) {
      sh.cm[tid] = tid * stride < rem;
      sh.cand[tid] = N;
    }
    if (tid < kG * kG) {
      sh.hg[tid / kG][tid % kG] = 0;
      sh.tg[tid / kG][tid % kG] = 0;
    }
    if (tid == 0) sh.tie = 0;

    // 1. candidates: the uninserted points of ranks 0, stride, 2 stride, ...
    const int64_t i0 = tid * chunk, i1 = i0 + chunk < cnt ? i0 + chunk : cnt;
    int64_t mine = 0;
    for (int64_t i = i0; i < i1; ++i) mine += !ins[i];
    int64_t total;
    const int64_t before = block_exclusive_scan(mine, &total, sh.scan);
    for (int g = 0; g < kG; ++g) {
      const int64_t rank = g * stride;
      if (rank < rem && before <= rank && rank < before + mine) {
        int64_t seen = before;
        for (int64_t i = i0; i < i1; ++i)
          if (!ins[i] && seen++ == rank) {
            sh.cand[g] = i;
            break;
          }
      }
    }
    __syncthreads();
    if (tid < kG) {
      const int64_t c = sh.cand[tid] < N + D ? sh.cand[tid] : N + D;
      const double* src = c < N ? P + c * D : sh.sup + (c - N) * D;
      double s = src[0] * src[0];
      sh.p[tid][0] = src[0];
      for (int k = 1; k < D; ++k) {
        sh.p[tid][k] = src[k];
        s = fma(src[k], src[k], s);
      }
      sh.sp[tid] = s;
    }
    __syncthreads();

    // 2. the in-sphere scan of the slots in use; the union cavity in order
    {
      const int64_t per = ((top + kWarps - 1) / kWarps + 31) / 32 * 32;
      const int64_t s0 = warp * per, s1 = s0 + per < top ? s0 + per : top;
      int32_t wc = 0;
      bool tie = false;
      for (int64_t base = s0; base < s1; base += 32) {
        const int64_t s = base + lane;
        unsigned mask = 0;
        if (s < s1) {
          const double rv = rr[s];
          if (rv != -INFINITY) {
            ++scanned;
            const double sv = ss[s];
            double c[D];
            for (int k = 0; k < D; ++k) c[k] = cc[s * D + k];
            for (int g = 0; g < kG; ++g) {
              if (!sh.cm[g]) continue;
              double dot = fma(c[0], sh.p[g][0], 0.0);
              for (int k = 1; k < D; ++k) dot = fma(c[k], sh.p[g][k], dot);
              const double d2 = (sv - dot * 2.0) + sh.sp[g];
              if (d2 < rv) mask |= 1u << g;
              tie = tie || d2 == rv;
            }
          }
        }
        const unsigned bal = __ballot_sync(~0u, mask != 0);
        if (mask) {
          const int32_t pos = wc + __popc(bal & lanes_below(lane));
          if (pos < UC) sh.wlist[warp][pos] = (int32_t)((s << 4) | mask);
        }
        wc += __popc(bal);
      }
      if (__any_sync(~0u, tie) && lane == 0) sh.tie = 1;
      if (lane == 0) sh.wcount[warp] = wc;
    }
    __syncthreads();
    if (tid == 0) {
      int32_t off = 0;
      for (int w = 0; w < kWarps; ++w) {
        sh.woff[w] = off;
        off += sh.wcount[w];
      }
      sh.nu = off;
      if (off > UC || sh.tie) sh.ok = 0;
    }
    __syncthreads();
    if (!sh.ok) break;
    for (int i = lane; i < sh.wcount[warp]; i += 32) sh.uni[sh.woff[warp] + i] = sh.wlist[warp][i];
    __syncthreads();
    const int32_t nu = sh.nu;

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
        for (int j = 0; j < D; ++j) sh.fac[g][f][j] = ids[j];
      }
    }
    __syncthreads();
    for (int item = tid; item < kG * F; item += kThreads) {
      const int g = item / F, f = item % F;
      const int nf = (sh.nb[g] < CAV ? sh.nb[g] : CAV) * (D + 1);
      int count = 0;
      if (f < nf)
        for (int f2 = 0; f2 < nf; ++f2) {
          bool same = true;
          for (int j = 0; j < D; ++j) same = same && sh.fac[g][f2][j] == sh.fac[g][f][j];
          count += same;
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

    // 4a. stage 1: disjoint cavities within the new-simplex budget
    if (tid == 0) {
      unsigned ov[kG] = {0, 0, 0, 0};
      for (int i = 0; i < nu; ++i) {
        const unsigned m = sh.uni[i] & 15;
        for (int j = 0; j < kG; ++j)
          if ((m >> j) & 1) ov[j] |= m;
      }
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
    if (!sh.ok) break;
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
      double dk = sh.wctr[w][0] - sh.p[g][0];
      double pw = dk * dk;
      for (int k = 1; k < D; ++k) {
        dk = sh.wctr[w][k] - sh.p[g][k];
        pw = fma(dk, dk, pw);
      }
      if (pw < sh.wr2[w]) sh.hg[sh.wowner[w]][g] = 1;
      if (pw == sh.wr2[w]) sh.tg[sh.wowner[w]][g] = 1;
    }
    __syncthreads();
    if (tid == 0) {
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
      for (int w = 0; w < nw; ++w) ok = ok && !(sh.facc[sh.wowner[w]] && !sh.wnok[w]);
      ok = ok && top + sum_a <= S;
      sh.ok = ok;
      sh.sum_a = sum_a;
      sh.facc_mask = fm;
    }
    __syncthreads();
    if (!sh.ok) break;

    // 5. kill the accepted cavities, then write the new simplices
    for (int i = tid; i < nu; i += kThreads)
      if (sh.uni[i] & sh.facc_mask) rr[sh.uni[i] >> 4] = -INFINITY;
    __syncthreads();
    for (int w = tid; w < nw; w += kThreads) {
      const int o = sh.wowner[w];
      if (!sh.facc[o]) continue;
      const int32_t lp = sh.wlp[w];
      const int64_t slot = lp < sh.nb[o] ? (int64_t)sh.badidx[o][lp]
                                         : top + sh.aoff[o] + lp - sh.nb[o];
      for (int j = 0; j <= D; ++j) vid[slot * (D + 1) + j] = sh.wv[w][j];
      for (int k = 0; k < D; ++k) cc[slot * D + k] = sh.wctr[w][k];
      ss[slot] = slot_norm2<D>(sh.wctr[w]);
      rr[slot] = sh.wnok[w] ? sh.wr2[w] : INFINITY;
    }
    if (tid < kG && sh.facc[tid]) ins[sh.cand[tid]] = 1;
    __syncthreads();
    if (tid == 0) {
      sh.top = top + sh.sum_a;
      sh.nins += __popc(sh.facc_mask);
    }
    __syncthreads();
  }

  __syncthreads();
  for (int64_t s = tid; s < S; s += kThreads) alive[b * S + s] = rr[s] != -INFINITY;
  int64_t total_scanned;
  block_exclusive_scan(scanned, &total_scanned, sh.scan);
  if (tid == 0) {
    ok_out[b] = sh.ok != 0;
    work[2 * b] = trips;
    work[2 * b + 1] = total_scanned;
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

template <int D, int CAV>
int launch_triangulate(const void* pts, const void* cnt, long long B, long long N, long long S,
                       void* simp, void* alive, void* ok, void* cc, void* rr, void* ss, void* ins,
                       void* work, cudaStream_t stream) {
  const size_t shared = sizeof(Shared<D, CAV>);
  const cudaError_t err = cudaFuncSetAttribute(
      triangulate_kernel<D, CAV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
  if (err != cudaSuccess) return (int)err;
  triangulate_kernel<D, CAV><<<(unsigned)B, kThreads, shared, stream>>>(
      (const double*)pts, (const int64_t*)cnt, N, S, (int32_t*)simp, (bool*)alive, (bool*)ok,
      (double*)cc, (double*)rr, (double*)ss, (uint8_t*)ins, (int64_t*)work);
  return (int)cudaGetLastError();
}

}  // namespace

// Triangulate B padded rows: pts float64 [B, N, dim], cnt int64 [B].  Out:
// simp int32 [B, S, dim+1], alive bool [B, S], ok bool [B], work int64
// [B, 2] (trips, alive slots scanned).  Scratch: cc float64 [B, S, dim],
// rr and ss float64 [B, S], ins uint8 [B, N].  (dim, cavity, group) must be
// (2, 32, 4) or (3, 96, 4).  Returns the cudaError_t of the launch.
extern "C" int triangulate(const void* pts, const void* cnt, long long B, long long N,
                           long long S, int dim, int cavity, int group, void* simp, void* alive,
                           void* ok, void* cc, void* rr, void* ss, void* ins, void* work,
                           void* stream) {
  if (B == 0) return 0;
  if (B > INT_MAX || S * 16 > INT_MAX || N + 4 > INT_MAX || group != kG)
    return (int)cudaErrorInvalidValue;
  if (dim == 2 && cavity == 32)
    return launch_triangulate<2, 32>(pts, cnt, B, N, S, simp, alive, ok, cc, rr, ss, ins, work,
                                     (cudaStream_t)stream);
  if (dim == 3 && cavity == 96)
    return launch_triangulate<3, 96>(pts, cnt, B, N, S, simp, alive, ok, cc, rr, ss, ins, work,
                                     (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
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
