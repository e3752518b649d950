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
// What bounds them on an H100, and what the design does about it:
// * pair_edges writes 17 bytes per slot (a 16-byte edge and a keep byte)
//   over cap^2 slots per row, and spends 2 cap (1 + 2 dim) Threefry-2x32
//   blocks per row regenerating the two cells' points.  At the plans'
//   capacities (16-24) the writes dominate: it is bound by memory.  One
//   block per row: its threads first regenerate the row's 2 cap points (or
//   hyperbolic features) into shared memory, once each, then every thread
//   tests one slot pair out of shared memory and writes its edge and keep
//   byte straight to the output; no [R, cap, cap] temporaries exist.
// * cell_points writes 8 dim + 1 bytes per slot and draws 1 + 2 dim
//   Threefry blocks (72 integer operations each) per slot, padding slots
//   included, as the reference does.  One thread per slot, no shared state.
//   Drawing only the points (about a fifth of the slots) was tried on the
//   card, skipping padding lanes and, separately, one thread per point; it
//   did not move the kernel's time, so the draws do not bound it.
//
// Exactness: the draws are JAX's Threefry bits (threefry.cuh), the uniform
// is (bits >> 11) * 2^-53, and the decodes use the operations XLA uses on
// the CPU, in the same order, with fma only where XLA contracts (see
// repro_torch/kernels/geom/ref.py).  The library is built with -fmad=false.
// The libdevice transcendentals are those PyTorch's CUDA kernels call, so
// the kernels equal their plain PyTorch versions on the card bit for bit.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "../../delaunay/csrc/predicates.cuh"
#include "../../pairmask/csrc/tiles.cuh"
#include "../../sampler/csrc/threefry.cuh"

namespace {

constexpr int kThreads = 256;  // cell_points' block
constexpr int kRowThreads = 128;
constexpr int kGeomHyp = 1, kGeomTorus = 2, kGeomCert = 3;
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
  if (x >= kAcoshLarge) return log(x) + kLog2;
  const double sm = sqrt(x - 1.0);
  return log1p(sm * (sqrt(x + 1.0) + sm));
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
  const double e_hi = exp(r - kLog2), e_lo = exp(-kLog2 - r);
  const double em1 = expm1(r);
  const double sh = fabs(r) < 1.0 ? (em1 + em1 / (em1 + 1.0)) * 0.5 : e_hi - e_lo;
  f[0] = cos(theta);
  f[1] = sin(theta);
  f[2] = (e_hi + e_lo) / sh;
  f[3] = 1.0 / sh;
}

__global__ void pair_edges_kernel(
    const int32_t* __restrict__ kind, const uint32_t* __restrict__ key_a,
    const uint32_t* __restrict__ key_b, const int64_t* __restrict__ count_a,
    const int64_t* __restrict__ count_b, const int64_t* __restrict__ gid_a,
    const int64_t* __restrict__ gid_b, int64_t K, const double* __restrict__ geom_a,
    const double* __restrict__ geom_b, int64_t G, const double* __restrict__ fparams,
    int64_t F, const bool* __restrict__ self_pair, const bool* __restrict__ active,
    int64_t cap, int dim, longlong2* __restrict__ edges, bool* __restrict__ keep) {
  extern __shared__ double smem[];  // side a: [cap, 4], side b: [cap, 4]
  __shared__ bool cert;
  const int64_t r = blockIdx.x;
  const int k = kind[r];
  const bool hyp = k == kGeomHyp, cert_row = k == kGeomCert;
  const bool live = active[r] && (hyp || k == kGeomTorus || cert_row);
  const int64_t ca = count_a[r], cb = count_b[r];
  const double* fp = fparams + r * F;
  if (live && cert_row) {
    // the simplex in geom_a[:(dim+1) dim], the region box in geom_b[:2 dim]
    if (threadIdx.x == 0) {
      const double* box = geom_b + r * G;
      cert = dim == 2 ? dt_circumsphere_in_box<2>(geom_a + r * G, box, box + 2)
                      : dt_circumsphere_in_box<3>(geom_a + r * G, box, box + 3);
    }
  } else if (live) {
    for (int64_t t = threadIdx.x; t < 2 * cap; t += blockDim.x) {
      const bool side_b = t >= cap;
      const int64_t i = side_b ? t - cap : t;
      if (i >= (side_b ? cb : ca)) continue;
      const uint32_t* key = (side_b ? key_b : key_a) + 2 * r;
      const double* geom = (side_b ? geom_b : geom_a) + r * G;
      const Key2x32 slot = tf_fold_in(Key2x32{key[0], key[1]}, (uint32_t)i);
      double* dst = smem + (side_b ? cap : 0) * 4 + 4 * i;
      if (hyp) {
        hyp_features(slot, geom, fp[0], dst);
      } else {
        float* p = (float*)dst;
        for (int d = 0; d < dim; ++d)
          p[d] = (float)((geom[d] + uniform53(slot, (uint32_t)d)) / fp[0]);
      }
    }
  }
  __syncthreads();
  const bool once_only = self_pair[r];
  const int64_t* ids = gid_a + r * K;
  const int64_t ga = ids[0], gb = gid_b[r * K];
  const float r2 = k == kGeomTorus ? (float)fp[1] : 0.0f;  // CERT rows may have F = 1
  const double* fa = smem;
  const double* fb = smem + 4 * cap;
  const int64_t slots = cap * cap;
  for (int64_t s = threadIdx.x; s < slots; s += blockDim.x) {
    const int64_t i = s / cap, j = s % cap;
    bool hit = live && i < ca && j < cb && (!once_only || i < j);
    int64_t u = ga + i, v = gb + j;
    if (cert_row) {
      // edge (ids[i], ids[j]) when bit pair_slot_index(i, j, cap) of gid_b[0] is set
      int64_t bit = i * (cap - 1) - i * (i - 1) / 2 + (j - i - 1);
      bit = bit < 0 ? 0 : (bit > 62 ? 62 : bit);
      hit = hit && cert && ((gb >> bit) & 1);
      u = ids[i < K ? i : K - 1];
      v = ids[j < K ? j : K - 1];
    } else if (hit) {
      hit = hyp ? hyp_tile(fa + 4 * i, fb + 4 * j, fp[1])
                : euclid_tile((const float*)(fa + 4 * i), (const float*)(fb + 4 * j), dim, r2);
    }
    edges[r * slots + s] = make_longlong2(u > v ? u : v, u > v ? v : u);
    keep[r * slots + s] = hit;
  }
}

__global__ void cell_points_kernel(const uint32_t* __restrict__ key,
                                   const int64_t* __restrict__ count,
                                   const int64_t* __restrict__ cell, int64_t Kc,
                                   const double* __restrict__ geom, int64_t G, int polar,
                                   double inv_scale, int64_t cap, int dim, int64_t total,
                                   double* __restrict__ out, bool* __restrict__ mask) {
  const int64_t at = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (at >= total) return;
  const int64_t r = at / cap, i = at % cap;
  const Key2x32 slot = tf_fold_in(Key2x32{key[2 * r], key[2 * r + 1]}, (uint32_t)i);
  // the reference divides by the plan's constant scale, which XLA compiles
  // as a multiplication by its float64 reciprocal
  if (polar) {
    const double* g = geom + r * G;  // (clo, chi, width)
    double ar;
    polar_draw(slot, g[0], g[1], (double)cell[r * Kc + 1], g[2], &ar, out + 2 * at + 1);
    out[2 * at] = ar * inv_scale;
  } else {
    for (int d = 0; d < dim; ++d)
      out[at * dim + d] = ((double)cell[r * Kc + d] + uniform53(slot, (uint32_t)d)) * inv_scale;
  }
  mask[at] = i < count[r];
}

}  // namespace

// Candidate-pair rows: kind int32 [R]; key_a, key_b uint32 [R, 2]; count_a,
// count_b int64 [R]; gid_a, gid_b int64 [R, K]; geom_a, geom_b float64
// [R, G]; fparams float64 [R, F]; self_pair, active bool [R].  Out: edges
// int64 [R, cap^2, 2], keep bool [R, cap^2].  Returns the cudaError_t.
extern "C" int pair_edges(const void* kind, const void* key_a, const void* key_b,
                          const void* count_a, const void* count_b, const void* gid_a,
                          const void* gid_b, long long K, const void* geom_a,
                          const void* geom_b, long long G, const void* fparams,
                          long long F, const void* self_pair, const void* active,
                          long long rows, long long cap, int dim, void* edges,
                          void* keep, void* stream) {
  if (rows == 0 || cap == 0) return 0;
  if (rows > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  // a few warps per row: the threads loop over the row's slots, and small
  // blocks (the kernel takes ~58 registers a thread) let several rows'
  // decode phases overlap on one SM
  const long long slots = cap * cap;
  const int threads = slots >= kRowThreads ? kRowThreads : (int)((slots + 31) / 32 * 32);
  const size_t shared = (size_t)cap * 2 * 4 * sizeof(double);
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pair_edges_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (err != cudaSuccess) return (int)err;
  }
  pair_edges_kernel<<<(unsigned)rows, threads, shared, (cudaStream_t)stream>>>(
      (const int32_t*)kind, (const uint32_t*)key_a, (const uint32_t*)key_b,
      (const int64_t*)count_a, (const int64_t*)count_b, (const int64_t*)gid_a,
      (const int64_t*)gid_b, K, (const double*)geom_a, (const double*)geom_b, G,
      (const double*)fparams, F, (const bool*)self_pair, (const bool*)active, cap, dim,
      (longlong2*)edges, (bool*)keep);
  return (int)cudaGetLastError();
}

// Point-plan cells: key uint32 [R, 2]; count int64 [R]; cell int64 [R, Kc];
// geom float64 [R, G].  Out: points float64 [R, cap, dim], mask bool
// [R, cap].  polar = 0 for cube cells, 1 for polar cells (dim 2);
// inv_scale = 1 / the plan's scale.
extern "C" int cell_points(const void* key, const void* count, const void* cell,
                           long long Kc, const void* geom, long long G, int polar,
                           double inv_scale, long long rows, long long cap, int dim,
                           void* out, void* mask, void* stream) {
  const long long total = rows * cap;
  if (total == 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  cell_points_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)key, (const int64_t*)count, (const int64_t*)cell, Kc,
      (const double*)geom, G, polar, inv_scale, cap, dim, total, (double*)out, (bool*)mask);
  return (int)cudaGetLastError();
}
