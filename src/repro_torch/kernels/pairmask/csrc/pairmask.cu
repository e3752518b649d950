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
