// The two threshold tests of the pair-mask kernel, one pair each, shared by
// pair_mask (pairmask.cu) and the engine's pair_edges (geom/csrc/geom.cu).
//
// XLA on the CPU evaluates the reference's tile arithmetic with fused
// multiply-adds in a fixed order; these functions spell out that order with
// explicit fmaf/fma.  Every library that includes them is compiled with
// -fmad=false, so no other multiply-add is contracted.  The plain PyTorch
// twins are euclid_tile / hyp_tile in repro_torch/kernels/pairmask/ref.py.
#pragma once

// float32 squared distance over dim (2 or 3) coordinates, <= r2
__device__ __forceinline__ bool euclid_tile(const float* a, const float* b, int dim,
                                            float r2) {
  const float d0 = a[0] - b[0];
  const float d1 = a[1] - b[1];
  float acc = fmaf(d0, d0, d1 * d1);
  if (dim == 3) {
    const float d2 = a[2] - b[2];
    acc = fmaf(d2, d2, acc);
  }
  return acc <= r2;
}

// Eq. 9 on float64 features [cos t, sin t, coth r, 1/sinh r]: dist_H < R
__device__ __forceinline__ bool hyp_tile(const double* q, const double* c,
                                         double cosh_r) {
  double acc = fma(q[0], c[0], q[1] * c[1]);
  acc = fma(-q[2], c[2], acc);
  acc = fma(cosh_r, q[3] * c[3], acc);
  return acc > 0.0;
}
