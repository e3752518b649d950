// The Cramer circumsphere predicate, shared by the triangulation kernel and
// the circumspheres kernel (delaunay.cu) and by the GEOM_CERT rows of the
// engine's pair_edges (../../geom/csrc/geom.cu).
//
// Replaces repro/kernels/delaunay/predicates.py::circumsphere (line 23) and
// circumsphere_in_box (line 65).  Inside jit (the triangulation loop, the
// engine's pair program) XLA on the CPU compiles them with fused
// multiply-adds in a fixed order: sums of squares as fma chains, every
// 2 x 2 minor a b - c d as fma(a, b, -(c d)), and a 3 x 3 determinant over
// columns x, y, z as fma(z0, C, fma(x0, A, -(y0 B))) (Fused = true).  The
// planning pass (repro/core/rdg.py::circumspheres) runs the predicate
// outside jit, one operation at a time, and rounds every product and sum
// (Fused = false).  Every library that includes this header is built with
// -fmad=false, so nothing but the explicit fma calls is contracted.  The
// plain PyTorch twin is repro_torch/kernels/delaunay/predicates.py.
#pragma once

template <bool Fused>
__device__ __forceinline__ double dt_minor(double a, double b, double c, double d) {
  return Fused ? fma(a, b, -(c * d)) : a * b - c * d;
}

// determinant of the columns x, y, z
template <bool Fused>
__device__ __forceinline__ double dt_det3(const double* x, const double* y, const double* z) {
  const double A = dt_minor<Fused>(y[1], z[2], y[2], z[1]);
  const double B = dt_minor<Fused>(x[1], z[2], x[2], z[1]);
  const double C = dt_minor<Fused>(x[1], y[2], x[2], y[1]);
  if (Fused) return fma(z[0], C, dt_minor<Fused>(x[0], A, y[0], B));
  return x[0] * A - y[0] * B + z[0] * C;
}

template <bool Fused>
__device__ __forceinline__ double dt_sumsq(const double* x, int n) {
  double s = x[0] * x[0];
  for (int k = 1; k < n; ++k) s = Fused ? fma(x[k], x[k], s) : s + x[k] * x[k];
  return s;
}

// Circumsphere of the simplex v [(D+1) x D], row-major: center [D], the
// squared radius, and whether the determinant is nonzero (a degenerate
// simplex gets a finite junk center and radius, as in the reference).
template <int D, bool Fused>
__device__ __forceinline__ bool dt_circumsphere(const double* v, double* center, double* r2) {
  double r[D][D], rhs[D], num[D], det;
  for (int i = 0; i < D; ++i)
    for (int k = 0; k < D; ++k) r[i][k] = v[(i + 1) * D + k] - v[k];
  for (int i = 0; i < D; ++i) rhs[i] = 0.5 * dt_sumsq<Fused>(r[i], D);
  if constexpr (D == 2) {
    det = dt_minor<Fused>(r[0][0], r[1][1], r[0][1], r[1][0]);
    num[0] = dt_minor<Fused>(rhs[0], r[1][1], r[0][1], rhs[1]);
    num[1] = dt_minor<Fused>(r[0][0], rhs[1], rhs[0], r[1][0]);
  } else {
    // column k holds coordinate k of every row
    double c[3][3];
    for (int k = 0; k < 3; ++k)
      for (int i = 0; i < 3; ++i) c[k][i] = r[i][k];
    det = dt_det3<Fused>(c[0], c[1], c[2]);
    num[0] = dt_det3<Fused>(rhs, c[1], c[2]);
    num[1] = dt_det3<Fused>(c[0], rhs, c[2]);
    num[2] = dt_det3<Fused>(c[0], c[1], rhs);
  }
  const bool nondeg = det != 0.0;
  const double den = nondeg ? det : 1.0;
  double off[D];
  for (int k = 0; k < D; ++k) {
    off[k] = num[k] / den;
    center[k] = v[k] + off[k];
  }
  *r2 = dt_sumsq<Fused>(off, D);
  return nondeg;
}

// GEOM_CERT, as the engine's jitted pair program rounds it: the
// circumsphere of v lies inside the box [lo, hi]
template <int D>
__device__ __forceinline__ bool dt_circumsphere_in_box(const double* v, const double* lo,
                                                       const double* hi) {
  double center[D], r2;
  const bool nondeg = dt_circumsphere<D, true>(v, center, &r2);
  const double rad = sqrt(r2);
  bool inside = true;
  for (int k = 0; k < D; ++k)
    inside = inside && center[k] - rad >= lo[k] && center[k] + rad <= hi[k];
  return nondeg && inside;
}
