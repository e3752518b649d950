// Threefry-2x32 (20 rounds), JAX's key and counter layout.
//
// fold_in(k, d) = TF(k, (0, d)); 32-bit word i of bits(k, .) is the XOR
// of the two outputs of TF(k, (0, i)).  64-bit word i of bits(k, 64, .)
// is TF(k, (i >> 32, i mod 2^32)) with output word 0 as its high half
// and word 1 as its low half, NOT XORed (tf_random_bits64; R-MAT and BA
// draw these).  The plain PyTorch twins are in repro_torch.core.prng.
#pragma once

#include <stdint.h>

struct Key2x32 {
  uint32_t k0, k1;
};

__device__ __forceinline__ uint32_t tf_rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

#define TF_ROUND(r) \
  x0 += x1;         \
  x1 = tf_rotl(x1, r) ^ x0;

__device__ __forceinline__ Key2x32 threefry2x32(Key2x32 k, uint32_t x0, uint32_t x1) {
  const uint32_t k2 = k.k0 ^ k.k1 ^ 0x1BD11BDAu;
  x0 += k.k0;
  x1 += k.k1;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k.k1;
  x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2;
  x1 += k.k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k.k0;
  x1 += k.k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k.k1;
  x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2;
  x1 += k.k0 + 5u;
  return Key2x32{x0, x1};
}

#undef TF_ROUND

__device__ __forceinline__ Key2x32 tf_fold_in(Key2x32 k, uint32_t d) {
  return threefry2x32(k, 0u, d);
}

// counter_bits64(key, ., 1)[i]: word 0 of bits(fold_in(key, i), (1, 2))
// as the high half, word 1 as the low half.
__device__ __forceinline__ uint64_t tf_bits64(Key2x32 k, uint32_t i) {
  const Key2x32 ki = tf_fold_in(k, i);
  const Key2x32 a = threefry2x32(ki, 0u, 0u);
  const Key2x32 b = threefry2x32(ki, 0u, 1u);
  return ((uint64_t)(a.k0 ^ a.k1) << 32) | (uint64_t)(b.k0 ^ b.k1);
}

// repro.core.prng.fold_in64: fold_in of x >> 31, then of x & 0x7FFFFFFF
__device__ __forceinline__ Key2x32 tf_fold_in64(Key2x32 k, int64_t x) {
  return tf_fold_in(tf_fold_in(k, (uint32_t)(x >> 31)), (uint32_t)(x & 0x7FFFFFFF));
}

// 64-bit word i of jax.random.bits(k, shape, uint64)
__device__ __forceinline__ uint64_t tf_random_bits64(Key2x32 k, uint64_t i) {
  const Key2x32 b = threefry2x32(k, (uint32_t)(i >> 32), (uint32_t)i);
  return ((uint64_t)b.k0 << 32) | (uint64_t)b.k1;
}

// element i of jax.random.uniform(k, shape, float64): the word's top 52
// bits as the mantissa of a float in [1, 2), less 1 (exact)
__device__ __forceinline__ double tf_uniform64(Key2x32 k, uint64_t i) {
  const uint64_t w = (tf_random_bits64(k, i) >> 12) | 0x3FF0000000000000ull;
  return __longlong_as_double((long long)w) - 1.0;
}

// x mod d and x / d for one divisor by an exact 64-bit reciprocal:
// inv = floor((2^64 - 1) / d), so umulhi(x, inv) undershoots x / d by at
// most 2 and two conditional subtractions finish the remainder (d >= 1;
// the plain twin is repro_torch.kernels.sampler.ref.barrett_mod64).  One
// 64-bit division makes the reciprocal; every reduction after it is a
// high multiply, a multiply and two compares.
struct Mod64 {
  uint64_t d, inv;
};

__device__ __forceinline__ Mod64 mod64_init(uint64_t d) { return Mod64{d, ~0ull / d}; }

__device__ __forceinline__ uint64_t mod64(uint64_t x, Mod64 m) {
  uint64_t r = x - __umul64hi(x, m.inv) * m.d;
  if (r >= m.d) r -= m.d;
  if (r >= m.d) r -= m.d;
  return r;
}

__device__ __forceinline__ uint64_t div64(uint64_t x, Mod64 m) {
  uint64_t q = __umul64hi(x, m.inv);
  uint64_t r = x - q * m.d;
  if (r >= m.d) {
    ++q;
    r -= m.d;
  }
  if (r >= m.d) ++q;
  return q;
}

// jax.random.randint(k, (), minval, maxval, int64): split into two
// subkeys, a high and a low 64-bit word, reduced by span with the
// multiplier (2^32 mod span)^2 mod span, all unsigned and wrapping
// mod 2^64 (jax/_src/random.py::_randint).  The five remainders share
// one divisor, so they share one reciprocal.
__device__ __forceinline__ int64_t tf_randint64(Key2x32 k, int64_t minval, int64_t maxval) {
  const uint64_t hi = tf_random_bits64(threefry2x32(k, 0u, 0u), 0);
  const uint64_t lo = tf_random_bits64(threefry2x32(k, 0u, 1u), 0);
  const Mod64 span = mod64_init(maxval <= minval ? 1ull : (uint64_t)maxval - (uint64_t)minval);
  uint64_t mult = mod64(1ull << 32, span);
  mult = mod64(mult * mult, span);
  const uint64_t off = mod64(mod64(hi, span) * mult + mod64(lo, span), span);
  return (int64_t)((uint64_t)minval + off);
}
