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

// jax.random.randint(k, (), minval, maxval, int64): split into two
// subkeys, a high and a low 64-bit word, reduced by span with the
// multiplier (2^32 mod span)^2 mod span, all unsigned and wrapping
// mod 2^64 (jax/_src/random.py::_randint)
__device__ __forceinline__ int64_t tf_randint64(Key2x32 k, int64_t minval, int64_t maxval) {
  const uint64_t hi = tf_random_bits64(threefry2x32(k, 0u, 0u), 0);
  const uint64_t lo = tf_random_bits64(threefry2x32(k, 0u, 1u), 0);
  const uint64_t span = maxval <= minval ? 1ull : (uint64_t)maxval - (uint64_t)minval;
  uint64_t mult = (1ull << 32) % span;
  mult = (mult * mult) % span;
  const uint64_t off = ((hi % span) * mult + lo % span) % span;
  return (int64_t)((uint64_t)minval + off);
}
