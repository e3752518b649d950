// Threefry-2x32 (20 rounds), JAX's key and counter layout.
//
// fold_in(k, d) = TF(k, (0, d)); 32-bit word i of bits(k, .) is the XOR
// of the two outputs of TF(k, (0, i)).  The plain PyTorch twin is
// repro_torch.core.prng.threefry2x32.
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
