// The port's noise stream, shared by every kernel that draws normals.
//
// Philox4x32-10 (Salmon et al., SC'11; the Random123 reference), key = the
// problem's 64-bit seed, counter = (solve index, global sample index,
// a*H + t, 0), output word 0; normal z = sqrt(2) erfinv(((bits >> 8) -
// (2^23 - 0.5)) 2^-23), exact in float32 and finite.  ops/sampling.py holds
// the same stream in plain PyTorch (philox_normals), word for word.

#pragma once

#include <stdint.h>

__device__ __forceinline__ uint32_t philox_word0(uint32_t c0, uint32_t c1,
                                                 uint32_t c2, uint32_t c3,
                                                 uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return c0;
}

__device__ __forceinline__ float bits_to_normal(uint32_t bits) {
  const float x = ((float)(bits >> 8) - 8388607.5f) * (1.0f / 8388608.0f);
  return erfinvf(x) * 1.41421356f;
}

// Problem b's Philox key, seeds[b].
__device__ __forceinline__ void philox_key(const unsigned long long* seeds, int b,
                                           uint32_t& k0, uint32_t& k1) {
  const unsigned long long s = seeds[b];
  k0 = (uint32_t)(s & 0xffffffffull);
  k1 = (uint32_t)(s >> 32);
}

// eps(a, t, k) = sigma z(step, global sample kg, row = a*H + t): the one
// code path of every draw, in pass 1 and again in pass 2.
__device__ __forceinline__ float draw_eps(uint32_t step, uint32_t kg, uint32_t row,
                                          float sigma, uint32_t k0, uint32_t k1) {
  return bits_to_normal(philox_word0(step, kg, row, 0u, k0, k1)) * sigma;
}
