// JAX's threefry2x32 hash on the device, shared by the kernels that draw JAX's
// random bits in registers (`dropout.cu`, `me_adamw.cu`).
//
// `threefry_bits(k0, k1, hi, lo)` is the 20-round Threefry-2x32 of the counter
// words (hi, lo) under the key words (k0, k1), its two output words xor'd: the
// bits `jax.random.bits` gives for the flat index hi * 2^32 + lo with
// `jax_threefry_partitionable` on, as `core/prng.py:random_bits` computes them
// on tensors.  Rotates are funnel shifts.
#pragma once

#include <stdint.h>

namespace prt {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

// threefry2x32 of the counter words (x0, x1) under the key (k0, k1): the steps
// of `core/prng.py:threefry2x32`
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1, uint32_t x0,
                                                  uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
#define PRT_ROUND(r) \
  x0 += x1;          \
  x1 = rotl(x1, r) ^ x0;
  x0 += k0;
  x1 += k1;
  PRT_ROUND(13) PRT_ROUND(15) PRT_ROUND(26) PRT_ROUND(6)
  x0 += k1;
  x1 += k2 + 1u;
  PRT_ROUND(17) PRT_ROUND(29) PRT_ROUND(16) PRT_ROUND(24)
  x0 += k2;
  x1 += k0 + 2u;
  PRT_ROUND(13) PRT_ROUND(15) PRT_ROUND(26) PRT_ROUND(6)
  x0 += k0;
  x1 += k1 + 3u;
  PRT_ROUND(17) PRT_ROUND(29) PRT_ROUND(16) PRT_ROUND(24)
  x0 += k1;
  x1 += k2 + 4u;
  PRT_ROUND(13) PRT_ROUND(15) PRT_ROUND(26) PRT_ROUND(6)
  x0 += k2;
  x1 += k0 + 5u;
#undef PRT_ROUND
  return x0 ^ x1;
}

// the bits of flat index i
__device__ __forceinline__ uint32_t threefry_bits_at(uint32_t k0, uint32_t k1, uint64_t i) {
  return threefry_bits(k0, k1, static_cast<uint32_t>(i >> 32), static_cast<uint32_t>(i));
}

}  // namespace prt
