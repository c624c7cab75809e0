// Threefry-2x32 on the device, bit-equal to jax.random's default PRNG
// (jax/_src/prng.py threefry_2x32), shared by sampling.cu (the positional
// draws of sampled tokens) and dropout.cu (dropout's keep masks). The
// Python twin is paddle_tpu_torch/core/rng.py:threefry_2x32.
#pragma once

#include <cstdint>

namespace rng {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// 20 rounds in five groups of four, rotations (13, 15, 26, 6) /
// (17, 29, 16, 24), the key schedule k1, k2, k1 ^ k2 ^ 0x1BD11BDA injected
// after each group with the group number added to the second word: counters
// (x0, x1) are hashed in place under key (k1, k2).
__device__ __forceinline__ void threefry2x32(uint32_t k1, uint32_t k2,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int g = 0; g < 5; ++g) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[g & 1][j]);
      x1 ^= x0;
    }
    x0 += ks[(g + 1) % 3];
    x1 += ks[(g + 2) % 3] + static_cast<uint32_t>(g + 1);
  }
}

}  // namespace rng
