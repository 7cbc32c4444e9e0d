// Philox4x32-10 counter-based generator for in-kernel attention dropout.
//
// Replaces the TPU hardware PRNG of mer_tpu/ops/flash_attention.py:50-69
// (`_dropout_mask`, seeded per (bh, q-block) through pltpu.prng_seed). Here
// the keep bit of one attention probability is a pure function of
// (seed[2], bh, query row, key column): counter = (column, row, bh, 0),
// key = seed, first output word. No tile index enters it, so the forward,
// the backward and the plain PyTorch version
// (mer_tpu_torch/ops/flash_attention.py::philox_bits) draw the same bits
// whatever their tiling. Keep iff bits >= threshold, threshold =
// min(int(rate * 2^32), 2^32 - 1), so P(keep) = 1 - rate to 2^-32.
//
// Rounds and constants are those of Salmon et al., "Parallel random numbers:
// as easy as 1, 2, 3" (SC 2011): ten rounds, the key bumped between them.

#pragma once

#include <stdint.h>

namespace mer_philox {

constexpr uint32_t kM0 = 0xD2511F53u;
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;
constexpr uint32_t kW1 = 0xBB67AE85u;

__device__ __forceinline__ uint32_t bits(uint32_t seed0, uint32_t seed1, uint32_t bh, uint32_t row,
                                         uint32_t col) {
  uint32_t c0 = col, c1 = row, c2 = bh, c3 = 0u, k0 = seed0, k1 = seed1;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(kM0, c0), lo0 = kM0 * c0;
    const uint32_t hi1 = __umulhi(kM1, c2), lo1 = kM1 * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += kW0;
    k1 += kW1;
  }
  return c0;
}

// Dropout of one kernel call; `on` = 0 leaves every probability as it is.
struct Dropout {
  uint32_t seed0, seed1, threshold;
  float keep_scale;  // 1 / (1 - rate)
  int on;
};

// The factor D of probability (row, col) of head bh: keep_scale if kept, else 0.
__device__ __forceinline__ float factor(const Dropout& d, uint32_t bh, uint32_t row, uint32_t col) {
  return bits(d.seed0, d.seed1, bh, row, col) >= d.threshold ? d.keep_scale : 0.f;
}

}  // namespace mer_philox
