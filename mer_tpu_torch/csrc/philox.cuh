// Philox4x32-10 counter-based generator for in-kernel attention dropout.
//
// Replaces the TPU hardware PRNG of mer_tpu/ops/flash_attention.py:50-69
// (`_dropout_mask`, seeded per (bh, q-block) through pltpu.prng_seed). Here
// the keep bit of one attention probability is a pure function of
// (seed[2], bh, query row, key column): one Philox call at counter
// (column >> 1, row >> 1, bh, 0), key = seed, serves the 2 x 2 block of scores
// (row & ~1 .. + 1, column & ~1 .. + 1), score (row, column) taking output word
// 2 (row & 1) + (column & 1). No tile index enters it, so the forwards, the
// backwards and the plain PyTorch version
// (mer_tpu_torch/ops/flash_attention.py::philox_bits) draw the same bits
// whatever their tiling. Keep iff bits >= threshold, threshold =
// min(int(rate * 2^32), 2^32 - 1), so P(keep) = 1 - rate to 2^-32.
//
// Why 2 x 2 blocks: in the mma.sync and wgmma accumulator layout lane (g, t)
// holds fragment rows g and g + 8 at fragment columns 2t and 2t + 1, and lanes
// l and l ^ 4 hold rows g and g ^ 1. Together the two lanes hold exactly two
// blocks, so each draws one block and hands the other lane the keep bits of
// its row with one shuffle: one Philox call per four scores, in every kernel.
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

// The four output words of Philox4x32-10 at counter (c0, c1, c2, 0) and key (seed0, seed1).
__device__ __forceinline__ void philox4(uint32_t seed0, uint32_t seed1, uint32_t c0, uint32_t c1, uint32_t c2,
                                        uint32_t (&out)[4]) {
  uint32_t c3 = 0u, k0 = seed0, k1 = seed1;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    // one 32 x 32 -> 64-bit multiply each (a single IMAD.WIDE), not a high and a low half apart
    const uint64_t p0 = static_cast<uint64_t>(kM0) * c0, p1 = static_cast<uint64_t>(kM1) * c2;
    c0 = static_cast<uint32_t>(p1 >> 32) ^ c1 ^ k0;
    c1 = static_cast<uint32_t>(p1);
    c2 = static_cast<uint32_t>(p0 >> 32) ^ c3 ^ k1;
    c3 = static_cast<uint32_t>(p0);
    k0 += kW0;
    k1 += kW1;
  }
  out[0] = c0;
  out[1] = c1;
  out[2] = c2;
  out[3] = c3;
}

// Dropout of one kernel call; `on` = 0 leaves every probability as it is.
struct Dropout {
  uint32_t seed0, seed1, threshold;
  float keep_scale;  // 1 / (1 - rate)
  int on;
};

// The lane's four keep bits from the words w of the 2 x 2 block it drew (see keep_bits), p the parity of its first
// fragment row: lanes l and l ^ 4 swap rows.
__device__ __forceinline__ uint32_t lane_keep_bits(const Dropout& d, const uint32_t (&w)[4], uint32_t p,
                                                   bool transposed) {
  // word 2 (query & 1) + (key & 1): the block's fragment row of parity r, columns c = 0, 1, as bits c
  const auto keep = [&](int i) { return static_cast<uint32_t>(w[i] >= d.threshold); };
  const uint32_t row0 = transposed ? keep(0) | (keep(2) << 1) : keep(0) | (keep(1) << 1);
  const uint32_t row1 = transposed ? keep(1) | (keep(3) << 1) : keep(2) | (keep(3) << 1);
  const uint32_t mine = p ? row1 : row0;                           // this lane's row of its own block
  const uint32_t got = __shfl_xor_sync(0xffffffffu, p ? row0 : row1, 4);  // its row of lane ^ 4's block
  return p ? got | (mine << 2) : mine | (got << 2);                   // rows g (bits 0, 1) and g + 8 (bits 2, 3)
}

// The keep bits of a lane's four scores in the accumulator layout: bit 2 h + c
// is that of fragment row row + 8 h, fragment column col + c. `row` is the
// lane's first fragment row (g), whose parity is g's (the tile starts on an
// even row); `col` its first column (2t, even). Fragment rows are query rows
// and columns keys, or, `transposed` (the dk/dv products' S^T), rows are keys
// and columns query rows. All 32 lanes of the warp call it together: lanes l
// and l ^ 4 swap keep bits.
__device__ __forceinline__ uint32_t keep_bits(const Dropout& d, uint32_t bh, uint32_t row, uint32_t col,
                                              bool transposed) {
  const uint32_t p = row & 1u;                // lane ^ 4 holds the rows of the other parity
  const uint32_t pair = (row + 8u * p) >> 1;  // the block this lane draws: rows g, g + 1 or g + 7, g + 8
  uint32_t w[4];
  if (transposed) philox4(d.seed0, d.seed1, pair, col >> 1, bh, w);
  else philox4(d.seed0, d.seed1, col >> 1, pair, bh, w);
  return lane_keep_bits(d, w, p, transposed);
}

// keep_bits (not transposed) where a lane's block is not found from its fragment row alone, as in a tile that
// stacks several (b*h) slices: the block the lane draws (fragment rows g, g + 1 for p = 0, or g + 7, g + 8 for
// p = 1; columns col, col + 1) is head bh's query rows 2 pair, 2 pair + 1 at keys col, col + 1 (col even).
__device__ __forceinline__ uint32_t keep_bits_at(const Dropout& d, uint32_t bh, uint32_t pair, uint32_t col,
                                                 uint32_t p) {
  uint32_t w[4];
  philox4(d.seed0, d.seed1, col >> 1, pair, bh, w);
  return lane_keep_bits(d, w, p, false);
}

// The factors D (keep_scale if kept, else 0) of those four scores: f[2 h + c].
__device__ __forceinline__ void factors(const Dropout& d, uint32_t bh, uint32_t row, uint32_t col, bool transposed,
                                        float (&f)[4]) {
  const uint32_t bits = keep_bits(d, bh, row, col, transposed);
#pragma unroll
  for (int e = 0; e < 4; ++e) f[e] = (bits >> e) & 1u ? d.keep_scale : 0.f;
}

}  // namespace mer_philox
