// The stacked tile shared by K1's one-pass forward (flash_attention_fwd_stacked.cuh) and K2's one-pass backward
// (flash_attention_bwd_stacked.cuh) at the fusion model's dialogue shapes (Sq, Sk <= 64; head dims 96 and 50, K2
// also 64).
//
// In the [B, H, S, Dh] layout consecutive (b*h) slices are consecutive rows of the [B*H*S, Dh] view, so a block's
// 64-row tile holds n <= 64 / max(Sq, Sk) whole slices: rows tile0 Sq .. (tile0 + n) Sq of q (and g, out) and
// tile0 Sk .. of k and v. The products run over the whole tile; a score whose row and key lie in different slices,
// or past the tile's real rows, gets no weight, so the block-diagonal stack's products are the slices' own, side by
// side. This header holds what both directions do the same way:
//
// - the tile's geometry: how many slices, the key columns' slices and biases (from the mask's bytes by plain loads:
//   a TMA box must start 16-byte aligned, a mask row starts at byte b Sk);
// - the bf16 operand tiles: 64 x 64 boxes, 128-byte swizzled as TMA writes them, read by TMA through a map of the
//   [rows][Dh] view (Dh 64, 96: a row stride a multiple of 16 bytes), or at Dh 50, whose 100-byte rows no tensor map
//   takes, by 4-byte loads into the same layout, columns 50-63 and rows past the real ones zero;
// - the bf16 dropout draw: one Philox call per 2 x 2 scores, the lane's block located in its slice (keep_bits_at);
// - the f32 tiles (rows padded to a multiple of 4 values: 50 -> 52) and the f32 draw, each score's block at its
//   own slice, row and key.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention_tiles.cuh"
#include "philox.cuh"
#include "sm90.cuh"

namespace {
namespace mer_stacked {

using namespace sm90;
using bf16 = __nv_bfloat16;

constexpr int kRows = 64;  // a tile's rows: stacked query rows, stacked keys
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
using mer_tiles::kFullyMaskedLse;
using mer_tiles::kMaskBias;
constexpr float kMaskBias2 = kMaskBias * kLog2e;  // an ignored key's bias in log2 units
constexpr uint32_t kBoxBytes = kRows * 64 * sizeof(bf16);

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// bf16 with dropout at an odd Sq or Sk: a tile holds one slice, or a lane's 2 x 2 Philox block could straddle
// two (the f32 designs draw each score's block at its own row and key)
inline bool one_slice(int dtype, int Sq, int Sk, bool dropout) { return dtype == 1 && dropout && ((Sq | Sk) & 1); }

// the most slices a tile stacks: as many as fit in 64 rows, one where one_slice says so
inline int most_slices(int dtype, int Sq, int Sk, bool dropout) {
  return one_slice(dtype, Sq, Sk, dropout) ? 1 : kRows / (Sq > Sk ? Sq : Sk);
}

// The slices a tile stacks, chosen on the card for both directions (PERF.md: every count timed at the counted
// shapes). A block is one chain of dependent latencies, so the grid wants about one block an SM: in bf16 the fewest
// slices a tile (at most most_slices) that keep the grid within one block an SM; in f32, whose FMA work grows with
// the tile, one. K2's probe: at B H = 128 one slice, where two to the most that fit took 1.08-1.66 times as long; at
// 256 two, where one took 1.06-1.20 times as long and three or more 1.05-1.62; in f32 two took 1.12-1.30 times as
// long as one. K1's: this count within 5% of the fastest at every counted shape, the fastest at 19 of 30; in f32
// one the fastest at all.
inline int slices_per_tile(int dtype, int BH, int Sq, int Sk, bool dropout, int sms) {
  if (dtype == 0) return 1;
  const int most = most_slices(dtype, Sq, Sk, dropout), waves = (BH + sms - 1) / sms;
  return waves < most ? waves : most;
}

// the SMs of the current card, asked once
inline int sm_count() {
  static const int sms = [] {
    int device = 0, n = 0;
    return cudaGetDevice(&device) == cudaSuccess &&
                   cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) == cudaSuccess && n > 0
               ? n
               : 132;
  }();
  return sms;
}

// Whether a stacked design takes a call's sizes: Sq, Sk <= 64 and, in bf16 and f32, one of `head_dims`
template <int... kHeadDims>
inline bool takes_sizes(int dtype, int Sq, int Sk, int Dh) {
  return (dtype == 0 || dtype == 1) && Sq >= 1 && Sq <= kRows && Sk >= 1 && Sk <= kRows && ((Dh == kHeadDims) || ...);
}

// The key columns of a tile (thread tid < 64 makes column tid): its slice in the tile (-1 past the real keys) and
// its bias (`masked` on an ignored key, else 0)
__device__ __forceinline__ void key_columns(int* slice, float* bias, int tid, int rows_k, int Sk, int H, int tile0,
                                            const uint8_t* mask, float masked) {
  if (tid >= kRows) return;
  const int s = tid / Sk, key = tid - s * Sk;
  const bool real = tid < rows_k;
  slice[tid] = real ? s : -1;
  bias[tid] = real && mask != nullptr && mask[(size_t)((tile0 + s) / H) * Sk + key] ? masked : 0.f;
}

// -- bf16 tiles ------------------------------------------------------------------------------------------------

// element offset of (row, col) in a 128-byte swizzled [64][64] bf16 tile: the row's 16-byte chunk col >> 3 XOR the
// row's place in its 8-row atom
__device__ __forceinline__ int swizzled(int row, int col) {
  return row * 64 + (((col >> 3) ^ (row & 7)) << 3) + (col & 7);
}

// the [rows][Dh] view as 64 x 64 boxes, 128-byte swizzled; columns past Dh and rows past `rows` read as zeros
inline bool encode_view(CUtensorMap* map, const void* base, int Dh, int rows) {
  const cuuint64_t d = static_cast<cuuint64_t>(Dh), r = static_cast<cuuint64_t>(rows);
  return encode_3d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, {d, r, 1}, {d * 2, r * d * 2}, {64, 64, 1});
}

// 64-column boxes of a bf16 row of DH values; whether TMA reads the view (a row stride a multiple of 16 bytes)
template <int DH>
struct Boxes {
  static constexpr int kN = DH / 64 + (DH % 64 != 0);
  static constexpr bool kTma = DH % 8 == 0;
};

// A tile to load by load_words: rows row0 .. row0 + 63 of the [rows][DH] bf16 view at src into the swizzled tile
// dst, the rows from `real` on zero
struct WordTile {
  bf16* dst;
  const bf16* src;
  size_t row0;
  int real;
};

// Load kOps tiles with 4-byte loads (src 4-byte aligned; DH even), as TMA would write a box: columns DH .. 63 and
// rows from `real` on read as zeros. Each of the block's kThreads threads takes 16-byte chunks; every load of
// every tile is issued before the first store. For DH <= 64 (50).
template <int DH, int kThreads, int kOps>
__device__ __forceinline__ void load_words(const WordTile (&tiles)[kOps], int tid) {
  static_assert(DH % 2 == 0 && DH <= 64, "one 64-column box of bf16 pairs");
  constexpr int kWords = DH / 2, kChunks = kRows * 8 / kThreads;
  uint32_t w[kOps][kChunks][4];
#pragma unroll
  for (int o = 0; o < kOps; ++o) {
    const uint32_t* words = reinterpret_cast<const uint32_t*>(tiles[o].src) + tiles[o].row0 * kWords;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int chunk = tid + i * kThreads, r = chunk >> 3, c = chunk & 7;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        w[o][i][e] = r < tiles[o].real && 4 * c + e < kWords ? words[(size_t)r * kWords + 4 * c + e] : 0u;
    }
  }
#pragma unroll
  for (int o = 0; o < kOps; ++o)
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int chunk = tid + i * kThreads, r = chunk >> 3, c = chunk & 7;
      *reinterpret_cast<uint4*>(tiles[o].dst + swizzled(r, 8 * c)) =
          make_uint4(w[o][i][0], w[o][i][1], w[o][i][2], w[o][i][3]);
    }
}

// The dropout draw of a lane of a bf16 tile (wgmma accumulator layout: rows r0 and r0 + 8, r0 = 16 w + g): the
// 2 x 2 blocks it draws start at stacked row r0 + 7 (r0 & 1) (keep_bits' pairing), located in that row's slice
struct LaneDraw {
  uint32_t bh, pair, parity;
  __device__ __forceinline__ LaneDraw(int r0, int Sq, int tile0) {
    const int drawn = r0 + 7 * (r0 & 1), s = drawn / Sq;
    bh = tile0 + s;
    pair = (drawn - s * Sq) >> 1;
    parity = r0 & 1;
  }
  // the keep bits of the lane's scores at key columns col, col + 1 (even), whose slice is `col_slice`; all 32 lanes
  // call it together
  __device__ __forceinline__ uint32_t bits(const mer_philox::Dropout& d, int col, int col_slice, int Sk) const {
    return mer_philox::keep_bits_at(d, bh, pair, col - max(col_slice, 0) * Sk, parity);
  }
};

// -- f32 tiles --------------------------------------------------------------------------------------------------

// a row of DH f32 values padded to 16-byte chunks in shared memory (50 -> 52)
template <int DH>
struct PaddedRow {
  static constexpr int kDp = (DH + 3) & ~3, kChunks = kDp / 4;
  static constexpr bool kBulk = DH == kDp;  // one 1-D bulk copy of n S DH values (DH 50: not 16-byte aligned)
};

// rows `rows` of the [.][DH] f32 view at src into dst [rows][kDp], the padding zero, by 8-byte loads (DH 50)
template <int DH, int kThreads>
__device__ __forceinline__ void load_padded(float* dst, const float* src, int rows, int tid) {
  constexpr int kPairs = PaddedRow<DH>::kDp / 2, kReal = DH / 2;
  for (int i = tid; i < rows * kPairs; i += kThreads) {
    const int r = i / kPairs, c = i - r * kPairs;
    const float2 x = c < kReal ? *reinterpret_cast<const float2*>(src + (size_t)r * DH + 2 * c) : make_float2(0.f, 0.f);
    *reinterpret_cast<float2*>(dst + r * PaddedRow<DH>::kDp + 2 * c) = x;
  }
}

// 16-byte chunk c (values 4 c .. 4 c + 3, those below DH) of a row of DH f32 values at dst
template <int DH>
__device__ __forceinline__ void store_chunk(float* dst, int c, float4 x) {
  if constexpr (PaddedRow<DH>::kBulk) {
    *reinterpret_cast<float4*>(dst + 4 * c) = x;
  } else {
    *reinterpret_cast<float2*>(dst + 4 * c) = make_float2(x.x, x.y);
    if (4 * c + 2 < DH) *reinterpret_cast<float2*>(dst + 4 * c + 2) = make_float2(x.z, x.w);
  }
}

// dot products of an f32 row a with four rows b[u] over C 16-byte chunks into acc[u], each lane starting its sweep at
// its own chunk (lanes that share a column read distinct banks); the sums in the same order every call
template <int C>
__device__ __forceinline__ void dot4(const float4* a, const float4* const (&b)[4], float (&acc)[4], int lane) {
  int c = lane % C;
  for (int step = 0; step < C; ++step) {
    const float4 x = a[c];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 y = b[u][c];
      acc[u] = fmaf(x.x, y.x, fmaf(x.y, y.y, fmaf(x.z, y.z, fmaf(x.w, y.w, acc[u]))));
    }
    c = c + 1 == C ? 0 : c + 1;
  }
}

// The dropout factors (keep_scale or 0) of row i, keys j0 .. j0 + 3 (j0 even) of slice bh: two Philox blocks, each
// score taking word 2 (i & 1) + (j & 1)
__device__ __forceinline__ void f32_factors(const mer_philox::Dropout& d, uint32_t bh, int i, int j0, float (&f)[4]) {
  uint32_t words[2][4];
#pragma unroll
  for (int u = 0; u < 2; ++u) mer_philox::philox4(d.seed0, d.seed1, (j0 >> 1) + u, i >> 1, bh, words[u]);
#pragma unroll
  for (int u = 0; u < 4; ++u) f[u] = words[u >> 1][2 * (i & 1) + (u & 1)] >= d.threshold ? d.keep_scale : 0.f;
}

}  // namespace mer_stacked
}  // namespace
