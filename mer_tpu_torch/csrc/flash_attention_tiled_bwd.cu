// Long-sequence masked attention backward for Hopper (sm_90a), f32 and bf16:
// the key-tiled kernel K4.
//
// Replaces the TPU kernels mer_tpu/ops/flash_attention.py:579
// (`_bwd_dkv_kernel`) and :624 (`_bwd_dq_kernel`), launched at :693 and :721
// from `_flash_bwd_tiled`, which `_flash_bwd_impl` takes above BWD_FUSED_MAX =
// 2048 keys. It computes K2's function (flash_attention_bwd.cu) for any Sk,
// the formulas at the head of flash_attention_backward.cuh, with P o D and dS
// rounded to the input dtype before their products.
//
// Fully masked rows take P = 1/Sk, as K2 has it. The TPU kernel does not: its
// tiled backward takes exp(s - lse) = 1 there and gives that row's dk, dv Sk
// times the fused backward's (a standing difference, held by
// tests/test_torch_attention_long.py).
//
// Two designs, picked per call:
//
// - bf16 with Dh = 64 (the wav2vec2 and RoBERTa heads) and 16-byte aligned
//   tensors: the Hopper design below (`mer_k4`).
// - Anything else (f32, whose products wgmma has no exact type for; any other
//   Dh <= 128, which TMA's 16-byte row pitch or the 64-wide tiles do not
//   take): the two grids of flash_attention_backward.cuh, K2's template at one
//   slice a block (mma.sync in bf16, FMA in f32).
//
// The Hopper design: three launches in order on the stream, no float atomics,
// so every result has the same bits from run to run. Each of the two product
// kernels is a block of one consumer warpgroup (64 rows) and one producer warp,
// two blocks an SM (two consumer warpgroups of 64 rows a block ran slower).
//
// 1. prep: per query row delta = rowsum(g o out) - g_lse, the lse in log2
//    units (+inf on a fully masked row, whose P = 1/Sk is kept beside it), per
//    key its bias in log2 units (-1e30 log2 e on ignored and padding keys),
//    into f32 scratch padded to 64 rows, which 1-D bulk copies read.
// 2. dq: a block owns one (b*h) slice and 64 query rows. TMA loads its q and g
//    once; 64-key tiles of K and V with their bias stream through a ring of
//    kStages stages (a "full" and an "empty" mbarrier each) that the producer
//    warp's TMA and bulk copies fill. Per tile S = q K^T and dP = g V^T run as
//    wgmma.m64n64k16 with both operands in shared memory (K-major, 128-byte
//    swizzled as TMA writes them); P, D and dS are computed in the accumulator
//    registers, and dq += dS K is a wgmma whose A (dS rounded to bf16) comes
//    from registers and whose B is the K tile read MN-major through the
//    instruction's transpose bit. With dropout it draws D (one Philox call per
//    2 x 2 scores) and writes the tile's keep bits, 512 bytes, to the scratch.
// 3. dk/dv: a block owns one slice and 64 keys. TMA loads its K and V once;
//    64-row tiles of q and g, their rows' lse, delta and fully-masked
//    probability, and the keep bits stream through the ring. Per tile S^T =
//    K q^T and dP^T = V g^T by wgmma from shared memory; P^T, D (from the keep
//    bits: the dq kernel's layout puts a lane's 32 bits in two adjacent words)
//    and dS^T in registers; dV += (P o D)^T g and dK += dS^T q by wgmma with A
//    from registers and the same q and g tiles as B, MN-major. dK and dV stay
//    in registers for the block's life and are written once.
//
// Head dims other than 64 and f32 go to the older design (above), which the
// TMA boxes and the 64-wide wgmma tiles do not serve.
//
// Bound. At [2, 12, 4499, 4499, 64] bf16 (the 90 s clips' fine-tune step) one
// call reads q, k, v, out, g (6.9 MB each), lse and the mask and writes dq,
// dk, dv: about 55 MB, 16 us at 3.35 TB/s; its five products are 10 x 2 x 12
// x 4499^2 x 64 = 311 GFLOP, 0.31 ms at 989 TFLOP/s. Operations bound it. What
// the design does about what held the mma.sync version (6.30 ms there) back:
//
// - Dropout: one Philox4x32-10 call per 2 x 2 scores instead of per score
//   (philox.cuh), and only the dq kernel draws: the dk/dv kernel reads its
//   keep bits (B H Sq Sk / 8 bytes: 61 MB at the shape above, 36 us of
//   traffic). An eighth of the calls the mma.sync version made.
// - Operands: K and V (dk/dv) or q and g (dq) are read by the tensor cores
//   straight from shared memory through wgmma descriptors, never through
//   registers, and the streamed tiles arrive by TMA under a producer warp, so
//   the consumers issue no loads and no block-wide barriers.
// - Seven products instead of five: the dq kernel still recomputes S and dP,
//   the price of no float atomics (reproducible training); PERF.md says what
//   is left.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention_backward.cuh"
#include "philox.cuh"
#include "sm90.cuh"

namespace {

struct flash_attention_tiled_bwd {};  // the kernels' tag: K4 in a profile

namespace mer_k4 {

using bf16 = __nv_bfloat16;
using namespace sm90;
using mer_tiles::pack_bf16;

constexpr int kD = 64;     // the head dim of this design
constexpr int kTile = 64;  // rows of a TMA box: query rows (dk/dv kernel) or keys (dq kernel) a ring stage
constexpr uint32_t kTileBytes = kTile * kD * sizeof(bf16);
constexpr int kStages = 2;
constexpr int kThreads = 128 + 32;             // one consumer warpgroup, one producer warp
constexpr int kBitWords = kTile * kTile / 32;  // keep bits of a 64 x 64 tile
constexpr int kStats = 3;  // per query row: lse log2 e (+inf on a fully masked row), delta, that row's P (1/Sk) or 0
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMaskBias2 = mer_bwd::kMaskBias * kLog2e;  // an ignored key's bias, in log2 units
using mer_bwd::kFullyMaskedLse;

struct Params {
  const bf16* out;
  const bf16* g;
  const float* lse;
  const float* g_lse;
  const uint8_t* mask;
  bf16 *dq, *dk, *dv;
  float* stats;  // [BH][kStats][sq_pad]
  float* bias;   // [B][sk_pad]
  uint32_t* bits;  // with dropout: [BH][sk_pad / 64][sq_pad / 64][kBitWords], the keep bits (bits_tile)
  int BH, B, H, Sq, Sk, sq_pad, sk_pad;
  float scale;
  mer_philox::Dropout drop;
};

constexpr int pad64(int n) { return (n + 63) / 64 * 64; }

// the accumulator's columns 16 kk .. 16 kk + 15 as the A operand of a k-step, rounded to bf16
__device__ __forceinline__ void a_fragments(const float (&d)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// 1. per query row (8 threads a row) its three statistics; per key its bias
template <typename Tag>
__global__ void __launch_bounds__(256) prep_kernel(const Params p) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = tid >> 3, part = tid & 7;
  const int bh = row / p.sq_pad, i = row - bh * p.sq_pad;
  const bool ok = bh < p.BH && i < p.Sq;
  float sum = 0.f;
  if (ok) {
    const size_t off = ((size_t)bh * p.Sq + i) * kD + part * 8;
    const uint4 gv = *reinterpret_cast<const uint4*>(p.g + off);
    const uint4 ov = *reinterpret_cast<const uint4*>(p.out + off);
    const bf16* ge = reinterpret_cast<const bf16*>(&gv);
    const bf16* oe = reinterpret_cast<const bf16*>(&ov);
#pragma unroll
    for (int e = 0; e < 8; ++e) sum += __bfloat162float(ge[e]) * __bfloat162float(oe[e]);
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  sum += __shfl_xor_sync(0xffffffffu, sum, 4);
  if (part == 0 && bh < p.BH) {
    float lse2 = 0.f, delta = 0.f, fully = 0.f;  // padding rows: zero q and g rows, finite P, nothing added
    if (ok) {
      const size_t stat = (size_t)bh * p.Sq + i;
      const float lse = p.lse[stat];
      delta = sum - (p.g_lse != nullptr ? p.g_lse[stat] : 0.f);
      if (lse < kFullyMaskedLse) {
        lse2 = INFINITY;  // exp2 of any score less it is 0; P is `fully`
        fully = 1.f / p.Sk;
      } else {
        lse2 = lse * kLog2e;
      }
    }
    float* st = p.stats + (size_t)bh * kStats * p.sq_pad + i;
    st[0] = lse2;
    st[p.sq_pad] = delta;
    st[2 * p.sq_pad] = fully;
  }
  if (tid < p.B * p.sk_pad) {
    const int b = tid / p.sk_pad, j = tid - b * p.sk_pad;
    p.bias[tid] = (j >= p.Sk || (p.mask != nullptr && p.mask[(size_t)b * p.Sk + j])) ? kMaskBias2 : 0.f;
  }
}

// dq kernel: q and g of its 64 rows resident; K, V and the keys' bias stream
struct DqSmem {
  bf16 q[kTile * kD];  // 1024-byte aligned tiles first
  bf16 g[kTile * kD];
  bf16 k[kStages][kTile * kD];
  bf16 v[kStages][kTile * kD];
  float bias[kStages][kTile];
  uint64_t full[kStages], empty[kStages], once;
};

// dk/dv kernel: K and V of its 64 keys resident; q, g, their rows' statistics and the keep bits stream
struct DkvSmem {
  bf16 k[kTile * kD];
  bf16 v[kTile * kD];
  bf16 q[kStages][kTile * kD];
  bf16 g[kStages][kTile * kD];
  float stats[kStages][kStats][kTile];
  uint32_t bits[kStages][kBitWords];
  uint64_t full[kStages], empty[kStages], once;
};

template <typename Smem>
__device__ __forceinline__ Smem& ring_init(unsigned char* raw) {
  Smem& sm = *reinterpret_cast<Smem*>(align1024(raw));
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 4);  // one arrival per consumer warp
    }
    mbar_init(&sm.once, 1);
    fence_barrier_init();
  }
  __syncthreads();
  return sm;
}

// The keep bits of a 64 x 64 tile, as the dq kernel holds them and the dk/dv kernel reads them: word
// 32 w + pos(g, t) is lane (g, t) of dq warp w, pos = 8 (g >> 1) + 2 t + (g & 1), its byte v the keys
// 16 v .. 16 v + 15, bit 4 (j & 1) + 2 h + c the score (query 16 w + g + 8 h, key 16 v + 8 (j & 1) + 2 t + c).
// A dk/dv lane (g', t') of warp v then finds its scores of query rows 16 w .. 16 w + 15 in byte v of words
// pos(2 t', g' >> 1) and pos(2 t' + 1, g' >> 1), which are adjacent.
__device__ __forceinline__ size_t bits_tile(const Params& p, int bh, int key_tile, int q_tile) {
  return (((size_t)bh * (p.sk_pad / kTile) + key_tile) * (p.sq_pad / kTile) + q_tile) * kBitWords;
}

// 2. dq of 64 query rows of one slice; with dropout, the keep bits of every tile for the dk/dv kernel
template <typename Tag, bool kDrop>
__global__ void __launch_bounds__(kThreads, 2)
    dq_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
              const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_g,
              const Params p) {
  extern __shared__ unsigned char smem_raw[];
  DqSmem& sm = ring_init<DqSmem>(smem_raw);
  const int bh = blockIdx.y, q0 = blockIdx.x * kTile;
  const int n_tiles = (p.Sk + kTile - 1) / kTile;

  if (threadIdx.x >= 128) {  // the producer warp: one lane issues every copy
    if (threadIdx.x == 128) {
      mbar_expect_tx(&sm.once, 2 * kTileBytes);
      tma_load_3d(sm.q, &map_q, &sm.once, 0, q0, bh);
      tma_load_3d(sm.g, &map_g, &sm.once, 0, q0, bh);
      const float* bias = p.bias + (size_t)(bh / p.H) * p.sk_pad;
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(&sm.empty[s], ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(&sm.full[s], 2 * kTileBytes + kTile * sizeof(float));
        tma_load_3d(sm.k[s], &map_k, &sm.full[s], 0, it * kTile, bh);
        tma_load_3d(sm.v[s], &map_v, &sm.full[s], 0, it * kTile, bh);
        bulk_load(sm.bias[s], bias + it * kTile, kTile * sizeof(float), &sm.full[s]);
      }
    }
    return;
  }

  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = q0 + 16 * w + g;  // this lane's query rows: row0, row0 + 8 (< sq_pad)
  float lse2[2], delta[2], fully[2];
  const float* stats = p.stats + (size_t)bh * kStats * p.sq_pad;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lse2[h] = stats[row0 + 8 * h];
    delta[h] = stats[p.sq_pad + row0 + 8 * h];
    fully[h] = stats[2 * p.sq_pad + row0 + 8 * h];
  }
  const float c_log2 = p.scale * kLog2e;
  float dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;
  mbar_wait(&sm.once, 0);
  const uint64_t q_desc = desc_sw128(sm.q), g_desc = desc_sw128(sm.g);
  uint32_t* bits_out = p.bits + bits_tile(p, bh, 0, blockIdx.x) + 32 * w + 8 * (g >> 1) + 2 * t + (g & 1);
  const size_t bits_stride = (size_t)(p.sq_pad / kTile) * kBitWords;  // one key tile further

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    mbar_wait(&sm.full[s], (it / kStages) & 1);
    const uint64_t k_desc = desc_sw128(sm.k[s]), v_desc = desc_sw128(sm.v[s]);
    float sc[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss(sc, q_desc + 2 * kk, k_desc + 2 * kk, kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss(dp, g_desc + 2 * kk, v_desc + 2 * kk, kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(sc);
    fence_operands(dp);

    // P, D and dS where they lie: row row0 + 8 h, key it * 64 + 8 j + 2 t + c
    uint32_t keep = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * t;
      const float2 b2 = *reinterpret_cast<const float2*>(&sm.bias[s][col]);
      uint32_t kb = 0;
      if (kDrop) {
        kb = mer_philox::keep_bits(p.drop, bh, row0, it * kTile + col, false);
        keep |= kb << (4 * j);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e, h = e >> 1;
        const float pr = exp2f(fmaf(sc[i], c_log2, ((e & 1) ? b2.y : b2.x) - lse2[h])) + fully[h];
        dp[i] = kDrop ? pr * fmaf(dp[i], (kb >> e) & 1u ? p.drop.keep_scale : 0.f, -delta[h])
                      : pr * (dp[i] - delta[h]);  // dS
      }
    }
    if (kDrop) bits_out[it * bits_stride] = keep;
    uint32_t a_ds[4][4];
    a_fragments(dp, a_ds);
    fence_operands(dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_mn(dq, a_ds[kk], k_desc + 128 * kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(dq);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[s]);  // this warp is done with the stage
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    if (r >= p.Sq) continue;
    const size_t row = ((size_t)bh * p.Sq + r) * kD;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * t, i = 4 * j + 2 * h;
      *reinterpret_cast<__nv_bfloat162*>(p.dq + row + col) =
          __floats2bfloat162_rn(dq[i] * p.scale, dq[i + 1] * p.scale);
    }
  }
}

// 3. dk, dv of 64 keys of one slice; with dropout, D from the dq kernel's keep bits
template <typename Tag, bool kDrop>
__global__ void __launch_bounds__(kThreads, 2)
    dkv_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_g,
               const Params p) {
  extern __shared__ unsigned char smem_raw[];
  DkvSmem& sm = ring_init<DkvSmem>(smem_raw);
  const int bh = blockIdx.y, k0 = blockIdx.x * kTile;
  const int n_tiles = (p.Sq + kTile - 1) / kTile;

  if (threadIdx.x >= 128) {
    if (threadIdx.x == 128) {
      mbar_expect_tx(&sm.once, 2 * kTileBytes);
      tma_load_3d(sm.k, &map_k, &sm.once, 0, k0, bh);
      tma_load_3d(sm.v, &map_v, &sm.once, 0, k0, bh);
      const float* stats = p.stats + (size_t)bh * kStats * p.sq_pad;
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(&sm.empty[s], ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(&sm.full[s], 2 * kTileBytes + kStats * kTile * sizeof(float) + (kDrop ? 4 * kBitWords : 0));
        tma_load_3d(sm.q[s], &map_q, &sm.full[s], 0, it * kTile, bh);
        tma_load_3d(sm.g[s], &map_g, &sm.full[s], 0, it * kTile, bh);
        for (int r = 0; r < kStats; ++r)
          bulk_load(sm.stats[s][r], stats + r * p.sq_pad + it * kTile, kTile * sizeof(float), &sm.full[s]);
        if (kDrop) bulk_load(sm.bits[s], p.bits + bits_tile(p, bh, blockIdx.x, it), 4 * kBitWords, &sm.full[s]);
      }
    }
    return;
  }

  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int key0 = k0 + 16 * w + g;  // this lane's keys (rows of S^T): key0, key0 + 8 (< sk_pad)
  const float* bias = p.bias + (size_t)(bh / p.H) * p.sk_pad;
  const float bias2[2] = {bias[key0], bias[key0 + 8]};
  const float c_log2 = p.scale * kLog2e;
  const int bit0 = g & 1;  // bit 4 h + 2 (j & 1) + (g & 1) of this lane's bytes: key g + 8 h, query chunk j
  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(&sm.once, 0);
  const uint64_t k_desc = desc_sw128(sm.k), v_desc = desc_sw128(sm.v);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    mbar_wait(&sm.full[s], (it / kStages) & 1);
    const uint64_t q_desc = desc_sw128(sm.q[s]), g_desc = desc_sw128(sm.g[s]);
    float st[32], dpt[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss(st, k_desc + 2 * kk, q_desc + 2 * kk, kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss(dpt, v_desc + 2 * kk, g_desc + 2 * kk, kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(st);
    fence_operands(dpt);

    // P^T, D and dS^T where they lie: row key0 + 8 h, column it * 64 + 8 j + 2 t + c
    uint32_t bytes[2] = {0u, 0u};  // the keep bits of query rows 2t (c = 0) and 2t + 1 (c = 1) of a 16-row block
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * t;
      const float2 lse2 = *reinterpret_cast<const float2*>(&sm.stats[s][0][col]);
      const float2 delta = *reinterpret_cast<const float2*>(&sm.stats[s][1][col]);
      const float2 fully = *reinterpret_cast<const float2*>(&sm.stats[s][2][col]);
      if (kDrop && (j & 1) == 0) {  // query rows 16 (j / 2) ..: byte w of words pos(2t, g >> 1) and the next
        const uint2 words = *reinterpret_cast<const uint2*>(&sm.bits[s][32 * (j >> 1) + 8 * t + 2 * (g >> 1)]);
        bytes[0] = words.x >> (8 * w);
        bytes[1] = words.y >> (8 * w);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e, h = e >> 1, c = e & 1;
        const float pr = exp2f(fmaf(st[i], c_log2, bias2[h] - (c ? lse2.y : lse2.x))) + (c ? fully.y : fully.x);
        const float dl = c ? delta.y : delta.x;
        if (kDrop) {
          const float f = (bytes[c] >> (4 * h + 2 * (j & 1) + bit0)) & 1u ? p.drop.keep_scale : 0.f;
          st[i] = pr * f;                      // (P o D)^T
          dpt[i] = pr * fmaf(dpt[i], f, -dl);  // dS^T
        } else {
          st[i] = pr;
          dpt[i] = pr * (dpt[i] - dl);
        }
      }
    }
    uint32_t a_pd[4][4], a_ds[4][4];
    a_fragments(st, a_pd);
    a_fragments(dpt, a_ds);
    fence_operands(dv);
    fence_operands(dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_mn(dv, a_pd[kk], g_desc + 128 * kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_mn(dk, a_ds[kk], q_desc + 128 * kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(dv);
    fence_operands(dk);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[s]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + 8 * h;
    if (key >= p.Sk) continue;
    const size_t row = ((size_t)bh * p.Sk + key) * kD;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * t, i = 4 * j + 2 * h;
      *reinterpret_cast<__nv_bfloat162*>(p.dk + row + col) =
          __floats2bfloat162_rn(dk[i] * p.scale, dk[i + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(p.dv + row + col) = __floats2bfloat162_rn(dv[i], dv[i + 1]);
    }
  }
}

template <typename Kernel>
cudaError_t launch_ring(Kernel kernel, size_t bytes, int rows, const CUtensorMap (&maps)[4], const Params& p,
                        cudaStream_t stream) {
  const cudaError_t smem_ok = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (smem_ok != cudaSuccess) return smem_ok;
  kernel<<<dim3((rows + kTile - 1) / kTile, p.BH), kThreads, bytes, stream>>>(maps[0], maps[1], maps[2], maps[3], p);
  return cudaGetLastError();
}

template <typename Tag, bool kDrop>
cudaError_t launch_kernels(const CUtensorMap (&maps)[4], const Params& p, cudaStream_t stream) {
  const int threads = 8 * p.BH * p.sq_pad > p.B * p.sk_pad ? 8 * p.BH * p.sq_pad : p.B * p.sk_pad;
  prep_kernel<Tag><<<(threads + 255) / 256, 256, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_ring(dq_kernel<Tag, kDrop>, sizeof(DqSmem) + 1024, p.Sq, maps, p, stream);  // + alignment slack
  if (err != cudaSuccess) return err;
  return launch_ring(dkv_kernel<Tag, kDrop>, sizeof(DkvSmem) + 1024, p.Sk, maps, p, stream);
}

// One call of the Hopper design (scratch: see mer_flash_attention_tiled_bwd).
template <typename Tag>
cudaError_t launch(const mer_bwd::Args& a) {
  Params p{static_cast<const bf16*>(a.out), static_cast<const bf16*>(a.g), static_cast<const float*>(a.lse),
           static_cast<const float*>(a.g_lse), static_cast<const uint8_t*>(a.mask), static_cast<bf16*>(a.dq),
           static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), static_cast<float*>(a.delta), nullptr, nullptr,
           a.B * a.H, a.B, a.H, a.Sq, a.Sk, pad64(a.Sq), pad64(a.Sk), a.scale, a.drop};
  p.bias = p.stats + (size_t)p.BH * kStats * p.sq_pad;
  p.bits = reinterpret_cast<uint32_t*>(p.bias + (size_t)p.B * p.sk_pad);
  if (p.BH > 65535 || (long long)8 * p.BH * p.sq_pad > 0x7fffffffLL) return cudaErrorInvalidValue;
  CUtensorMap maps[4];  // q, k, v, g
  if (!encode_rows64(&maps[0], a.q, a.Sq, p.BH) || !encode_rows64(&maps[1], a.k, a.Sk, p.BH) ||
      !encode_rows64(&maps[2], a.v, a.Sk, p.BH) || !encode_rows64(&maps[3], a.g, a.Sq, p.BH))
    return cudaErrorInvalidValue;
  return a.drop.on ? launch_kernels<Tag, true>(maps, p, a.stream) : launch_kernels<Tag, false>(maps, p, a.stream);
}

}  // namespace mer_k4
}  // namespace

// dtype: 0 = float32, 1 = bfloat16. g_lse may be null (no lse cotangent);
// scratch is 16-byte aligned, of B H 3 pad64(Sq) + B pad64(Sk) floats, with
// dropout B H pad64(Sq) pad64(Sk) / 32 words more (pad64: rounded up to 64;
// the older design's delta [B, H, Sq] takes its head). dropout as in
// mer_flash_attention_fwd. Returns the cudaError_t of the launches.
extern "C" int mer_flash_attention_tiled_bwd(int dtype, const void* q, const void* k, const void* v,
                                             const void* mask, const void* out, const void* lse, const void* g,
                                             const void* g_lse, void* dq, void* dk, void* dv, void* scratch, int B,
                                             int H, int Sq, int Sk, int Dh, float scale, int dropout,
                                             uint32_t seed0, uint32_t seed1, uint32_t threshold, float keep_scale,
                                             void* stream) {
  const mer_bwd::Args a{q, k, v, mask, out, lse, g, g_lse, dq, dk, dv, scratch, B, H, Sq, Sk, Dh, scale,
                        {seed0, seed1, threshold, keep_scale, dropout}, 0, static_cast<cudaStream_t>(stream)};
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const bool hopper = dtype == 1 && Dh == mer_k4::kD && B > 0 && H > 0 && Sq > 0 && Sk > 0 && aligned(q) &&
                      aligned(k) && aligned(v) && aligned(out) && aligned(g) && aligned(dq) && aligned(dk) &&
                      aligned(dv) && aligned(scratch);
  if (hopper) return static_cast<int>(mer_k4::launch<flash_attention_tiled_bwd>(a));
  return mer_bwd::launch<flash_attention_tiled_bwd, false>(dtype, a);
}

