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
// Three designs, picked per call (the entry records which one ran:
// mer_flash_attention_tiled_bwd_route):
//
// - bf16 with Dh = 64 (the wav2vec2 and RoBERTa heads) and 16-byte aligned
//   tensors: the Hopper design below (`mer_k4`), route 1.
// - f32 with Dh = 64 and 16-byte aligned tensors: the same three launches in
//   TF32 with error compensation (3xTF32, `mer_k4_tf32`, further below),
//   route 2.
// - Anything else (any other Dh <= 128, which TMA's 16-byte row pitch or the
//   64-wide tiles do not take; unaligned tensors): the two grids of
//   flash_attention_backward.cuh, K2's template at one slice a block
//   (mma.sync in bf16, FMA in f32), route 0.
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
// Head dims other than 64 go to the older design (above), which the TMA boxes
// and the 64-wide wgmma tiles do not serve.
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
//
// The f32 design (`mer_k4_tf32`): the bf16 design's three launches, with every
// product in 3xTF32 on wgmma.m64n64k8 tf32 (as flash_attention_hopper.cuh's
// forward): each operand x = hi + lo, hi = tf32(x), lo = tf32(x - hi)
// (cvt.rna), and a product as lo_a hi_b + hi_a lo_b + hi_a hi_b, the small
// terms first; the dropped lo lo term is 2^-22 of a product. What it does
// about the four things that differ from bf16:
//
// - TF32 wgmma takes K-major operands only (no transpose bit). S = q K^T,
//   dP = g V^T, S^T = K q^T and dP^T = V g^T take q, g, K, V as they lie;
//   dq += dS K, dV += (P o D)^T g and dK += dS^T q need K^T, g^T and q^T.
//   Those are written transposed, their reduction index (keys or rows)
//   permuted inside every group of 8 (position p holds 2 (p & 3) + (p >> 2)),
//   so that the accumulator registers of dS, P o D, dS^T and (P o D)^T are
//   the A operand as they lie (lane (g, t) holds columns 8 j + 2 t and + 1, A's
//   fragment wants t and t + 4).
// - Who splits. The prep pass writes the TF32 halves of every operand a
//   product kernel reads, zero past Sq and Sk: q, g, K, V K-major and q^T,
//   g^T, K^T transposed, 14 arrays of B H S 64 floats (tiled_scratch_numel).
//   Each is read by ceil(S / 64) blocks of the other axis; splitting a tile
//   in shared memory in every block that reads it would repeat the split that
//   many times and needs the same shared memory for the halves. The resident
//   tiles are loaded as halves too, so no consumer writes shared memory.
// - Drift. The tensor cores' accumulation does not round to nearest, so dq,
//   dK and dV take each tile's three products in a fresh accumulator and add
//   it on the CUDA cores in f32 (S, dP and their transposes are one tile's
//   sums anyway).
// - Registers and shared memory. An f32 64 x 64 tile is 16 KB, its halves
//   32 KB. dq kernel: q and g resident (64 KB), a ring of two stages of K and
//   V (64 KB each, with the keys' biases) and one K^T buffer (32 KB) with its
//   own barriers: 224 KB, one block an SM. The K^T of tile i + 1 loads while
//   S and dP of tile i + 1 run, K and V two tiles ahead. dk/dv kernel: K and
//   V resident (64 KB), one q, g buffer (64 KB, with the rows' statistics
//   and keep bits) and one q^T, g^T buffer (64 KB), each with its own
//   barriers: 193 KB, one block an SM; q and g of tile i + 1 load while dV
//   and dK of tile i run, q^T and g^T while S^T and dP^T of tile i + 1 do.
//   Registers of a dk/dv thread: dK and dV (64) held throughout, S^T and dP^T
//   (64), then the halves of (P o D)^T (64) with dS^T and one fresh
//   accumulator (32 each): dV runs first, then dS^T is split and dK runs
//   through the same accumulator. ptxas -v: 244 registers a dk/dv thread
//   (229 with dropout), 149 a dq thread (186), no spill; one block an SM
//   leaves room for 255.
//
// Bound of the f32 design. Five products of 2 B H Sq Sk 64 FLOPs each, three
// TF32 products apiece at 495 TFLOP/s: at [16, 12, 256, 256, 64] (the f32
// text step) 8.05 GFLOP of f32, 24.2 of TF32, 0.049 ms; q, k, v, out, g, dq,
// dk, dv 12.6 MB each, 0.030 ms at 3.35 TB/s. The prep pass moves 239 MB more
// (q, k, v, g, out read, 14 halves written, 0.071 ms) and the product kernels
// read the halves back (176 MB, 0.053 ms at HBM rate if none stays in L2).
// At [2, 12, 4499, 4499, 64] (the 90 s clips) 932.6 GFLOP of TF32, 1.884 ms,
// against a prep of 529 MB (0.16 ms): operations bound it there.

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
template <typename P>
__device__ __forceinline__ size_t bits_tile(const P& p, int bh, int key_tile, int q_tile) {
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

// -- the f32 design: 3xTF32 on wgmma (see the head of the file) -------------------------------------------------

namespace mer_k4_tf32 {

using namespace sm90;
using mer_k4::align1024;
using mer_k4::bits_tile;
using mer_k4::kBitWords;
using mer_k4::kD;
using mer_k4::kFullyMaskedLse;
using mer_k4::kLog2e;
using mer_k4::kMaskBias2;
using mer_k4::kStats;
using mer_k4::kThreads;
using mer_k4::kTile;
using mer_k4::pad64;

constexpr uint32_t kBoxBytes = kTile * 32 * sizeof(float);  // 64 rows of one 128-byte row: 8 KB
constexpr int kPrepThreads = 256;
constexpr int kKvStages = 2;  // the dq kernel's K, V ring

struct Params {
  const float *q, *k, *v, *out, *g, *lse, *g_lse;
  const uint8_t* mask;
  float *dq, *dk, *dv;
  float* stats;    // [BH][kStats][sq_pad], as the bf16 design's
  float* bias;     // [B][sk_pad]
  uint32_t* bits;  // with dropout: the keep bits, as the bf16 design's
  float* qg;       // [4][BH][sq_pad][64]: q hi, q lo, g hi, g lo
  float* qgt;      // [4][BH][64][sq_pad]: q^T hi, q^T lo, g^T hi, g^T lo, rows permuted in groups of 8
  float* kv;       // [4][BH][sk_pad][64]: K hi, K lo, V hi, V lo
  float* kt;       // [2][BH][64][sk_pad]: K^T hi, K^T lo, keys permuted in groups of 8
  int BH, B, H, Sq, Sk, sq_pad, sk_pad;
  float scale;
  mer_philox::Dropout drop;
};

// d = lo_a hi_b + hi_a lo_b + hi_a hi_b over a 64-wide reduction, A and B K-major in shared memory (descriptors of
// their hi and lo halves)
__device__ __forceinline__ void product_ss(float (&d)[32], uint64_t a_hi, uint64_t a_lo, uint64_t b_hi,
                                           uint64_t b_lo) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) wgmma_tf32_ss(d, a_lo + kstep(kk), b_hi + kstep(kk), kk);  // small terms first
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) wgmma_tf32_ss(d, a_hi + kstep(kk), b_lo + kstep(kk), 1);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) wgmma_tf32_ss(d, a_hi + kstep(kk), b_hi + kstep(kk), 1);
}

// d = the same with A's halves from registers (split_fragments), into a fresh accumulator; waits for the products
__device__ __forceinline__ void product_rs(float (&d)[32], const uint32_t (&a_hi)[8][4], const uint32_t (&a_lo)[8][4],
                                           uint64_t b_hi, uint64_t b_lo) {
  fence_operands(d);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 8; ++j) wgmma_tf32_rs(d, a_lo[j], b_hi + kstep(j), j);
#pragma unroll
  for (int j = 0; j < 8; ++j) wgmma_tf32_rs(d, a_hi[j], b_lo + kstep(j), 1);
#pragma unroll
  for (int j = 0; j < 8; ++j) wgmma_tf32_rs(d, a_hi[j], b_hi + kstep(j), 1);
  wgmma_commit();
  wgmma_wait<0>();  // the registers of a_hi and a_lo are read until the products complete
  fence_operands(d);
}

// 1. One 64-row tile of one slice: blocks x < sq_pad / 64 take query rows (q's and g's halves, K-major and
// transposed, and the rows' statistics), the others keys (K's and V's halves, K^T's, and, for head 0's slices, the
// batch element's key biases). Zero past Sq and Sk.
template <typename Tag>
__global__ void __launch_bounds__(kPrepThreads) prep_kernel(const Params p) {
  __shared__ float ts[2][kTile][kD + 1];  // the tile's two tensors, read back transposed
  const int bh = blockIdx.y, nq = p.sq_pad / kTile, tid = threadIdx.x;
  const bool rows = blockIdx.x < nq;
  const int r0 = (rows ? blockIdx.x : blockIdx.x - nq) * kTile, n = rows ? p.Sq : p.Sk;
  const int pad = rows ? p.sq_pad : p.sk_pad;
  const float* a = rows ? p.q : p.k;
  const float* b = rows ? p.g : p.v;
  float* halves = rows ? p.qg : p.kv;
  const size_t part = (size_t)p.BH * pad * kD;  // one array of halves
  for (int i = tid; i < kTile * kD / 4; i += kPrepThreads) {
    const int r = i >> 4, c = 4 * (i & 15), row = r0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
    if (row < n) {
      const size_t src = ((size_t)bh * n + row) * kD + c;
      x = __ldg(reinterpret_cast<const float4*>(a + src));
      y = __ldg(reinterpret_cast<const float4*>(b + src));
    }
    const size_t dst = ((size_t)bh * pad + row) * kD + c;
    float4 hi = tf32_hi(x);
    *reinterpret_cast<float4*>(halves + dst) = hi;
    *reinterpret_cast<float4*>(halves + part + dst) = tf32_lo(x, hi);
    hi = tf32_hi(y);
    *reinterpret_cast<float4*>(halves + 2 * part + dst) = hi;
    *reinterpret_cast<float4*>(halves + 3 * part + dst) = tf32_lo(y, hi);
    ts[0][r][c] = x.x, ts[0][r][c + 1] = x.y, ts[0][r][c + 2] = x.z, ts[0][r][c + 3] = x.w;
    ts[1][r][c] = y.x, ts[1][r][c + 1] = y.y, ts[1][r][c + 2] = y.z, ts[1][r][c + 3] = y.w;
  }
  __syncthreads();
  // transposed halves: q^T and g^T of query rows, K^T alone of keys; row (key) positions permuted in groups of 8
  float* t_halves = rows ? p.qgt : p.kt;
  for (int i = tid; i < (rows ? 2 : 1) * kTile * kD / 4; i += kPrepThreads) {
    const int which = i >> 10, d = (i >> 4) & 63, p4 = i & 15;  // column d, positions 4 p4 .. 4 p4 + 3
    float y[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int pos = 4 * p4 + e;
      y[e] = ts[which][8 * (pos >> 3) + 2 * (pos & 3) + ((pos >> 2) & 1)][d];
    }
    const float4 x = make_float4(y[0], y[1], y[2], y[3]), hi = tf32_hi(x);
    const size_t dst = ((size_t)bh * kD + d) * pad + r0 + 4 * p4;
    *reinterpret_cast<float4*>(t_halves + 2 * which * part + dst) = hi;
    *reinterpret_cast<float4*>(t_halves + (2 * which + 1) * part + dst) = tf32_lo(x, hi);
  }
  if (rows) {  // per query row (4 threads a row) lse in log2 units, delta and the fully-masked probability
    const int r = tid >> 2, quarter = tid & 3, i = r0 + r;
    float sum = 0.f;
    if (i < p.Sq) {
      const size_t off = ((size_t)bh * p.Sq + i) * kD + 16 * quarter;
#pragma unroll
      for (int e = 0; e < 16; e += 4) {
        const float4 gv = __ldg(reinterpret_cast<const float4*>(p.g + off + e));
        const float4 ov = __ldg(reinterpret_cast<const float4*>(p.out + off + e));
        sum += gv.x * ov.x + gv.y * ov.y + gv.z * ov.z + gv.w * ov.w;
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (quarter == 0) {
      float lse2 = 0.f, delta = 0.f, fully = 0.f;  // padding rows: zero q and g rows, finite P, nothing added
      if (i < p.Sq) {
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
  } else if (bh % p.H == 0 && tid < kTile) {
    const int batch = bh / p.H, j = r0 + tid;
    p.bias[(size_t)batch * p.sk_pad + j] =
        (j >= p.Sk || (p.mask != nullptr && p.mask[(size_t)batch * p.Sk + j])) ? kMaskBias2 : 0.f;
  }
}

// An f32 64 x 64 tile's TF32 halves: [hi, lo][column half][row][32], every box 1024-byte aligned
using Halves = float[2][2][kTile * 32];

struct DqSmem {  // 1024-byte aligned
  Halves q, g;                             // resident
  Halves k[kKvStages], v[kKvStages];       // the ring: [key][column]
  Halves kt;                               // [column][key position]
  float bias[kKvStages][kTile];
  uint64_t kv_full[kKvStages], kv_empty[kKvStages], kt_full, kt_empty, once;
};
static_assert(sizeof(DqSmem) + 1024 <= 232448, "the dq kernel's shared memory");

struct DkvSmem {
  Halves k, v;    // resident
  Halves q, g;    // [row][column]
  Halves qt, gt;  // [column][row position]
  float stats[kStats][kTile];
  uint32_t bits[kBitWords];
  uint64_t qg_full, qg_empty, t_full, t_empty, once;
};
static_assert(sizeof(DkvSmem) + 1024 <= 232448, "the dk/dv kernel's shared memory");

// `n` (full, empty) barrier pairs, a full one filled by the producer's copies, an empty one by the four consumer
// warps, and `once`, which the resident tiles fill; then the block syncs
__device__ __forceinline__ void init_barriers(uint64_t* const* full, uint64_t* const* empty, int n, uint64_t* once) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < n; ++i) {
      mbar_init(full[i], 1);
      mbar_init(empty[i], 4);
    }
    mbar_init(once, 1);
    fence_barrier_init();
  }
  __syncthreads();
}

// the four boxes of a tile's halves, hi at slice `slice`, lo at slice + BH
__device__ __forceinline__ void load_halves(Halves& dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                            int slice, int BH, bool transposed) {
#pragma unroll
  for (int part = 0; part < 2; ++part)
#pragma unroll
    for (int c = 0; c < 2; ++c)
      tma_load_3d(dst[part][c], map, bar, transposed ? c0 + 32 * c : 32 * c, transposed ? 0 : c1, slice + part * BH);
}

__device__ __forceinline__ uint64_t desc(const float* box) { return desc_sw128(box); }

// 2. dq of 64 query rows of one slice; with dropout, the keep bits of every tile for the dk/dv kernel
template <typename Tag, bool kDrop>
__global__ void __launch_bounds__(kThreads, 1)
    dq_kernel(const __grid_constant__ CUtensorMap map_qg, const __grid_constant__ CUtensorMap map_kv,
              const __grid_constant__ CUtensorMap map_kt, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  DqSmem& sm = *reinterpret_cast<DqSmem*>(align1024(smem_raw));
  {
    uint64_t* const full[3] = {&sm.kv_full[0], &sm.kv_full[1], &sm.kt_full};
    uint64_t* const empty[3] = {&sm.kv_empty[0], &sm.kv_empty[1], &sm.kt_empty};
    static_assert(kKvStages == 2, "the barrier lists");
    init_barriers(full, empty, 3, &sm.once);
  }
  const int bh = blockIdx.y, q0 = blockIdx.x * kTile;
  const int n_tiles = (p.Sk + kTile - 1) / kTile;

  if (threadIdx.x >= 128) {  // the producer warp: one lane issues every copy
    if (threadIdx.x == 128) {
      mbar_expect_tx(&sm.once, 8 * kBoxBytes);
      load_halves(sm.q, &map_qg, &sm.once, 0, q0, bh, p.BH, false);
      load_halves(sm.g, &map_qg, &sm.once, 0, q0, bh + 2 * p.BH, p.BH, false);
      const float* bias = p.bias + (size_t)(bh / p.H) * p.sk_pad;
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kKvStages, key0 = it * kTile;
        if (it >= kKvStages) mbar_wait(&sm.kv_empty[s], ((it / kKvStages) & 1) ^ 1);
        mbar_expect_tx(&sm.kv_full[s], 8 * kBoxBytes + kTile * sizeof(float));
        load_halves(sm.k[s], &map_kv, &sm.kv_full[s], 0, key0, bh, p.BH, false);
        load_halves(sm.v[s], &map_kv, &sm.kv_full[s], 0, key0, bh + 2 * p.BH, p.BH, false);
        bulk_load(sm.bias[s], bias + key0, kTile * sizeof(float), &sm.kv_full[s]);
        if (it >= 1) mbar_wait(&sm.kt_empty, (it - 1) & 1);
        mbar_expect_tx(&sm.kt_full, 4 * kBoxBytes);
        load_halves(sm.kt, &map_kt, &sm.kt_full, key0, 0, bh, p.BH, true);
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
  const uint64_t q_hi = desc(sm.q[0][0]), q_lo = desc(sm.q[1][0]), g_hi = desc(sm.g[0][0]), g_lo = desc(sm.g[1][0]);
  const uint64_t kt_hi = desc(sm.kt[0][0]), kt_lo = desc(sm.kt[1][0]);
  uint32_t* bits_out = p.bits + bits_tile(p, bh, 0, blockIdx.x) + 32 * w + 8 * (g >> 1) + 2 * t + (g & 1);
  const size_t bits_stride = (size_t)(p.sq_pad / kTile) * kBitWords;  // one key tile further

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kKvStages;
    mbar_wait(&sm.kv_full[s], (it / kKvStages) & 1);
    float sc[32], dp[32];
    wgmma_fence();
    product_ss(sc, q_hi, q_lo, desc(sm.k[s][0][0]), desc(sm.k[s][1][0]));
    product_ss(dp, g_hi, g_lo, desc(sm.v[s][0][0]), desc(sm.v[s][1][0]));
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
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.kv_empty[s]);  // K, V and the biases are read
    if (kDrop) bits_out[it * bits_stride] = keep;

    uint32_t ds_hi[8][4], ds_lo[8][4];
    split_fragments(dp, ds_hi, ds_lo);
    mbar_wait(&sm.kt_full, it & 1);
    float acc[32];
    product_rs(acc, ds_hi, ds_lo, kt_hi, kt_lo);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.kt_empty);
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[i] += acc[i];
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    if (r >= p.Sq) continue;
    const size_t row = ((size_t)bh * p.Sq + r) * kD;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = 4 * j + 2 * h;
      *reinterpret_cast<float2*>(p.dq + row + 8 * j + 2 * t) = make_float2(dq[i] * p.scale, dq[i + 1] * p.scale);
    }
  }
}

// 3. dk, dv of 64 keys of one slice; with dropout, D from the dq kernel's keep bits
template <typename Tag, bool kDrop>
__global__ void __launch_bounds__(kThreads, 1)
    dkv_kernel(const __grid_constant__ CUtensorMap map_qg, const __grid_constant__ CUtensorMap map_qgt,
               const __grid_constant__ CUtensorMap map_kv, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  DkvSmem& sm = *reinterpret_cast<DkvSmem*>(align1024(smem_raw));
  {
    uint64_t* const full[2] = {&sm.qg_full, &sm.t_full};
    uint64_t* const empty[2] = {&sm.qg_empty, &sm.t_empty};
    init_barriers(full, empty, 2, &sm.once);
  }
  const int bh = blockIdx.y, k0 = blockIdx.x * kTile;
  const int n_tiles = (p.Sq + kTile - 1) / kTile;

  if (threadIdx.x >= 128) {
    if (threadIdx.x == 128) {
      mbar_expect_tx(&sm.once, 8 * kBoxBytes);
      load_halves(sm.k, &map_kv, &sm.once, 0, k0, bh, p.BH, false);
      load_halves(sm.v, &map_kv, &sm.once, 0, k0, bh + 2 * p.BH, p.BH, false);
      const float* stats = p.stats + (size_t)bh * kStats * p.sq_pad;
      for (int it = 0; it < n_tiles; ++it) {
        const int row0 = it * kTile;
        if (it >= 1) mbar_wait(&sm.qg_empty, (it - 1) & 1);
        mbar_expect_tx(&sm.qg_full, 8 * kBoxBytes + kStats * kTile * sizeof(float) + (kDrop ? 4 * kBitWords : 0));
        load_halves(sm.q, &map_qg, &sm.qg_full, 0, row0, bh, p.BH, false);
        load_halves(sm.g, &map_qg, &sm.qg_full, 0, row0, bh + 2 * p.BH, p.BH, false);
        for (int r = 0; r < kStats; ++r)
          bulk_load(sm.stats[r], stats + r * p.sq_pad + row0, kTile * sizeof(float), &sm.qg_full);
        if (kDrop) bulk_load(sm.bits, p.bits + bits_tile(p, bh, blockIdx.x, it), 4 * kBitWords, &sm.qg_full);
        if (it >= 1) mbar_wait(&sm.t_empty, (it - 1) & 1);
        mbar_expect_tx(&sm.t_full, 8 * kBoxBytes);
        load_halves(sm.qt, &map_qgt, &sm.t_full, row0, 0, bh, p.BH, true);
        load_halves(sm.gt, &map_qgt, &sm.t_full, row0, 0, bh + 2 * p.BH, p.BH, true);
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
  const uint64_t k_hi = desc(sm.k[0][0]), k_lo = desc(sm.k[1][0]), v_hi = desc(sm.v[0][0]), v_lo = desc(sm.v[1][0]);
  const uint64_t q_hi = desc(sm.q[0][0]), q_lo = desc(sm.q[1][0]), g_hi = desc(sm.g[0][0]), g_lo = desc(sm.g[1][0]);
  const uint64_t qt_hi = desc(sm.qt[0][0]), qt_lo = desc(sm.qt[1][0]);
  const uint64_t gt_hi = desc(sm.gt[0][0]), gt_lo = desc(sm.gt[1][0]);

  for (int it = 0; it < n_tiles; ++it) {
    mbar_wait(&sm.qg_full, it & 1);
    float st[32], dpt[32];
    wgmma_fence();
    product_ss(st, k_hi, k_lo, q_hi, q_lo);
    product_ss(dpt, v_hi, v_lo, g_hi, g_lo);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(st);
    fence_operands(dpt);

    // P^T, D and dS^T where they lie: row key0 + 8 h, column it * 64 + 8 j + 2 t + c
    uint32_t bytes[2] = {0u, 0u};  // the keep bits of query rows 2t (c = 0) and 2t + 1 (c = 1) of a 16-row block
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * t;
      const float2 lse2 = *reinterpret_cast<const float2*>(&sm.stats[0][col]);
      const float2 delta = *reinterpret_cast<const float2*>(&sm.stats[1][col]);
      const float2 fully = *reinterpret_cast<const float2*>(&sm.stats[2][col]);
      if (kDrop && (j & 1) == 0) {  // query rows 16 (j / 2) ..: byte w of words pos(2t, g >> 1) and the next
        const uint2 words = *reinterpret_cast<const uint2*>(&sm.bits[32 * (j >> 1) + 8 * t + 2 * (g >> 1)]);
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
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.qg_empty);  // q, g, the statistics and the keep bits are read

    uint32_t a_hi[8][4], a_lo[8][4];
    float acc[32];
    split_fragments(st, a_hi, a_lo);
    mbar_wait(&sm.t_full, it & 1);
    product_rs(acc, a_hi, a_lo, gt_hi, gt_lo);  // dV's tile
#pragma unroll
    for (int i = 0; i < 32; ++i) dv[i] += acc[i];
    split_fragments(dpt, a_hi, a_lo);
    product_rs(acc, a_hi, a_lo, qt_hi, qt_lo);  // dK's tile
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.t_empty);
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[i] += acc[i];
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + 8 * h;
    if (key >= p.Sk) continue;
    const size_t row = ((size_t)bh * p.Sk + key) * kD;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * t, i = 4 * j + 2 * h;
      *reinterpret_cast<float2*>(p.dk + row + col) = make_float2(dk[i] * p.scale, dk[i + 1] * p.scale);
      *reinterpret_cast<float2*>(p.dv + row + col) = make_float2(dv[i], dv[i + 1]);
    }
  }
}

template <typename Kernel>
cudaError_t launch_one(Kernel kernel, size_t bytes, int rows, const CUtensorMap& m0, const CUtensorMap& m1,
                       const CUtensorMap& m2, const Params& p, cudaStream_t stream) {
  const cudaError_t smem_ok = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (smem_ok != cudaSuccess) return smem_ok;
  kernel<<<dim3((rows + kTile - 1) / kTile, p.BH), kThreads, bytes, stream>>>(m0, m1, m2, p);
  return cudaGetLastError();
}

template <typename Tag, bool kDrop>
cudaError_t launch_kernels(const CUtensorMap (&maps)[4], const Params& p, cudaStream_t stream) {
  prep_kernel<Tag><<<dim3((p.sq_pad + p.sk_pad) / kTile, p.BH), kPrepThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // + alignment slack
  err = launch_one(dq_kernel<Tag, kDrop>, sizeof(DqSmem) + 1024, p.Sq, maps[0], maps[2], maps[3], p, stream);
  if (err != cudaSuccess) return err;
  return launch_one(dkv_kernel<Tag, kDrop>, sizeof(DkvSmem) + 1024, p.Sk, maps[0], maps[1], maps[2], p, stream);
}

// One f32 call at head dim 64 (scratch: see mer_flash_attention_tiled_bwd).
template <typename Tag>
cudaError_t launch(const mer_bwd::Args& a) {
  Params p{static_cast<const float*>(a.q), static_cast<const float*>(a.k), static_cast<const float*>(a.v),
           static_cast<const float*>(a.out), static_cast<const float*>(a.g), static_cast<const float*>(a.lse),
           static_cast<const float*>(a.g_lse), static_cast<const uint8_t*>(a.mask), static_cast<float*>(a.dq),
           static_cast<float*>(a.dk), static_cast<float*>(a.dv), static_cast<float*>(a.delta), nullptr, nullptr,
           nullptr, nullptr, nullptr, nullptr, a.B * a.H, a.B, a.H, a.Sq, a.Sk, pad64(a.Sq), pad64(a.Sk), a.scale,
           a.drop};
  if (p.BH > 65535) return cudaErrorInvalidValue;
  p.bias = p.stats + (size_t)p.BH * kStats * p.sq_pad;
  p.bits = reinterpret_cast<uint32_t*>(p.bias + (size_t)p.B * p.sk_pad);
  p.qg = reinterpret_cast<float*>(p.bits + (a.drop.on ? (size_t)p.BH * p.sq_pad / 32 * p.sk_pad : 0));
  p.qgt = p.qg + 4 * (size_t)p.BH * p.sq_pad * kD;
  p.kv = p.qgt + 4 * (size_t)p.BH * p.sq_pad * kD;
  p.kt = p.kv + 4 * (size_t)p.BH * p.sk_pad * kD;
  CUtensorMap maps[4];  // q's and g's halves, their transposes, K's and V's, K^T's
  if (!encode_f32_rows(&maps[0], p.qg, kD, p.sq_pad, 4 * p.BH) ||
      !encode_f32_rows(&maps[1], p.qgt, p.sq_pad, kD, 4 * p.BH) ||
      !encode_f32_rows(&maps[2], p.kv, kD, p.sk_pad, 4 * p.BH) ||
      !encode_f32_rows(&maps[3], p.kt, p.sk_pad, kD, 2 * p.BH))
    return cudaErrorInvalidValue;
  return a.drop.on ? launch_kernels<Tag, true>(maps, p, a.stream) : launch_kernels<Tag, false>(maps, p, a.stream);
}

}  // namespace mer_k4_tf32
}  // namespace

static int last_route = -1;  // see mer_flash_attention_tiled_bwd_route

// dtype: 0 = float32, 1 = bfloat16. g_lse may be null (no lse cotangent);
// scratch is 16-byte aligned, of B H 3 pad64(Sq) + B pad64(Sk) floats, with
// dropout B H pad64(Sq) pad64(Sk) / 32 words more, and in f32 at Dh 64 then
// the TF32 halves, B H 64 (8 pad64(Sq) + 6 pad64(Sk)) floats (pad64: rounded
// up to 64; the older design's delta [B, H, Sq] takes its head). dropout as in
// mer_flash_attention_fwd. Returns the cudaError_t of the launches, and records
// the design it launched for mer_flash_attention_tiled_bwd_route.
extern "C" int mer_flash_attention_tiled_bwd(int dtype, const void* q, const void* k, const void* v,
                                             const void* mask, const void* out, const void* lse, const void* g,
                                             const void* g_lse, void* dq, void* dk, void* dv, void* scratch, int B,
                                             int H, int Sq, int Sk, int Dh, float scale, int dropout,
                                             uint32_t seed0, uint32_t seed1, uint32_t threshold, float keep_scale,
                                             void* stream) {
  const mer_bwd::Args a{q, k, v, mask, out, lse, g, g_lse, dq, dk, dv, scratch, B, H, Sq, Sk, Dh, scale,
                        {seed0, seed1, threshold, keep_scale, dropout}, 0, static_cast<cudaStream_t>(stream)};
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const bool hopper = (dtype == 0 || dtype == 1) && Dh == mer_k4::kD && B > 0 && H > 0 && Sq > 0 && Sk > 0 &&
                      aligned(q) && aligned(k) && aligned(v) && aligned(out) && aligned(g) && aligned(dq) &&
                      aligned(dk) && aligned(dv) && aligned(scratch);
  last_route = hopper ? 2 - dtype : 0;
  if (hopper && dtype == 1) return static_cast<int>(mer_k4::launch<flash_attention_tiled_bwd>(a));
  if (hopper) return static_cast<int>(mer_k4_tf32::launch<flash_attention_tiled_bwd>(a));
  return mer_bwd::launch<flash_attention_tiled_bwd, false>(dtype, a);
}

// The design the last call of mer_flash_attention_tiled_bwd launched: 0 the template, 1 the bf16 Hopper design,
// 2 the f32 3xTF32 one (-1 before any call).
extern "C" int mer_flash_attention_tiled_bwd_route() { return last_route; }
