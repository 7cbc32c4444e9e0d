// The Hopper (sm_90a) attention forwards at head dim 64 shared by K1
// (flash_attention_fwd.cu) and K3 (flash_attention_stream.cu): the bf16
// forward on wgmma and TMA (`bf16_fwd`, `launch_bf16`) and the f32 forward in
// TF32 with error compensation (3xTF32, `launch_tf32`), which both entries
// launch for 16-byte aligned tensors, and the parts the two share.
//
// The function is the one at the head of flash_attention_forward.cuh: out =
// softmax(scale q k^T + bias) v, lse in natural-log units, -1e30 on ignored
// keys, no weight on keys past Sk, a fully masked row giving the mean of v,
// dropout as Philox4x32-10 of (seed, b*H + h, row, column), one call per
// 2 x 2 scores (philox.cuh).
//
// Shared parts:
// - the key biases in log2 units: 0, -1e30 log2 e on an ignored key, -inf
//   past Sk (no weight, even in a fully masked row); the f32 prep pass writes
//   them, [B][Sk padded to 64], the bf16 forward makes them from the mask's
//   bytes tile by tile;
// - the online softmax of a 64 x 64 score tile in the wgmma accumulator
//   registers, in log2 units (exp2 of scale log2 e s + bias - m, a running
//   max and a per-thread partial row sum of the undropped probabilities), the
//   keep bits drawn where the scores lie (lane (g, t) of warp w holds rows
//   16 w + g (+ 8), columns 8 j + 2 t (+ 1): the mma.sync layout
//   mer_philox::factors serves);
// - the epilogue: out = O / l and lse = m ln 2 + ln l, or for a fully masked
//   row -1e30 + ln l in natural units as the plain version rounds it.
//
// The bf16 forward (`bf16_fwd::forward_kernel`): one launch a call. A block
// owns one (b*h) slice and 64 query rows, one consumer warpgroup and one
// producer warp, three blocks an SM (the shape chosen on the card, PERF.md).
// TMA loads the q tile once (3-D maps [slice][rows][64]: no box crosses a
// slice; rows past Sq read as zeros); 64-key tiles of K and V stream through
// a ring of stages, each with a "full" and an "empty" mbarrier, and beside
// them the tile's key biases, which the producer warp's 32 lanes make from the
// mask's bytes (two keys a lane, plain loads: a TMA box must start 16-byte
// aligned, and a mask row starts at byte b Sk). Per tile S = q K^T is
// wgmma.m64n64k16 from shared memory (both K-major, 128-byte swizzled as TMA
// writes them); the online softmax runs in the accumulator registers, and
// with dropout each lane draws its scores' keep bits there. O += (P o D) V is a wgmma whose A
// (P o D rounded to bf16) comes from registers and whose B is the V tile
// read MN-major through the transpose bit. The products overlap the softmax:
// S of tile i and (P o D) V of tile i - 1 are issued together, the
// exponentials and Philox of tile i run while the second product completes,
// and O is rescaled once it has. Several blocks an SM overlap one another's
// softmax and products. out and lse are written once. K1 takes it from 64
// keys (the RoBERTa windows, wav2vec2's 99-499 frames, the long clips' 2,999
// and the ring's blocks), K3 above 4,096: one design either side of
// STREAM_THRESHOLD.
//
// Bound (bf16). At [32, 12, 512, 512, 64] (RoBERTa-base's longest window) one
// call reads q, k, v (25.2 MB each) and the mask and writes out and lse: 101
// MB, 30.3 us at 3.35 TB/s; its two products are 4 x 384 x 512^2 x 64 = 25.8
// GFLOP, 26.1 us at 989 TFLOP/s. Bytes bound it, just; at 4,499 keys the
// products do (0.126 ms at [2, 12, 4499, 4499, 64]). Beside the products
// each score takes an exp2 on the SFU (16 a cycle and SM: as long as the two
// products at this head dim) and, with dropout, a quarter of a Philox4x32-10
// call: work on the CUDA cores of the order of the products, which the design
// overlaps with them but cannot remove.
//
// The f32 forward (`forward_tf32_kernel`). TF32 wgmma takes only K-major
// operands and has no transpose bit, and one TF32 pass keeps 2^-11 of each
// product, short of the f32 limit of 2e-5. So:
//
// 1. prep (one launch before the forward): the key biases, and each K and V
//    value split into x = hi + lo, hi = tf32(x), lo = tf32(x - hi) (cvt.rna),
//    into f32 scratch: K's halves [2][B*H][Sk padded][64] and V^T's [2][B*H]
//    [64][Sk padded], zero past Sk. V^T is the product P V's B operand,
//    K-major. Its keys are permuted inside every group of 8 (position p holds
//    key 2 (p & 3) + (p >> 2): 0, 2, 4, 6, 1, 3, 5, 7), so that P's
//    accumulator registers serve as the A operand as they lie: lane (g, t)
//    holds keys 8 j + 2 t and + 1, A's fragment wants columns t and t + 4.
//    Done once per call (each K and V value read once, four halves written),
//    where a transpose in shared memory would be redone by each of the
//    ceil(Sq / 64) query blocks that read a tile.
// 2. forward: a block owns one (b*h) slice and 64 query rows, one consumer
//    warpgroup and one producer warp; two blocks an SM (98 KB of shared
//    memory each). TMA loads q once; the consumers split it in shared memory
//    (hi in place, lo beside it). K's halves with the tile's biases, and V^T's
//    halves, arrive in two single-stage buffers with their own full and
//    empty mbarriers: K of tile i + 1 loads while tile i's softmax and P V
//    run, V^T of tile i + 1 while S of tile i + 1 does. Per tile S = q K^T is
//    wgmma.m64n64k8 tf32 from shared memory, lo_q hi_K + hi_q lo_K + hi_q hi_K
//    (the small terms first: 24 products into one accumulator), the online
//    softmax as above, P o D split in registers, and lo_P hi_V + hi_P lo_V +
//    hi_P hi_V into a fresh accumulator (A from registers), which the CUDA
//    cores add to the rescaled O in f32 (the tensor cores' accumulation does
//    not round to nearest: an accumulator spanning every key tile drifts, one
//    tile's 24 products stay at f32 rounding). The dropped lo lo term is 2^-22
//    of a product.
//
// Bound. At the wav2vec2 f32 export's [32, 12, 499, 499, 64] the two products
// are 4 x 384 x 499^2 x 64 = 24.5 GFLOP of f32, 73.4 GFLOP of TF32 in three
// passes: 0.148 ms at 495 TFLOP/s; q, k, v, out move 196 MB (0.059 ms at 3.35
// TB/s), and the prep pass moves another 300 MB (K, V read, four halves
// written: 0.09 ms), which the forward's products do not hide. Operations bound
// the function; at [2, 12, 4499, 4499, 64] (K3's 90 s clips) 0.754 ms of
// TF32 against a 55 MB prep.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention_forward.cuh"
#include "philox.cuh"
#include "sm90.cuh"

namespace {
namespace mer_hopper {

using namespace sm90;

constexpr int kD = 64;     // the head dim of these designs
constexpr int kTile = 64;  // query rows of a block; keys of a tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kMaskBias2 = mer_fwd::kMaskBias * kLog2e;  // an ignored key's bias, in log2 units

template <typename T>
struct Params {
  T* out;
  float* lse;
  const uint8_t* mask;
  float* bias;  // [B][sk_pad]
  int BH, B, H, Sq, Sk, sk_pad;
  float scale;
  mer_philox::Dropout drop;
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// key j's bias of batch element b in log2 units
template <typename T>
__device__ __forceinline__ float key_bias(const Params<T>& p, int b, int j) {
  return j >= p.Sk ? -INFINITY : (p.mask != nullptr && p.mask[(size_t)b * p.Sk + j]) ? kMaskBias2 : 0.f;
}

// One tile's online-softmax step on sc[4 j + 2 h + c] (row row0 + 8 h, key key0 + 8 j + 2 t + c): the scores to
// log2 units with the tile's biases, the running max m2 (alpha: the factor that rescales O), l rescaled and
// increased by the undropped, unrounded probabilities, and sc replaced by the probabilities times their dropout
// factors.
template <bool kDrop>
__device__ __forceinline__ void softmax_tile(float (&sc)[32], const float* bias, float c_log2, float (&m2)[2],
                                             float (&l)[2], float (&alpha)[2], const mer_philox::Dropout& drop,
                                             int bh, int row0, int key0, int t) {
  float mx[2] = {m2[0], m2[1]};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 b2 = *reinterpret_cast<const float2*>(&bias[8 * j + 2 * t]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[4 * j + e] = fmaf(sc[4 * j + e], c_log2, (e & 1) ? b2.y : b2.x);
      mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // the first tile holds key 0, whose bias is finite: m is finite from then on
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    alpha[h] = exp2f(m2[h] - mx[h]);
    m2[h] = mx[h];
    l[h] *= alpha[h];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float f[4];
    if (kDrop) mer_philox::factors(drop, bh, row0, key0 + 8 * j + 2 * t, false, f);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float pr = exp2f(sc[4 * j + e] - m2[e >> 1]);
      l[e >> 1] += pr;  // undropped and unrounded: l and lse as without dropout
      if (kDrop) pr *= f[e];
      sc[4 * j + e] = pr;
    }
  }
}

// out = O / l of the lane's rows row0 and row0 + 8 (o[4 j + 2 h + c]: column 8 j + 2 t + c) and their lse
template <typename T>
__device__ __forceinline__ void write_rows(const float (&o)[32], float (&l)[2], const float (&m2)[2],
                                           const Params<T>& p, int bh, int row0, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int r = row0 + 8 * h;
    if (r >= p.Sq) continue;
    const float lsum = fmaxf(l[h], 1e-30f), inv = 1.f / lsum;
    const size_t row = ((size_t)bh * p.Sq + r) * kD;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = 4 * j + 2 * h;
      if constexpr (sizeof(T) == 2)
        *reinterpret_cast<__nv_bfloat162*>(p.out + row + 8 * j + 2 * t) =
            __floats2bfloat162_rn(o[i] * inv, o[i + 1] * inv);
      else
        *reinterpret_cast<float2*>(p.out + row + 8 * j + 2 * t) = make_float2(o[i] * inv, o[i + 1] * inv);
    }
    // a fully masked row's max is the mask bias itself: its lse in natural units as the plain version rounds it
    if (t == 0)
      p.lse[(size_t)bh * p.Sq + r] = m2[h] < 0.5f * kMaskBias2 ? mer_fwd::kMaskBias + logf(lsum)
                                                                  : m2[h] * kLn2 + logf(lsum);
  }
}

// -- the bf16 forward -------------------------------------------------------------------

namespace bf16_fwd {

using bf16 = __nv_bfloat16;

// The block's shape, chosen on the card (PERF.md: blocks of 128 query rows in two consumer warpgroups, and other
// stage and block counts, were slower): the K/V ring's stages, and the blocks an SM that the registers are capped
// for (with dropout 128 registers a thread, unspilled).
constexpr int kStages = 3;
constexpr int kBlocksPerSm = 3;
constexpr int kThreads = 128 + 32;  // one consumer warpgroup, one producer warp
constexpr uint32_t kTileBytes = kTile * kD * sizeof(bf16);

struct Smem {  // 1024-byte aligned; the 8 KB tiles first
  bf16 q[kTile * kD];
  bf16 k[kStages][kTile * kD];
  bf16 v[kStages][kTile * kD];
  float bias[kStages][kTile];  // the tile's key biases in log2 units, beside its K and V
  uint64_t full[kStages], empty[kStages], q_full;
};

// out and lse of 64 query rows of one slice. The producer warp loads q once and streams 64-key tiles of K and V
// through the ring (lane 0 issues the copies), and beside them the tile's key biases, which its 32 lanes make from
// the mask's bytes (two keys a lane: a TMA box must start 16-byte aligned, a mask row starts at byte b Sk). A
// stage's full barrier completes on K's and V's bytes and the 32 lanes' arrivals, each after its biases.
template <typename Tag, bool kDrop>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    forward_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v, const Params<bf16> p) {
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(align1024(smem_raw));
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 32);  // the producer warp's lanes
      mbar_init(&sm.empty[s], 4);  // one arrival per consumer warp
    }
    mbar_init(&sm.q_full, 1);
    fence_barrier_init();
  }
  __syncthreads();
  const int bh = blockIdx.y, q0 = blockIdx.x * kTile;
  const int n_tiles = (p.Sk + kTile - 1) / kTile;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x >= 128) {  // the producer warp
    if (lane == 0) {
      mbar_expect_tx(&sm.q_full, kTileBytes);
      tma_load_3d(sm.q, &map_q, &sm.q_full, 0, q0, bh);
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages, key = it * kTile + 2 * lane;
      if (it >= kStages) mbar_wait(&sm.empty[s], ((it / kStages) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx_only(&sm.full[s], 2 * kTileBytes);
        tma_load_3d(sm.k[s], &map_k, &sm.full[s], 0, it * kTile, bh);
        tma_load_3d(sm.v[s], &map_v, &sm.full[s], 0, it * kTile, bh);
      }
      *reinterpret_cast<float2*>(&sm.bias[s][2 * lane]) =
          make_float2(key_bias(p, bh / p.H, key), key_bias(p, bh / p.H, key + 1));
      mbar_arrive(&sm.full[s]);  // releases this lane's biases
    }
    return;
  }

  const int w = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int row0 = q0 + 16 * w + g;  // this lane's query rows: row0, row0 + 8
  const float c_log2 = p.scale * kLog2e;

  float o[32], sc[32], m2[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  uint32_t a_p[4][4];  // P o D of the previous tile, bf16 pairs: the A operand of its product with V
  mbar_wait(&sm.q_full, 0);
  const uint64_t q_desc = desc_sw128(sm.q);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages, prev = (it + kStages - 1) % kStages, key0 = it * kTile;
    mbar_wait(&sm.full[s], (it / kStages) & 1);
    const uint64_t k_desc = desc_sw128(sm.k[s]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss(sc, q_desc + 2 * kk, k_desc + 2 * kk, kk);
    wgmma_commit();
    if (it > 0) {  // O += (P o D) V of the previous tile, behind S of this one
      const uint64_t v_desc = desc_sw128(sm.v[prev]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs_mn(o, a_p[kk], v_desc + 128 * kk);
      wgmma_commit();
    }
    if (it > 0)
      wgmma_wait<1>();
    else
      wgmma_wait<0>();
    fence_operands(sc);

    // scores in log2 units where they lie: row row0 + 8 h, key key0 + 8 j + 2 t + c
    float alpha[2];
    softmax_tile<kDrop>(sc, sm.bias[s], c_log2, m2, l, alpha, p.drop, bh, row0, key0, t);
    if (it > 0) {
      wgmma_wait<0>();  // the previous tile's product with V: its stage and a_p are free
      fence_operands(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[prev]);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) a_p[kk][r] = mer_tiles::pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
  }
  {  // the last tile's product with V
    const uint64_t v_desc = desc_sw128(sm.v[(n_tiles - 1) % kStages]);
    fence_operands(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_mn(o, a_p[kk], v_desc + 128 * kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(o);
  }
  write_rows(o, l, m2, p, bh, row0, t);
}

template <typename Tag, bool kDrop>
cudaError_t launch_kernel(const CUtensorMap (&maps)[3], const Params<bf16>& p, cudaStream_t stream) {
  const auto kernel = forward_kernel<Tag, kDrop>;
  const int bytes = sizeof(Smem) + 1024;  // + alignment slack
  // above the default 48 KB of dynamic shared memory: raised once per kernel, before any launch or capture
  static const cudaError_t smem_ok = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (smem_ok != cudaSuccess) return smem_ok;
  kernel<<<dim3((p.Sq + kTile - 1) / kTile, p.BH), kThreads, bytes, stream>>>(maps[0], maps[1], maps[2], p);
  return cudaGetLastError();
}

}  // namespace bf16_fwd

// One bf16 call at head dim 64: one launch; q, k, v and out 16-byte aligned, the mask [B][Sk] bytes (or null).
template <typename Tag>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* mask, void* out, void* lse, int B,
                        int H, int Sq, int Sk, float scale, mer_philox::Dropout drop, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const Params<bf16> p{static_cast<bf16*>(out), static_cast<float*>(lse), static_cast<const uint8_t*>(mask),
                       nullptr, B * H, B, H, Sq, Sk, (Sk + kTile - 1) / kTile * kTile, scale, drop};
  if (p.BH > 65535) return cudaErrorInvalidValue;
  CUtensorMap maps[3];  // q, k, v
  if (!encode_rows64(&maps[0], q, Sq, p.BH) || !encode_rows64(&maps[1], k, Sk, p.BH) ||
      !encode_rows64(&maps[2], v, Sk, p.BH))
    return cudaErrorInvalidValue;
  return drop.on ? bf16_fwd::launch_kernel<Tag, true>(maps, p, stream)
                 : bf16_fwd::launch_kernel<Tag, false>(maps, p, stream);
}

// -- the f32 forward (3xTF32) ---------------------------------------------------------

constexpr int kThreads = 128 + 32;                        // one consumer warpgroup, one producer warp
constexpr uint32_t kBoxBytes = kTile * 32 * sizeof(float);  // 64 rows of one 128-byte row: 8 KB
constexpr int kPrepThreads = 256;

struct SmemTF32 {  // 1024-byte aligned; every box at a multiple of 1024 bytes
  float q_hi[2][kTile * 32];   // q's column halves: TMA writes q here, the consumers split it in place
  float q_lo[2][kTile * 32];
  float k[2][2][kTile * 32];   // [hi, lo][column half][key][32]
  float vt[2][2][kTile * 32];  // [hi, lo][key half][column][32 keys, permuted in groups of 8]
  float bias[kTile];
  uint64_t q_full, k_full, k_empty, v_full, v_empty;
};

// 1. the key biases and K's and V^T's TF32 halves of one 64-key tile of one slice (the slices of head 0 write
// their batch element's biases)
template <typename Tag>
__global__ void __launch_bounds__(kPrepThreads) prep_tf32_kernel(const float* __restrict__ k,
                                                                 const float* __restrict__ v,
                                                                 float* __restrict__ k_parts,
                                                                 float* __restrict__ vt_parts, const Params<float> p) {
  __shared__ float vs[kTile][kD + 1];
  const int bh = blockIdx.y, key0 = blockIdx.x * kTile, tid = threadIdx.x;
  const size_t half = (size_t)p.BH * p.sk_pad * kD;  // the lo halves follow the hi halves
  for (int i = tid; i < kTile * kD / 4; i += kPrepThreads) {
    const int r = i >> 4, c = 4 * (i & 15), key = key0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
    if (key < p.Sk) {
      const size_t src = ((size_t)bh * p.Sk + key) * kD + c;
      x = __ldg(reinterpret_cast<const float4*>(k + src));
      y = __ldg(reinterpret_cast<const float4*>(v + src));
    }
    const float4 hi = tf32_hi(x);
    const size_t dst = ((size_t)bh * p.sk_pad + key) * kD + c;
    *reinterpret_cast<float4*>(k_parts + dst) = hi;
    *reinterpret_cast<float4*>(k_parts + half + dst) = tf32_lo(x, hi);
    vs[r][c] = y.x;
    vs[r][c + 1] = y.y;
    vs[r][c + 2] = y.z;
    vs[r][c + 3] = y.w;
  }
  __syncthreads();
  for (int i = tid; i < kTile * kD / 4; i += kPrepThreads) {
    const int d = i >> 4, p4 = i & 15;  // column d, key positions 4 p4 .. 4 p4 + 3 of the tile
    float y[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int pos = 4 * p4 + e;
      y[e] = vs[8 * (pos >> 3) + 2 * (pos & 3) + ((pos >> 2) & 1)][d];
    }
    const float4 x = make_float4(y[0], y[1], y[2], y[3]), hi = tf32_hi(x);
    const size_t dst = ((size_t)bh * kD + d) * p.sk_pad + key0 + 4 * p4;
    *reinterpret_cast<float4*>(vt_parts + dst) = hi;
    *reinterpret_cast<float4*>(vt_parts + half + dst) = tf32_lo(x, hi);
  }
  if (bh % p.H == 0 && tid < kTile)
    p.bias[(size_t)(bh / p.H) * p.sk_pad + key0 + tid] = key_bias(p, bh / p.H, key0 + tid);
}

// 2. out and lse of 64 query rows of one slice; two blocks an SM
template <typename Tag, bool kDrop>
__global__ void __launch_bounds__(kThreads, 2)
    forward_tf32_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_vt, const Params<float> p) {
  extern __shared__ unsigned char smem_raw[];
  SmemTF32& sm = *reinterpret_cast<SmemTF32*>(align1024(smem_raw));
  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    mbar_init(&sm.k_full, 1);
    mbar_init(&sm.v_full, 1);
    mbar_init(&sm.k_empty, 4);  // one arrival per consumer warp
    mbar_init(&sm.v_empty, 4);
    fence_barrier_init();
  }
  __syncthreads();
  const int bh = blockIdx.y, q0 = blockIdx.x * kTile;
  const int n_tiles = (p.Sk + kTile - 1) / kTile;

  if (threadIdx.x >= 128) {  // the producer warp: one lane issues every copy
    if (threadIdx.x == 128) {
      mbar_expect_tx(&sm.q_full, 2 * kBoxBytes);
      for (int c = 0; c < 2; ++c) tma_load_3d(sm.q_hi[c], &map_q, &sm.q_full, 32 * c, q0, bh);
      const float* bias = p.bias + (size_t)(bh / p.H) * p.sk_pad;
      for (int it = 0; it < n_tiles; ++it) {
        const int key0 = it * kTile;
        if (it > 0) mbar_wait(&sm.k_empty, (it - 1) & 1);
        mbar_expect_tx(&sm.k_full, 4 * kBoxBytes + kTile * sizeof(float));
        for (int part = 0; part < 2; ++part)
          for (int c = 0; c < 2; ++c)
            tma_load_3d(sm.k[part][c], &map_k, &sm.k_full, 32 * c, key0, bh + part * p.BH);
        bulk_load(sm.bias, bias + key0, kTile * sizeof(float), &sm.k_full);
        if (it > 0) mbar_wait(&sm.v_empty, (it - 1) & 1);
        mbar_expect_tx(&sm.v_full, 4 * kBoxBytes);
        for (int part = 0; part < 2; ++part)
          for (int c = 0; c < 2; ++c)
            tma_load_3d(sm.vt[part][c], &map_vt, &sm.v_full, key0 + 32 * c, 0, bh + part * p.BH);
      }
    }
    return;
  }

  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = q0 + 16 * w + g;  // this lane's query rows: row0, row0 + 8
  const float c_log2 = p.scale * kLog2e;

  mbar_wait(&sm.q_full, 0);
  {  // q's halves, then visible to wgmma (the async proxy) once every consumer has written its share
    float4* hi = reinterpret_cast<float4*>(sm.q_hi);
    float4* lo = reinterpret_cast<float4*>(sm.q_lo);
    for (int i = threadIdx.x; i < 2 * kTile * 32 / 4; i += 128) {
      const float4 x = hi[i], h4 = tf32_hi(x);
      hi[i] = h4;
      lo[i] = tf32_lo(x, h4);
    }
    fence_proxy_async();
    bar_sync(1, 128);
  }
  const uint64_t dq_hi = desc_sw128(sm.q_hi), dq_lo = desc_sw128(sm.q_lo);
  const uint64_t dk_hi = desc_sw128(sm.k[0]), dk_lo = desc_sw128(sm.k[1]);
  const uint64_t dv_hi = desc_sw128(sm.vt[0]), dv_lo = desc_sw128(sm.vt[1]);

  float o[32], sc[32], pv[32], m2[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  for (int it = 0; it < n_tiles; ++it) {
    const int phase = it & 1;
    mbar_wait(&sm.k_full, phase);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) wgmma_tf32_ss(sc, dq_lo + kstep(kk), dk_hi + kstep(kk), kk);  // small terms first
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) wgmma_tf32_ss(sc, dq_hi + kstep(kk), dk_lo + kstep(kk), 1);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) wgmma_tf32_ss(sc, dq_hi + kstep(kk), dk_hi + kstep(kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(sc);

    float alpha[2];
    softmax_tile<kDrop>(sc, sm.bias, c_log2, m2, l, alpha, p.drop, bh, row0, it * kTile, t);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.k_empty);  // K and the biases are read: the next tile's may load

    // P o D as A fragments: k-step j's column t is key 8 j + 2 t (sc[4 j + 2 h]), column t + 4 key 8 j + 2 t + 1
    // (sc[4 j + 2 h + 1]), rows g (h = 0) and g + 8 (h = 1); V^T's groups hold the keys in that order
    uint32_t p_hi[8][4], p_lo[8][4];
    split_fragments(sc, p_hi, p_lo);
    mbar_wait(&sm.v_full, phase);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 8; ++j) wgmma_tf32_rs(pv, p_lo[j], dv_hi + kstep(j), j);  // a fresh accumulator a tile
#pragma unroll
    for (int j = 0; j < 8; ++j) wgmma_tf32_rs(pv, p_hi[j], dv_lo + kstep(j), 1);
#pragma unroll
    for (int j = 0; j < 8; ++j) wgmma_tf32_rs(pv, p_hi[j], dv_hi + kstep(j), 1);
    wgmma_commit();
    wgmma_wait<0>();  // the registers of p_hi and p_lo are read until the products complete
    fence_operands(pv);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.v_empty);
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = fmaf(o[i], alpha[(i >> 1) & 1], pv[i]);
  }
  write_rows(o, l, m2, p, bh, row0, t);
}

// One f32 call at head dim 64: scratch (16-byte aligned) holds tf32_scratch_floats(B, H, Sk) floats.
inline size_t tf32_scratch_floats(int B, int H, int Sk) {
  const size_t sk_pad = (size_t)(Sk + kTile - 1) / kTile * kTile;
  return (size_t)B * sk_pad + 4 * (size_t)B * H * sk_pad * kD;
}

template <typename Tag>
cudaError_t launch_tf32(const void* q, const void* k, const void* v, const void* mask, void* out, void* lse,
                        void* scratch, int B, int H, int Sq, int Sk, float scale, mer_philox::Dropout drop,
                        cudaStream_t stream) {
  const int sk_pad = (Sk + kTile - 1) / kTile * kTile;
  const Params<float> p{static_cast<float*>(out), static_cast<float*>(lse), static_cast<const uint8_t*>(mask),
                        static_cast<float*>(scratch), B * H, B, H, Sq, Sk, sk_pad, scale, drop};
  if (p.BH > 65535 || (long long)B * sk_pad > 0x7fffffffLL) return cudaErrorInvalidValue;
  float* k_parts = p.bias + (size_t)B * sk_pad;  // 256-byte aligned: sk_pad is a multiple of 64
  float* vt_parts = k_parts + 2 * (size_t)p.BH * sk_pad * kD;
  CUtensorMap maps[3];  // q, K's halves, V^T's halves
  if (!encode_f32_rows(&maps[0], q, kD, Sq, p.BH) || !encode_f32_rows(&maps[1], k_parts, kD, sk_pad, 2 * p.BH) ||
      !encode_f32_rows(&maps[2], vt_parts, sk_pad, kD, 2 * p.BH))
    return cudaErrorInvalidValue;
  prep_tf32_kernel<Tag><<<dim3(sk_pad / kTile, p.BH), kPrepThreads, 0, stream>>>(
      static_cast<const float*>(k), static_cast<const float*>(v), k_parts, vt_parts, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const auto kernel = drop.on ? &forward_tf32_kernel<Tag, true> : &forward_tf32_kernel<Tag, false>;
  const int bytes = sizeof(SmemTF32) + 1024;  // + alignment slack
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((Sq + kTile - 1) / kTile, p.BH), kThreads, bytes, stream>>>(maps[0], maps[1], maps[2], p);
  return cudaGetLastError();
}

}  // namespace mer_hopper
}  // namespace
