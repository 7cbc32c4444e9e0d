// K2's one-pass stacked backward for Hopper (sm_90a): the design that
// flash_attention_bwd.cu launches for bf16 and f32 at Sq, Sk <= 64 and head
// dims 64 and 96 with 16-byte aligned q, k, v, out, g, dq, dk, dv (the fusion
// model's dialogues: 8, 16, 24 and 33 utterances, 8 heads of 96).
//
// Replaces the TPU kernel mer_tpu/ops/flash_attention.py:270 (`_bwd_kernel`,
// launched at :390 from `_flash_bwd_fused`), the function at the head of
// flash_attention_backward.cuh:
//
//   P = exp(s - lse) (1/Sk on a fully masked row),  delta = rowsum(g o out) - g_lse
//   dS = P o ((g v^T) o D - delta),  dq = scale dS k,  dk = scale dS^T q,  dv = (P o D)^T g
//
// with P o D and dS rounded to bf16 before their products in bf16 (nothing
// rounded in f32), D the Philox4x32-10 keep mask of (seed, b*H + h, row,
// column), row and column counted within the slice (philox.cuh).
//
// Bound. A call reads q, k, v, out, g, the lse and the mask and writes dq, dk,
// dv once: at the dialogue shapes [16-32, 4-8, 8-33, 8-33, 96] 1.6-13 MB in
// bf16, 0.47-3.9 us at 3.35 TB/s (0.94-7.8 us in f32), against 0.008-0.27
// GFLOP of products (under 0.3 us at 989 TFLOP/s in bf16; in f32 0.14 GFLOP
// at 24 keys is 2.1 us at 67 TFLOP/s). Bytes bound it on paper; what a call
// meets is the latency of one chain of dependent steps (load, two products,
// the softmax's exponentials, three products, store) and the launch. The
// backward template (flash_attention_backward.cuh) takes two launches,
// recomputes S and g v^T in each, keeps delta in device memory between them
// and walks the keys and rows in small cp.async steps: 18-33 us in bf16 at
// these shapes, where the bound is under 4 (PERF.md).
//
// What this design does about it:
//
// 1. One launch, one pass: a block owns a tile of whole (b*h) slices and
//    computes S, g v^T, P, D and dS once each; delta is taken inside the block
//    from g and out (plain 16-byte loads, issued before the tile's copies
//    land) and never goes to device memory.
// 2. Block-diagonal stacking. In the [B, H, S, Dh] layout consecutive slices
//    are consecutive rows of the [B*H*S, Dh] view, so a 64-row tile holds
//    spt <= 64 / max(Sq, Sk) slices (slices_per_tile, chosen on the card:
//    about one block an SM) as rows tile0 Sq .. (tile0 + spt) Sq of q and g and
//    tile0 Sk .. of k and v. A score whose row and column lie in different
//    slices, or past the tile's real rows, gets P = 0 and dS = 0. Because the
//    stack is block-diagonal, dQ of the stack is [dS_1 k_1; dS_2 k_2; ..] and
//    so for dK and dV: the products over the whole tile are the slices'
//    products side by side.
// 3. bf16 (`bf16_kernel`): q, k, v, g come in by TMA through 128-byte
//    swizzled maps over the [B*H*S, Dh] views, a 64 x 64 box each 64 columns
//    (Dh 96: two boxes, the second zero-filled past column 96); rows past the
//    tile's slices are the next slices' (or zeros past the tensor) and
//    finite, as the products' B operands must be. S = q K^T and dP = g V^T are
//    wgmma.m64n64k16 from shared memory; P, D and dS are computed in the
//    accumulator registers; P o D and dS, rounded to bf16, go to shared memory
//    in the swizzled layout, where they are the A operands of dV = (P o D)^T g
//    and dK = dS^T q (MN-major through the transpose bit) and dQ = dS K
//    (K-major), three m64n96k16 (or m64n64k16) products with q, g, K as
//    MN-major B operands, their k-steps only over the tile's real rows. One
//    warpgroup a block, two blocks an SM; the key columns' biases (mask bytes
//    by plain loads: a TMA box must start 16-byte aligned, a mask row starts
//    at byte b Sk) and slices go to shared memory first.
// 4. f32 (`f32_kernel`): the same one-pass, stacked block, its tiles by 1-D
//    bulk copies (n Sq Dh 4 bytes each), its products by FMA on the CUDA
//    cores over the slices' diagonal blocks alone, each lane starting its
//    head-dim sweep at its own 16-byte chunk (no bank conflict on the rows
//    that lanes share a column of); every sum in a fixed order, so f32 gives
//    the same bits from run to run.
// 5. Dropout: in bf16 one Philox call per 2 x 2 scores as everywhere, the
//    lane's block located by keep_bits_at (its slice's bh, its rows within
//    the slice); the blocks must not straddle slices, so with dropout and an
//    odd Sq or Sk a bf16 tile holds one slice. f32 draws each score's block at
//    the score's own slice, row and key.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention_backward.cuh"
#include "philox.cuh"
#include "sm90.cuh"

namespace {
namespace mer_stacked {

using namespace sm90;
using bf16 = __nv_bfloat16;
using mer_bwd::kFullyMaskedLse;
using mer_bwd::kMaskBias;

constexpr int kRows = 64;  // a tile's rows: stacked query rows, stacked keys
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMaskBias2 = kMaskBias * kLog2e;  // an ignored key's bias, in log2 units

template <typename T>
struct Params {
  const T *q, *k, *v, *out, *g;
  const float *lse, *g_lse;
  const uint8_t* mask;
  T *dq, *dk, *dv;
  int BH, H, Sq, Sk, spt;  // spt: (b*h) slices a tile
  float scale;
  mer_philox::Dropout drop;
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// bf16 with dropout at an odd Sq or Sk: a tile holds one slice, or a lane's 2 x 2 Philox block could straddle
// two (the f32 design draws each score's block at its own row and key)
inline bool one_slice(int dtype, int Sq, int Sk, bool dropout) { return dtype == 1 && dropout && ((Sq | Sk) & 1); }

// The slices a tile stacks, chosen on the card (PERF.md: every count timed at the counted shapes). A
// block is one chain of dependent latencies, so the grid wants about one block an SM: in bf16 the fewest slices a
// tile (at most 64 / max(Sq, Sk)) that keep the grid within one block an SM (B H = 128: one slice, where two to the
// most that fit took 1.08-1.66 times as long; B H = 256: two, where one took 1.06-1.20 times as long and three or
// more 1.05-1.62); in f32, whose FMA work grows with the tile, one (two took 1.12-1.30 times as long).
inline int slices_per_tile(int dtype, int BH, int Sq, int Sk, bool dropout, int sms) {
  if (dtype == 0 || one_slice(dtype, Sq, Sk, dropout)) return 1;
  const int fit = kRows / (Sq > Sk ? Sq : Sk), waves = (BH + sms - 1) / sms;
  return waves < fit ? waves : fit;
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

// -- bf16: TMA and wgmma ------------------------------------------------------------------------------

namespace bf16_design {

constexpr int kThreads = 128;  // one warpgroup
constexpr uint32_t kBoxBytes = kRows * 64 * sizeof(bf16);

template <int NB>  // 64-column boxes of a row: 1 (Dh 64) or 2 (Dh 96)
struct Smem {      // 1024-byte aligned; the 8 KB tiles first
  bf16 q[NB][kRows * 64];
  bf16 k[NB][kRows * 64];
  bf16 v[NB][kRows * 64];
  bf16 g[NB][kRows * 64];
  bf16 pd[kRows * 64];  // P o D [query][key], 128-byte swizzled as TMA writes a box
  bf16 ds[kRows * 64];  // dS, the same
  float bias[kRows];    // the key columns' biases in log2 units
  int slice[kRows];     // the key columns' slice in the tile, -1 past its real keys
  uint64_t full;
};

// element offset of (row, col) in a 128-byte swizzled [64][64] bf16 tile: the row's 16-byte chunk col >> 3 XOR the
// row's place in its 8-row atom
__device__ __forceinline__ int swizzled(int row, int col) {
  return row * 64 + (((col >> 3) ^ (row & 7)) << 3) + (col & 7);
}

// The products on wgmma: S = q K^T and dP = g V^T (m64n64k16, both operands K-major as TMA writes them), then
// dV = (P o D)^T g and dK = dS^T q over the real query rows (A MN-major through the transpose bit) and dQ = dS K over
// the real keys (A K-major), with q, g, K as MN-major B operands of N = Dh (m64n96k16 or m64n64k16).
template <int DH, typename S>
__device__ __forceinline__ void scores(S& sm, float (&sc)[32], float (&dp)[32]) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wgmma_ss(sc, desc_sw128(sm.q[kk >> 2]) + 2 * (kk & 3), desc_sw128(sm.k[kk >> 2]) + 2 * (kk & 3), kk);
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wgmma_ss(dp, desc_sw128(sm.g[kk >> 2]) + 2 * (kk & 3), desc_sw128(sm.v[kk >> 2]) + 2 * (kk & 3), kk);
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(sc);
  fence_operands(dp);
}

template <int DH, typename S>
__device__ __forceinline__ void grads(S& sm, float (&dq)[DH / 2], float (&dk)[DH / 2], float (&dv)[DH / 2],
                                      int steps_q, int steps_k) {
  const uint64_t pd_desc = desc_sw128(sm.pd), ds_desc = desc_sw128(sm.ds);
  const uint64_t q_mn = desc_sw128_mn(sm.q[0], kBoxBytes), k_mn = desc_sw128_mn(sm.k[0], kBoxBytes),
                 g_mn = desc_sw128_mn(sm.g[0], kBoxBytes);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    if (kk < steps_q) {
      wgmma_ss_t<1, 1>(dv, pd_desc + 128 * kk, g_mn + 128 * kk, kk);
      wgmma_ss_t<1, 1>(dk, ds_desc + 128 * kk, q_mn + 128 * kk, kk);
    }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    if (kk < steps_k) wgmma_ss_t<0, 1>(dq, ds_desc + 2 * kk, k_mn + 128 * kk, kk);
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(dq);
  fence_operands(dk);
  fence_operands(dv);
}

template <typename Tag, int DH, bool kDrop>
__global__ void __launch_bounds__(kThreads, 2)
    bf16_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_g,
                const Params<bf16> p) {
  constexpr int NB = DH / 64 + (DH % 64 != 0);
  constexpr int NJ = DH / 8;  // 8-column groups of dq, dk, dv
  extern __shared__ unsigned char smem_raw[];
  Smem<NB>& sm = *reinterpret_cast<Smem<NB>*>(align1024(smem_raw));
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int tile0 = blockIdx.x * p.spt;        // the tile's first (b*h) slice
  const int n = min(p.spt, p.BH - tile0);     // its real slices
  const int rows_q = n * p.Sq, rows_k = n * p.Sk;
  if (tid == 0) {
    mbar_init(&sm.full, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&sm.full, 4 * NB * kBoxBytes);
    for (int b = 0; b < NB; ++b) {
      tma_load_3d(sm.q[b], &map_q, &sm.full, 64 * b, tile0 * p.Sq, 0);
      tma_load_3d(sm.k[b], &map_k, &sm.full, 64 * b, tile0 * p.Sk, 0);
      tma_load_3d(sm.v[b], &map_v, &sm.full, 64 * b, tile0 * p.Sk, 0);
      tma_load_3d(sm.g[b], &map_g, &sm.full, 64 * b, tile0 * p.Sq, 0);
    }
  }
  if (tid < kRows) {  // the key columns: slice and bias
    const int s = tid / p.Sk, key = tid - s * p.Sk;
    const bool real = tid < rows_k;
    sm.slice[tid] = real ? s : -1;
    sm.bias[tid] = real && p.mask != nullptr && p.mask[(size_t)((tile0 + s) / p.H) * p.Sk + key] ? kMaskBias2 : 0.f;
  }
  // this lane's query rows r0 and r0 + 8: slice (-2 past the real rows), lse, delta = rowsum(g o out) - g_lse; the
  // four lanes of a row read its 16-byte chunks t, t + 4, ..
  const int r0 = 16 * w + g;
  int rslice[2];
  float lse2[2], delta[2];
  bool fully[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    const bool real = r < rows_q;
    const size_t row = (size_t)tile0 * p.Sq + r;
    float part = 0.f, lse = 0.f;
    if (real) {
      const uint4* gr = reinterpret_cast<const uint4*>(p.g + row * DH);
      const uint4* outr = reinterpret_cast<const uint4*>(p.out + row * DH);
#pragma unroll
      for (int c = t; c < DH / 8; c += 4) {
        const uint4 a = gr[c], b = outr[c];
        const bf16* ae = reinterpret_cast<const bf16*>(&a);
        const bf16* be = reinterpret_cast<const bf16*>(&b);
#pragma unroll
        for (int e = 0; e < 8; ++e) part = fmaf(__bfloat162float(ae[e]), __bfloat162float(be[e]), part);
      }
      lse = p.lse[row];
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    rslice[h] = real ? r / p.Sq : -2;
    delta[h] = real ? part - (p.g_lse != nullptr ? p.g_lse[row] : 0.f) : 0.f;
    fully[h] = lse < kFullyMaskedLse;
    lse2[h] = lse * kLog2e;
  }
  __syncthreads();  // the columns' slices and biases
  mbar_wait(&sm.full, 0);

  // S = q K^T and dP = g V^T over the stacked rows and keys
  float sc[32], dp[32];
  scores<DH>(sm, sc, dp);

  // P, D and dS where they lie (row r0 + 8 h, key 8 j + 2 t + c), P o D and dS to shared memory in bf16
  const float c_log2 = p.scale * kLog2e, inv_sk = 1.f / p.Sk;
  const int drawn = r0 + 7 * (r0 & 1);  // the first row of the 2 x 2 blocks this lane draws (keep_bits' pairing)
  const int drawn_slice = drawn / p.Sq;
  const uint32_t drawn_bh = tile0 + drawn_slice, drawn_pair = (drawn - drawn_slice * p.Sq) >> 1;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * t;
    const int2 cs = *reinterpret_cast<const int2*>(&sm.slice[col]);
    const float2 cb = *reinterpret_cast<const float2*>(&sm.bias[col]);
    uint32_t bits = 0xFu;
    if (kDrop) bits = mer_philox::keep_bits_at(p.drop, drawn_bh, drawn_pair, col - max(cs.x, 0) * p.Sk, r0 & 1);
    float pd[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e, h = e >> 1, c = e & 1;
      const bool on = rslice[h] == (c ? cs.y : cs.x);
      const float pr = !on ? 0.f : fully[h] ? inv_sk : exp2f(fmaf(sc[i], c_log2, (c ? cb.y : cb.x) - lse2[h]));
      const float f = kDrop ? ((bits >> e) & 1u ? p.drop.keep_scale : 0.f) : 1.f;
      pd[e] = pr * f;
      ds[e] = pr * fmaf(dp[i], f, -delta[h]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int off = swizzled(r0 + 8 * h, col);
      *reinterpret_cast<uint32_t*>(&sm.pd[off]) = mer_tiles::pack_bf16(pd[2 * h], pd[2 * h + 1]);
      *reinterpret_cast<uint32_t*>(&sm.ds[off]) = mer_tiles::pack_bf16(ds[2 * h], ds[2 * h + 1]);
    }
  }
  fence_proxy_async();  // the writes above, before wgmma reads them
  __syncthreads();

  // dV = (P o D)^T g and dK = dS^T q over the real query rows (16 a k-step), dQ = dS K over the real keys
  float dq[DH / 2], dk[DH / 2], dv[DH / 2];
  grads<DH>(sm, dq, dk, dv, (rows_q + 15) >> 4, (rows_k + 15) >> 4);

  // the real rows of the tile: dq rows tile0 Sq + r, dk and dv rows tile0 Sk + r
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r < rows_q) {
      bf16* out = p.dq + ((size_t)tile0 * p.Sq + r) * DH;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * j + 2 * t) =
            __floats2bfloat162_rn(dq[4 * j + 2 * h] * p.scale, dq[4 * j + 2 * h + 1] * p.scale);
    }
    if (r < rows_k) {
      const size_t row = ((size_t)tile0 * p.Sk + r) * DH;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(p.dk + row + 8 * j + 2 * t) =
            __floats2bfloat162_rn(dk[4 * j + 2 * h] * p.scale, dk[4 * j + 2 * h + 1] * p.scale);
        *reinterpret_cast<__nv_bfloat162*>(p.dv + row + 8 * j + 2 * t) =
            __floats2bfloat162_rn(dv[4 * j + 2 * h], dv[4 * j + 2 * h + 1]);
      }
    }
  }
}

// the [rows][Dh] view as 64 x 64 boxes, 128-byte swizzled; columns past Dh and rows past `rows` read as zeros
inline bool encode_view(CUtensorMap* map, const void* base, int Dh, int rows) {
  const cuuint64_t d = static_cast<cuuint64_t>(Dh), r = static_cast<cuuint64_t>(rows);
  return encode_3d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, {d, r, 1}, {d * 2, r * d * 2}, {64, 64, 1});
}

template <typename Tag, int DH, bool kDrop>
cudaError_t launch_kernel(const CUtensorMap (&maps)[4], const Params<bf16>& p, cudaStream_t stream) {
  const auto kernel = bf16_kernel<Tag, DH, kDrop>;
  constexpr int bytes = sizeof(Smem<DH / 64 + (DH % 64 != 0)>) + 1024;  // + alignment slack
  // above the default 48 KB of dynamic shared memory: raised once, before any capture
  static const cudaError_t smem_ok = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (smem_ok != cudaSuccess) return smem_ok;
  kernel<<<(p.BH + p.spt - 1) / p.spt, kThreads, bytes, stream>>>(maps[0], maps[1], maps[2], maps[3], p);
  return cudaGetLastError();
}

template <typename Tag, int DH>
cudaError_t launch(const Params<bf16>& p, cudaStream_t stream) {
  CUtensorMap maps[4];  // q, k, v, g
  if (!encode_view(&maps[0], p.q, DH, p.BH * p.Sq) || !encode_view(&maps[1], p.k, DH, p.BH * p.Sk) ||
      !encode_view(&maps[2], p.v, DH, p.BH * p.Sk) || !encode_view(&maps[3], p.g, DH, p.BH * p.Sq))
    return cudaErrorInvalidValue;
  return p.drop.on ? launch_kernel<Tag, DH, true>(maps, p, stream) : launch_kernel<Tag, DH, false>(maps, p, stream);
}

}  // namespace bf16_design

// -- f32: bulk copies and FMA ---------------------------------------------------------------------------

namespace f32_design {

constexpr int kThreads = 256;

// Shared memory of a tile of rq = n Sq query rows and rk = n Sk keys: the barrier, then q, g [rq][Dh], k, v
// [rk][Dh], P o D and dS [rq][Sk] (row r's keys of its own slice), delta and lse [rq], the keys' biases [rk]
__host__ __device__ inline int smem_bytes(int rq, int rk, int Sk, int Dh) {
  return 16 + 4 * ((2 * rq + 2 * rk) * Dh + 2 * rq * Sk + 2 * rq + rk);
}

template <typename Tag, int DH, bool kDrop>
__global__ void __launch_bounds__(kThreads) f32_kernel(const Params<float> p) {
  constexpr int C = DH / 4;  // 16-byte chunks of a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tile0 = blockIdx.x * p.spt, n = min(p.spt, p.BH - tile0);
  const int Sq = p.Sq, Sk = p.Sk, rq = n * Sq, rk = n * Sk;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  float* qs = reinterpret_cast<float*>(smem_raw + 16);
  float* gs = qs + rq * DH;
  float* ks = gs + rq * DH;
  float* vs = ks + rk * DH;
  float* pd = vs + rk * DH;
  float* ds = pd + rq * Sk;
  float* delta_s = ds + rq * Sk;
  float* lse_s = delta_s + rq;
  float* bias_s = lse_s + rq;
  if (tid == 0) {
    mbar_init(full, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    const uint32_t q_bytes = rq * DH * 4, k_bytes = rk * DH * 4;
    mbar_expect_tx(full, 2 * q_bytes + 2 * k_bytes);
    bulk_load(qs, p.q + (size_t)tile0 * Sq * DH, q_bytes, full);
    bulk_load(gs, p.g + (size_t)tile0 * Sq * DH, q_bytes, full);
    bulk_load(ks, p.k + (size_t)tile0 * Sk * DH, k_bytes, full);
    bulk_load(vs, p.v + (size_t)tile0 * Sk * DH, k_bytes, full);
  }
  // per query row (a warp a row) delta and lse; per key its bias
  for (int r = warp; r < rq; r += kThreads / 32) {
    const size_t row = (size_t)tile0 * Sq + r;
    float part = 0.f;
#pragma unroll
    for (int d = lane; d < DH; d += 32) part = fmaf(p.g[row * DH + d], p.out[row * DH + d], part);
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) part += __shfl_xor_sync(0xffffffffu, part, m);
    if (lane == 0) {
      delta_s[r] = part - (p.g_lse != nullptr ? p.g_lse[row] : 0.f);
      lse_s[r] = p.lse[row];
    }
  }
  for (int c = tid; c < rk; c += kThreads) {
    const int s = c / Sk, key = c - s * Sk;
    bias_s[c] = p.mask != nullptr && p.mask[(size_t)((tile0 + s) / p.H) * Sk + key] ? kMaskBias : 0.f;
  }
  __syncthreads();
  mbar_wait(full, 0);

  // 1. S and dP of the slices' diagonal blocks, four keys of one row an item; P o D and dS
  const float inv_sk = 1.f / Sk;
  const int groups = (Sk + 3) >> 2;
  for (int it = tid; it < rq * groups; it += kThreads) {
    const int r = it / groups, j0 = 4 * (it - r * groups);
    const int s = r / Sq, i = r - s * Sq;
    const float4* qr = reinterpret_cast<const float4*>(qs + r * DH);
    const float4* gr = reinterpret_cast<const float4*>(gs + r * DH);
    const float4* kr[4];
    const float4* vr[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int key = s * Sk + min(j0 + u, Sk - 1);
      kr[u] = reinterpret_cast<const float4*>(ks + key * DH);
      vr[u] = reinterpret_cast<const float4*>(vs + key * DH);
    }
    float sacc[4] = {0.f, 0.f, 0.f, 0.f}, dacc[4] = {0.f, 0.f, 0.f, 0.f};
    int c = lane % C;  // each lane starts at its own chunk: lanes sharing a column read distinct banks
    for (int step = 0; step < C; ++step) {
      const float4 a = qr[c], b = gr[c];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 x = kr[u][c], y = vr[u][c];
        sacc[u] = fmaf(a.x, x.x, fmaf(a.y, x.y, fmaf(a.z, x.z, fmaf(a.w, x.w, sacc[u]))));
        dacc[u] = fmaf(b.x, y.x, fmaf(b.y, y.y, fmaf(b.z, y.z, fmaf(b.w, y.w, dacc[u]))));
      }
      c = c + 1 == C ? 0 : c + 1;
    }
    uint32_t words[2][4];  // the 2 x 2 blocks of keys j0, j0 + 1 and j0 + 2, j0 + 3 at rows i & ~1, i | 1
    if (kDrop)
#pragma unroll
      for (int u = 0; u < 2; ++u)
        mer_philox::philox4(p.drop.seed0, p.drop.seed1, (j0 >> 1) + u, i >> 1, tile0 + s, words[u]);
    const float lse = lse_s[r], dl = delta_s[r];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + u;
      if (j >= Sk) continue;
      const float pr = lse < kFullyMaskedLse ? inv_sk
                                             : mer_tiles::exp_of(fmaf(sacc[u], p.scale, bias_s[s * Sk + j]) - lse);
      const float f = kDrop ? (words[u >> 1][2 * (i & 1) + (u & 1)] >= p.drop.threshold ? p.drop.keep_scale : 0.f)
                            : 1.f;
      pd[r * Sk + j] = pr * f;
      ds[r * Sk + j] = pr * fmaf(dacc[u], f, -dl);
    }
  }
  __syncthreads();

  // 2. dq = scale dS k (a 16-byte chunk of a query row an item), then dk = scale dS^T q, dv = (P o D)^T g (a chunk
  // of a key row an item); the sums in key and row order
  for (int it = tid; it < rq * C; it += kThreads) {
    const int r = it / C, c = it - r * C, s = r / Sq;
    const float* w = ds + r * Sk;
    const float4* kc = reinterpret_cast<const float4*>(ks + s * Sk * DH) + c;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < Sk; ++j) {
      const float a = w[j];
      const float4 x = kc[j * C];
      acc = make_float4(fmaf(a, x.x, acc.x), fmaf(a, x.y, acc.y), fmaf(a, x.z, acc.z), fmaf(a, x.w, acc.w));
    }
    *reinterpret_cast<float4*>(p.dq + ((size_t)tile0 * Sq + r) * DH + 4 * c) =
        make_float4(acc.x * p.scale, acc.y * p.scale, acc.z * p.scale, acc.w * p.scale);
  }
  for (int it = tid; it < rk * C; it += kThreads) {
    const int r = it / C, c = it - r * C, s = r / Sk, j = r - s * Sk;
    const float* wd = ds + s * Sq * Sk + j;
    const float* wp = pd + s * Sq * Sk + j;
    const float4* qc = reinterpret_cast<const float4*>(qs + s * Sq * DH) + c;
    const float4* gc = reinterpret_cast<const float4*>(gs + s * Sq * DH) + c;
    float4 ak = make_float4(0.f, 0.f, 0.f, 0.f), av = ak;
    for (int i = 0; i < Sq; ++i) {
      const float a = wd[i * Sk], b = wp[i * Sk];
      const float4 x = qc[i * C], y = gc[i * C];
      ak = make_float4(fmaf(a, x.x, ak.x), fmaf(a, x.y, ak.y), fmaf(a, x.z, ak.z), fmaf(a, x.w, ak.w));
      av = make_float4(fmaf(b, y.x, av.x), fmaf(b, y.y, av.y), fmaf(b, y.z, av.z), fmaf(b, y.w, av.w));
    }
    const size_t off = ((size_t)tile0 * Sk + r) * DH + 4 * c;
    *reinterpret_cast<float4*>(p.dk + off) =
        make_float4(ak.x * p.scale, ak.y * p.scale, ak.z * p.scale, ak.w * p.scale);
    *reinterpret_cast<float4*>(p.dv + off) = av;
  }
}

template <typename Tag, int DH, bool kDrop>
cudaError_t launch_kernel(const Params<float>& p, cudaStream_t stream) {
  const auto kernel = f32_kernel<Tag, DH, kDrop>;
  // above the default 48 KB of dynamic shared memory: the most any call asks (64 rows, 64 keys), raised once, before
  // any capture
  static const cudaError_t smem_ok =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(kRows, kRows, kRows, DH));
  if (smem_ok != cudaSuccess) return smem_ok;
  const int rows = p.spt < p.BH ? p.spt : p.BH;
  const int bytes = smem_bytes(rows * p.Sq, rows * p.Sk, p.Sk, DH);
  kernel<<<(p.BH + p.spt - 1) / p.spt, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename Tag, int DH>
cudaError_t launch(const Params<float>& p, cudaStream_t stream) {
  return p.drop.on ? launch_kernel<Tag, DH, true>(p, stream) : launch_kernel<Tag, DH, false>(p, stream);
}

}  // namespace f32_design

// Whether the stacked design takes a call (dtype 0 = f32, 1 = bf16); `aligned`: q, k, v, out, g, dq, dk, dv all
// 16-byte aligned. Mirrored by ops/flash_attention.py::_fused_route.
inline bool takes(int dtype, int Sq, int Sk, int Dh, bool aligned) {
  return (dtype == 0 || dtype == 1) && Sq >= 1 && Sq <= kRows && Sk >= 1 && Sk <= kRows && (Dh == 64 || Dh == 96) &&
         aligned;
}

// One bf16 call (takes() holds), slices_per_tile's slices a tile.
template <typename Tag>
cudaError_t launch_bf16(const mer_bwd::Args& a) {
  if (a.B * a.H <= 0) return cudaErrorInvalidValue;
  const int spt = slices_per_tile(1, a.B * a.H, a.Sq, a.Sk, a.drop.on, sm_count());
  const Params<bf16> p{static_cast<const bf16*>(a.q),   static_cast<const bf16*>(a.k),
                       static_cast<const bf16*>(a.v),   static_cast<const bf16*>(a.out),
                       static_cast<const bf16*>(a.g),   static_cast<const float*>(a.lse),
                       static_cast<const float*>(a.g_lse), static_cast<const uint8_t*>(a.mask),
                       static_cast<bf16*>(a.dq),        static_cast<bf16*>(a.dk),
                       static_cast<bf16*>(a.dv),        a.B * a.H, a.H, a.Sq, a.Sk, spt, a.scale, a.drop};
  return a.Dh == 64 ? bf16_design::launch<Tag, 64>(p, a.stream) : bf16_design::launch<Tag, 96>(p, a.stream);
}

// One f32 call (takes() holds), slices_per_tile's slices a tile.
template <typename Tag>
cudaError_t launch_f32(const mer_bwd::Args& a) {
  if (a.B * a.H <= 0) return cudaErrorInvalidValue;
  const int spt = slices_per_tile(0, a.B * a.H, a.Sq, a.Sk, a.drop.on, sm_count());
  const Params<float> p{static_cast<const float*>(a.q),   static_cast<const float*>(a.k),
                        static_cast<const float*>(a.v),   static_cast<const float*>(a.out),
                        static_cast<const float*>(a.g),   static_cast<const float*>(a.lse),
                        static_cast<const float*>(a.g_lse), static_cast<const uint8_t*>(a.mask),
                        static_cast<float*>(a.dq),        static_cast<float*>(a.dk),
                        static_cast<float*>(a.dv),        a.B * a.H, a.H, a.Sq, a.Sk, spt, a.scale, a.drop};
  return a.Dh == 64 ? f32_design::launch<Tag, 64>(p, a.stream) : f32_design::launch<Tag, 96>(p, a.stream);
}

}  // namespace mer_stacked
}  // namespace
