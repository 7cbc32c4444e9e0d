// K2's one-pass stacked backward for Hopper (sm_90a): the design that
// flash_attention_bwd.cu launches for bf16 and f32 at Sq, Sk <= 64 and head
// dims 50, 64 and 96 with 16-byte aligned q, k, v, out, g, dq, dk, dv (the
// fusion model's dialogues: 8, 16, 24 and 33 utterances, 8 heads of 96, and
// the mel variant's 6 audio heads of 50).
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
//    from g and out (plain loads, issued before the tile's copies land) and
//    never goes to device memory.
// 2. Block-diagonal stacking (flash_attention_stacked.cuh): a 64-row tile
//    holds spt <= 64 / max(Sq, Sk) slices (slices_per_tile, chosen on the
//    card: about one block an SM). A score whose row and column lie in
//    different slices, or past the tile's real rows, gets P = 0 and dS = 0.
//    Because the stack is block-diagonal, dQ of the stack is [dS_1 k_1; dS_2
//    k_2; ..] and so for dK and dV: the products over the whole tile are the
//    slices' products side by side.
// 3. bf16 (`bf16_kernel`): q, k, v, g come in as 128-byte swizzled 64 x 64
//    boxes, by TMA through maps over the [B*H*S, Dh] views (Dh 96: two boxes,
//    the second zero-filled past column 96; rows past the tile's slices are the
//    next slices' or zeros past the tensor, finite, as the products' B operands
//    must be), or at Dh 50, whose 100-byte rows no tensor map takes, by 4-byte
//    loads into the same layout, columns 50-63 zero. S = q K^T and dP = g V^T
//    are wgmma.m64n64k16 from shared memory (Dh / 16 k-steps: 4 at Dh 50 over
//    the zero-filled tile); P, D and dS are computed in the accumulator
//    registers; P o D and dS, rounded to bf16, go to shared memory in the
//    swizzled layout, where they are the A operands of dV = (P o D)^T g and dK
//    = dS^T q (MN-major through the transpose bit) and dQ = dS K (K-major),
//    three m64nNk16 products (N = 96, 64, or 56 at Dh 50) with q, g, K as
//    MN-major B operands, their k-steps only over the tile's real rows. One
//    warpgroup a block, two blocks an SM; the key columns' biases and slices
//    go to shared memory first.
// 4. f32 (`f32_kernel`): the same one-pass, stacked block, its tiles by 1-D
//    bulk copies (n Sq Dh 4 bytes each; at Dh 50 plain 8-byte loads into rows
//    padded to 52, a bulk copy starting 16-byte aligned only for some tiles),
//    its products by FMA on the CUDA cores over the slices' diagonal blocks
//    alone, each lane starting its head-dim sweep at its own 16-byte chunk;
//    every sum in a fixed order, so f32 gives the same bits from run to run.
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
#include "flash_attention_stacked.cuh"

namespace {
namespace mer_stacked {

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

// -- bf16: TMA (or 4-byte loads at Dh 50) and wgmma -----------------------------------------------------------

namespace bf16_design {

constexpr int kThreads = 128;  // one warpgroup

template <int NB>  // 64-column boxes of a row: 1 (Dh 50, 64) or 2 (Dh 96)
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

// The products on wgmma: S = q K^T and dP = g V^T (m64n64k16, both operands K-major as TMA writes them; Dh / 16
// k-steps, rounded up), then dV = (P o D)^T g and dK = dS^T q over the real query rows (A MN-major through the
// transpose bit) and dQ = dS K over the real keys (A K-major), with q, g, K as MN-major B operands of N = Dh rounded
// up to 8 (m64n96k16, m64n64k16 or m64n56k16).
template <int DH, typename S>
__device__ __forceinline__ void scores(S& sm, float (&sc)[32], float (&dp)[32]) {
  constexpr int kSteps = (DH + 15) / 16;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk)
    wgmma_ss(sc, desc_sw128(sm.q[kk >> 2]) + 2 * (kk & 3), desc_sw128(sm.k[kk >> 2]) + 2 * (kk & 3), kk);
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk)
    wgmma_ss(dp, desc_sw128(sm.g[kk >> 2]) + 2 * (kk & 3), desc_sw128(sm.v[kk >> 2]) + 2 * (kk & 3), kk);
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(sc);
  fence_operands(dp);
}

template <int N, typename S>
__device__ __forceinline__ void grads(S& sm, float (&dq)[N / 2], float (&dk)[N / 2], float (&dv)[N / 2], int steps_q,
                                      int steps_k) {
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

// rowsum(g o out) of stacked row `row`: lane t of its quad takes the row's 16-byte chunks t, t + 4, .. (4-byte words
// at Dh 50, whose rows are not 16-byte aligned), then the quad's sum
template <int DH>
__device__ __forceinline__ float row_dot(const bf16* g, const bf16* out, size_t row, bool real, int t) {
  float part = 0.f;
  if (real) {
    if constexpr (Boxes<DH>::kTma) {
      const uint4* gr = reinterpret_cast<const uint4*>(g + row * DH);
      const uint4* outr = reinterpret_cast<const uint4*>(out + row * DH);
#pragma unroll
      for (int c = t; c < DH / 8; c += 4) {
        const uint4 a = gr[c], b = outr[c];
        const bf16* ae = reinterpret_cast<const bf16*>(&a);
        const bf16* be = reinterpret_cast<const bf16*>(&b);
#pragma unroll
        for (int e = 0; e < 8; ++e) part = fmaf(__bfloat162float(ae[e]), __bfloat162float(be[e]), part);
      }
    } else {
      const __nv_bfloat162* gr = reinterpret_cast<const __nv_bfloat162*>(g + row * DH);
      const __nv_bfloat162* outr = reinterpret_cast<const __nv_bfloat162*>(out + row * DH);
#pragma unroll
      for (int c = t; c < DH / 2; c += 4) {
        const float2 a = __bfloat1622float2(gr[c]), b = __bfloat1622float2(outr[c]);
        part = fmaf(a.y, b.y, fmaf(a.x, b.x, part));
      }
    }
  }
  part += __shfl_xor_sync(0xffffffffu, part, 1);
  return part + __shfl_xor_sync(0xffffffffu, part, 2);
}

template <typename Tag, int DH, bool kDrop>
__global__ void __launch_bounds__(kThreads, 2)
    bf16_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_g,
                const Params<bf16> p) {
  constexpr int NB = Boxes<DH>::kN;
  constexpr int N = (DH + 7) & ~7;  // the gradients' columns on wgmma
  constexpr int NJ = N / 8;         // 8-column groups of dq, dk, dv
  extern __shared__ unsigned char smem_raw[];
  Smem<NB>& sm = *reinterpret_cast<Smem<NB>*>(align1024(smem_raw));
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int tile0 = blockIdx.x * p.spt;        // the tile's first (b*h) slice
  const int n = min(p.spt, p.BH - tile0);     // its real slices
  const int rows_q = n * p.Sq, rows_k = n * p.Sk;
  if constexpr (Boxes<DH>::kTma) {
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
  } else {
    const size_t q0 = (size_t)tile0 * p.Sq, k0 = (size_t)tile0 * p.Sk;
    const WordTile tiles[4] = {{sm.q[0], p.q, q0, rows_q}, {sm.k[0], p.k, k0, rows_k}, {sm.v[0], p.v, k0, rows_k},
                               {sm.g[0], p.g, q0, rows_q}};
    load_words<DH, kThreads>(tiles, tid);
    fence_proxy_async();  // the writes above, before wgmma reads them (behind the barrier below)
  }
  key_columns(sm.slice, sm.bias, tid, rows_k, p.Sk, p.H, tile0, p.mask, kMaskBias2);
  // this lane's query rows r0 and r0 + 8: slice (-2 past the real rows), lse, delta = rowsum(g o out) - g_lse
  const int r0 = 16 * w + g;
  int rslice[2];
  float lse2[2], delta[2];
  bool fully[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    const bool real = r < rows_q;
    const size_t row = (size_t)tile0 * p.Sq + r;
    const float lse = real ? p.lse[row] : 0.f;  // issued beside row_dot's loads, not behind its shuffles
    const float glse = real && p.g_lse != nullptr ? p.g_lse[row] : 0.f;
    const float part = row_dot<DH>(p.g, p.out, row, real, t);
    rslice[h] = real ? r / p.Sq : -2;
    delta[h] = real ? part - glse : 0.f;
    fully[h] = lse < kFullyMaskedLse;
    lse2[h] = lse * kLog2e;
  }
  __syncthreads();  // the columns' slices and biases (and at Dh 50 the tiles)
  if constexpr (Boxes<DH>::kTma) mbar_wait(&sm.full, 0);

  // S = q K^T and dP = g V^T over the stacked rows and keys
  float sc[32], dp[32];
  scores<DH>(sm, sc, dp);

  // P, D and dS where they lie (row r0 + 8 h, key 8 j + 2 t + c), P o D and dS to shared memory in bf16
  const float c_log2 = p.scale * kLog2e, inv_sk = 1.f / p.Sk;
  const LaneDraw draw(r0, p.Sq, tile0);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * t;
    const int2 cs = *reinterpret_cast<const int2*>(&sm.slice[col]);
    const float2 cb = *reinterpret_cast<const float2*>(&sm.bias[col]);
    uint32_t bits = 0xFu;
    if (kDrop) bits = draw.bits(p.drop, col, cs.x, p.Sk);
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
  float dq[N / 2], dk[N / 2], dv[N / 2];
  grads<N>(sm, dq, dk, dv, (rows_q + 15) >> 4, (rows_k + 15) >> 4);

  // the real rows and columns of the tile: dq rows tile0 Sq + r, dk and dv rows tile0 Sk + r
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r < rows_q) {
      bf16* out = p.dq + ((size_t)tile0 * p.Sq + r) * DH;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (8 * j + 2 * t < DH)
          *reinterpret_cast<__nv_bfloat162*>(out + 8 * j + 2 * t) =
              __floats2bfloat162_rn(dq[4 * j + 2 * h] * p.scale, dq[4 * j + 2 * h + 1] * p.scale);
    }
    if (r < rows_k) {
      const size_t row = ((size_t)tile0 * p.Sk + r) * DH;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (8 * j + 2 * t < DH) {
          *reinterpret_cast<__nv_bfloat162*>(p.dk + row + 8 * j + 2 * t) =
              __floats2bfloat162_rn(dk[4 * j + 2 * h] * p.scale, dk[4 * j + 2 * h + 1] * p.scale);
          *reinterpret_cast<__nv_bfloat162*>(p.dv + row + 8 * j + 2 * t) =
              __floats2bfloat162_rn(dv[4 * j + 2 * h], dv[4 * j + 2 * h + 1]);
        }
    }
  }
}

template <typename Tag, int DH, bool kDrop>
cudaError_t launch_kernel(const CUtensorMap (&maps)[4], const Params<bf16>& p, cudaStream_t stream) {
  const auto kernel = bf16_kernel<Tag, DH, kDrop>;
  constexpr int bytes = sizeof(Smem<Boxes<DH>::kN>) + 1024;  // + alignment slack
  // above the default 48 KB of dynamic shared memory: raised once, before any capture
  static const cudaError_t smem_ok = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (smem_ok != cudaSuccess) return smem_ok;
  kernel<<<(p.BH + p.spt - 1) / p.spt, kThreads, bytes, stream>>>(maps[0], maps[1], maps[2], maps[3], p);
  return cudaGetLastError();
}

template <typename Tag, int DH>
cudaError_t launch(const Params<bf16>& p, cudaStream_t stream) {
  CUtensorMap maps[4] = {};  // q, k, v, g; unread at Dh 50
  if (Boxes<DH>::kTma &&
      (!encode_view(&maps[0], p.q, DH, p.BH * p.Sq) || !encode_view(&maps[1], p.k, DH, p.BH * p.Sk) ||
       !encode_view(&maps[2], p.v, DH, p.BH * p.Sk) || !encode_view(&maps[3], p.g, DH, p.BH * p.Sq)))
    return cudaErrorInvalidValue;
  return p.drop.on ? launch_kernel<Tag, DH, true>(maps, p, stream) : launch_kernel<Tag, DH, false>(maps, p, stream);
}

}  // namespace bf16_design

// -- f32: bulk copies and FMA ---------------------------------------------------------------------------

namespace f32_design {

constexpr int kThreads = 256;

// Shared memory of a tile of rq = n Sq query rows and rk = n Sk keys: the barrier, then q, g [rq][Dp], k, v
// [rk][Dp] (Dp: Dh padded to a multiple of 4), P o D and dS [rq][Sk] (row r's keys of its own slice), delta and lse
// [rq], the keys' biases [rk]
__host__ __device__ inline int smem_bytes(int rq, int rk, int Sk, int Dp) {
  return 16 + 4 * ((2 * rq + 2 * rk) * Dp + 2 * rq * Sk + 2 * rq + rk);
}

template <typename Tag, int DH, bool kDrop>
__global__ void __launch_bounds__(kThreads) f32_kernel(const Params<float> p) {
  using Row = PaddedRow<DH>;
  constexpr int DP = Row::kDp, C = Row::kChunks;  // padded row, 16-byte chunks of a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tile0 = blockIdx.x * p.spt, n = min(p.spt, p.BH - tile0);
  const int Sq = p.Sq, Sk = p.Sk, rq = n * Sq, rk = n * Sk;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  float* qs = reinterpret_cast<float*>(smem_raw + 16);
  float* gs = qs + rq * DP;
  float* ks = gs + rq * DP;
  float* vs = ks + rk * DP;
  float* pd = vs + rk * DP;
  float* ds = pd + rq * Sk;
  float* delta_s = ds + rq * Sk;
  float* lse_s = delta_s + rq;
  float* bias_s = lse_s + rq;
  const size_t q0 = (size_t)tile0 * Sq * DH, k0 = (size_t)tile0 * Sk * DH;
  if constexpr (Row::kBulk) {
    if (tid == 0) {
      mbar_init(full, 1);
      fence_barrier_init();
    }
    __syncthreads();
    if (tid == 0) {
      const uint32_t q_bytes = rq * DH * 4, k_bytes = rk * DH * 4;
      mbar_expect_tx(full, 2 * q_bytes + 2 * k_bytes);
      bulk_load(qs, p.q + q0, q_bytes, full);
      bulk_load(gs, p.g + q0, q_bytes, full);
      bulk_load(ks, p.k + k0, k_bytes, full);
      bulk_load(vs, p.v + k0, k_bytes, full);
    }
  } else {
    load_padded<DH, kThreads>(qs, p.q + q0, rq, tid);
    load_padded<DH, kThreads>(gs, p.g + q0, rq, tid);
    load_padded<DH, kThreads>(ks, p.k + k0, rk, tid);
    load_padded<DH, kThreads>(vs, p.v + k0, rk, tid);
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
  if constexpr (Row::kBulk) mbar_wait(full, 0);

  // 1. S and dP of the slices' diagonal blocks, four keys of one row an item; P o D and dS
  const float inv_sk = 1.f / Sk;
  const int groups = (Sk + 3) >> 2;
  for (int it = tid; it < rq * groups; it += kThreads) {
    const int r = it / groups, j0 = 4 * (it - r * groups);
    const int s = r / Sq, i = r - s * Sq;
    const float4* kr[4];
    const float4* vr[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int key = s * Sk + min(j0 + u, Sk - 1);
      kr[u] = reinterpret_cast<const float4*>(ks + key * DP);
      vr[u] = reinterpret_cast<const float4*>(vs + key * DP);
    }
    float sacc[4] = {0.f, 0.f, 0.f, 0.f}, dacc[4] = {0.f, 0.f, 0.f, 0.f};
    dot4<C>(reinterpret_cast<const float4*>(qs + r * DP), kr, sacc, lane);
    dot4<C>(reinterpret_cast<const float4*>(gs + r * DP), vr, dacc, lane);
    float f[4] = {1.f, 1.f, 1.f, 1.f};
    if (kDrop) f32_factors(p.drop, tile0 + s, i, j0, f);
    const float lse = lse_s[r], dl = delta_s[r];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + u;
      if (j >= Sk) continue;
      const float pr = lse < kFullyMaskedLse ? inv_sk
                                             : mer_tiles::exp_of(fmaf(sacc[u], p.scale, bias_s[s * Sk + j]) - lse);
      pd[r * Sk + j] = pr * f[u];
      ds[r * Sk + j] = pr * fmaf(dacc[u], f[u], -dl);
    }
  }
  __syncthreads();

  // 2. dq = scale dS k (a 16-byte chunk of a query row an item), then dk = scale dS^T q, dv = (P o D)^T g (a chunk
  // of a key row an item); the sums in key and row order
  for (int it = tid; it < rq * C; it += kThreads) {
    const int r = it / C, c = it - r * C, s = r / Sq;
    const float* w = ds + r * Sk;
    const float4* kc = reinterpret_cast<const float4*>(ks + s * Sk * DP) + c;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < Sk; ++j) {
      const float a = w[j];
      const float4 x = kc[j * C];
      acc = make_float4(fmaf(a, x.x, acc.x), fmaf(a, x.y, acc.y), fmaf(a, x.z, acc.z), fmaf(a, x.w, acc.w));
    }
    store_chunk<DH>(p.dq + ((size_t)tile0 * Sq + r) * DH, c,
                    make_float4(acc.x * p.scale, acc.y * p.scale, acc.z * p.scale, acc.w * p.scale));
  }
  for (int it = tid; it < rk * C; it += kThreads) {
    const int r = it / C, c = it - r * C, s = r / Sk, j = r - s * Sk;
    const float* wd = ds + s * Sq * Sk + j;
    const float* wp = pd + s * Sq * Sk + j;
    const float4* qc = reinterpret_cast<const float4*>(qs + s * Sq * DP) + c;
    const float4* gc = reinterpret_cast<const float4*>(gs + s * Sq * DP) + c;
    float4 ak = make_float4(0.f, 0.f, 0.f, 0.f), av = ak;
    for (int i = 0; i < Sq; ++i) {
      const float a = wd[i * Sk], b = wp[i * Sk];
      const float4 x = qc[i * C], y = gc[i * C];
      ak = make_float4(fmaf(a, x.x, ak.x), fmaf(a, x.y, ak.y), fmaf(a, x.z, ak.z), fmaf(a, x.w, ak.w));
      av = make_float4(fmaf(b, y.x, av.x), fmaf(b, y.y, av.y), fmaf(b, y.z, av.z), fmaf(b, y.w, av.w));
    }
    const size_t row = ((size_t)tile0 * Sk + r) * DH;
    store_chunk<DH>(p.dk + row, c, make_float4(ak.x * p.scale, ak.y * p.scale, ak.z * p.scale, ak.w * p.scale));
    store_chunk<DH>(p.dv + row, c, av);
  }
}

template <typename Tag, int DH, bool kDrop>
cudaError_t launch_kernel(const Params<float>& p, cudaStream_t stream) {
  constexpr int DP = PaddedRow<DH>::kDp;
  const auto kernel = f32_kernel<Tag, DH, kDrop>;
  // above the default 48 KB of dynamic shared memory: the most any call asks (64 rows, 64 keys), raised once, before
  // any capture
  static const cudaError_t smem_ok =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(kRows, kRows, kRows, DP));
  if (smem_ok != cudaSuccess) return smem_ok;
  const int rows = p.spt < p.BH ? p.spt : p.BH;
  const int bytes = smem_bytes(rows * p.Sq, rows * p.Sk, p.Sk, DP);
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
  return takes_sizes<50, 64, 96>(dtype, Sq, Sk, Dh) && aligned;
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
  if (a.Dh == 50) return bf16_design::launch<Tag, 50>(p, a.stream);
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
  if (a.Dh == 50) return f32_design::launch<Tag, 50>(p, a.stream);
  return a.Dh == 64 ? f32_design::launch<Tag, 64>(p, a.stream) : f32_design::launch<Tag, 96>(p, a.stream);
}

}  // namespace mer_stacked
}  // namespace
