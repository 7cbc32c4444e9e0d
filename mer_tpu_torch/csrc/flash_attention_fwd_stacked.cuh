// K1's one-pass stacked forward for Hopper (sm_90a): the design that
// flash_attention_fwd.cu launches for bf16 and f32 at Sq, Sk <= 64 and head
// dims 96 and 50 with 16-byte aligned q, k, v and out (the fusion model's
// dialogues: 8, 16, 24 and 33 utterances, 8 heads of 96, and the mel
// variant's 6 audio heads of 50).
//
// Replaces the TPU kernel mer_tpu/ops/flash_attention.py:72 (`_kernel`,
// launched at :538 from `_flash_impl`), with its dropout branch, at those
// shapes: the function at the head of flash_attention_forward.cuh,
//
//   s   = (q * 1/sqrt(Dh)) k^T + bias,  bias = -1e30 on ignored keys, else 0
//   lse = m + log(sum exp(s - m)),      m = row max of s        (f32)
//   out = (softmax(s) o D) v                                    (q's dtype)
//
// P o D rounded to v's dtype before the product with v, the sum of the
// unrounded, undropped probabilities in the lse, a fully masked row giving the
// mean of v; D the Philox4x32-10 keep mask of (seed, b*H + h, row, column),
// row and column counted within the slice (philox.cuh).
//
// Bound. At [32, 8, 33, 33, 96] bf16 a call reads q, k, v (1.6 MB each) and
// the mask and writes out and lse: 6.5 MB, 1.9 us at 3.35 TB/s, against 0.11
// GFLOP of products (0.11 us at 989 TFLOP/s); at the 8 bucket 0.5 us. Bytes
// bound it on paper; what a call meets is the latency of one chain of
// dependent steps (load, S, the softmax's exponentials, P V, store) and the
// launch. The template (flash_attention_forward.cuh) walks the keys in
// cp.async tiles on mma.sync with an online softmax over 4 warps of 16 rows:
// 8.3 us a launch on average at the fusion's calls (PERF.md).
//
// What this design does about it (the stacked tile of
// flash_attention_stacked.cuh, as K2's backward):
//
// 1. One launch, one pass: a block owns a 64-row tile of whole (b*h) slices
//    stacked block-diagonally; every key of a row (at most 64) lies in the
//    tile, so the softmax takes one pass, no online rescale: the row max, the
//    sum of the unrounded, undropped probabilities and the lse once each, in
//    log2 units. A score whose row and key lie in different slices, or past
//    the tile's real rows, gets no weight.
// 2. bf16 (`bf16_design`): q, k, v as 128-byte swizzled 64 x 64 boxes, by TMA
//    at Dh 96 (two boxes an operand, the second zero-filled past column 96),
//    by 4-byte loads at Dh 50 (no tensor map takes its 100-byte rows; columns
//    50-63 zero). S = q K^T is wgmma.m64n64k16 from shared memory (6 k-steps
//    at Dh 96, 4 at Dh 50); P o D, rounded to bf16, goes from the
//    accumulator registers straight into the register A operand of O = (P o
//    D) V, wgmma.m64n96k16 (m64n56k16 at Dh 50) with V MN-major through the
//    transpose bit, its k-steps over the tile's real keys alone. One
//    warpgroup a block; the key columns' biases and slices go to shared
//    memory first. out: at Dh 96 staged in shared memory and written in
//    16-byte stores, at Dh 50 (100-byte rows) as bf16 pairs, 50 columns.
// 3. f32 (`f32_design`): the same stacked block, its tiles by 1-D bulk copies
//    (plain 8-byte loads at Dh 50 into rows padded to 52: a bulk copy of n S
//    200 bytes does not start 16-byte aligned at S = 33), S by FMA on the CUDA
//    cores over the slices' diagonal blocks alone, a warp a row for the
//    softmax, O by FMA; every sum in a fixed order, so two calls give the
//    same bits.
// 4. Dropout: in bf16 one Philox call per 2 x 2 scores, the lane's block
//    located by keep_bits_at (its slice's bh, its rows within the slice); with
//    dropout at an odd Sq or Sk a bf16 tile holds one slice, so no block
//    straddles two. f32 draws each score's block at its own slice, row and key.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention_stacked.cuh"
#include "flash_attention_tiles.cuh"

namespace {
namespace mer_stacked_fwd {

using namespace mer_stacked;

template <typename T>
struct Params {
  const T *q, *k, *v;
  const uint8_t* mask;
  T* out;
  float* lse;
  int BH, H, Sq, Sk, spt;  // spt: (b*h) slices a tile
  float scale;
  mer_philox::Dropout drop;
};

// -- bf16: TMA (or 4-byte loads at Dh 50) and wgmma -----------------------------------------------------------

namespace bf16_design {

constexpr int kThreads = 128;  // one warpgroup
constexpr int kStageLd = 104;  // a staged out row at Dh 96: 208 bytes, 16-byte rows, 8 rows on distinct banks

template <int NB>  // 64-column boxes of a row: 1 (Dh 50) or 2 (Dh 96)
struct Smem {      // 1024-byte aligned; the 8 KB tiles first
  bf16 q[NB][kRows * 64];  // q; at Dh 96 then out's staged rows [64][kStageLd]
  bf16 k[NB][kRows * 64];
  bf16 v[NB][kRows * 64];
  float bias[kRows];  // the key columns' biases in log2 units
  int slice[kRows];   // the key columns' slice in the tile, -1 past its real keys
  uint64_t full;
};

template <typename Tag, int DH, bool kDrop>
__global__ void __launch_bounds__(kThreads, 2)
    forward_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v, const Params<bf16> p) {
  constexpr int NB = Boxes<DH>::kN;
  constexpr int N = (DH + 7) & ~7;        // out's columns on wgmma: 96 or 56
  constexpr int kSteps = (DH + 15) / 16;  // k-steps of S
  static_assert(NB * 64 * kRows >= kRows * kStageLd || !Boxes<DH>::kTma, "out's staging fits in q's boxes");
  extern __shared__ unsigned char smem_raw[];
  Smem<NB>& sm = *reinterpret_cast<Smem<NB>*>(align1024(smem_raw));
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int tile0 = blockIdx.x * p.spt;     // the tile's first (b*h) slice
  const int n = min(p.spt, p.BH - tile0);  // its real slices
  const int rows_q = n * p.Sq, rows_k = n * p.Sk;
  if constexpr (Boxes<DH>::kTma) {
    if (tid == 0) {
      mbar_init(&sm.full, 1);
      fence_barrier_init();
    }
    __syncthreads();
    if (tid == 0) {
      mbar_expect_tx(&sm.full, 3 * NB * kBoxBytes);
      for (int b = 0; b < NB; ++b) {
        tma_load_3d(sm.q[b], &map_q, &sm.full, 64 * b, tile0 * p.Sq, 0);
        tma_load_3d(sm.k[b], &map_k, &sm.full, 64 * b, tile0 * p.Sk, 0);
        tma_load_3d(sm.v[b], &map_v, &sm.full, 64 * b, tile0 * p.Sk, 0);
      }
    }
  } else {
    const size_t k0 = (size_t)tile0 * p.Sk;
    const WordTile tiles[3] = {
        {sm.q[0], p.q, (size_t)tile0 * p.Sq, rows_q}, {sm.k[0], p.k, k0, rows_k}, {sm.v[0], p.v, k0, rows_k}};
    load_words<DH, kThreads>(tiles, tid);
    fence_proxy_async();  // the writes above, before wgmma reads them (behind the barrier below)
  }
  key_columns(sm.slice, sm.bias, tid, rows_k, p.Sk, p.H, tile0, p.mask, kMaskBias2);
  const int r0 = 16 * w + g;  // this lane's query rows: r0 and r0 + 8; their slices, -2 past the real rows
  const int rslice[2] = {r0 < rows_q ? r0 / p.Sq : -2, r0 + 8 < rows_q ? (r0 + 8) / p.Sq : -2};
  __syncthreads();  // the columns' slices and biases (and at Dh 50 the tiles)
  if constexpr (Boxes<DH>::kTma) mbar_wait(&sm.full, 0);

  // S = q K^T over the stacked rows and keys (row r0 + 8 h, key 8 j + 2 t + c at sc[4 j + 2 h + c])
  float sc[32];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk)
    wgmma_ss(sc, desc_sw128(sm.q[kk >> 2]) + 2 * (kk & 3), desc_sw128(sm.k[kk >> 2]) + 2 * (kk & 3), kk);
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(sc);

  // the scores in log2 units with the keys' biases, -inf off the row's slice; the row max over its quad
  const float c_log2 = p.scale * kLog2e;
  float m2[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int2 cs = *reinterpret_cast<const int2*>(&sm.slice[8 * j + 2 * t]);
    const float2 cb = *reinterpret_cast<const float2*>(&sm.bias[8 * j + 2 * t]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1, c = e & 1;
      const float x = rslice[h] == (c ? cs.y : cs.x) ? fmaf(sc[4 * j + e], c_log2, c ? cb.y : cb.x) : -INFINITY;
      sc[4 * j + e] = x;
      m2[h] = fmaxf(m2[h], x);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m2[h] = fmaxf(m2[h], __shfl_xor_sync(0xffffffffu, m2[h], 1));
    m2[h] = fmaxf(m2[h], __shfl_xor_sync(0xffffffffu, m2[h], 2));
  }
  // P (a row past the real ones has no score: m2 = -inf, P = 0), l the undropped and unrounded sum, P o D
  const LaneDraw draw(r0, p.Sq, tile0);
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint32_t bits = 0xFu;
    if (kDrop) bits = draw.bits(p.drop, 8 * j + 2 * t, sm.slice[8 * j + 2 * t], p.Sk);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const float pr = sc[4 * j + e] == -INFINITY ? 0.f : exp2f(sc[4 * j + e] - m2[h]);
      l[h] += pr;
      sc[4 * j + e] = kDrop && !((bits >> e) & 1u) ? 0.f : kDrop ? pr * p.drop.keep_scale : pr;
    }
  }
  // P o D in bf16 as the A operand of k-step kk (keys 16 kk ..): rows g, g + 8 at keys 2t, 2t + 1, then + 8
  uint32_t a_p[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a_p[kk][r] = mer_tiles::pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

  // O = (P o D) V over the real keys (16 a k-step), V MN-major
  float o[N / 2];
  const int steps_k = (rows_k + 15) >> 4;
  const uint64_t v_mn = desc_sw128_mn(sm.v[0], kBoxBytes);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    if (kk < steps_k) wgmma_rs_mn(o, a_p[kk], v_mn + 128 * kk, kk);
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(o);

  // out = O / l and the lse of the real rows (a fully masked row's max is the mask bias itself: its lse in natural
  // units as the plain version rounds it)
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const float lsum = fmaxf(l[h], 1e-30f);
    inv[h] = 1.f / lsum;
    const int r = r0 + 8 * h;
    if (t == 0 && r < rows_q)
      p.lse[(size_t)tile0 * p.Sq + r] = m2[h] < 0.5f * kMaskBias2 ? kMaskBias + logf(lsum) : m2[h] * kLn2 + logf(lsum);
  }
  if constexpr (Boxes<DH>::kTma) {  // Dh 96: staged rows in q's place, then 16-byte stores of the real rows
    bf16* stage = sm.q[0];
    __syncthreads();  // every warp is past its reads of q
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(stage + (r0 + 8 * h) * kStageLd + 8 * j + 2 * t) =
            __floats2bfloat162_rn(o[4 * j + 2 * h] * inv[h], o[4 * j + 2 * h + 1] * inv[h]);
    __syncthreads();
    constexpr int kChunks = DH / 8;
    uint4* out = reinterpret_cast<uint4*>(p.out + (size_t)tile0 * p.Sq * DH);
    for (int i = tid; i < rows_q * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i - r * kChunks;
      out[i] = *reinterpret_cast<const uint4*>(stage + r * kStageLd + 8 * c);
    }
  } else {  // Dh 50: bf16 pairs of the 50 real columns
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r >= rows_q) continue;
      bf16* row = p.out + ((size_t)tile0 * p.Sq + r) * DH;
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
        if (8 * j + 2 * t < DH)
          *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + 2 * t) =
              __floats2bfloat162_rn(o[4 * j + 2 * h] * inv[h], o[4 * j + 2 * h + 1] * inv[h]);
    }
  }
}

template <typename Tag, int DH, bool kDrop>
cudaError_t launch_kernel(const CUtensorMap (&maps)[3], const Params<bf16>& p, cudaStream_t stream) {
  const auto kernel = forward_kernel<Tag, DH, kDrop>;
  constexpr int bytes = sizeof(Smem<Boxes<DH>::kN>) + 1024;  // + alignment slack
  // above the default 48 KB of dynamic shared memory: raised once, before any capture
  static const cudaError_t smem_ok = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (smem_ok != cudaSuccess) return smem_ok;
  kernel<<<(p.BH + p.spt - 1) / p.spt, kThreads, bytes, stream>>>(maps[0], maps[1], maps[2], p);
  return cudaGetLastError();
}

template <typename Tag, int DH>
cudaError_t launch(const Params<bf16>& p, cudaStream_t stream) {
  CUtensorMap maps[3] = {};  // q, k, v; unread at Dh 50
  if (Boxes<DH>::kTma && (!encode_view(&maps[0], p.q, DH, p.BH * p.Sq) ||
                          !encode_view(&maps[1], p.k, DH, p.BH * p.Sk) || !encode_view(&maps[2], p.v, DH, p.BH * p.Sk)))
    return cudaErrorInvalidValue;
  return p.drop.on ? launch_kernel<Tag, DH, true>(maps, p, stream) : launch_kernel<Tag, DH, false>(maps, p, stream);
}

}  // namespace bf16_design

// -- f32: bulk copies (or 8-byte loads at Dh 50) and FMA -------------------------------------------------------

namespace f32_design {

constexpr int kThreads = 256;

// Shared memory of a tile of rq = n Sq query rows and rk = n Sk keys: the barrier, then q [rq][Dp], k, v [rk][Dp]
// (Dp: Dh padded to a multiple of 4), the scores, then P o D, [rq][Sk] (row r's keys of its own slice), with
// dropout the factors D [rq][Sk], 1 / l [rq], the keys' biases [rk]
__host__ __device__ inline int smem_bytes(int rq, int rk, int Sk, int Dp, bool dropout) {
  return 16 + 4 * ((rq + 2 * rk) * Dp + (dropout ? 2 : 1) * rq * Sk + rq + rk);
}

template <typename Tag, int DH, bool kDrop>
__global__ void __launch_bounds__(kThreads) forward_kernel(const Params<float> p) {
  using Row = PaddedRow<DH>;
  constexpr int DP = Row::kDp, C = Row::kChunks;  // padded row, 16-byte chunks of a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tile0 = blockIdx.x * p.spt, n = min(p.spt, p.BH - tile0);
  const int Sq = p.Sq, Sk = p.Sk, rq = n * Sq, rk = n * Sk;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  float* qs = reinterpret_cast<float*>(smem_raw + 16);
  float* ks = qs + rq * DP;
  float* vs = ks + rk * DP;
  float* ps = vs + rk * DP;
  float* fs = ps + rq * Sk;
  float* inv_s = fs + (kDrop ? rq * Sk : 0);
  float* bias_s = inv_s + rq;
  const size_t q0 = (size_t)tile0 * Sq * DH, k0 = (size_t)tile0 * Sk * DH;
  if constexpr (Row::kBulk) {
    if (tid == 0) {
      mbar_init(full, 1);
      fence_barrier_init();
    }
    __syncthreads();
    if (tid == 0) {
      const uint32_t q_bytes = rq * DH * 4, k_bytes = rk * DH * 4;
      mbar_expect_tx(full, q_bytes + 2 * k_bytes);
      bulk_load(qs, p.q + q0, q_bytes, full);
      bulk_load(ks, p.k + k0, k_bytes, full);
      bulk_load(vs, p.v + k0, k_bytes, full);
    }
  } else {
    load_padded<DH, kThreads>(qs, p.q + q0, rq, tid);
    load_padded<DH, kThreads>(ks, p.k + k0, rk, tid);
    load_padded<DH, kThreads>(vs, p.v + k0, rk, tid);
  }
  for (int c = tid; c < rk; c += kThreads) {
    const int s = c / Sk, key = c - s * Sk;
    bias_s[c] = p.mask != nullptr && p.mask[(size_t)((tile0 + s) / p.H) * Sk + key] ? kMaskBias : 0.f;
  }
  __syncthreads();
  if constexpr (Row::kBulk) mbar_wait(full, 0);

  // 1. the scores of the slices' diagonal blocks (and with dropout their factors), four keys of one row an item
  const int groups = (Sk + 3) >> 2;
  for (int it = tid; it < rq * groups; it += kThreads) {
    const int r = it / groups, j0 = 4 * (it - r * groups);
    const int s = r / Sq, i = r - s * Sq;
    const float4* kr[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) kr[u] = reinterpret_cast<const float4*>(ks + (s * Sk + min(j0 + u, Sk - 1)) * DP);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    dot4<C>(reinterpret_cast<const float4*>(qs + r * DP), kr, acc, lane);
    float f[4];
    if (kDrop) f32_factors(p.drop, tile0 + s, i, j0, f);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + u;
      if (j >= Sk) continue;
      ps[r * Sk + j] = fmaf(acc[u], p.scale, bias_s[s * Sk + j]);
      if (kDrop) fs[r * Sk + j] = f[u];
    }
  }
  __syncthreads();

  // 2. a warp a row: its max, P and l (the undropped sum, lane 0's), the lse, P o D in place of the scores
  for (int r = warp; r < rq; r += kThreads / 32) {
    float* row = ps + r * Sk;
    float m = -INFINITY;
    for (int j = lane; j < Sk; j += 32) m = fmaxf(m, row[j]);
#pragma unroll
    for (int k = 16; k > 0; k >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, k));
    float l = 0.f;
    for (int j = lane; j < Sk; j += 32) {
      const float pr = mer_tiles::exp_of(row[j] - m);
      l += pr;
      row[j] = kDrop ? pr * fs[r * Sk + j] : pr;
    }
#pragma unroll
    for (int k = 16; k > 0; k >>= 1) l += __shfl_xor_sync(0xffffffffu, l, k);
    if (lane == 0) {
      p.lse[(size_t)tile0 * Sq + r] = m + logf(l);
      inv_s[r] = 1.f / l;
    }
  }
  __syncthreads();

  // 3. out = (P o D) V / l, a 16-byte chunk of a query row an item, the keys in order
  for (int it = tid; it < rq * C; it += kThreads) {
    const int r = it / C, c = it - r * C, s = r / Sq;
    const float* w = ps + r * Sk;
    const float4* vc = reinterpret_cast<const float4*>(vs + s * Sk * DP) + c;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < Sk; ++j) {
      const float a = w[j];
      const float4 x = vc[j * C];
      acc = make_float4(fmaf(a, x.x, acc.x), fmaf(a, x.y, acc.y), fmaf(a, x.z, acc.z), fmaf(a, x.w, acc.w));
    }
    const float il = inv_s[r];
    store_chunk<DH>(p.out + ((size_t)tile0 * Sq + r) * DH, c,
                    make_float4(acc.x * il, acc.y * il, acc.z * il, acc.w * il));
  }
}

template <typename Tag, int DH, bool kDrop>
cudaError_t launch_kernel(const Params<float>& p, cudaStream_t stream) {
  constexpr int DP = PaddedRow<DH>::kDp;
  const auto kernel = forward_kernel<Tag, DH, kDrop>;
  // above the default 48 KB of dynamic shared memory: the most any call asks (64 rows, 64 keys), raised once, before
  // any capture
  static const cudaError_t smem_ok = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                          smem_bytes(kRows, kRows, kRows, DP, kDrop));
  if (smem_ok != cudaSuccess) return smem_ok;
  const int rows = p.spt < p.BH ? p.spt : p.BH;
  const int bytes = smem_bytes(rows * p.Sq, rows * p.Sk, p.Sk, DP, kDrop);
  kernel<<<(p.BH + p.spt - 1) / p.spt, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename Tag, int DH>
cudaError_t launch(const Params<float>& p, cudaStream_t stream) {
  return p.drop.on ? launch_kernel<Tag, DH, true>(p, stream) : launch_kernel<Tag, DH, false>(p, stream);
}

}  // namespace f32_design

// Whether the stacked forward takes a call (dtype 0 = f32, 1 = bf16); `aligned`: q, k, v and out all 16-byte
// aligned. Mirrored by ops/flash_attention.py::_forward_route.
inline bool takes(int dtype, int Sq, int Sk, int Dh, bool aligned) {
  return takes_sizes<50, 96>(dtype, Sq, Sk, Dh) && aligned;
}

// One call (takes() holds), slices_per_tile's slices a tile.
template <typename Tag>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, const void* mask, void* out, void* lse,
                   int B, int H, int Sq, int Sk, int Dh, float scale, mer_philox::Dropout drop, cudaStream_t stream) {
  if (B * H <= 0) return cudaErrorInvalidValue;
  const int spt = slices_per_tile(dtype, B * H, Sq, Sk, drop.on, sm_count());
  const auto mask8 = static_cast<const uint8_t*>(mask);
  if (dtype == 1) {
    const Params<bf16> p{static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                         mask8, static_cast<bf16*>(out), static_cast<float*>(lse), B * H, H, Sq, Sk, spt, scale, drop};
    return Dh == 50 ? bf16_design::launch<Tag, 50>(p, stream) : bf16_design::launch<Tag, 96>(p, stream);
  }
  const Params<float> p{static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
                        mask8, static_cast<float*>(out), static_cast<float*>(lse), B * H, H, Sq, Sk, spt, scale, drop};
  return Dh == 50 ? f32_design::launch<Tag, 50>(p, stream) : f32_design::launch<Tag, 96>(p, stream);
}

}  // namespace mer_stacked_fwd
}  // namespace
