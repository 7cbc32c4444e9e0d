// The masked attention backward shared by K2 (flash_attention_bwd.cu) and K4
// (flash_attention_tiled_bwd.cu): two kernel templates on the tile frame of
// flash_attention_tiles.cuh. From the forward's inputs, out and lse and the
// cotangents g (of out) and g_lse (of lse, optional):
//
//   s     = scale (q k^T) + bias          bias = -1e30 on ignored keys
//   P     = exp(s - lse)                  (1/Sk on a fully masked row)
//   delta = rowsum(g o out) - g_lse
//   dP    = (g v^T) o D                   D = keep / (1 - rate), or 1
//   dS    = P o (dP - delta)
//   dq    = scale dS k,   dk = scale dS^T q,   dv = (P o D)^T g
//
// P o D and dS are rounded to the input dtype before their products (the
// rounding the forward makes for P.V); arithmetic is f32 otherwise, and dq,
// dk, dv come out in the input dtype. D is the Philox4x32-10 mask of (seed,
// b*H + h, row, column) (philox.cuh, one call per 2 x 2 scores) that the
// forwards draw.
//
// Fully masked rows. Each score of such a row rounds to -1e30 in f32, and so
// does -1e30 + log Sk, so exp(s - lse) gives 1 per key where the forward's
// softmax gave 1/Sk. lse < -1e29 marks the row and its P is 1/Sk, what the
// forward used (every s - m is 0).
//
// Layout: q, out, g, dq [B, H, Sq, Dh]; k, v, dk, dv [B, H, Sk, Dh],
// contiguous; mask [B, Sk] bytes, nonzero = ignore, or null; lse, g_lse
// [B, H, Sq] f32; delta [B, H, Sq] f32 scratch. Any Dh <= 128, any Sq, Sk.
//
// Design: the TPU's two grids. Hopper's blocks run in parallel, so where the
// TPU carries a sum across grid steps a block loops instead; no float atomics,
// so f32 training gives the same bits every run. A block is 4 warps of 16
// rows (or keys) and takes SPB (b*h) slices of 64 / SPB rows (or keys) each:
// SPB = 2 or 4 packs the short sequences (the fusion model's dialogues) so
// that no warp idles.
//
// 1. dq grid, a block per (SPB slices, 64 / SPB query rows of each). It
//    computes delta for its rows once (written to the scratch for pass 2),
//    then walks the keys in tiles of 64 / SPB a slice, K and V
//    double-buffered in shared memory with cp.async: S = q k^T and g v^T into
//    accumulator registers, P, D and dS there, and dq += dS k with dS as the
//    A operand.
// 2. dk/dv grid, a block per (SPB slices, 64 / SPB keys of each). It walks
//    the query rows in order in blocks of 64 / SPB a slice, q, g, lse and
//    delta double-buffered; per 16 rows S^T = k q^T and v g^T, then dv +=
//    (P o D)^T g and dk += dS^T q, the dk and dv rows held in registers
//    throughout.
//
// bf16 products run on the tensor cores (mma.sync.m16n8k16, f32
// accumulation), f32 ones as FMA on the CUDA cores.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention_tiles.cuh"
#include "philox.cuh"

// Internal linkage: K1 and K3 (K2 and K4) each build this header into a library of their
// own, and two such libraries in one process must not share a template's static (the
// once-raised shared-memory limit of each kernel).
namespace {
namespace mer_bwd {

using namespace mer_tiles;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlock = 16 * kWarps;  // rows (dq grid) or keys (dk/dv grid) a block, and a buffer's rows
constexpr int kMaxDh = 128;
using mer_tiles::kFullyMaskedLse;
using mer_tiles::kMaskBias;
constexpr int kDqScratchLd = kBlock + 4;   // f32 dS scratch row, dq grid
constexpr int kDkvScratchLd = 16 + 4;      // f32 P and dS scratch rows, dk/dv grid

struct Layout {
  int dh_pad, stride;
  size_t a_off, b_off, vec_off, scratch_off, bytes;
};

// dq grid: q, g [64][stride] (a), K, V tiles x 2 buffers (b), bias [2][64] + lse, delta [64] (vec);
// dk/dv grid: K, V [64][stride] (a), q, g blocks x 2 buffers (b), bias [64] + lse, delta [2][64] (vec);
// f32: a per-warp scratch for the probability operand
template <typename T>
__host__ __device__ Layout layout(int Dh, bool dq_grid) {
  Layout L;
  L.dh_pad = (Dh + 15) & ~15;
  L.stride = L.dh_pad + 16 / (int)sizeof(T);
  const size_t tile = (size_t)kBlock * L.stride * sizeof(T);
  L.a_off = 0;
  L.b_off = 2 * tile;
  L.vec_off = L.b_off + 4 * tile;
  L.scratch_off = L.vec_off + 5 * kBlock * sizeof(float);
  const size_t scratch = dq_grid ? (size_t)kWarps * 16 * kDqScratchLd : (size_t)kWarps * 16 * kDkvScratchLd;
  L.bytes = L.scratch_off + (sizeof(T) == 4 ? scratch * sizeof(float) : 0);
  return L;
}

__device__ __forceinline__ float key_bias(const uint8_t* mask, int b, int Sk, int key) {
  return (mask != nullptr && mask[(size_t)b * Sk + key]) ? kMaskBias : 0.f;
}

// softmax probability of a real key from its biased score and the row's lse
__device__ __forceinline__ float prob(float s_biased, float lse, float inv_sk) {
  return lse < kFullyMaskedLse ? inv_sk : exp_of(s_biased - lse);
}

// Kernel: a tag type named after the entry's source (flash_attention_bwd or
// flash_attention_tiled_bwd), so that a profile tells K2 from K4
template <typename Kernel, typename T, int ND, int SPB>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, const uint8_t* __restrict__ mask,
          const T* __restrict__ out, const float* __restrict__ lse, const T* __restrict__ g,
          const float* __restrict__ g_lse, T* __restrict__ dq, float* __restrict__ delta, int BH, int H, int Sq,
          int Sk, int Dh, float scale, mer_philox::Dropout drop, int vec) {
  constexpr int kSliceWarps = kWarps / SPB;
  constexpr int kSliceRows = 16 * kSliceWarps;  // query rows of a slice in this block
  constexpr int kKeys = kBlock / SPB;           // keys of a slice a tile
  constexpr int kKeyTiles = kKeys / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout<T>(Dh, true);
  const int kv_tile = kKeys * L.stride;  // one slice's K (or V) tile
  T* q_s = reinterpret_cast<T*>(smem + L.a_off);
  T* g_s = q_s + kBlock * L.stride;
  T* kv_s = reinterpret_cast<T*>(smem + L.b_off);               // [buffer][slice][K, V][keys][stride]
  float* bias_s = reinterpret_cast<float*>(smem + L.vec_off);  // [buffer][slice][keys]
  float* lse_s = bias_s + 2 * kBlock;                          // [slice][rows]
  float* delta_s = lse_s + kBlock;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g_row = lane >> 2, t = lane & 3;
  float* scratch = reinterpret_cast<float*>(smem + L.scratch_off) + warp * 16 * kDqScratchLd;

  const int bh0 = blockIdx.x * SPB;
  const int n_slices = min(SPB, BH - bh0);
  const int slice = warp / kSliceWarps;
  const int bh = bh0 + slice;
  const int q0 = blockIdx.y * kSliceRows;
  const int n_rows = min(kSliceRows, Sq - q0);

  zero_smem(smem, (int)L.vec_off, tid, kThreads);
  __syncthreads();
  for (int s = 0; s < n_slices; ++s) {
    const size_t off = ((size_t)(bh0 + s) * Sq + q0) * Dh;
    stage_rows(q_s + s * kSliceRows * L.stride, L.stride, q + off, n_rows, Dh, vec, tid, kThreads);
    stage_rows(g_s + s * kSliceRows * L.stride, L.stride, g + off, n_rows, Dh, vec, tid, kThreads);
  }

  const int n_tiles = (Sk + kKeys - 1) / kKeys;
  auto stage = [&](int tile, int buf) {
    const int k0 = tile * kKeys, n = min(kKeys, Sk - k0);
    for (int s = 0; s < n_slices; ++s) {
      T* k_dst = kv_s + (size_t)(buf * SPB + s) * 2 * kv_tile;
      const size_t src = ((size_t)(bh0 + s) * Sk + k0) * Dh;
      stage_rows(k_dst, L.stride, k + src, n, Dh, vec, tid, kThreads);
      stage_rows(k_dst + kv_tile, L.stride, v + src, n, Dh, vec, tid, kThreads);
    }
    if (tid < kBlock) {
      const int s = tid / kKeys, j = tid - s * kKeys;
      bias_s[buf * kBlock + tid] = (s < n_slices && j < n) ? key_bias(mask, (bh0 + s) / H, Sk, k0 + j) : 0.f;
    }
    cp_async_commit();
  };
  stage(0, 0);

  // the block's rows: lse, and delta = rowsum(g o out) - g_lse (kept for pass 2); two threads a row, all
  // rows at once (a row at a time a warp is a chain of load latencies that short sequences do not hide)
  static_assert(kThreads == 2 * kBlock, "two threads a row");
  {
    const int r = tid >> 1, half = tid & 1;
    const int s = r / kSliceRows, row = q0 + r - s * kSliceRows;
    const bool ok = s < n_slices && row < Sq;
    const size_t stat = (size_t)(bh0 + s) * Sq + row;
    float part = 0.f;
    if (ok) {
      const T* g_r = g + stat * Dh;
      const T* out_r = out + stat * Dh;
#pragma unroll 8
      for (int d = half; d < Dh; d += 2) part += to_f32(g_r[d]) * to_f32(out_r[d]);
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (half == 0) {
      const float dl = ok ? part - (g_lse != nullptr ? g_lse[stat] : 0.f) : 0.f;
      delta_s[r] = dl;
      lse_s[r] = ok ? lse[stat] : 0.f;
      if (ok) delta[stat] = dl;
    }
  }

  const int nd = L.dh_pad / 8;
  const int kdim = sizeof(T) == 2 ? L.dh_pad : Dh;
  const float inv_sk = 1.f / Sk;
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const int r_loc = 16 * warp + g_row;                    // this lane's rows in the block: r_loc, r_loc + 8
  const int row0 = q0 + r_loc - slice * kSliceRows;       // and in its slice
  const T* q_w = q_s + 16 * warp * L.stride;
  const T* g_w = g_s + 16 * warp * L.stride;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int buf = tile & 1;
    if (tile + 1 < n_tiles) {
      stage(tile + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile visible (and lse_s, delta_s, the first time)
    const T* k_t = kv_s + (size_t)(buf * SPB + slice) * 2 * kv_tile;
    const T* v_t = k_t + kv_tile;
    const float* bias = bias_s + buf * kBlock + slice * kKeys;
    const int k0 = tile * kKeys;
    const int n_keys = min(kKeys, Sk - k0);

    float s[kKeyTiles][4], dp[kKeyTiles][4];
#pragma unroll
    for (int n = 0; n < kKeyTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    gemm_nt<kKeyTiles>(s, q_w, k_t, L.stride, kdim, lane);
    gemm_nt<kKeyTiles>(dp, g_w, v_t, L.stride, kdim, lane);
#pragma unroll
    for (int n = 0; n < kKeyTiles; ++n) {
      float f[4];
      if (drop.on) mer_philox::factors(drop, bh, row0, k0 + 8 * n + 2 * t, false, f);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r_loc + 8 * (e >> 1), key = 8 * n + 2 * t + (e & 1);
        const float p = key < n_keys ? prob(fmaf(s[n][e], scale, bias[key]), lse_s[r], inv_sk) : 0.f;
        float dpe = dp[n][e];
        if (drop.on) dpe *= f[e];
        s[n][e] = p * (dpe - delta_s[r]);  // dS
      }
    }
    gemm_pv<kKeys / 16, ND>(acc, s, k_t, L.stride, nd, lane, scratch);
    __syncthreads();  // every warp is done with this buffer before it is staged again
  }

  if (slice >= n_slices) return;
  T* dq_bh = dq + (size_t)bh * Sq * Dh;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= Sq) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = 8 * n + 2 * t + c;
        if (d < Dh) dq_bh[(size_t)row * Dh + d] = from_f32<T>(acc[n][2 * h + c] * scale);
      }
  }
}

template <typename Kernel, typename T, int ND, int SPB>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const uint8_t* __restrict__ mask, const float* __restrict__ lse, const T* __restrict__ g,
           const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int BH, int H, int Sq, int Sk,
           int Dh, float scale, mer_philox::Dropout drop, int vec) {
  constexpr int kSliceWarps = kWarps / SPB;
  constexpr int kSliceKeys = 16 * kSliceWarps;  // keys of a slice in this block
  constexpr int kRows = kBlock / SPB;           // query rows of a slice a step
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout<T>(Dh, false);
  const int qg_tile = kRows * L.stride;  // one slice's q (or g) block
  T* k_s = reinterpret_cast<T*>(smem + L.a_off);
  T* v_s = k_s + kBlock * L.stride;
  T* qg_s = reinterpret_cast<T*>(smem + L.b_off);              // [buffer][slice][q, g][rows][stride]
  float* bias_s = reinterpret_cast<float*>(smem + L.vec_off);  // [slice][keys]
  float* lse_s = bias_s + kBlock;                              // [buffer][slice][rows]
  float* delta_s = lse_s + 2 * kBlock;                         // [buffer][slice][rows]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g_row = lane >> 2, t = lane & 3;
  // f32: P o D, then dS, in turn (gemm_pv frees it before it returns)
  float* scratch = reinterpret_cast<float*>(smem + L.scratch_off) + warp * 16 * kDkvScratchLd;

  const int bh0 = blockIdx.x * SPB;
  const int n_slices = min(SPB, BH - bh0);
  const int slice = warp / kSliceWarps;
  const int bh = bh0 + slice;
  const int k0 = blockIdx.y * kSliceKeys;
  const int n_keys = min(kSliceKeys, Sk - k0);

  zero_smem(smem, (int)L.vec_off, tid, kThreads);
  __syncthreads();
  for (int s = 0; s < n_slices; ++s) {
    const size_t off = ((size_t)(bh0 + s) * Sk + k0) * Dh;
    stage_rows(k_s + s * kSliceKeys * L.stride, L.stride, k + off, n_keys, Dh, vec, tid, kThreads);
    stage_rows(v_s + s * kSliceKeys * L.stride, L.stride, v + off, n_keys, Dh, vec, tid, kThreads);
  }
  if (tid < kBlock) {
    const int s = tid / kSliceKeys, j = tid - s * kSliceKeys;
    bias_s[tid] = (s < n_slices && j < n_keys) ? key_bias(mask, (bh0 + s) / H, Sk, k0 + j) : 0.f;
  }

  const int n_blocks = (Sq + kRows - 1) / kRows;
  auto stage = [&](int blk, int buf) {
    const int i0 = blk * kRows, n = min(kRows, Sq - i0);
    for (int s = 0; s < n_slices; ++s) {
      T* q_dst = qg_s + (size_t)(buf * SPB + s) * 2 * qg_tile;
      const size_t src = ((size_t)(bh0 + s) * Sq + i0) * Dh;
      stage_rows(q_dst, L.stride, q + src, n, Dh, vec, tid, kThreads);
      stage_rows(q_dst + qg_tile, L.stride, g + src, n, Dh, vec, tid, kThreads);
    }
    if (tid < kBlock) {
      const int s = tid / kRows, r = tid - s * kRows;
      const bool ok = s < n_slices && r < n;
      const size_t stat = (size_t)(bh0 + s) * Sq + i0 + r;
      lse_s[buf * kBlock + tid] = ok ? lse[stat] : 0.f;
      delta_s[buf * kBlock + tid] = ok ? delta[stat] : 0.f;
    }
    cp_async_commit();
  };
  stage(0, 0);  // with the K and V tiles in the same group

  const int nd = L.dh_pad / 8;
  const int kdim = sizeof(T) == 2 ? L.dh_pad : Dh;
  const float inv_sk = 1.f / Sk;
  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  const int j_loc = 16 * warp + g_row;              // this lane's keys in the block: j_loc, j_loc + 8
  const int j_in = j_loc - slice * kSliceKeys;      // and in its slice's keys
  const T* k_w = k_s + 16 * warp * L.stride;
  const T* v_w = v_s + 16 * warp * L.stride;

  for (int blk = 0; blk < n_blocks; ++blk) {
    const int buf = blk & 1;
    if (blk + 1 < n_blocks) {
      stage(blk + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* q_b = qg_s + (size_t)(buf * SPB + slice) * 2 * qg_tile;
    const T* g_b = q_b + qg_tile;
    const float* lse_b = lse_s + buf * kBlock + slice * kRows;
    const float* delta_b = delta_s + buf * kBlock + slice * kRows;
    const int i0 = blk * kRows;
    const int n_rows = min(kRows, Sq - i0);

    for (int r0 = 0; r0 < kRows; r0 += 16) {  // 16 query rows: one k-step of the dk, dv products
      if (r0 >= n_rows) break;
      float st[2][4], dpt[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
      gemm_nt<2>(st, k_w, q_b + r0 * L.stride, L.stride, kdim, lane);
      gemm_nt<2>(dpt, v_w, g_b + r0 * L.stride, L.stride, kdim, lane);
      float pd[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float f[4] = {1.f, 1.f, 1.f, 1.f};  // S^T: fragment rows are keys, columns query rows
        if (drop.on) mer_philox::factors(drop, bh, k0 + j_in, i0 + r0 + 8 * n + 2 * t, true, f);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j_loc + 8 * (e >> 1), r = r0 + 8 * n + 2 * t + (e & 1);
          const bool ok = j_in + 8 * (e >> 1) < n_keys && r < n_rows;
          const float p = ok ? prob(fmaf(st[n][e], scale, bias_s[j]), lse_b[r], inv_sk) : 0.f;
          pd[n][e] = p * f[e];
          st[n][e] = p * (dpt[n][e] * f[e] - delta_b[r]);  // dS^T
        }
      }
      gemm_pv<1, ND>(dv_acc, pd, g_b + r0 * L.stride, L.stride, nd, lane, scratch);
      gemm_pv<1, ND>(dk_acc, st, q_b + r0 * L.stride, L.stride, nd, lane, scratch);
    }
    __syncthreads();  // every warp is done with this buffer before it is staged again
  }

  if (slice >= n_slices) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = j_in + 8 * h;
    if (j >= n_keys) continue;
    const size_t row = ((size_t)bh * Sk + k0 + j) * Dh;
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = 8 * n + 2 * t + c;
        if (d < Dh) {
          dk[row + d] = from_f32<T>(dk_acc[n][2 * h + c] * scale);
          dv[row + d] = from_f32<T>(dv_acc[n][2 * h + c]);
        }
      }
  }
}

struct Args {
  const void *q, *k, *v, *mask, *out, *lse, *g, *g_lse;
  void *dq, *dk, *dv, *delta;
  int B, H, Sq, Sk, Dh;
  float scale;
  mer_philox::Dropout drop;
  int vec;
  cudaStream_t stream;
};

// above the default 48 KB of dynamic shared memory; raised once per
// instantiation for the largest head dim it takes, before any launch or capture
template <typename Kernel>
cudaError_t raise_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename Kernel, typename T, int ND, int SPB>
cudaError_t launch_dq(const Args& a) {
  static const cudaError_t smem_ok = raise_smem(dq_kernel<Kernel, T, ND, SPB>, layout<T>(8 * ND, true).bytes);
  if (smem_ok != cudaSuccess) return smem_ok;
  constexpr int kSliceRows = 16 * (kWarps / SPB);
  const dim3 grid((a.B * a.H + SPB - 1) / SPB, (a.Sq + kSliceRows - 1) / kSliceRows);
  dq_kernel<Kernel, T, ND, SPB><<<grid, kThreads, layout<T>(a.Dh, true).bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const uint8_t*>(a.mask), static_cast<const T*>(a.out), static_cast<const float*>(a.lse),
      static_cast<const T*>(a.g), static_cast<const float*>(a.g_lse), static_cast<T*>(a.dq),
      static_cast<float*>(a.delta), a.B * a.H, a.H, a.Sq, a.Sk, a.Dh, a.scale, a.drop, a.vec);
  return cudaGetLastError();
}

template <typename Kernel, typename T, int ND, int SPB>
cudaError_t launch_dkv(const Args& a) {
  static const cudaError_t smem_ok = raise_smem(dkv_kernel<Kernel, T, ND, SPB>, layout<T>(8 * ND, false).bytes);
  if (smem_ok != cudaSuccess) return smem_ok;
  constexpr int kSliceKeys = 16 * (kWarps / SPB);
  const dim3 grid((a.B * a.H + SPB - 1) / SPB, (a.Sk + kSliceKeys - 1) / kSliceKeys);
  dkv_kernel<Kernel, T, ND, SPB><<<grid, kThreads, layout<T>(a.Dh, false).bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const uint8_t*>(a.mask), static_cast<const float*>(a.lse), static_cast<const T*>(a.g),
      static_cast<const float*>(a.delta), static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.B * a.H, a.H, a.Sq, a.Sk,
      a.Dh, a.scale, a.drop, a.vec);
  return cudaGetLastError();
}

// The two grids of one call, in order on the stream. With kPack each grid
// packs 4 slices a block up to 16 rows (keys), 2 up to 32, else 1.
template <typename Kernel, typename T, int ND, bool kPack>
cudaError_t launch_grids(const Args& a) {
  cudaError_t err;
  if (kPack && a.Sq <= 16) err = launch_dq<Kernel, T, ND, kPack ? 4 : 1>(a);
  else if (kPack && a.Sq <= 32) err = launch_dq<Kernel, T, ND, kPack ? 2 : 1>(a);
  else err = launch_dq<Kernel, T, ND, 1>(a);
  if (err != cudaSuccess) return err;
  if (kPack && a.Sk <= 16) return launch_dkv<Kernel, T, ND, kPack ? 4 : 1>(a);
  if (kPack && a.Sk <= 32) return launch_dkv<Kernel, T, ND, kPack ? 2 : 1>(a);
  return launch_dkv<Kernel, T, ND, 1>(a);
}

// One backward call: checks the arguments (cudaErrorInvalidValue on what no
// instantiation takes), picks the head-dim instantiation and whether tiles
// take 16-byte copies, and launches both grids.
template <typename Kernel, bool kPack>
int launch(int dtype, Args a) {
  if (a.B <= 0 || a.H <= 0 || a.Sq <= 0 || a.Sk <= 0 || a.Dh <= 0 || a.Dh > kMaxDh || (a.Sq + 15) / 16 > 65535 ||
      (a.Sk + 15) / 16 > 65535 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const int esize = dtype == 0 ? 4 : 2;
  a.vec = (a.Dh * esize) % 16 == 0 && aligned(a.q) && aligned(a.k) && aligned(a.v) && aligned(a.g);
  cudaError_t err;
  if (dtype == 0)
    err = a.Dh <= 64 ? launch_grids<Kernel, float, 8, kPack>(a) : launch_grids<Kernel, float, kMaxDh / 8, kPack>(a);
  else
    err = a.Dh <= 64 ? launch_grids<Kernel, __nv_bfloat16, 8, kPack>(a)
                     : launch_grids<Kernel, __nv_bfloat16, kMaxDh / 8, kPack>(a);
  return static_cast<int>(err);
}

}  // namespace mer_bwd
}  // namespace
