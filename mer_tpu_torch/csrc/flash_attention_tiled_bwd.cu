// Long-sequence masked attention backward for Hopper (sm_90a), f32 and bf16:
// the key-tiled kernel K4.
//
// Replaces the TPU kernels mer_tpu/ops/flash_attention.py:579
// (`_bwd_dkv_kernel`) and :624 (`_bwd_dq_kernel`), launched at :693 and :721
// from `_flash_bwd_tiled`, which `_flash_bwd_impl` takes above BWD_FUSED_MAX =
// 2048 keys. It computes K2's function (flash_attention_bwd.cu) for any Sk,
// from the forward's inputs, out and lse and the cotangents g (of out) and
// g_lse (of lse, optional):
//
//   s     = scale (q k^T) + bias          bias = -1e30 on ignored keys
//   P     = exp(s - lse)                  (1/Sk on a fully masked row)
//   delta = rowsum(g o out) - g_lse
//   dP    = (g v^T) o D                   D = keep / (1 - rate), or 1
//   dS    = P o (dP - delta)
//   dq    = scale dS k,   dk = scale dS^T q,   dv = (P o D)^T g
//
// P o D and dS are rounded to the input dtype before their products (the
// rounding K3 makes for P.V); arithmetic is f32 otherwise, and dq, dk, dv come
// out in the input dtype. D is the Philox4x32-10 mask of (seed, b*H + h, row,
// column) (philox.cuh) that K1, K2 and K3 draw.
//
// Fully masked rows. Each score of such a row rounds to -1e30 in f32, and so
// does -1e30 + log Sk, so exp(s - lse) gives 1 per key where the forward's
// softmax gave 1/Sk. lse < -1e29 marks the row and its P is 1/Sk, as K2 has
// it. The TPU kernel does not: its tiled backward takes exp(s - lse) = 1 there
// and gives that row's dk, dv Sk times the fused backward's (a standing
// difference, held by tests/test_torch_attention_long.py).
//
// Layout: q, out, g, dq [B, H, Sq, Dh]; k, v, dk, dv [B, H, Sk, Dh],
// contiguous; mask [B, Sk] bytes, nonzero = ignore, or null; lse, g_lse
// [B, H, Sq] f32; delta [B, H, Sq] f32 scratch. Any Dh <= 128, any Sq, Sk.
//
// Design: the TPU's two grids. Hopper's blocks run in parallel, so where the
// TPU carries a sum across grid steps a block loops instead; no float atomics,
// so f32 training gives the same bits every run.
//
// 1. dq grid, a block of 4 warps per (b*h, 64 query rows), 16 rows a warp.
//    It computes delta for its rows once (written to the scratch for pass 2),
//    then walks the keys in 64-key tiles, K and V double-buffered in shared
//    memory with cp.async: S = q k^T and g v^T into accumulator registers,
//    P, D and dS there, and dq += dS k with dS as the A operand.
// 2. dk/dv grid, a block of 4 warps per (b*h, 64 keys), 16 keys a warp. It
//    walks the query rows in order in blocks of 64, q, g, lse and delta
//    double-buffered; per 16 rows S^T = k q^T and v g^T, then dv += (P o D)^T
//    g and dk += dS^T q, the dk and dv rows held in registers throughout.
//
// bf16 products run on the tensor cores (mma.sync.m16n8k16, f32
// accumulation), f32 ones as FMA on the CUDA cores
// (flash_attention_tiles.cuh).
//
// Bound. At [2, 12, 4499, 4499, 64] bf16 (the 90 s clips' fine-tune step) one
// call reads q, k, v, out, g (6.9 MB each), lse and the mask and writes dq,
// dk, dv: about 55 MB, 16 us at 3.35 TB/s; its five products are 10 x 2 x 12
// x 4499^2 x 64 = 311 GFLOP, 0.31 ms at 989 TFLOP/s. Operations bound it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention_tiles.cuh"
#include "philox.cuh"

namespace {

using namespace mer_tiles;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQ = 16 * kWarps;  // dq grid: query rows a block; dk/dv grid: query rows a step
constexpr int kBlockK = 16 * kWarps;  // dk/dv grid: keys a block; dq grid: keys a tile
constexpr int kMaxDh = 128;
constexpr float kMaskBias = -1e30f;        // as the TPU kernel's _NEG_INF
constexpr float kFullyMaskedLse = -1e29f;  // lse below this: every key of the row ignored
constexpr int kDqScratchLd = kBlockK + 4;  // f32 dS scratch row, dq grid
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
  const size_t tile = (size_t)64 * L.stride * sizeof(T);
  L.a_off = 0;
  L.b_off = 2 * tile;
  L.vec_off = L.b_off + 4 * tile;
  L.scratch_off = L.vec_off + 5 * 64 * sizeof(float);
  const size_t scratch = dq_grid ? (size_t)kWarps * 16 * kDqScratchLd : (size_t)kWarps * 16 * kDkvScratchLd;
  L.bytes = L.scratch_off + (sizeof(T) == 4 ? scratch * sizeof(float) : 0);
  return L;
}

__device__ __forceinline__ float key_bias(const uint8_t* mask, int b, int Sk, int key) {
  return (mask != nullptr && mask[(size_t)b * Sk + key]) ? kMaskBias : 0.f;
}

// softmax probability of a real key from its biased score and the row's lse
__device__ __forceinline__ float prob(float s_biased, float lse, float inv_sk) {
  return lse < kFullyMaskedLse ? inv_sk : expf(s_biased - lse);
}

template <typename T, int ND>
__global__ void __launch_bounds__(kThreads)
tiled_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const uint8_t* __restrict__ mask, const T* __restrict__ out, const float* __restrict__ lse,
                    const T* __restrict__ g, const float* __restrict__ g_lse, T* __restrict__ dq,
                    float* __restrict__ delta, int H, int Sq, int Sk, int Dh, float scale,
                    mer_philox::Dropout drop, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout<T>(Dh, true);
  const int tile_elems = 64 * L.stride;
  T* q_s = reinterpret_cast<T*>(smem + L.a_off);
  T* g_s = q_s + tile_elems;
  T* kv_s = reinterpret_cast<T*>(smem + L.b_off);
  float* bias_s = reinterpret_cast<float*>(smem + L.vec_off);  // [2][64]
  float* lse_s = bias_s + 2 * kBlockK;
  float* delta_s = lse_s + kBlockQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g_row = lane >> 2, t = lane & 3;
  float* scratch = reinterpret_cast<float*>(smem + L.scratch_off) + warp * 16 * kDqScratchLd;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int q0 = blockIdx.y * kBlockQ;
  const size_t q_off = ((size_t)bh * Sq + q0) * Dh;
  const int n_rows = min(kBlockQ, Sq - q0);
  const T* k_bh = k + (size_t)bh * Sk * Dh;
  const T* v_bh = v + (size_t)bh * Sk * Dh;

  zero_smem(smem, (int)L.vec_off, tid, kThreads);
  __syncthreads();
  stage_rows(q_s, L.stride, q + q_off, n_rows, Dh, vec, tid, kThreads);
  stage_rows(g_s, L.stride, g + q_off, n_rows, Dh, vec, tid, kThreads);

  const int n_tiles = (Sk + kBlockK - 1) / kBlockK;
  auto stage = [&](int tile, int buf) {
    const int k0 = tile * kBlockK, n = min(kBlockK, Sk - k0);
    T* k_dst = kv_s + 2 * buf * tile_elems;
    stage_rows(k_dst, L.stride, k_bh + (size_t)k0 * Dh, n, Dh, vec, tid, kThreads);
    stage_rows(k_dst + tile_elems, L.stride, v_bh + (size_t)k0 * Dh, n, Dh, vec, tid, kThreads);
    if (tid < kBlockK) bias_s[buf * kBlockK + tid] = tid < n ? key_bias(mask, b, Sk, k0 + tid) : 0.f;
    cp_async_commit();
  };
  stage(0, 0);

  // the block's rows: lse, and delta = rowsum(g o out) - g_lse (kept for pass 2)
  for (int r = warp; r < kBlockQ; r += kWarps) {
    const int row = q0 + r;
    float part = 0.f;
    if (r < n_rows)
      for (int d = lane; d < Dh; d += 32) part += to_f32(g[q_off + (size_t)r * Dh + d]) * to_f32(out[q_off + (size_t)r * Dh + d]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
    if (lane == 0) {
      const size_t stat = (size_t)bh * Sq + row;
      const float dl = r < n_rows ? part - (g_lse != nullptr ? g_lse[stat] : 0.f) : 0.f;
      delta_s[r] = dl;
      lse_s[r] = r < n_rows ? lse[stat] : 0.f;
      if (r < n_rows) delta[stat] = dl;
    }
  }

  const int nd = L.dh_pad / 8;
  const int kdim = sizeof(T) == 2 ? L.dh_pad : Dh;
  const float inv_sk = 1.f / Sk;
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const int r_loc = 16 * warp + g_row;  // this lane's rows within the block: r_loc, r_loc + 8
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
    const T* k_t = kv_s + 2 * buf * tile_elems;
    const T* v_t = k_t + tile_elems;
    const float* bias = bias_s + buf * kBlockK;
    const int k0 = tile * kBlockK;
    const int n_keys = min(kBlockK, Sk - k0);

    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    gemm_nt<8>(s, q_w, k_t, L.stride, kdim, lane);
    gemm_nt<8>(dp, g_w, v_t, L.stride, kdim, lane);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r_loc + 8 * (e >> 1), key = 8 * n + 2 * t + (e & 1);
        const float p = key < n_keys ? prob(fmaf(s[n][e], scale, bias[key]), lse_s[r], inv_sk) : 0.f;
        float dpe = dp[n][e];
        if (drop.on) dpe *= mer_philox::factor(drop, bh, q0 + r, k0 + key);
        s[n][e] = p * (dpe - delta_s[r]);  // dS
      }
    gemm_pv<4, ND>(acc, s, k_t, L.stride, nd, lane, scratch);
    __syncthreads();  // every warp is done with this buffer before it is staged again
  }

  T* dq_blk = dq + q_off;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r_loc + 8 * h;
    if (r >= n_rows) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = 8 * n + 2 * t + c;
        if (d < Dh) dq_blk[(size_t)r * Dh + d] = from_f32<T>(acc[n][2 * h + c] * scale);
      }
  }
}

template <typename T, int ND>
__global__ void __launch_bounds__(kThreads)
tiled_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const uint8_t* __restrict__ mask, const float* __restrict__ lse, const T* __restrict__ g,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int H, int Sq,
                     int Sk, int Dh, float scale, mer_philox::Dropout drop, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout<T>(Dh, false);
  const int tile_elems = 64 * L.stride;
  T* k_s = reinterpret_cast<T*>(smem + L.a_off);
  T* v_s = k_s + tile_elems;
  T* qg_s = reinterpret_cast<T*>(smem + L.b_off);              // [buffer][q, g][64][stride]
  float* bias_s = reinterpret_cast<float*>(smem + L.vec_off);  // [64]
  float* lse_s = bias_s + kBlockK;                             // [2][64]
  float* delta_s = lse_s + 2 * kBlockQ;                        // [2][64]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g_row = lane >> 2, t = lane & 3;
  // f32: P o D, then dS, in turn (gemm_pv frees it before it returns)
  float* scratch = reinterpret_cast<float*>(smem + L.scratch_off) + warp * 16 * kDkvScratchLd;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int k0 = blockIdx.y * kBlockK;
  const int n_keys = min(kBlockK, Sk - k0);
  const size_t kv_off = ((size_t)bh * Sk + k0) * Dh;
  const T* q_bh = q + (size_t)bh * Sq * Dh;
  const T* g_bh = g + (size_t)bh * Sq * Dh;

  zero_smem(smem, (int)L.vec_off, tid, kThreads);
  __syncthreads();
  stage_rows(k_s, L.stride, k + kv_off, n_keys, Dh, vec, tid, kThreads);
  stage_rows(v_s, L.stride, v + kv_off, n_keys, Dh, vec, tid, kThreads);
  if (tid < kBlockK) bias_s[tid] = tid < n_keys ? key_bias(mask, b, Sk, k0 + tid) : 0.f;

  const int n_blocks = (Sq + kBlockQ - 1) / kBlockQ;
  auto stage = [&](int blk, int buf) {
    const int i0 = blk * kBlockQ, n = min(kBlockQ, Sq - i0);
    T* q_dst = qg_s + 2 * buf * tile_elems;
    stage_rows(q_dst, L.stride, q_bh + (size_t)i0 * Dh, n, Dh, vec, tid, kThreads);
    stage_rows(q_dst + tile_elems, L.stride, g_bh + (size_t)i0 * Dh, n, Dh, vec, tid, kThreads);
    if (tid < kBlockQ) {
      const bool ok = tid < n;
      lse_s[buf * kBlockQ + tid] = ok ? lse[(size_t)bh * Sq + i0 + tid] : 0.f;
      delta_s[buf * kBlockQ + tid] = ok ? delta[(size_t)bh * Sq + i0 + tid] : 0.f;
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
  const int j_loc = 16 * warp + g_row;  // this lane's keys within the tile: j_loc, j_loc + 8
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
    const T* q_b = qg_s + 2 * buf * tile_elems;
    const T* g_b = q_b + tile_elems;
    const float* lse_b = lse_s + buf * kBlockQ;
    const float* delta_b = delta_s + buf * kBlockQ;
    const int i0 = blk * kBlockQ;
    const int n_rows = min(kBlockQ, Sq - i0);

    for (int r0 = 0; r0 < kBlockQ; r0 += 16) {  // 16 query rows: one k-step of the dk, dv products
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
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j_loc + 8 * (e >> 1), r = r0 + 8 * n + 2 * t + (e & 1);
          const bool ok = j < n_keys && r < n_rows;
          const float p = ok ? prob(fmaf(st[n][e], scale, bias_s[j]), lse_b[r], inv_sk) : 0.f;
          const float f = (drop.on && ok) ? mer_philox::factor(drop, bh, i0 + r, k0 + j) : 1.f;
          pd[n][e] = p * f;
          st[n][e] = p * (dpt[n][e] * f - delta_b[r]);  // dS^T
        }
      gemm_pv<1, ND>(dv_acc, pd, g_b + r0 * L.stride, L.stride, nd, lane, scratch);
      gemm_pv<1, ND>(dk_acc, st, q_b + r0 * L.stride, L.stride, nd, lane, scratch);
    }
    __syncthreads();  // every warp is done with this buffer before it is staged again
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = j_loc + 8 * h;
    if (j >= n_keys) continue;
    const size_t row = kv_off + (size_t)j * Dh;
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

template <typename T, int ND>
cudaError_t launch_nd(const void* q, const void* k, const void* v, const void* mask, const void* out,
                      const void* lse, const void* g, const void* g_lse, void* dq, void* dk, void* dv, void* delta,
                      int B, int H, int Sq, int Sk, int Dh, float scale, mer_philox::Dropout drop, int vec,
                      cudaStream_t stream) {
  // above the default 48 KB of dynamic shared memory; raised once per
  // instantiation for the largest head dim it takes, before any launch or capture
  static const cudaError_t smem_ok = [] {
    cudaError_t err = cudaFuncSetAttribute(tiled_bwd_dq_kernel<T, ND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)layout<T>(8 * ND, true).bytes);
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(tiled_bwd_dkv_kernel<T, ND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)layout<T>(8 * ND, false).bytes);
  }();
  if (smem_ok != cudaSuccess) return smem_ok;
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* g_ = static_cast<const T*>(g);
  const uint8_t* mask_ = static_cast<const uint8_t*>(mask);
  const float* lse_ = static_cast<const float*>(lse);
  float* delta_ = static_cast<float*>(delta);
  tiled_bwd_dq_kernel<T, ND><<<dim3(B * H, (Sq + kBlockQ - 1) / kBlockQ), kThreads, layout<T>(Dh, true).bytes,
                               stream>>>(q_, k_, v_, mask_, static_cast<const T*>(out), lse_, g_,
                                         static_cast<const float*>(g_lse), static_cast<T*>(dq), delta_, H, Sq, Sk,
                                         Dh, scale, drop, vec);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tiled_bwd_dkv_kernel<T, ND><<<dim3(B * H, (Sk + kBlockK - 1) / kBlockK), kThreads, layout<T>(Dh, false).bytes,
                                stream>>>(q_, k_, v_, mask_, lse_, g_, delta_, static_cast<T*>(dk),
                                          static_cast<T*>(dv), H, Sq, Sk, Dh, scale, drop, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, const void* out, const void* lse,
                   const void* g, const void* g_lse, void* dq, void* dk, void* dv, void* delta, int B, int H, int Sq,
                   int Sk, int Dh, float scale, mer_philox::Dropout drop, cudaStream_t stream) {
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const int vec = (Dh * (int)sizeof(T)) % 16 == 0 && aligned(q) && aligned(k) && aligned(v) && aligned(g);
  if (Dh <= 64)
    return launch_nd<T, 8>(q, k, v, mask, out, lse, g, g_lse, dq, dk, dv, delta, B, H, Sq, Sk, Dh, scale, drop,
                           vec, stream);
  return launch_nd<T, kMaxDh / 8>(q, k, v, mask, out, lse, g, g_lse, dq, dk, dv, delta, B, H, Sq, Sk, Dh, scale,
                                  drop, vec, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. g_lse may be null (no lse cotangent);
// delta is f32 scratch of [B, H, Sq]. dropout as in mer_flash_attention_fwd.
// Returns the cudaError_t of the launches.
extern "C" int mer_flash_attention_tiled_bwd(int dtype, const void* q, const void* k, const void* v,
                                             const void* mask, const void* out, const void* lse, const void* g,
                                             const void* g_lse, void* dq, void* dk, void* dv, void* delta, int B,
                                             int H, int Sq, int Sk, int Dh, float scale, int dropout,
                                             uint32_t seed0, uint32_t seed1, uint32_t threshold, float keep_scale,
                                             void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || Dh <= 0 || Dh > kMaxDh || (Sq + kBlockQ - 1) / kBlockQ > 65535 ||
      (Sk + kBlockK - 1) / kBlockK > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const mer_philox::Dropout drop{seed0, seed1, threshold, keep_scale, dropout};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch<float>(q, k, v, mask, out, lse, g, g_lse, dq, dk, dv, delta, B, H, Sq, Sk, Dh,
                                          scale, drop, s));
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16>(q, k, v, mask, out, lse, g, g_lse, dq, dk, dv, delta, B, H, Sq,
                                                  Sk, Dh, scale, drop, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
