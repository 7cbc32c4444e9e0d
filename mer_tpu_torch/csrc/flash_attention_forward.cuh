// The masked attention forward shared by K1 (flash_attention_fwd.cu) and K3
// (flash_attention_stream.cu): one kernel template, an online softmax over
// key tiles with both products on the tile frame of flash_attention_tiles.cuh.
//
//   s   = scale (q k^T) + bias,  bias = -1e30 on ignored keys, else 0
//   per key tile:  m' = max(m, rowmax s),  p = exp(s - m'),  a = exp(m - m')
//                  l = a l + rowsum p,      acc = a acc + (p o D) v
//   out = acc / max(l, 1e-30)   (q's dtype),   lse = m + log(max(l, 1e-30))  (f32)
//
// p o D is rounded to v's dtype before the product with v (the TPU kernels'
// p.astype(v.dtype)); l sums the unrounded, undropped p, so the lse is that of
// the undropped scores and dropout acts on the normalised probabilities. D = 1
// without dropout; with it keep / (1 - rate), the keep bit Philox4x32-10 of
// (seed, b*H + h, row, column) (philox.cuh, one call per 2 x 2 scores), the
// mask every attention kernel and plain version draws. A fully masked row (every key -1e30) gets the mean
// of v, as softmax gives it.
//
// Layout: q [B, H, Sq, Dh], k/v [B, H, Sk, Dh], contiguous; mask [B, Sk] bytes,
// nonzero = ignore, or null; out like q; lse [B, H, Sq] f32. Any Dh <= 128 and
// any Sq, Sk: tiles are zero-padded in shared memory, never in device memory.
//
// A block of 4 warps, 16 query rows a warp, takes SPB (b*h) slices: SPB = 1
// gives one slice 64 rows and 64-key tiles; SPB = 2 or 4 give each slice 32 or
// 16 rows and 32- or 16-key tiles, so a short sequence (Sq <= 32: the fusion
// model's dialogues) fills every warp instead of a quarter of a 64-row tile,
// as the TPU kernel's bh_block packs slices into one grid step. Per buffer the
// block stages 64 key rows of K and of V in all (SPB slices x 64 / SPB keys)
// with cp.async, double-buffered, in the input dtype. The running max, sum and
// output rows stay in f32 registers in the mma.sync.m16n8k16 accumulator
// layout; in bf16 both products run on the tensor cores (the scores'
// registers become P's A operand, V enters through ldmatrix.trans), in f32 as
// FMA on the CUDA cores (bound by the f32 rate, 67 TFLOP/s). K1 and K3 take
// this template at head dims other than 64 (the fusion model's 96 and 50) and
// for tensors that are not 16-byte aligned; at 64 both launch the Hopper
// forwards of flash_attention_hopper.cuh (bf16 on wgmma, f32 in 3xTF32,
// bound at the TF32 rate, 495 TFLOP/s over three passes). Keys past Sk get a
// -inf bias, so the zero- or stale-padded last tile adds nothing.

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
namespace mer_fwd {

using namespace mer_tiles;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockRows = 16 * kWarps;  // query rows a block, over its slices
constexpr int kBlockKeys = 64;           // key rows a buffer, over the slices
constexpr int kMaxDh = 128;
constexpr int kScratchLd = kBlockKeys + 4;  // f32 P scratch row
constexpr float kMaskBias = -1e30f;         // as the TPU kernel's _NEG_INF

struct Layout {
  int dh_pad, stride;  // padded head dim, tile row stride (elements)
  size_t q_off, kv_off, bias_off, scratch_off, bytes;
};

template <typename T>
__host__ __device__ Layout layout(int Dh) {
  Layout L;
  L.dh_pad = (Dh + 15) & ~15;
  L.stride = L.dh_pad + 16 / (int)sizeof(T);
  const size_t tile = (size_t)kBlockKeys * L.stride * sizeof(T);
  L.q_off = 0;
  L.kv_off = (size_t)kBlockRows * L.stride * sizeof(T);
  L.bias_off = L.kv_off + 4 * tile;  // [buffer][slice][K, V][keys] tiles
  L.scratch_off = L.bias_off + 2 * kBlockKeys * sizeof(float);
  L.bytes = L.scratch_off + (sizeof(T) == 4 ? (size_t)kWarps * 16 * kScratchLd * sizeof(float) : 0);
  return L;
}

// Kernel: a tag type named after the entry's source (flash_attention_fwd or
// flash_attention_stream), so that a profile tells K1 from K3; ND: n-tiles of 8
// output columns a lane keeps (kMaxDh / 8 or half of it); SPB: (b*h) slices a block
template <typename Kernel, typename T, int ND, int SPB>
__global__ void __launch_bounds__(kThreads)
forward_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const uint8_t* __restrict__ mask, T* __restrict__ out, float* __restrict__ lse, int BH, int H,
               int Sq, int Sk, int Dh, float scale, mer_philox::Dropout drop, int vec) {
  constexpr int kSliceWarps = kWarps / SPB;
  constexpr int kSliceRows = 16 * kSliceWarps;  // query rows of a slice in this block
  constexpr int kKeys = kBlockKeys / SPB;       // keys of a slice a tile
  constexpr int kKeyTiles = kKeys / 8;          // n-tiles of scores a warp
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout<T>(Dh);
  T* q_s = reinterpret_cast<T*>(smem + L.q_off);
  T* kv_s = reinterpret_cast<T*>(smem + L.kv_off);
  float* bias_s = reinterpret_cast<float*>(smem + L.bias_off);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  float* scratch = reinterpret_cast<float*>(smem + L.scratch_off) + warp * 16 * kScratchLd;

  const int bh0 = blockIdx.x * SPB;
  const int n_slices = min(SPB, BH - bh0);
  const int slice = warp / kSliceWarps;
  const int bh = bh0 + slice;  // this warp's slice; past BH it computes on zeros and writes nothing
  const int q0 = blockIdx.y * kSliceRows;
  const int n_rows = min(kSliceRows, Sq - q0);
  const int tile_elems = kKeys * L.stride;  // one slice's K (or V) tile

  // zero the tiles once: pad columns, rows past Sq and a short first key tile stay zero
  zero_smem(smem, (int)L.bias_off, tid, kThreads);
  __syncthreads();
  for (int s = 0; s < n_slices; ++s)
    stage_rows(q_s + s * kSliceRows * L.stride, L.stride, q + ((size_t)(bh0 + s) * Sq + q0) * Dh, n_rows, Dh, vec,
               tid, kThreads);

  const int n_tiles = (Sk + kKeys - 1) / kKeys;
  auto stage = [&](int tile, int buf) {
    const int k0 = tile * kKeys, n = min(kKeys, Sk - k0);
    for (int s = 0; s < n_slices; ++s) {
      T* k_dst = kv_s + (size_t)(buf * SPB + s) * 2 * tile_elems;
      const size_t src = ((size_t)(bh0 + s) * Sk + k0) * Dh;
      stage_rows(k_dst, L.stride, k + src, n, Dh, vec, tid, kThreads);
      stage_rows(k_dst + tile_elems, L.stride, v + src, n, Dh, vec, tid, kThreads);
    }
    if (tid < kBlockKeys) {
      const int s = tid / kKeys, j = tid - s * kKeys;
      float bias = -INFINITY;  // past Sk: no weight at all
      if (j < n) bias = (s < n_slices && mask != nullptr && mask[(size_t)((bh0 + s) / H) * Sk + k0 + j]) ? kMaskBias : 0.f;
      bias_s[buf * kBlockKeys + tid] = bias;
    }
    cp_async_commit();
  };
  stage(0, 0);  // with the q tiles in the same group

  const int nd = L.dh_pad / 8;
  const int kdim = sizeof(T) == 2 ? L.dh_pad : Dh;
  float o[ND][4], m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  const int row0 = q0 + 16 * (warp % kSliceWarps) + g;  // this lane's rows: row0 and row0 + 8
  const T* q_w = q_s + 16 * warp * L.stride;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int buf = tile & 1;
    if (tile + 1 < n_tiles) {
      stage(tile + 1, buf ^ 1);  // read last in the previous iteration, released by its closing barrier
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* k_t = kv_s + (size_t)(buf * SPB + slice) * 2 * tile_elems;
    const T* v_t = k_t + tile_elems;
    const float* bias = bias_s + buf * kBlockKeys + slice * kKeys;
    const int k0 = tile * kKeys;

    float s[kKeyTiles][4];
#pragma unroll
    for (int n = 0; n < kKeyTiles; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    gemm_nt<kKeyTiles>(s, q_w, k_t, L.stride, kdim, lane);

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kKeyTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = fmaf(s[n][e], scale, bias[8 * n + 2 * t + (e & 1)]);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // the first tile holds key 0, so m is finite from then on
      const float m_new = fmaxf(m_run[h], quad_max(mx[h]));
      alpha[h] = exp_of(m_run[h] - m_new);
      m_run[h] = m_new;
    }
#pragma unroll
    for (int n = 0; n < kKeyTiles; ++n) {
      float f[4];
      if (drop.on) mer_philox::factors(drop, bh, row0, k0 + 8 * n + 2 * t, false, f);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp_of(s[n][e] - m_run[e >> 1]);
        sum[e >> 1] += p;  // undropped and unrounded: l and lse as without dropout
        if (drop.on) p *= f[e];
        s[n][e] = p;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_run[h] = l_run[h] * alpha[h] + quad_sum(sum[h]);
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    gemm_pv<kKeys / 16, ND>(o, s, v_t, L.stride, nd, lane, scratch);
    __syncthreads();  // every warp is done with this buffer before it is staged again
  }

  if (slice >= n_slices) return;
  T* out_bh = out + (size_t)bh * Sq * Dh;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= Sq) continue;
    const float l = fmaxf(l_run[h], 1e-30f);
    const float inv_l = 1.f / l;
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = 8 * n + 2 * t + c;
        if (d < Dh) out_bh[(size_t)row * Dh + d] = from_f32<T>(o[n][2 * h + c] * inv_l);
      }
    if (t == 0) lse[(size_t)bh * Sq + row] = m_run[h] + logf(l);
  }
}

template <typename Kernel, typename T, int ND, int SPB>
cudaError_t launch_nd(const void* q, const void* k, const void* v, const void* mask, void* out, void* lse, int B,
                      int H, int Sq, int Sk, int Dh, float scale, mer_philox::Dropout drop, int vec,
                      cudaStream_t stream) {
  // above the default 48 KB of dynamic shared memory; raised once per
  // instantiation for the largest head dim it takes, before any launch or capture
  static const cudaError_t smem_ok = cudaFuncSetAttribute(
      forward_kernel<Kernel, T, ND, SPB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)layout<T>(8 * ND).bytes);
  if (smem_ok != cudaSuccess) return smem_ok;
  constexpr int kSliceRows = 16 * (kWarps / SPB);
  const dim3 grid((B * H + SPB - 1) / SPB, (Sq + kSliceRows - 1) / kSliceRows);
  forward_kernel<Kernel, T, ND, SPB><<<grid, kThreads, layout<T>(Dh).bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), static_cast<float*>(lse), B * H, H, Sq, Sk, Dh,
      scale, drop, vec);
  return cudaGetLastError();
}

// One forward call with SPB slices a block: checks the arguments, picks the
// head-dim instantiation and whether tiles take 16-byte copies.
template <typename Kernel, typename T, int SPB>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* out, void* lse, int B,
                   int H, int Sq, int Sk, int Dh, float scale, mer_philox::Dropout drop, cudaStream_t stream) {
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const int vec = (Dh * (int)sizeof(T)) % 16 == 0 && aligned(q) && aligned(k) && aligned(v);
  if (Dh <= 64)
    return launch_nd<Kernel, T, 8, SPB>(q, k, v, mask, out, lse, B, H, Sq, Sk, Dh, scale, drop, vec, stream);
  return launch_nd<Kernel, T, kMaxDh / 8, SPB>(q, k, v, mask, out, lse, B, H, Sq, Sk, Dh, scale, drop, vec, stream);
}

// Rejects what no instantiation takes (cudaErrorInvalidValue); 0 if the call may launch.
inline cudaError_t check_args(int B, int H, int Sq, int Sk, int Dh) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || Dh <= 0 || Dh > kMaxDh || (Sq + 15) / 16 > 65535)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace mer_fwd
}  // namespace
