// Long-sequence masked attention forward for Hopper (sm_90a), f32 and bf16:
// the streaming kernel K3.
//
// Replaces the TPU kernel mer_tpu/ops/flash_attention.py:424
// (`_stream_kernel`, launched at :470 from `_flash_stream`, taken by
// `_flash_impl` above STREAM_THRESHOLD = 4096 keys). It computes K1's
// function (flash_attention_fwd.cu) with an online softmax over key tiles:
//
//   s   = scale (q k^T) + bias,  bias = -1e30 on ignored keys, else 0
//   per key tile:  m' = max(m, rowmax s),  p = exp(s - m'),  a = exp(m - m')
//                  l = a l + rowsum p,      acc = a acc + (p o D) v
//   out = acc / max(l, 1e-30)   (q's dtype),   lse = m + log(max(l, 1e-30))  (f32)
//
// as :436-462 does, with the TPU kernel's rounding: p o D is rounded to v's
// dtype before the product with v (:453-455), l sums the unrounded p. D = 1
// without dropout; with it keep / (1 - rate), the keep bit Philox4x32-10 of
// (seed, b*H + h, row, column) (philox.cuh), the same mask K1, K2 and K4
// draw. The TPU kernel takes no dropout; the port's training path needs it
// here (the model's attention dropout at more than 4,096 frames).
//
// Layout: q [B, H, Sq, Dh], k/v [B, H, Sk, Dh], contiguous; mask [B, Sk] bytes,
// nonzero = ignore, or null; out like q; lse [B, H, Sq] f32. Any Dh <= 128 and
// any Sq, Sk: tiles are zero-padded in shared memory, never in device memory.
//
// Design. A block of 4 warps owns (b*h, 64 query rows), 16 rows a warp; it
// walks the keys in tiles of 64, each K/V tile staged in shared memory with
// cp.async into one of two buffers while the warps work on the other. The
// running max, sum and output rows stay in f32 registers in the layout of
// the mma.sync.m16n8k16 accumulator (flash_attention_tiles.cuh): a lane holds
// 2 rows x 16 of the tile's 64 scores and 2 rows x (Dh / 4) of the output. In
// bf16 both products run on the tensor cores (scores from q and k fragments;
// P.V with p's accumulator registers as the A operand, rounded to bf16, and
// V through ldmatrix.trans); in f32 they are FMA on the CUDA cores, no TF32.
// The mask bias is read per tile straight from the [B, Sk] mask; keys past Sk
// get -inf, so the zero-padded last tile adds nothing.
//
// Bound. At [2, 12, 8192, 8192, 64] bf16 one call moves q, k, v, out (25.2 MB
// each, 101 MB) and the lse (0.8 MB): 30 us at 3.35 TB/s; its two products
// are 4 x 2 x 12 x 8192^2 x 64 = 412 GFLOP, 0.42 ms at the dense bf16 peak of
// 989 TFLOP/s. Operations bound it. mma.sync reaches a fraction of that peak
// (wgmma, TMA, a producer warp and larger tiles are later work), and the
// exponentials (one per score) and, with dropout, ten Philox rounds per score
// ride on the CUDA cores beside it.

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
constexpr int kBlockQ = 16 * kWarps;  // 64 query rows a block
constexpr int kBlockK = 64;           // keys a tile
constexpr int kKeyTiles = kBlockK / 8;
constexpr int kMaxDh = 128;
constexpr int kScratchLd = kBlockK + 4;  // f32 P scratch row
constexpr float kMaskBias = -1e30f;      // as the TPU kernel's _NEG_INF

struct Layout {
  int dh_pad, stride;  // padded head dim, tile row stride (elements)
  size_t q_off, kv_off, bias_off, scratch_off, bytes;
};

template <typename T>
__host__ __device__ Layout layout(int Dh) {
  Layout L;
  L.dh_pad = (Dh + 15) & ~15;
  L.stride = L.dh_pad + 16 / (int)sizeof(T);
  const size_t tile = (size_t)kBlockK * L.stride * sizeof(T);
  L.q_off = 0;
  L.kv_off = (size_t)kBlockQ * L.stride * sizeof(T);
  L.bias_off = L.kv_off + 4 * tile;                    // [buffer][K, V] tiles
  L.scratch_off = L.bias_off + 2 * kBlockK * sizeof(float);
  L.bytes = L.scratch_off + (sizeof(T) == 4 ? (size_t)kWarps * 16 * kScratchLd * sizeof(float) : 0);
  return L;
}

// ND: n-tiles of 8 output columns a lane keeps (kMaxDh / 8 or half of it)
template <typename T, int ND>
__global__ void __launch_bounds__(kThreads)
flash_attention_stream_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                              const uint8_t* __restrict__ mask, T* __restrict__ out, float* __restrict__ lse,
                              int H, int Sq, int Sk, int Dh, float scale, mer_philox::Dropout drop, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout<T>(Dh);
  T* q_s = reinterpret_cast<T*>(smem + L.q_off);
  T* kv_s = reinterpret_cast<T*>(smem + L.kv_off);
  float* bias_s = reinterpret_cast<float*>(smem + L.bias_off);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  float* scratch = reinterpret_cast<float*>(smem + L.scratch_off) + warp * 16 * kScratchLd;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int q0 = blockIdx.y * kBlockQ;
  const T* k_bh = k + (size_t)bh * Sk * Dh;
  const T* v_bh = v + (size_t)bh * Sk * Dh;
  const int tile_elems = kBlockK * L.stride;

  // zero the tiles once: pad columns, rows past Sq and a short last key tile stay zero
  zero_smem(smem, (int)L.bias_off, tid, kThreads);
  __syncthreads();
  stage_rows(q_s, L.stride, q + ((size_t)bh * Sq + q0) * Dh, min(kBlockQ, Sq - q0), Dh, vec, tid, kThreads);

  const int n_tiles = (Sk + kBlockK - 1) / kBlockK;
  auto stage = [&](int tile, int buf) {
    const int k0 = tile * kBlockK, n = min(kBlockK, Sk - k0);
    T* k_dst = kv_s + 2 * buf * tile_elems;
    stage_rows(k_dst, L.stride, k_bh + (size_t)k0 * Dh, n, Dh, vec, tid, kThreads);
    stage_rows(k_dst + tile_elems, L.stride, v_bh + (size_t)k0 * Dh, n, Dh, vec, tid, kThreads);
    if (tid < kBlockK) {
      float bias = -INFINITY;  // past Sk: no weight at all
      if (tid < n) bias = (mask != nullptr && mask[(size_t)b * Sk + k0 + tid]) ? kMaskBias : 0.f;
      bias_s[buf * kBlockK + tid] = bias;
    }
    cp_async_commit();
  };
  stage(0, 0);  // with the q tile in the same group

  const int nd = L.dh_pad / 8;
  const int kdim = sizeof(T) == 2 ? L.dh_pad : Dh;
  float o[ND][4], m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  const int row0 = q0 + 16 * warp + g;  // this lane's rows: row0 and row0 + 8
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
    const T* k_t = kv_s + 2 * buf * tile_elems;
    const T* v_t = k_t + tile_elems;
    const float* bias = bias_s + buf * kBlockK;
    const int k0 = tile * kBlockK;

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
      alpha[h] = expf(m_run[h] - m_new);
      m_run[h] = m_new;
    }
#pragma unroll
    for (int n = 0; n < kKeyTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = expf(s[n][e] - m_run[e >> 1]);
        sum[e >> 1] += p;  // undropped and unrounded: l and lse as without dropout
        if (drop.on) p *= mer_philox::factor(drop, bh, row0 + 8 * (e >> 1), k0 + 8 * n + 2 * t + (e & 1));
        s[n][e] = p;
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
    gemm_pv<kBlockK / 16, ND>(o, s, v_t, L.stride, nd, lane, scratch);
    __syncthreads();  // every warp is done with this buffer before it is staged again
  }

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

template <typename T, int ND>
cudaError_t launch_nd(const void* q, const void* k, const void* v, const void* mask, void* out, void* lse,
                      int B, int H, int Sq, int Sk, int Dh, float scale, mer_philox::Dropout drop, int vec,
                      cudaStream_t stream) {
  // above the default 48 KB of dynamic shared memory; raised once per
  // instantiation for the largest head dim it takes, before any launch or capture
  static const cudaError_t smem_ok = cudaFuncSetAttribute(
      flash_attention_stream_kernel<T, ND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)layout<T>(8 * ND).bytes);
  if (smem_ok != cudaSuccess) return smem_ok;
  const dim3 grid(B * H, (Sq + kBlockQ - 1) / kBlockQ);
  flash_attention_stream_kernel<T, ND><<<grid, kThreads, layout<T>(Dh).bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), static_cast<float*>(lse), H, Sq, Sk, Dh, scale,
      drop, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* out, void* lse, int B,
                   int H, int Sq, int Sk, int Dh, float scale, mer_philox::Dropout drop, cudaStream_t stream) {
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const int vec = (Dh * (int)sizeof(T)) % 16 == 0 && aligned(q) && aligned(k) && aligned(v);
  if (Dh <= 64)
    return launch_nd<T, 8>(q, k, v, mask, out, lse, B, H, Sq, Sk, Dh, scale, drop, vec, stream);
  return launch_nd<T, kMaxDh / 8>(q, k, v, mask, out, lse, B, H, Sq, Sk, Dh, scale, drop, vec, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. dropout as in mer_flash_attention_fwd.
// Returns the cudaError_t of the launch.
extern "C" int mer_flash_attention_stream(int dtype, const void* q, const void* k, const void* v,
                                          const void* mask, void* out, void* lse, int B, int H, int Sq, int Sk,
                                          int Dh, float scale, int dropout, uint32_t seed0, uint32_t seed1,
                                          uint32_t threshold, float keep_scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || Dh <= 0 || Dh > kMaxDh || (Sq + kBlockQ - 1) / kBlockQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const mer_philox::Dropout drop{seed0, seed1, threshold, keep_scale, dropout};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch<float>(q, k, v, mask, out, lse, B, H, Sq, Sk, Dh, scale, drop, s));
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16>(q, k, v, mask, out, lse, B, H, Sq, Sk, Dh, scale, drop, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
