// Masked multi-head attention forward for Hopper (sm_90a), f32 and bf16.
//
// Replaces the TPU kernel mer_tpu/ops/flash_attention.py:72 (`_kernel`,
// launched from `_flash_impl`), single-pass branch, with its dropout branch
// (:86-115, mask :50-69):
//
//   s   = (q * 1/sqrt(Dh)) k^T + bias,  bias = -1e30 on ignored keys, else 0
//   lse = m + log(sum exp(s - m)),      m = row max of s        (f32)
//   out = (softmax(s) o D) v                                    (q's dtype)
//
// D = 1 without dropout; with it D = keep / (1 - rate), the keep bit drawn
// by Philox4x32-10 from (seed, b*H + h, row, column) (philox.cuh). Dropout
// acts on the normalised probabilities and the lse comes from the undropped
// ones, so in the online softmax acc += (exp(s - m) o D) v while
// l += sum exp(s - m), and out = acc / l.
//
// Layout: q [B, H, Sq, Dh], k/v [B, H, Sk, Dh], all contiguous; mask
// [B, Sk] bytes with nonzero = ignore (torch key_padding_mask), or null for
// none; out like q; lse [B, H, Sq] f32. Dh <= 128, any value: lanes past Dh
// are masked, never padded in memory. Every query row gets a real output.
//
// Design. One block of 4 warps per (b*h, 16-query tile). Key/value tiles of
// 32 keys are staged in shared memory as f32; each warp owns 4 query rows and
// keeps an online softmax (running max, sum and a 4-value slice of the output
// row per lane) across key tiles, so Sk has no cap. Scores: lane j takes key
// j of the tile, Dh-long dot products against the warp's 4 query rows
// broadcast from shared memory, 4 independent FMA chains per K read (the K
// tile's row stride is odd, so the 32 lanes hit 32 banks). P.V: each p_j is
// broadcast by shuffle and every lane accumulates its own output dims
// d = lane + 32c, one V read serving the 4 rows. All arithmetic is f32 FMA;
// the mask bias is read straight from the [B, Sk] mask, never broadcast in
// memory. With dropout each lane draws the keep bits of its key for the
// warp's 4 rows, 10 Philox rounds each.
//
// Bound. At the fusion model's main-path shape (B=32, H=8, Sq=Sk=33, Dh=96,
// bf16) one call moves about 6.5 MB (q, k, v, out at 1.6 MB each, lse, mask)
// and does about 0.11 GFLOP: a memory bound near 2 us at 3.35 TB/s, far below
// the compute line (the Philox integer work of dropout is not counted). At
// these sizes launch overhead dominates; tensor-core products (mma.sync /
// wgmma), TMA staging and wider tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // 16 query rows per block
constexpr int kBlockK = 32;                     // one key per lane
constexpr int kMaxDh = 128;
constexpr int kDimsPerLane = kMaxDh / 32;
constexpr float kMaskBias = -1e30f;             // as the TPU kernel's _NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const uint8_t* __restrict__ mask,
                           T* __restrict__ out, float* __restrict__ lse,
                           int H, int Sq, int Sk, int Dh, float scale, mer_philox::Dropout drop) {
  extern __shared__ float smem[];
  const int k_stride = Dh | 1;                 // odd row stride: conflict-free key reads
  float* q_s = smem;                           // [kBlockQ, Dh], pre-scaled
  float* k_s = q_s + kBlockQ * Dh;             // [kBlockK, k_stride]
  float* v_s = k_s + kBlockK * k_stride;       // [kBlockK, Dh]
  float* bias_s = v_s + kBlockK * Dh;          // [kBlockK]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int q0 = blockIdx.y * kBlockQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  const T* q_bh = q + (size_t)bh * Sq * Dh;
  const T* k_bh = k + (size_t)bh * Sk * Dh;
  const T* v_bh = v + (size_t)bh * Sk * Dh;

  // the q tile is one contiguous run of rows; rows past Sq read as zeros
  const int q_elems = min(kBlockQ, Sq - q0) * Dh;
  for (int i = tid; i < kBlockQ * Dh; i += kThreads)
    q_s[i] = i < q_elems ? to_f32(q_bh[(size_t)q0 * Dh + i]) * scale : 0.f;

  float m_run[kRowsPerWarp], l_run[kRowsPerWarp], acc[kRowsPerWarp][kDimsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kDimsPerLane; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = 0; k0 < Sk; k0 += kBlockK) {
    const int n_keys = min(kBlockK, Sk - k0);
    __syncthreads();  // previous tile fully consumed (and q_s written, first time)
    const int kv_elems = n_keys * Dh;
    for (int i = tid; i < kBlockK * Dh; i += kThreads) {
      const int j = i / Dh, d = i - j * Dh;
      const bool ok = i < kv_elems;
      k_s[j * k_stride + d] = ok ? to_f32(k_bh[(size_t)k0 * Dh + i]) : 0.f;
      v_s[i] = ok ? to_f32(v_bh[(size_t)k0 * Dh + i]) : 0.f;
    }
    if (tid < kBlockK) {
      float bias = -INFINITY;  // past Sk: no weight at all
      if (tid < n_keys) bias = (mask != nullptr && mask[(size_t)b * Sk + k0 + tid]) ? kMaskBias : 0.f;
      bias_s[tid] = bias;
    }
    __syncthreads();

    // scores of this warp's rows against key `lane`: one K read feeds 4 rows
    const float* k_row = k_s + lane * k_stride;
    const float* q_w = q_s + warp * kRowsPerWarp * Dh;
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
    for (int d = 0; d < Dh; ++d) {
      const float kd = k_row[d];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) s[r] = fmaf(q_w[r * Dh + d], kd, s[r]);
    }

    float p[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      s[r] += bias_s[lane];
      // the first tile always holds key 0, so m_new is finite from then on
      const float m_new = fmaxf(m_run[r], warp_max(s[r]));
      const float alpha = expf(m_run[r] - m_new);
      p[r] = expf(s[r] - m_new);
      l_run[r] = l_run[r] * alpha + warp_sum(p[r]);  // undropped: lse and l as without dropout
      m_run[r] = m_new;
#pragma unroll
      for (int c = 0; c < kDimsPerLane; ++c) acc[r][c] *= alpha;
      if (drop.on) p[r] *= mer_philox::factor(drop, bh, q0 + warp * kRowsPerWarp + r, k0 + lane);
    }

    // P.V: one V read per lane and key feeds 4 rows
    for (int j = 0; j < n_keys; ++j) {
      const float* v_row = v_s + j * Dh;
      float vd[kDimsPerLane];
#pragma unroll
      for (int c = 0; c < kDimsPerLane; ++c) vd[c] = lane + 32 * c < Dh ? v_row[lane + 32 * c] : 0.f;
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float pj = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
        for (int c = 0; c < kDimsPerLane; ++c) acc[r][c] = fmaf(pj, vd[c], acc[r][c]);
      }
    }
  }

  T* out_bh = out + (size_t)bh * Sq * Dh;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + warp * kRowsPerWarp + r;
    if (row >= Sq) continue;
    const float inv_l = 1.f / l_run[r];
#pragma unroll
    for (int c = 0; c < kDimsPerLane; ++c) {
      const int d = lane + 32 * c;
      if (d < Dh) out_bh[(size_t)row * Dh + d] = from_f32<T>(acc[r][c] * inv_l);
    }
    if (lane == 0) lse[(size_t)bh * Sq + row] = m_run[r] + logf(l_run[r]);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* out,
                   void* lse, int B, int H, int Sq, int Sk, int Dh, float scale,
                   mer_philox::Dropout drop, cudaStream_t stream) {
  const dim3 grid(B * H, (Sq + kBlockQ - 1) / kBlockQ);
  const size_t smem = sizeof(float) * (kBlockQ * Dh + kBlockK * (Dh | 1) + kBlockK * Dh + kBlockK);
  flash_attention_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), static_cast<float*>(lse),
      H, Sq, Sk, Dh, scale, drop);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. dropout: 0 = off; else the keep bit of
// each probability is Philox(seed0, seed1) >= threshold, kept ones scaled by
// keep_scale. Returns the cudaError_t of the launch.
extern "C" int mer_flash_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                       const void* mask, void* out, void* lse, int B, int H,
                                       int Sq, int Sk, int Dh, float scale, int dropout,
                                       uint32_t seed0, uint32_t seed1, uint32_t threshold,
                                       float keep_scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || Dh <= 0 || Dh > kMaxDh ||
      (Sq + kBlockQ - 1) / kBlockQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const mer_philox::Dropout drop{seed0, seed1, threshold, keep_scale, dropout};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch<float>(q, k, v, mask, out, lse, B, H, Sq, Sk, Dh, scale, drop, s));
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16>(q, k, v, mask, out, lse, B, H, Sq, Sk, Dh, scale, drop, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
