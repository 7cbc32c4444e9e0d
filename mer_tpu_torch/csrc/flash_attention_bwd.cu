// Masked multi-head attention backward for Hopper (sm_90a), f32 and bf16.
//
// Replaces the TPU kernel mer_tpu/ops/flash_attention.py:270 (`_bwd_kernel`,
// launched at :390 from `_flash_bwd_fused`), with its dropout branch. Given
// the forward's inputs, its out and lse, and the cotangents g (of out) and
// g_lse (of lse, optional):
//
//   s     = (q * scale) k^T + bias               bias = -1e30 on ignored keys
//   P     = exp(s - lse)                         (1/Sk on a fully masked row)
//   delta = rowsum(g o out) - g_lse
//   dP    = (g v^T) o D                          D = keep / (1 - rate), or 1
//   dS    = P o (dP - delta)
//   dq    = dS k * scale,  dk = dS^T q * scale,  dv = (P o D)^T g
//
// Arithmetic is f32 FMA; dq, dk, dv come out in the input dtype. D is drawn
// by the same Philox4x32-10 function of (seed, b*H + h, row, column) as the
// forward (philox.cuh), so the mask is regenerated exactly. Layout: q, out, g,
// dq [B, H, Sq, Dh]; k, v, dk, dv [B, H, Sk, Dh], contiguous; mask [B, Sk]
// bytes, nonzero = ignore, or null; lse, g_lse [B, H, Sq] f32. Any Dh <= 128
// (lanes past Dh masked), Sk <= 2048 as the TPU kernel's single-pass range
// (BWD_FUSED_MAX); any Sq.
//
// Fully masked rows. Recomputing P from the forward's lse fails on a row
// whose every key is ignored: each score rounds to -1e30 in f32 and so does
// -1e30 + log Sk, giving P = 1 per key where softmax gives 1/Sk. Such a row
// is the only one with lse near -1e30, so lse < -1e29 marks it and its P is
// set to 1/Sk, which is exactly what the forward used (every s - m is 0).
//
// Design. The TPU grid runs in order and accumulates dk, dv in VMEM across
// q-blocks; Hopper's blocks run in parallel, so the work is split in two
// grids on one stream, and no float atomics are used (f32 training
// reproduces from run to run):
//
// 1. dq pass, a block of 4 warps per (b*h, 16-query tile). Each warp owns 4
//    query rows; it computes their delta (written to a [B, H, Sq] f32
//    scratch) and loops over 32-key tiles staged in shared memory. Lane j
//    takes key j: the row's score and g.v_j (two Dh-long FMA chains, odd row
//    stride so 32 lanes hit 32 banks), P, D and dS; then dS_j is broadcast by
//    shuffle and each lane accumulates its dq dims d = lane + 32c.
// 2. dk/dv pass, a block of 4 warps per (b*h, 32-key tile). Each warp owns 8
//    keys and keeps their dk and dv rows in registers (lane = dims
//    lane + 32c); a loop over 32-row query chunks takes the place of the TPU
//    grid's q axis. Within a chunk lane i takes query row i: scores and g.v
//    against the warp's 8 keys, P, D, dS; then rows are summed in order,
//    each (P o D)_ij and dS_ij broadcast by shuffle.
//
// Bound. At the fusion model's training shape (B=32, H=8, Sq=Sk=33, Dh=96,
// bf16) one call reads q, k, v, g, out (1.6 MB each), lse and the mask, and
// writes dq, dk, dv: about 13 MB, 3.9 us at 3.35 TB/s; its five products are
// about 0.27 GFLOP, 0.3 us at the bf16 tensor-core peak. Memory sets the
// bound; at these sizes launch overhead and the f32 CUDA-core products
// dominate. Tensor-core products, TMA staging and one fused grid are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // dq pass: 16 query rows per block
constexpr int kBlockK = 32;                     // keys per tile, one per lane in the dq pass
constexpr int kKeysPerWarp = kBlockK / kWarps;  // dk/dv pass: 8 keys per warp
constexpr int kChunkQ = 32;                     // dk/dv pass: query rows per chunk, one per lane
constexpr int kMaxDh = 128;
constexpr int kDimsPerLane = kMaxDh / 32;
constexpr int kMaxSk = 2048;                    // as the TPU kernel's BWD_FUSED_MAX
constexpr float kMaskBias = -1e30f;             // as the TPU kernel's _NEG_INF
constexpr float kFullyMaskedLse = -1e29f;       // lse below this: every key of the row ignored

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// softmax probability of a real key from its biased score and the row's lse
__device__ __forceinline__ float prob(float s_biased, float lse, float inv_sk) {
  return lse < kFullyMaskedLse ? inv_sk : expf(s_biased - lse);
}

__device__ __forceinline__ float key_bias(const uint8_t* mask, int b, int Sk, int key) {
  return (mask != nullptr && mask[(size_t)b * Sk + key]) ? kMaskBias : 0.f;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const uint8_t* __restrict__ mask,
                              const T* __restrict__ out, const float* __restrict__ lse,
                              const T* __restrict__ g, const float* __restrict__ g_lse,
                              T* __restrict__ dq, float* __restrict__ delta,
                              int H, int Sq, int Sk, int Dh, float scale, mer_philox::Dropout drop) {
  extern __shared__ float smem[];
  const int kv_stride = Dh | 1;                // odd row stride: conflict-free key reads
  float* q_s = smem;                           // [kBlockQ, Dh], pre-scaled
  float* g_s = q_s + kBlockQ * Dh;             // [kBlockQ, Dh]
  float* k_s = g_s + kBlockQ * Dh;             // [kBlockK, kv_stride]
  float* v_s = k_s + kBlockK * kv_stride;      // [kBlockK, kv_stride]
  float* bias_s = v_s + kBlockK * kv_stride;   // [kBlockK]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int q0 = blockIdx.y * kBlockQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  const size_t q_off = (size_t)bh * Sq * Dh;
  const T* k_bh = k + (size_t)bh * Sk * Dh;
  const T* v_bh = v + (size_t)bh * Sk * Dh;

  const int q_elems = min(kBlockQ, Sq - q0) * Dh;
  for (int i = tid; i < kBlockQ * Dh; i += kThreads) {
    const bool ok = i < q_elems;
    q_s[i] = ok ? to_f32(q[q_off + (size_t)q0 * Dh + i]) * scale : 0.f;
    g_s[i] = ok ? to_f32(g[q_off + (size_t)q0 * Dh + i]) : 0.f;
  }

  // the warp's rows: lse, and delta = rowsum(g o out) - g_lse (kept for pass 2)
  float lse_r[kRowsPerWarp], delta_r[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + warp * kRowsPerWarp + r;
    const bool ok = row < Sq;
    float part = 0.f;
#pragma unroll
    for (int c = 0; c < kDimsPerLane; ++c) {
      const int d = lane + 32 * c;
      if (ok && d < Dh) part += to_f32(g[q_off + (size_t)row * Dh + d]) * to_f32(out[q_off + (size_t)row * Dh + d]);
    }
    const size_t stat = (size_t)bh * Sq + row;
    delta_r[r] = warp_sum(part) - ((ok && g_lse != nullptr) ? g_lse[stat] : 0.f);
    lse_r[r] = ok ? lse[stat] : 0.f;
    if (ok && lane == 0) delta[stat] = delta_r[r];
  }

  float acc[kRowsPerWarp][kDimsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kDimsPerLane; ++c) acc[r][c] = 0.f;

  const float inv_sk = 1.f / Sk;
  const float* q_w = q_s + warp * kRowsPerWarp * Dh;
  const float* g_w = g_s + warp * kRowsPerWarp * Dh;
  for (int k0 = 0; k0 < Sk; k0 += kBlockK) {
    const int n_keys = min(kBlockK, Sk - k0);
    __syncthreads();  // previous tile consumed (q_s, g_s written, first time)
    for (int i = tid; i < kBlockK * Dh; i += kThreads) {
      const int j = i / Dh, d = i - j * Dh;
      const bool ok = j < n_keys;
      k_s[j * kv_stride + d] = ok ? to_f32(k_bh[(size_t)k0 * Dh + i]) : 0.f;
      v_s[j * kv_stride + d] = ok ? to_f32(v_bh[(size_t)k0 * Dh + i]) : 0.f;
    }
    if (tid < kBlockK) bias_s[tid] = tid < n_keys ? key_bias(mask, b, Sk, k0 + tid) : 0.f;
    __syncthreads();

    // key `lane` against the warp's 4 rows: score (as the forward computes it) and g.v
    const float* k_row = k_s + lane * kv_stride;
    const float* v_row = v_s + lane * kv_stride;
    float s[kRowsPerWarp], dp[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = dp[r] = 0.f;
    for (int d = 0; d < Dh; ++d) {
      const float kd = k_row[d], vd = v_row[d];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        s[r] = fmaf(q_w[r * Dh + d], kd, s[r]);
        dp[r] = fmaf(g_w[r * Dh + d], vd, dp[r]);
      }
    }
    float ds[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float p = lane < n_keys ? prob(s[r] + bias_s[lane], lse_r[r], inv_sk) : 0.f;
      float dpr = dp[r];
      if (drop.on) dpr *= mer_philox::factor(drop, bh, q0 + warp * kRowsPerWarp + r, k0 + lane);
      ds[r] = p * (dpr - delta_r[r]);
    }

    // dq += dS k: dS_j broadcast by shuffle, one K read per lane and key feeds 4 rows
    for (int j = 0; j < n_keys; ++j) {
      const float* k_j = k_s + j * kv_stride;
      float kd[kDimsPerLane];
#pragma unroll
      for (int c = 0; c < kDimsPerLane; ++c) kd[c] = lane + 32 * c < Dh ? k_j[lane + 32 * c] : 0.f;
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float ds_j = __shfl_sync(0xffffffffu, ds[r], j);
#pragma unroll
        for (int c = 0; c < kDimsPerLane; ++c) acc[r][c] = fmaf(ds_j, kd[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + warp * kRowsPerWarp + r;
    if (row >= Sq) continue;
#pragma unroll
    for (int c = 0; c < kDimsPerLane; ++c) {
      const int d = lane + 32 * c;
      if (d < Dh) dq[q_off + (size_t)row * Dh + d] = from_f32<T>(acc[r][c] * scale);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, const uint8_t* __restrict__ mask,
                               const float* __restrict__ lse, const T* __restrict__ g,
                               const float* __restrict__ delta, T* __restrict__ dk,
                               T* __restrict__ dv, int H, int Sq, int Sk, int Dh, float scale,
                               mer_philox::Dropout drop) {
  extern __shared__ float smem[];
  const int stride = Dh | 1;                   // odd row stride: conflict-free row reads
  float* k_s = smem;                           // [kBlockK, stride]
  float* v_s = k_s + kBlockK * stride;         // [kBlockK, stride]
  float* q_s = v_s + kBlockK * stride;         // [kChunkQ, stride], pre-scaled
  float* g_s = q_s + kChunkQ * stride;         // [kChunkQ, stride]
  float* bias_s = g_s + kChunkQ * stride;      // [kBlockK]
  float* lse_s = bias_s + kBlockK;             // [kChunkQ]
  float* delta_s = lse_s + kChunkQ;            // [kChunkQ]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int k0 = blockIdx.y * kBlockK;
  const int n_keys = min(kBlockK, Sk - k0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int j0 = warp * kKeysPerWarp;          // the warp's first key within the tile

  const size_t kv_off = (size_t)bh * Sk * Dh + (size_t)k0 * Dh;
  const size_t q_off = (size_t)bh * Sq * Dh;
  for (int i = tid; i < kBlockK * Dh; i += kThreads) {
    const int j = i / Dh, d = i - j * Dh;
    const bool ok = j < n_keys;
    k_s[j * stride + d] = ok ? to_f32(k[kv_off + i]) : 0.f;
    v_s[j * stride + d] = ok ? to_f32(v[kv_off + i]) : 0.f;
  }
  if (tid < kBlockK) bias_s[tid] = tid < n_keys ? key_bias(mask, b, Sk, k0 + tid) : 0.f;

  float dk_acc[kKeysPerWarp][kDimsPerLane], dv_acc[kKeysPerWarp][kDimsPerLane];
#pragma unroll
  for (int jj = 0; jj < kKeysPerWarp; ++jj)
#pragma unroll
    for (int c = 0; c < kDimsPerLane; ++c) dk_acc[jj][c] = dv_acc[jj][c] = 0.f;

  const float inv_sk = 1.f / Sk;
  for (int i0 = 0; i0 < Sq; i0 += kChunkQ) {
    const int n_rows = min(kChunkQ, Sq - i0);
    __syncthreads();  // previous chunk consumed (k_s, v_s staged, first time)
    for (int i = tid; i < kChunkQ * Dh; i += kThreads) {
      const int r = i / Dh, d = i - r * Dh;
      const bool ok = r < n_rows;
      q_s[r * stride + d] = ok ? to_f32(q[q_off + (size_t)i0 * Dh + i]) * scale : 0.f;
      g_s[r * stride + d] = ok ? to_f32(g[q_off + (size_t)i0 * Dh + i]) : 0.f;
    }
    if (tid < kChunkQ) {
      const bool ok = tid < n_rows;
      lse_s[tid] = ok ? lse[(size_t)bh * Sq + i0 + tid] : 0.f;
      delta_s[tid] = ok ? delta[(size_t)bh * Sq + i0 + tid] : 0.f;
    }
    __syncthreads();

    // query row i0 + lane against the warp's 8 keys
    const float* q_row = q_s + lane * stride;
    const float* g_row = g_s + lane * stride;
    float s[kKeysPerWarp], dp[kKeysPerWarp];
#pragma unroll
    for (int jj = 0; jj < kKeysPerWarp; ++jj) s[jj] = dp[jj] = 0.f;
    for (int d = 0; d < Dh; ++d) {
      const float qd = q_row[d], gd = g_row[d];
#pragma unroll
      for (int jj = 0; jj < kKeysPerWarp; ++jj) {
        s[jj] = fmaf(qd, k_s[(j0 + jj) * stride + d], s[jj]);
        dp[jj] = fmaf(gd, v_s[(j0 + jj) * stride + d], dp[jj]);
      }
    }
    float pd[kKeysPerWarp], ds[kKeysPerWarp];
#pragma unroll
    for (int jj = 0; jj < kKeysPerWarp; ++jj) {
      const int key = j0 + jj;
      const bool ok = lane < n_rows && key < n_keys;
      const float p = ok ? prob(s[jj] + bias_s[key], lse_s[lane], inv_sk) : 0.f;
      const float f = (drop.on && ok) ? mer_philox::factor(drop, bh, i0 + lane, k0 + key) : 1.f;
      pd[jj] = p * f;
      ds[jj] = p * (dp[jj] * f - delta_s[lane]);
    }

    // sum over the chunk's rows in order: dv += (P o D)_ij g_i, dk += dS_ij q_i
    for (int i = 0; i < n_rows; ++i) {
      float gi[kDimsPerLane], qi[kDimsPerLane];
#pragma unroll
      for (int c = 0; c < kDimsPerLane; ++c) {
        const int d = lane + 32 * c;
        gi[c] = d < Dh ? g_s[i * stride + d] : 0.f;
        qi[c] = d < Dh ? q_s[i * stride + d] : 0.f;
      }
#pragma unroll
      for (int jj = 0; jj < kKeysPerWarp; ++jj) {
        const float pd_i = __shfl_sync(0xffffffffu, pd[jj], i);
        const float ds_i = __shfl_sync(0xffffffffu, ds[jj], i);
#pragma unroll
        for (int c = 0; c < kDimsPerLane; ++c) {
          dv_acc[jj][c] = fmaf(pd_i, gi[c], dv_acc[jj][c]);
          dk_acc[jj][c] = fmaf(ds_i, qi[c], dk_acc[jj][c]);  // q_s holds q * scale
        }
      }
    }
  }

#pragma unroll
  for (int jj = 0; jj < kKeysPerWarp; ++jj) {
    if (j0 + jj >= n_keys) continue;
    const size_t row = kv_off + (size_t)(j0 + jj) * Dh;
#pragma unroll
    for (int c = 0; c < kDimsPerLane; ++c) {
      const int d = lane + 32 * c;
      if (d < Dh) {
        dk[row + d] = from_f32<T>(dk_acc[jj][c]);
        dv[row + d] = from_f32<T>(dv_acc[jj][c]);
      }
    }
  }
}

size_t dq_smem(int Dh) { return sizeof(float) * (2 * kBlockQ * Dh + 2 * kBlockK * (Dh | 1) + kBlockK); }
size_t dkv_smem(int Dh) {
  return sizeof(float) * (2 * (kBlockK + kChunkQ) * (Dh | 1) + kBlockK + 2 * kChunkQ);
}

// Both passes may need more than the default 48 KB of dynamic shared memory
// (up to Dh = 128); raised once per dtype, before any launch or graph capture.
template <typename T>
cudaError_t allow_smem() {
  cudaError_t err = cudaFuncSetAttribute(flash_attention_bwd_dq_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_smem(kMaxDh));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(flash_attention_bwd_dkv_kernel<T>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dkv_smem(kMaxDh));
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, const void* out,
                   const void* lse, const void* g, const void* g_lse, void* dq, void* dk, void* dv,
                   void* delta, int B, int H, int Sq, int Sk, int Dh, float scale,
                   mer_philox::Dropout drop, cudaStream_t stream) {
  static const cudaError_t smem_ok = allow_smem<T>();
  if (smem_ok != cudaSuccess) return smem_ok;
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* g_ = static_cast<const T*>(g);
  const uint8_t* mask_ = static_cast<const uint8_t*>(mask);
  const float* lse_ = static_cast<const float*>(lse);
  float* delta_ = static_cast<float*>(delta);
  flash_attention_bwd_dq_kernel<T><<<dim3(B * H, (Sq + kBlockQ - 1) / kBlockQ), kThreads, dq_smem(Dh), stream>>>(
      q_, k_, v_, mask_, static_cast<const T*>(out), lse_, g_, static_cast<const float*>(g_lse),
      static_cast<T*>(dq), delta_, H, Sq, Sk, Dh, scale, drop);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_attention_bwd_dkv_kernel<T><<<dim3(B * H, (Sk + kBlockK - 1) / kBlockK), kThreads, dkv_smem(Dh), stream>>>(
      q_, k_, v_, mask_, lse_, g_, delta_, static_cast<T*>(dk), static_cast<T*>(dv), H, Sq, Sk, Dh,
      scale, drop);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. g_lse may be null (no lse cotangent);
// delta is f32 scratch of [B, H, Sq]. dropout as in mer_flash_attention_fwd.
// Returns the cudaError_t of the launches.
extern "C" int mer_flash_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                                       const void* mask, const void* out, const void* lse,
                                       const void* g, const void* g_lse, void* dq, void* dk,
                                       void* dv, void* delta, int B, int H, int Sq, int Sk, int Dh,
                                       float scale, int dropout, uint32_t seed0, uint32_t seed1,
                                       uint32_t threshold, float keep_scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || Sk > kMaxSk || Dh <= 0 || Dh > kMaxDh ||
      (Sq + kBlockQ - 1) / kBlockQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const mer_philox::Dropout drop{seed0, seed1, threshold, keep_scale, dropout};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch<float>(q, k, v, mask, out, lse, g, g_lse, dq, dk, dv, delta, B, H,
                                          Sq, Sk, Dh, scale, drop, s));
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16>(q, k, v, mask, out, lse, g, g_lse, dq, dk, dv, delta,
                                                  B, H, Sq, Sk, Dh, scale, drop, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
