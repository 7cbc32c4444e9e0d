// wav2vec2 conv layer 0 + GroupNorm + GELU for Hopper (sm_90a), f32 and bf16:
// kernel K7 of the port.
//
// Replaces the TPU kernels mer_tpu/ops/w2v_conv_pallas.py:194
// (`_l0_stats_kernel`) and :214 (`_l0_apply_kernel`), launched from
// `layer0_gn_pallas` (:227). For a batch of waveforms [B, L] in the compute
// dtype T (float32 or bfloat16):
//
//   y[b, t, c]  = sum_j wave[b, 5 t + j] * w[j, c]        t < T0 = (L - 10) / 5 + 1
//   mean, var   = per (b, c) over exactly the T0 frames, var = E[y^2] - mean^2
//   out[b,t,c]  = gelu((y - mean) * rsqrt(var + eps) * gamma[c] + beta[c])
//
// which is conv1d(k = 10, stride 5, 1 -> 512 channels, no bias), GroupNorm(512
// groups of one channel) over time, and the exact (erf) GELU. The products and
// sums are f32 (the wave and the taps hold compute-dtype values), the
// statistics f32 partials summed in f64, and the output is rounded once, after
// the GELU.
//
// Layout: wave [B, L] T, contiguous; w [10, 512] T, tap-major; gamma, beta
// [512] f32; out [B, T0, 512] T. Scratch: partial [B, n_tiles, 2, 512] f32
// (per-tile sum and sum of squares), stats [B, 2, 512] f32 (mean, rstd).
//
// Design. The function writes 512 values for every 5 samples it reads, so the
// work is the one write of `out`; nothing else of that size may touch device
// memory. GroupNorm needs all T0 frames of a clip before the first can be
// normalised, so the conv is computed twice (10 multiply-adds an element,
// cheaper than a round trip of y through memory):
//
//   pass 1 (stats):    a block of 256 threads takes one (clip, tile of 256
//                      frames); the tile's 1,285 samples sit in shared memory,
//                      thread i keeps the taps of channels 2i, 2i + 1 in
//                      registers and walks the frames (every lane reads the
//                      same 10 samples: a broadcast), summing y and y^2, and
//                      writes its 4 sums to `partial`. No atomics: blocks run
//                      in no order, so each tile owns its slot.
//   finalize:          one thread per (clip, channel) adds the tiles' partials
//                      in tile order, in f64, and writes mean and rstd. The
//                      sums are the same from run to run.
//   pass 2 (apply):    the same walk, now normalising, GELU, and one store of
//                      2 channels per thread: a warp writes 64 consecutive
//                      channels of a frame (128 B in bf16, 256 B in f32).
//
// Frames t >= T0 of the last tile are never computed, so they stay out of the
// statistics; samples past L are never read.
//
// Bound. At the export batch [32, 160000] bf16 the function reads 10 MB and
// writes 32 x 31,999 x 512 x 2 B = 1.05 GB: about 0.31 ms at 3.35 TB/s, against
// 10.5 GFLOP of products (x 2 passes here), 0.3 ms at the 67 TFLOP/s of the f32
// CUDA cores. Bound by bytes; the instruction stream of pass 2 (10 shared
// loads, 20 FMA, two erff and the stores per frame and thread) is what this
// version pays on top. Tensor cores have nothing to do here: the contraction is
// 10 long.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kC = 512;                                 // channels
constexpr int kTaps = 10;
constexpr int kStride = 5;
constexpr int kThreads = kC / 2;                        // 2 channels per thread
constexpr int kTileT = 256;                             // frames per block
constexpr int kWin = kStride * (kTileT - 1) + kTaps;    // samples a tile reads: 1,285

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float gelu_exact(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752440f));
}

// The tile's samples into shared memory (zeros past L) and this thread's taps
// into registers; returns the number of frames of the tile (<= kTileT).
template <typename T>
__device__ __forceinline__ int stage_tile(const T* __restrict__ wave, int L, int T0, const T* __restrict__ w,
                                          float* win_s, float (&w0)[kTaps], float (&w1)[kTaps]) {
  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * kTileT;
  const T* clip = wave + (size_t)blockIdx.y * L;
  const int s0 = t0 * kStride;
  for (int i = tid; i < kWin; i += kThreads) win_s[i] = s0 + i < L ? to_f32(clip[s0 + i]) : 0.f;
#pragma unroll
  for (int j = 0; j < kTaps; ++j) {
    w0[j] = to_f32(w[j * kC + 2 * tid]);
    w1[j] = to_f32(w[j * kC + 2 * tid + 1]);
  }
  __syncthreads();
  return min(kTileT, T0 - t0);
}

__device__ __forceinline__ void conv_frame(const float* win, const float (&w0)[kTaps], const float (&w1)[kTaps],
                                           float& y0, float& y1) {
  y0 = 0.f;
  y1 = 0.f;
#pragma unroll
  for (int j = 0; j < kTaps; ++j) {
    const float s = win[j];
    y0 = fmaf(s, w0[j], y0);
    y1 = fmaf(s, w1[j], y1);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
w2v_layer0_stats_kernel(const T* __restrict__ wave, int L, int T0, const T* __restrict__ w,
                        float* __restrict__ partial) {
  __shared__ float win_s[kWin + 3];
  float w0[kTaps], w1[kTaps];
  const int n_frames = stage_tile(wave, L, T0, w, win_s, w0, w1);
  float sum0 = 0.f, sum1 = 0.f, sq0 = 0.f, sq1 = 0.f;
  for (int i = 0; i < n_frames; ++i) {
    float y0, y1;
    conv_frame(win_s + i * kStride, w0, w1, y0, y1);
    sum0 += y0;
    sum1 += y1;
    sq0 = fmaf(y0, y0, sq0);
    sq1 = fmaf(y1, y1, sq1);
  }
  float* slot = partial + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * 2 * kC + 2 * threadIdx.x;
  store2(slot, sum0, sum1);
  store2(slot + kC, sq0, sq1);
}

// grid B, block 512: thread c of clip b sums the tiles' partials in tile order.
__global__ void __launch_bounds__(kC)
w2v_layer0_finalize_kernel(const float* __restrict__ partial, int n_tiles, int T0, float eps,
                           float* __restrict__ stats) {
  const int c = threadIdx.x;
  const float* p = partial + (size_t)blockIdx.x * n_tiles * 2 * kC + c;
  double sum = 0.0, sq = 0.0;
  for (int i = 0; i < n_tiles; ++i) {
    sum += (double)p[(size_t)i * 2 * kC];
    sq += (double)p[(size_t)i * 2 * kC + kC];
  }
  const double mean = sum / T0;
  const double var = fmax(sq / T0 - mean * mean, 0.0);
  stats[(size_t)blockIdx.x * 2 * kC + c] = (float)mean;
  stats[(size_t)blockIdx.x * 2 * kC + kC + c] = (float)(1.0 / sqrt(var + (double)eps));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
w2v_layer0_apply_kernel(const T* __restrict__ wave, int L, int T0, const T* __restrict__ w,
                        const float* __restrict__ stats, const float* __restrict__ gamma,
                        const float* __restrict__ beta, T* __restrict__ out) {
  __shared__ float win_s[kWin + 3];
  float w0[kTaps], w1[kTaps];
  const int n_frames = stage_tile(wave, L, T0, w, win_s, w0, w1);
  const int c = 2 * threadIdx.x;
  const float* st = stats + (size_t)blockIdx.y * 2 * kC;
  const float mean0 = st[c], mean1 = st[c + 1];
  const float rstd0 = st[kC + c], rstd1 = st[kC + c + 1];
  const float g0 = gamma[c], g1 = gamma[c + 1], b0 = beta[c], b1 = beta[c + 1];
  T* dst = out + ((size_t)blockIdx.y * T0 + (size_t)blockIdx.x * kTileT) * kC + c;
  for (int i = 0; i < n_frames; ++i) {
    float y0, y1;
    conv_frame(win_s + i * kStride, w0, w1, y0, y1);
    y0 = fmaf((y0 - mean0) * rstd0, g0, b0);
    y1 = fmaf((y1 - mean1) * rstd1, g1, b1);
    store2(dst + (size_t)i * kC, gelu_exact(y0), gelu_exact(y1));
  }
}

template <typename T>
int launch(const void* wave, const void* w, const float* gamma, const float* beta, float* partial, float* stats,
           void* out, int B, int L, int T0, int n_tiles, float eps, cudaStream_t stream) {
  const dim3 grid(n_tiles, B);
  w2v_layer0_stats_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(wave), L, T0,
                                                            static_cast<const T*>(w), partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  w2v_layer0_finalize_kernel<<<B, kC, 0, stream>>>(partial, n_tiles, T0, eps, stats);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  w2v_layer0_apply_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(wave), L, T0,
                                                            static_cast<const T*>(w), stats, gamma, beta,
                                                            static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype 0 = float32, 1 = bfloat16 (wave, w, out); gamma, beta, partial, stats f32.
// n_tiles must be ceil(T0 / 256), the tiling `partial` was sized for. Returns the
// cudaError_t of the first launch that failed, or 0.
extern "C" int mer_w2v_layer0_gn(int dtype, const void* wave, const void* w, const void* gamma, const void* beta,
                                 void* partial, void* stats, void* out, int B, int L, int T0, int n_tiles,
                                 float eps, void* stream) {
  if (B <= 0 || B > 65535 || L < kTaps || T0 != (L - kTaps) / kStride + 1 ||
      n_tiles != (T0 + kTileT - 1) / kTileT || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  float* p = static_cast<float*>(partial);
  float* st = static_cast<float*>(stats);
  return dtype == 0 ? launch<float>(wave, w, g, b, p, st, out, B, L, T0, n_tiles, eps, s)
                    : launch<__nv_bfloat16>(wave, w, g, b, p, st, out, B, L, T0, n_tiles, eps, s);
}
