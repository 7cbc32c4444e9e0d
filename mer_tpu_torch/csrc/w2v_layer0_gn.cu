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
// groups of one channel) over time, and the exact (erf) GELU. The output is
// rounded once, after the GELU.
//
// Layout: wave [B, L] T, contiguous; w [10, 512] T, tap-major; gamma, beta
// [512] f32; out [B, T0, 512] T. Scratch: partial [B, n_tiles, 65] f64 (per
// tile, the window moments below), stats [B, 2, 512] f32 (per channel the
// scale rstd * gamma and the shift beta - mean * scale), counters [B] int,
// zero on entry and left zero.
//
// Design. The function writes 512 values for every 5 samples it reads, so the
// work is the one write of `out`; nothing else of that size may touch device
// memory. GroupNorm needs all T0 frames of a clip before the first can be
// normalised, so two passes read the wave, and y never goes through memory:
//
//   pass 1 (stats):  y is linear in the 10 samples of its window s_t, so
//                    sum_t y = w . S and sum_t y^2 = w^T G w with S = sum_t
//                    s_t and G = sum_t s_t s_t^T: 65 window moments (10 sums,
//                    55 products) per clip, the same for all 512 channels. A
//                    block of 260 threads takes one (clip, tile of frames),
//                    its samples staged as f64, one thread per moment and
//                    frame group of 4, each product exact in f64 (two f32
//                    values), and writes the tile's 65
//                    f64 partials (groups added in a fixed order). No float
//                    atomics: each tile owns its slot. The last block of a
//                    clip to finish (an int counter per clip) adds the tiles'
//                    partials in f64, in tile order as four runs whose sums it
//                    adds in order, and forms each channel's mean and E[y^2]
//                    from them in f64: the scale and shift. The sums are the
//                    same from run to run.
//   pass 2 (apply):  a block of 256 threads per (clip, tile): 4 frame groups
//                    of 64 threads, each thread owning 8 channels (their 80
//                    taps, times the channels' scale, in registers); per frame
//                    every lane of a warp reads the same 10 samples from
//                    shared memory (a broadcast), accumulates from the shift
//                    in f32, applies the GELU and stores 8 channels: 16 bytes
//                    in bf16, a warp 512 contiguous bytes.
//
// Tiles of 32-256 frames: the wrapper picks the length from the grid
// (`ops/w2v_conv.py::conv_plan`) so that batch-2 calls fill the card. Frames
// t >= T0 of the last tile are never computed, so they stay out of the
// statistics; samples past L are never read.
//
// Bound. At the export batch [32, 160000] bf16 the function reads 10 MB and
// writes 32 x 31,999 x 512 x 2 B = 1.05 GB: about 0.31 ms at 3.35 TB/s, against
// 10.5 GFLOP of products, 0.16 ms at the 67 TFLOP/s of the f32 CUDA cores.
// Bound by bytes; the instruction stream of pass 2 (10 broadcast loads, 80
// FMA, 8 erff and a 16-byte store per frame and thread) is what it pays on
// top. Tensor cores have nothing to do here: the contraction is 10 long.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kC = 512;                                 // channels
constexpr int kTaps = 10;
constexpr int kStride = 5;
constexpr int kMoments = kTaps + kTaps * (kTaps + 1) / 2;  // 65: sums s_j, then products s_j s_k (j <= k)
constexpr int kStatGroups = 4;                           // frame groups of the stats pass
constexpr int kStatThreads = kMoments * kStatGroups;     // 260
constexpr int kVec = 8;                                  // channels a thread of the apply pass owns
constexpr int kApplyGroups = 4;                          // frame groups of the apply pass
constexpr int kApplyThreads = kApplyGroups * kC / kVec;  // 256
constexpr int kMaxTile = 256;                            // frames per block, at most
constexpr int kMaxWin = kStride * (kMaxTile - 1) + kTaps;  // samples a tile reads: 1,285

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float gelu_exact(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752440f));
}

// 8 channels' values from 16 (bf16) or 32 (f32) bytes
__device__ __forceinline__ void load8(const float* p, float (&v)[kVec]) {
  const float4 a = *reinterpret_cast<const float4*>(p), b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[kVec]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x, v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float (&v)[kVec]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[kVec]) {
  uint4 raw;
  uint32_t* w = reinterpret_cast<uint32_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = raw;
}

// The samples of tile blockIdx.x of clip blockIdx.y into win_s (f32, or f64 for the stats pass); returns the
// tile's frame count (<= tile).
template <typename T, typename S>
__device__ __forceinline__ int stage_tile(const T* __restrict__ wave, int L, int T0, int tile, S* win_s) {
  const int t0 = blockIdx.x * tile;
  const int n_frames = min(tile, T0 - t0);
  const int n_samples = kStride * (n_frames - 1) + kTaps;  // <= L - 5 t0: frame T0 - 1 ends inside the clip
  const T* src = wave + (size_t)blockIdx.y * L + (size_t)t0 * kStride;
  for (int i = threadIdx.x; i < n_samples; i += blockDim.x) win_s[i] = (S)to_f32(src[i]);
  __syncthreads();
  return n_frames;
}

// moment q: the sum of s_q (q < 10), else the sum of s_j s_k, (j, k) the (q - 10)-th pair j <= k in row order
__device__ __forceinline__ void moment_taps(int q, int& j, int& k) {
  j = q, k = -1;
  if (q < kTaps) return;
  int r = q - kTaps;
  for (j = 0; r >= kTaps - j; ++j) r -= kTaps - j;
  k = j + r;
}

// pass 1: grid (n_tiles, B), kStatThreads threads
template <typename T>
__global__ void __launch_bounds__(kStatThreads, 2)
w2v_layer0_stats_kernel(const T* __restrict__ wave, int L, int T0, int tile, const T* __restrict__ w,
                        const float* __restrict__ gamma, const float* __restrict__ beta, float eps,
                        double* __restrict__ partial, float* __restrict__ stats, int* __restrict__ counters) {
  __shared__ double win_s[kMaxWin];  // converted once: the products below take two f64 values each
  __shared__ double red[kStatGroups][kMoments];
  __shared__ double mom[kMoments];
  __shared__ int last;
  const int n_frames = stage_tile(wave, L, T0, tile, win_s);
  const int grp = threadIdx.x / kMoments, q = threadIdx.x - grp * kMoments;
  int j, k;
  moment_taps(q, j, k);
  double acc = 0.0;
  if (k < 0) {
    for (int i = grp; i < n_frames; i += kStatGroups) acc += win_s[kStride * i + j];
  } else {
    for (int i = grp; i < n_frames; i += kStatGroups) acc = fma(win_s[kStride * i + j], win_s[kStride * i + k], acc);
  }
  red[grp][q] = acc;
  __syncthreads();
  const int b = blockIdx.y;
  if (threadIdx.x < kMoments)
    partial[((size_t)b * gridDim.x + blockIdx.x) * kMoments + threadIdx.x] =
        ((red[0][threadIdx.x] + red[1][threadIdx.x]) + red[2][threadIdx.x]) + red[3][threadIdx.x];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&counters[b], 1) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;

  // the clip's last tile: its statistics, from every tile's partials in tile order
  __threadfence();
  {  // moment q over the tiles in tile order, as four runs of tiles (one a frame group), kBatch loads in flight
    constexpr int kBatch = 16;
    const int n = gridDim.x, lo = grp * n / kStatGroups, hi = (grp + 1) * n / kStatGroups;
    const double* p = partial + ((size_t)b * n + lo) * kMoments + q;
    double sum = 0.0;
    int i = 0;
    for (; i + kBatch <= hi - lo; i += kBatch) {
      double v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) v[u] = __ldcg(p + (size_t)(i + u) * kMoments);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) sum += v[u];
    }
    for (; i < hi - lo; ++i) sum += __ldcg(p + (size_t)i * kMoments);
    red[grp][q] = sum;
  }
  __syncthreads();
  if (threadIdx.x < kMoments) mom[threadIdx.x] = (((red[0][q] + red[1][q]) + red[2][q]) + red[3][q]) / T0;
  __syncthreads();
  for (int c = threadIdx.x; c < kC; c += kStatThreads) {
    double wc[kTaps];
#pragma unroll
    for (int t = 0; t < kTaps; ++t) wc[t] = (double)to_f32(w[t * kC + c]);
    double mean = 0.0, sq = 0.0;
#pragma unroll
    for (int t = 0; t < kTaps; ++t) mean = fma(wc[t], mom[t], mean);
    int m = kTaps;
#pragma unroll
    for (int t = 0; t < kTaps; ++t)
#pragma unroll
      for (int u = t; u < kTaps; ++u, ++m) sq = fma((t == u ? 1.0 : 2.0) * wc[t] * wc[u], mom[m], sq);
    const double var = fmax(sq - mean * mean, 0.0);
    const double scale = (double)gamma[c] / sqrt(var + (double)eps);
    stats[(size_t)b * 2 * kC + c] = (float)scale;
    stats[(size_t)b * 2 * kC + kC + c] = (float)((double)beta[c] - mean * scale);
  }
  if (threadIdx.x == 0) counters[b] = 0;
}

// pass 2: grid (n_tiles, B), kApplyThreads threads
template <typename T>
__global__ void __launch_bounds__(kApplyThreads)
w2v_layer0_apply_kernel(const T* __restrict__ wave, int L, int T0, int tile, const T* __restrict__ w,
                        const float* __restrict__ stats, T* __restrict__ out) {
  __shared__ float win_s[kMaxWin + 3];
  const int n_frames = stage_tile(wave, L, T0, tile, win_s);
  const int grp = threadIdx.x / (kC / kVec), c0 = kVec * (threadIdx.x % (kC / kVec));
  const float* st = stats + (size_t)blockIdx.y * 2 * kC;
  float scale[kVec], shift[kVec], wt[kTaps][kVec];
  load8(st + c0, scale);
  load8(st + kC + c0, shift);
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
    load8(w + t * kC + c0, wt[t]);
#pragma unroll
    for (int e = 0; e < kVec; ++e) wt[t][e] *= scale[e];
  }
  T* dst = out + ((size_t)blockIdx.y * T0 + (size_t)blockIdx.x * tile) * kC + c0;
  for (int i = grp; i < n_frames; i += kApplyGroups) {
    const float* s = win_s + kStride * i;
    float y[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) y[e] = shift[e];
#pragma unroll
    for (int t = 0; t < kTaps; ++t) {
      const float v = s[t];
#pragma unroll
      for (int e = 0; e < kVec; ++e) y[e] = fmaf(v, wt[t][e], y[e]);
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) y[e] = gelu_exact(y[e]);
    store8(dst + (size_t)i * kC, y);
  }
}

template <typename T>
int launch(const void* wave, const void* w, const float* gamma, const float* beta, double* partial, float* stats,
           void* out, int B, int L, int T0, int tile, int n_tiles, float eps, int* counters, cudaStream_t stream) {
  const dim3 grid(n_tiles, B);
  w2v_layer0_stats_kernel<T><<<grid, kStatThreads, 0, stream>>>(static_cast<const T*>(wave), L, T0, tile,
                                                                static_cast<const T*>(w), gamma, beta, eps, partial,
                                                                stats, counters);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  w2v_layer0_apply_kernel<T><<<grid, kApplyThreads, 0, stream>>>(static_cast<const T*>(wave), L, T0, tile,
                                                                 static_cast<const T*>(w), stats,
                                                                 static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype 0 = float32, 1 = bfloat16 (wave, w, out); gamma, beta, stats f32,
// partial f64 [B, n_tiles, 65], counters [B] int (zero on entry, left zero).
// tile (frames per block) is 1 .. 256 and n_tiles = ceil(T0 / tile), the
// tiling partial was sized for; w, stats and out 16-byte aligned. Two
// launches. Returns the cudaError_t of the first launch that failed, or 0.
extern "C" int mer_w2v_layer0_gn(int dtype, const void* wave, const void* w, const void* gamma, const void* beta,
                                 void* partial, void* stats, void* out, int B, int L, int T0, int tile, int n_tiles,
                                 float eps, void* counters, void* stream) {
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  if (B <= 0 || B > 65535 || L < kTaps || T0 != (L - kTaps) / kStride + 1 || tile < 1 || tile > kMaxTile ||
      n_tiles != (T0 + tile - 1) / tile || (dtype != 0 && dtype != 1) || !aligned(w) || !aligned(stats) ||
      !aligned(out) || counters == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  double* p = static_cast<double*>(partial);
  float* st = static_cast<float*>(stats);
  int* cnt = static_cast<int*>(counters);
  return dtype == 0 ? launch<float>(wave, w, g, b, p, st, out, B, L, T0, tile, n_tiles, eps, cnt, s)
                    : launch<__nv_bfloat16>(wave, w, g, b, p, st, out, B, L, T0, tile, n_tiles, eps, cnt, s);
}
