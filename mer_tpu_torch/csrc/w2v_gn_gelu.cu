// GroupNorm(512 groups of one channel) over time + exact GELU on a layer-0 conv
// output that something else computed, for Hopper (sm_90a), f32 and bf16:
// kernel K8 of the port.
//
// Replaces the TPU kernels mer_tpu/ops/w2v_conv_pallas.py:320
// (`_gn_stats_kernel`) and :335 (`_gn_apply_kernel`), launched from
// `gn_gelu_pallas` (:345). For an activation x [B, T, 512] in the compute dtype
// (float32 or bfloat16), channels last, and t_valid <= T:
//
//   sum, sq     = per (b, c) over the rows t < t_valid, of x and x^2, in f32
//   mean, var   = sum / t_valid, sq / t_valid - mean^2          (biased, one pass)
//   out[b,t,c]  = gelu((x - mean) * rsqrt(var + eps) * gamma[c] + beta[c])   every t < T
//
// Rows t >= t_valid stay out of the statistics and are still written (the TPU
// kernel's pad rows, which its caller slices off). The output is rounded to x's
// dtype once, after the GELU.
//
// Layout: x, out [B, T, 512], contiguous; gamma, beta [512] f32. Scratch:
// partial [B, n_tiles, 2, 512] f32 (per-tile sum and sum of squares), stats
// [B, 2, 512] f32 (mean, rstd). Any T: the ragged last tile is masked here,
// where the TPU wrapper pads the wave so that T divides its 1,024-row blocks.
//
// Design. No product, 3 passes over x: bound by bytes. GroupNorm needs every
// valid row of a clip before the first can be normalised, and blocks run in no
// order, so:
//
//   pass 1 (stats):   a block of 256 threads takes one (clip, tile of 128 rows).
//                     A thread owns one 16-byte run of channels (4 f32 or 8
//                     bf16) and walks every 2nd (f32) or 4th (bf16) row of the
//                     tile, so a warp reads 512 consecutive bytes; the row
//                     groups are then added in a fixed order through shared
//                     memory and the tile's sums go to its own slot of
//                     `partial`. No atomics.
//   finalize:         one thread per (clip, channel) adds the tiles' partials in
//                     tile order, in f64, and writes mean and rstd: the same
//                     bits every run.
//   pass 2 (apply):   the same walk: one 16-byte load, normalise, erff GELU,
//                     one 16-byte store.
//
// Bound. x is read twice and written once; the function's own count is one read
// and one write: at [32, 31999, 512] bf16 2 x 1.05 GB / 3.35 TB/s = 0.63 ms
// (f32 twice that), against which this design's third pass adds a half.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kC = 512;        // channels
constexpr int kThreads = 256;
constexpr int kTileT = 128;    // rows per block

template <typename T>
struct Vec;  // one 16-byte run of channels

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[8]) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[8]) {
    uint4 r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = r;
  }
};

__device__ __forceinline__ float gelu_exact(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752440f));
}

// grid (n_tiles, B): per-tile sum and sum of squares over the rows < t_valid.
template <typename T>
__global__ void __launch_bounds__(kThreads)
w2v_gn_stats_kernel(const T* __restrict__ x, int rows, int t_valid, float* __restrict__ partial) {
  constexpr int kN = Vec<T>::kN;
  constexpr int kLanes = kC / kN;            // threads across a row: 128 or 64
  constexpr int kGroups = kThreads / kLanes; // rows in flight: 2 or 4
  __shared__ float red_s[kGroups][2][kC];
  const int lane = threadIdx.x % kLanes, group = threadIdx.x / kLanes;
  const int t0 = blockIdx.x * kTileT;
  const int t1 = min(t0 + kTileT, t_valid);
  const T* src = x + ((size_t)blockIdx.y * rows) * kC + lane * kN;
  float sum[kN], sq[kN], v[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) sum[i] = sq[i] = 0.f;
  for (int t = t0 + group; t < t1; t += kGroups) {
    Vec<T>::load(src + (size_t)t * kC, v);
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      sum[i] += v[i];
      sq[i] = fmaf(v[i], v[i], sq[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    red_s[group][0][lane * kN + i] = sum[i];
    red_s[group][1][lane * kN + i] = sq[i];
  }
  __syncthreads();
  float* slot = partial + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * 2 * kC;
  for (int i = threadIdx.x; i < 2 * kC; i += kThreads) {
    float acc = 0.f;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) acc += red_s[g][i / kC][i % kC];
    slot[i] = acc;
  }
}

// grid B, block 512: thread c of clip b sums the tiles' partials in tile order.
__global__ void __launch_bounds__(kC)
w2v_gn_finalize_kernel(const float* __restrict__ partial, int n_tiles, int t_valid, float eps,
                       float* __restrict__ stats) {
  const int c = threadIdx.x;
  const float* p = partial + (size_t)blockIdx.x * n_tiles * 2 * kC + c;
  double sum = 0.0, sq = 0.0;
  for (int i = 0; i < n_tiles; ++i) {
    sum += (double)p[(size_t)i * 2 * kC];
    sq += (double)p[(size_t)i * 2 * kC + kC];
  }
  const double mean = sum / t_valid;
  const double var = fmax(sq / t_valid - mean * mean, 0.0);
  stats[(size_t)blockIdx.x * 2 * kC + c] = (float)mean;
  stats[(size_t)blockIdx.x * 2 * kC + kC + c] = (float)(1.0 / sqrt(var + (double)eps));
}

// grid (n_tiles, B): normalise, GELU and store every row < rows.
template <typename T>
__global__ void __launch_bounds__(kThreads)
w2v_gn_apply_kernel(const T* __restrict__ x, int rows, const float* __restrict__ stats,
                    const float* __restrict__ gamma, const float* __restrict__ beta, T* __restrict__ out) {
  constexpr int kN = Vec<T>::kN;
  constexpr int kLanes = kC / kN;
  constexpr int kGroups = kThreads / kLanes;
  const int lane = threadIdx.x % kLanes, group = threadIdx.x / kLanes;
  const int c = lane * kN;
  const float* st = stats + (size_t)blockIdx.y * 2 * kC;
  float mean[kN], rstd[kN], g[kN], b[kN], v[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    mean[i] = st[c + i];
    rstd[i] = st[kC + c + i];
    g[i] = gamma[c + i];
    b[i] = beta[c + i];
  }
  const int t0 = blockIdx.x * kTileT;
  const int t1 = min(t0 + kTileT, rows);
  const size_t base = ((size_t)blockIdx.y * rows) * kC + c;
  for (int t = t0 + group; t < t1; t += kGroups) {
    Vec<T>::load(x + base + (size_t)t * kC, v);
#pragma unroll
    for (int i = 0; i < kN; ++i) v[i] = gelu_exact(fmaf((v[i] - mean[i]) * rstd[i], g[i], b[i]));
    Vec<T>::store(out + base + (size_t)t * kC, v);
  }
}

template <typename T>
int launch(const void* x, const float* gamma, const float* beta, float* partial, float* stats, void* out, int B,
           int rows, int t_valid, int n_tiles, float eps, cudaStream_t stream) {
  const dim3 grid(n_tiles, B);
  w2v_gn_stats_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x), rows, t_valid, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  w2v_gn_finalize_kernel<<<B, kC, 0, stream>>>(partial, n_tiles, t_valid, eps, stats);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  w2v_gn_apply_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x), rows, stats, gamma, beta,
                                                        static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype 0 = float32, 1 = bfloat16 (x, out); gamma, beta, partial, stats f32.
// n_tiles must be ceil(rows / 128), the tiling `partial` was sized for. Returns
// the cudaError_t of the first launch that failed, or 0.
extern "C" int mer_w2v_gn_gelu(int dtype, const void* x, const void* gamma, const void* beta, void* partial,
                               void* stats, void* out, int B, int rows, int t_valid, int n_tiles, float eps,
                               void* stream) {
  if (B <= 0 || B > 65535 || rows <= 0 || t_valid <= 0 || t_valid > rows ||
      n_tiles != (rows + kTileT - 1) / kTileT || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  float* p = static_cast<float*>(partial);
  float* st = static_cast<float*>(stats);
  return dtype == 0 ? launch<float>(x, g, b, p, st, out, B, rows, t_valid, n_tiles, eps, s)
                    : launch<__nv_bfloat16>(x, g, b, p, st, out, B, rows, t_valid, n_tiles, eps, s);
}
