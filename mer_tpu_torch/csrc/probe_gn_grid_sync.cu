// A probe, not a kernel of the port: K8's function (GroupNorm of 512 groups of
// one channel over time + exact GELU, csrc/w2v_gn_gelu.cu) as one persistent
// cooperative grid, for Hopper (sm_90a), f32 and bf16. It tests whether K8's
// second read of x can come from L2 instead of HBM:
// python -m mer_tpu_torch.scripts.probe_gn_designs times it against K8.
//
// Design. The grid is every block the card holds at once (a cooperative
// launch); it walks the batch clip by clip:
//
//   statistics:  block j of G takes the valid rows [j tv / G, (j + 1) tv / G)
//                of the clip and walks them forwards, as K8's statistics grid
//                walks a tile (a thread owns a 16-byte run of channels), and
//                writes its sums to its slot of `partial`;
//   grid barrier;
//   finalize:    thread c of the grid (c < 512) adds the G partials of
//                channel c in block order, in f64: mean and rstd, the same
//                bits every run;
//   grid barrier;
//   apply:       block j takes the rows [j T / G, (j + 1) T / G) and walks
//                them backwards, from the rows its statistics pass read last
//                (an f32 clip, 65.5 MB, is larger than the 50 MB L2: its
//                tail is what is left there), and writes with streaming
//                stores (st.global.cs) so that the output does not evict the
//                clip.
//
// The arithmetic is K8's: sums in f32 (x^2 with a fused multiply-add), the
// row groups added in a fixed order, mean and the biased variance in f64, the
// output rounded to x's dtype once, after the GELU. Rows t >= t_valid stay
// out of the statistics and are still written.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kC = 512;  // channels
constexpr int kThreads = 256;

template <typename T>
struct Vec;  // one 16-byte run of channels

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 r = __ldcg(reinterpret_cast<const float4*>(p));
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[8]) {
    const uint4 r = __ldcg(reinterpret_cast<const uint4*>(p));
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
    __stcs(reinterpret_cast<uint4*>(p), r);
  }
};

__device__ __forceinline__ float gelu_exact(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752440f));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_grid_sync_kernel(const T* __restrict__ x, const float* __restrict__ gamma, const float* __restrict__ beta,
                    float* __restrict__ partial, float* __restrict__ stats, T* __restrict__ out, int B, int rows,
                    int t_valid, float eps) {
  constexpr int kN = Vec<T>::kN;
  constexpr int kLanes = kC / kN;             // threads across a row: 128 or 64
  constexpr int kGroups = kThreads / kLanes;  // rows in flight: 2 or 4
  __shared__ float red_s[kGroups][2][kC];
  cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x, j = blockIdx.x;
  const int lane = threadIdx.x % kLanes, group = threadIdx.x / kLanes;
  const int c = lane * kN;
  float g[kN], bt[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    g[i] = gamma[c + i];
    bt[i] = beta[c + i];
  }
  const int s0 = (int)((long long)t_valid * j / G), s1 = (int)((long long)t_valid * (j + 1) / G);
  const int a0 = (int)((long long)rows * j / G), a1 = (int)((long long)rows * (j + 1) / G);
  for (int b = 0; b < B; ++b) {
    const size_t base = (size_t)b * rows * kC + c;
    float sum[kN], sq[kN], v[kN];
#pragma unroll
    for (int i = 0; i < kN; ++i) sum[i] = sq[i] = 0.f;
    for (int t = s0 + group; t < s1; t += kGroups) {
      Vec<T>::load(x + base + (size_t)t * kC, v);
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        sum[i] += v[i];
        sq[i] = fmaf(v[i], v[i], sq[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      red_s[group][0][c + i] = sum[i];
      red_s[group][1][c + i] = sq[i];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < 2 * kC; i += kThreads) {
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < kGroups; ++q) acc += red_s[q][i / kC][i % kC];
      partial[(size_t)j * 2 * kC + i] = acc;
    }
    grid.sync();
    const int ch = j * kThreads + threadIdx.x;
    if (ch < kC) {
      double s = 0.0, s2 = 0.0;
      for (int k = 0; k < G; ++k) {
        s += (double)__ldcg(partial + (size_t)k * 2 * kC + ch);
        s2 += (double)__ldcg(partial + (size_t)k * 2 * kC + kC + ch);
      }
      const double mean = s / t_valid;
      const double var = fmax(s2 / t_valid - mean * mean, 0.0);
      stats[(size_t)b * 2 * kC + ch] = (float)mean;
      stats[(size_t)b * 2 * kC + kC + ch] = (float)(1.0 / sqrt(var + (double)eps));
    }
    grid.sync();
    float mean[kN], rstd[kN];
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      mean[i] = __ldcg(stats + (size_t)b * 2 * kC + c + i);
      rstd[i] = __ldcg(stats + (size_t)b * 2 * kC + kC + c + i);
    }
    for (int t = a1 - 1 - group; t >= a0; t -= kGroups) {
      Vec<T>::load(x + base + (size_t)t * kC, v);
#pragma unroll
      for (int i = 0; i < kN; ++i) v[i] = gelu_exact(fmaf((v[i] - mean[i]) * rstd[i], g[i], bt[i]));
      Vec<T>::store(out + base + (size_t)t * kC, v);
    }
    __syncthreads();  // red_s is refilled by the next clip's statistics
  }
}

template <typename T>
int blocks_per_sm() {
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, gn_grid_sync_kernel<T>, kThreads, 0);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

template <typename T>
int launch(const void* x, const void* gamma, const void* beta, void* partial, void* stats, void* out, int B,
           int rows, int t_valid, int grid, float eps, cudaStream_t stream) {
  void* args[] = {&x, &gamma, &beta, &partial, &stats, &out, &B, &rows, &t_valid, &eps};
  return static_cast<int>(
      cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(gn_grid_sync_kernel<T>), grid, kThreads, args, 0,
                                  stream));
}

}  // namespace

// The grid a cooperative launch may take on the current device: SMs x the
// blocks an SM holds at once (dtype 0 = float32, 1 = bfloat16), or a negative
// cudaError_t.
extern "C" int mer_probe_gn_grid_sync_blocks(int dtype) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const int per_sm = dtype == 0 ? blocks_per_sm<float>() : blocks_per_sm<__nv_bfloat16>();
  return per_sm <= 0 ? per_sm : per_sm * sms;
}

// x, out [B, rows, 512] (dtype 0 = float32, 1 = bfloat16); gamma, beta [512]
// f32; partial [grid, 2, 512] f32; stats [B, 2, 512] f32. grid at most
// mer_probe_gn_grid_sync_blocks(dtype). Returns the launch's cudaError_t.
extern "C" int mer_probe_gn_grid_sync(int dtype, const void* x, const void* gamma, const void* beta, void* partial,
                                      void* stats, void* out, int B, int rows, int t_valid, int grid, float eps,
                                      void* stream) {
  if (B <= 0 || rows <= 0 || t_valid <= 0 || t_valid > rows || grid <= 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(x, gamma, beta, partial, stats, out, B, rows, t_valid, grid, eps, s)
                    : launch<__nv_bfloat16>(x, gamma, beta, partial, stats, out, B, rows, t_valid, grid, eps, s);
}
