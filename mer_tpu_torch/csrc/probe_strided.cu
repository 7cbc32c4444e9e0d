// Lowering probes P for Hopper (sm_90a): the questions that
// scripts/probe_pallas_strided.py (:37, :88, :112) asks of Mosaic, asked of a
// CUDA card. That script decided the design of the wav2vec2 conv frontend's
// TPU kernels (strided row selection, the lane fold, the skinny tap GEMM, a
// grid-accumulated reduce); here each is a small kernel, one launch a probe,
// whose result the script mer_tpu_torch/scripts/probe_strided.py checks
// exactly against torch (the bf16 product to rtol 1e-3, as :96 does).
//
// x is [T, C] f32 row-major, out as each probe says:
//   0 even rows    out [T/2, C]   = x[0::2]
//   1 odd rows     out [T/2, C]   = x[1::2]
//   2 fold         out [T/2, 2C]  = x.reshape(T/2, 2C): a row pair side by side
//   3 unfold       out [2T, C/2]  = x.reshape(2T, C/2): a row split in halves
//   4 skinny GEMM  out [T, C] f32 = bf16(x[:, :16]) @ w, w [16, C] bf16, on
//                  mma.sync.m16n8k16
//   5 reduce       out [1, C]     = x.sum(0) over 4 chunks of T/4 rows taken
//                  in order: blocks run in no order, so the TPU's sequential
//                  grid axis becomes runs of rows inside a block, added in
//                  order (f32 sums of integers below 2^24: exact)
//
// Bound: a probe reads what its out needs once (all of x, 512 KB at [256,
// 512], for 2, 3 and 5; half of its rows for 0 and 1; x[:, :16] and w for
// 4) and writes out once: under 0.4 us at 3.35 TB/s; at this size launch
// latency is the time (mer_probe_launch_floor times an empty kernel beside
// the probes). So each probe spreads its work over many threads with short
// dependent chains:
//   0-3: a thread per element of out, 128 a block (16-byte accesses and
//        several rows a block measured no faster on an H100);
//   4:   a warp per 16 x 8 tile of out, one mma (4-warp blocks with W staged
//        in shared memory and read by ldmatrix.trans measured slower);
//   5:   a block of 16 warps per 32 columns: warp r sums the r-th run of
//        consecutive rows (independent loads, unrolled), the 16 partials
//        added in run order in shared memory (a thread a column summing all
//        T rows was 5 times slower).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kReduceSteps = 4;  // the TPU probe's grid of 4
constexpr int kRuns = 16;        // reduce: row runs (warps) a block

__global__ void rows_kernel(const float* __restrict__ x, float* __restrict__ out, int T, int C, int odd) {
  const int i = blockIdx.y, c = blockIdx.x * kThreads + threadIdx.x;
  if (c < C) out[(size_t)i * C + c] = x[(size_t)(2 * i + odd) * C + c];
}

// fold (2): out[i][j] = x[2 i + j / C][j % C]; unfold (3): out[i][j] = x[i / 2][(i % 2) (C / 2) + j]
__global__ void fold_kernel(const float* __restrict__ x, float* __restrict__ out, int T, int C, int unfold) {
  const int i = blockIdx.y, j = blockIdx.x * kThreads + threadIdx.x;
  const int width = unfold ? C / 2 : 2 * C;
  if (j >= width) return;
  const float v = unfold ? x[(size_t)(i / 2) * C + (i % 2) * (C / 2) + j] : x[(size_t)(2 * i + j / C) * C + j % C];
  out[(size_t)i * width + j] = v;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_pair(const __nv_bfloat16* w, int k, int C, int n) {
  __nv_bfloat162 v;
  v.x = w[(size_t)k * C + n];
  v.y = w[(size_t)(k + 1) * C + n];
  return *reinterpret_cast<const uint32_t*>(&v);
}

// one warp a 16 x 8 tile of out; T a multiple of 16, C of 8
__global__ void skinny_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                              float* __restrict__ out, int T, int C) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.y * 16, n0 = blockIdx.x * 8;
  const float* x0 = x + (size_t)(r0 + g) * C + 2 * t;
  const float* x1 = x0 + (size_t)8 * C;
  const uint32_t a0 = pack_bf16(x0[0], x0[1]), a1 = pack_bf16(x1[0], x1[1]);
  const uint32_t a2 = pack_bf16(x0[8], x0[9]), a3 = pack_bf16(x1[8], x1[9]);
  const uint32_t b0 = pack_pair(w, 2 * t, C, n0 + g), b1 = pack_pair(w, 2 * t + 8, C, n0 + g);
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  float* o0 = out + (size_t)(r0 + g) * C + n0 + 2 * t;
  float* o1 = o0 + (size_t)8 * C;
  o0[0] = c[0];
  o0[1] = c[1];
  o1[0] = c[2];
  o1[1] = c[3];
}

// a block of kRuns warps per 32 columns; run r covers rows [r T / kRuns, (r + 1) T / kRuns)
__global__ void reduce_kernel(const float* __restrict__ x, float* __restrict__ out, int T, int C) {
  __shared__ float part[kRuns][32];
  const int run = threadIdx.x >> 5, lane = threadIdx.x & 31, c = blockIdx.x * 32 + lane;
  const int begin = (int)((long long)run * T / kRuns), end = (int)((long long)(run + 1) * T / kRuns);
  float acc = 0.f;
  if (c < C) {
    int row = begin;
    for (; row + 4 <= end; row += 4) {
      const float v0 = __ldg(x + (size_t)row * C + c), v1 = __ldg(x + (size_t)(row + 1) * C + c);
      const float v2 = __ldg(x + (size_t)(row + 2) * C + c), v3 = __ldg(x + (size_t)(row + 3) * C + c);
      acc += v0;
      acc += v1;
      acc += v2;
      acc += v3;
    }
    for (; row < end; ++row) acc += __ldg(x + (size_t)row * C + c);
  }
  part[run][lane] = acc;
  __syncthreads();
  if (run == 0 && c < C) {
    float total = part[0][lane];
#pragma unroll
    for (int r = 1; r < kRuns; ++r) total += part[r][lane];  // the runs, and so the four chunks, in order
    out[c] = total;
  }
}

__global__ void empty_kernel() {}

}  // namespace

// probe as in the header; w only for probe 4. T even (probes 0-3), a multiple
// of 16 (4) or of 4 (5); C even (3), a multiple of 8 (4). Returns the
// cudaError_t of the launch.
extern "C" int mer_probe_strided(int probe, const void* x, const void* w, void* out, int T, int C, void* stream) {
  if (T <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* x_ = static_cast<const float*>(x);
  float* out_ = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto blocks = [](int n) { return (n + kThreads - 1) / kThreads; };
  switch (probe) {
    case 0:
    case 1:
      if (T % 2) return static_cast<int>(cudaErrorInvalidValue);
      rows_kernel<<<dim3(blocks(C), T / 2), kThreads, 0, s>>>(x_, out_, T, C, probe);
      break;
    case 2:
      if (T % 2) return static_cast<int>(cudaErrorInvalidValue);
      fold_kernel<<<dim3(blocks(2 * C), T / 2), kThreads, 0, s>>>(x_, out_, T, C, 0);
      break;
    case 3:
      if (C % 2) return static_cast<int>(cudaErrorInvalidValue);
      fold_kernel<<<dim3(blocks(C / 2), 2 * T), kThreads, 0, s>>>(x_, out_, T, C, 1);
      break;
    case 4:
      if (T % 16 || C % 8 || C < 16) return static_cast<int>(cudaErrorInvalidValue);
      skinny_kernel<<<dim3(C / 8, T / 16), 32, 0, s>>>(x_, static_cast<const __nv_bfloat16*>(w), out_, T, C);
      break;
    case 5:
      if (T % kReduceSteps) return static_cast<int>(cudaErrorInvalidValue);
      reduce_kernel<<<(C + 31) / 32, 32 * kRuns, 0, s>>>(x_, out_, T, C);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// one launch of an empty kernel: the launch-latency floor the probes sit on
extern "C" int mer_probe_launch_floor(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
