// wav2vec2 conv layers 1..6 (stride 2, 512 -> 512 channels, exact GELU) for
// Hopper (sm_90a), f32 and bf16: kernel K6 of the port.
//
// Replaces the TPU kernel mer_tpu/ops/w2v_conv_pallas.py:135 (`_kernel`,
// launched from `conv_stack_fused` at :504, whose chain is `_conv_chain`
// :115). For the layer-0 output x0 [B, T0, 512] in the compute dtype T:
//
//   for layer i = 1..6, taps k_i = 3, 3, 3, 3, 2, 2, stride 2, no bias:
//     T_i           = (T_{i-1} - k_i) / 2 + 1
//     x_i[b, t, :]  = gelu( sum_j x_{i-1}[b, 2 t + j, :] @ W_i[j] )     t < T_i
//
// with f32 accumulation, the exact (erf) GELU in f32, and one rounding to T
// after each layer (as `_conv_chain` recasts between layers). out = x_6.
//
// Layout: x [B, T, 512] T, contiguous, channels last; the weights per output
// channel: w3 [4, 512, 3 * 512] for layers 1..4 and w2 [2, 512, 2 * 512] for
// layers 5, 6, row c_out, column j * 512 + c_in (the transpose of
// `_stack_weights`' tap-major matrices), in T. Scratch buf_a [B, T_1, 512],
// buf_b [B, T_2, 512]; out [B, T_6, 512].
//
// Design: one kernel that does a stride-2 layer with its GELU epilogue,
// launched once per layer (6 launches a call), not one fused launch. With
// channels last, window t of a clip is the contiguous run of k * 512 values
// that starts at row 2 t, so a layer is a plain matrix product per clip,
//
//   out[b] [T_out, 512] = gelu( A_b [T_out, K] @ W^T ),   K = k * 512,
//   A_b row t = x[b] + 2 t * 512   (row stride 1,024 elements, rows overlap)
//   W row n   = w + n * K          (both operands are rows of K contiguous values)
//
// and needs no window copy and no halo. The fused alternative keeps the
// intermediates in shared memory, but a tile of one output frame needs 79 rows
// of layer-1 input (79 -> 39 -> 19 -> 9 -> 4 -> 2 -> 1), the 227 KB of an SM
// hold only a few output frames with their intermediates, and every tile would
// stream all 8.4 MB of weights again; the intermediates it saves are 1/2, 1/4,
// ... of the layer-0 output that has to be read anyway. Per layer, the card's
// L2 holds the layer's weights (1.5 MB) and the A rows are read once per
// column tile.
//
// A block of 256 threads owns a 128 x 128 output tile of one clip and walks K
// in slices; the next slice of A and W is fetched into registers (16-byte
// loads) while the current one is multiplied out of shared memory (two
// buffers, one barrier a slice). Rows t >= T_out of the last tile are
// zero-filled and never stored, so nothing past a clip's last window is read.
// Two pipelines share that frame:
//
//   f32:  slices of 16 k, stored as [k][row] (both operands transposed on the
//         way in); each thread accumulates an 8 x 8 tile as four 4 x 4
//         quadrants on the f32 CUDA cores, reading its values as float4. f32
//         inputs need full f32 products for the 2e-5 tolerance (no TF32).
//   bf16: slices of 32 k, stored as bf16 [row][k]; 8 warps of 64 x 32 tiles on
//         the tensor cores through mma.sync.m16n8k16 (bf16 x bf16 -> f32), the
//         fragments being plain 32-bit shared loads of two consecutive k.
//         wgmma from shared memory with TMA loads is the step after this one.
//
// Bound. At the export batch [32, 31999, 512] the six layers do
// 2 * 512 * 512 * (3 * (15999 + 7999 + 3999 + 1999) + 2 * (999 + 499)) per
// clip = 48.8 GFLOP, 1.56 TFLOP a batch: 1.6 ms at the 989 TFLOP/s of the bf16
// tensor cores, 23 ms at the 67 TFLOP/s of the f32 CUDA cores, against 1.1 GB
// (bf16) of input, 33 MB of output and 8.4 MB of weights, 0.33 ms at
// 3.35 TB/s. Bound by operations in both types.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kC = 512;          // channels in and out
constexpr int kBM = 128;         // output frames per block
constexpr int kBN = 128;         // output channels per block
constexpr int kThreads = 256;
constexpr int kLayers = 6;

static_assert(kC % kBN == 0 && kBM == kBN, "one fetch pattern serves both operands");

__device__ __forceinline__ float gelu_exact(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752440f));
}

// -- f32: the CUDA cores ---------------------------------------------------------

constexpr int kBK = 16;          // K slice
constexpr int kLd = kBM + 4;     // padded [k][row] row, a multiple of 4 floats

static_assert(kC % kBK == 0 && kBM * kBK == 8 * kThreads, "8 values of each operand a thread per slice");

// grid (512 / kBN, ceil(T_out / kBM), B); K = taps * 512.
__global__ void __launch_bounds__(kThreads, 2)
w2v_conv_s2_gelu_kernel(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ out,
                        int T_in, int T_out, int K) {
  __shared__ __align__(16) float a_s[2][kBK][kLd];  // [buffer][k][frame]
  __shared__ __align__(16) float b_s[2][kBK][kLd];  // [buffer][k][channel]

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const float* x_clip = x + (size_t)blockIdx.z * T_in * kC;

  // fetch: 8 values (k f_k..f_k + 7) of frame f_row of A and of channel f_row of W
  const int f_row = tid & (kBM - 1);
  const int f_k = (tid >> 7) * 8;
  const bool a_valid = m0 + f_row < T_out;
  const float* a_src = x_clip + (size_t)(m0 + f_row) * 2 * kC + f_k;
  const float* b_src = w + (size_t)(n0 + f_row) * K + f_k;

  float4 a_reg[2], b_reg[2];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      a_reg[h] = a_valid ? *reinterpret_cast<const float4*>(a_src + k0 + 4 * h) : make_float4(0.f, 0.f, 0.f, 0.f);
      b_reg[h] = *reinterpret_cast<const float4*>(b_src + k0 + 4 * h);
    }
  };
  auto stash = [&](int buf) {  // transposed: a warp's 32 rows land in 32 banks
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float av[4] = {a_reg[h].x, a_reg[h].y, a_reg[h].z, a_reg[h].w};
      const float bv[4] = {b_reg[h].x, b_reg[h].y, b_reg[h].z, b_reg[h].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        a_s[buf][f_k + 4 * h + j][f_row] = av[j];
        b_s[buf][f_k + 4 * h + j][f_row] = bv[j];
      }
    }
  };

  // compute: frames 4 ty.. and 64 + 4 ty.., channels 4 tx.. and 64 + 4 tx..
  const int ty = tid >> 4, tx = tid & 15;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  fetch(0);
  stash(0);
  __syncthreads();
  const int n_slices = K / kBK;
  for (int s = 0; s < n_slices; ++s) {
    const int buf = s & 1;
    if (s + 1 < n_slices) fetch((s + 1) * kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a_lo = *reinterpret_cast<const float4*>(&a_s[buf][kk][4 * ty]);
      const float4 a_hi = *reinterpret_cast<const float4*>(&a_s[buf][kk][64 + 4 * ty]);
      const float4 b_lo = *reinterpret_cast<const float4*>(&b_s[buf][kk][4 * tx]);
      const float4 b_hi = *reinterpret_cast<const float4*>(&b_s[buf][kk][64 + 4 * tx]);
      const float a[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w, a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      const float b[8] = {b_lo.x, b_lo.y, b_lo.z, b_lo.w, b_hi.x, b_hi.y, b_hi.z, b_hi.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (s + 1 < n_slices) stash(buf ^ 1);  // the other buffer: nobody reads it during this slice
    __syncthreads();
  }

  float* out_clip = out + (size_t)blockIdx.z * T_out * kC;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + (i - 4));
    if (row >= T_out) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half)
      *reinterpret_cast<float4*>(out_clip + (size_t)row * kC + n0 + 64 * half + 4 * tx) =
          make_float4(gelu_exact(acc[i][4 * half]), gelu_exact(acc[i][4 * half + 1]),
                      gelu_exact(acc[i][4 * half + 2]), gelu_exact(acc[i][4 * half + 3]));
  }
}

// -- bf16: the tensor cores --------------------------------------------------------

// The same block tile over mma.sync.m16n8k16. 8 warps as 2 (frames) x 4
// (channels), each a 64 x 32 tile: 4 x 4 fragments of 16 x 8. A and W slices of
// 32 k lie in shared memory as bf16 [row][k], the row padded to 40 values (80 B:
// the 8 rows x 4 words of a warp's fragment load then hit 32 banks), so both
// operands' fragments are plain 32-bit loads of two consecutive k.
constexpr int kMmaBK = 32;
constexpr int kMmaLd = kMmaBK + 8;

static_assert(kC % kMmaBK == 0 && kBM * kMmaBK == 16 * kThreads, "two 8-value chunks of each operand a thread");

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kThreads, 2)
w2v_conv_s2_gelu_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                            __nv_bfloat16* __restrict__ out, int T_in, int T_out, int K) {
  __shared__ __align__(16) __nv_bfloat16 a_s[2][kBM][kMmaLd];  // [buffer][row][k]
  __shared__ __align__(16) __nv_bfloat16 b_s[2][kBN][kMmaLd];  // [buffer][channel][k]

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const __nv_bfloat16* x_clip = x + (size_t)blockIdx.z * T_in * kC;

  // fetch: two 16-byte chunks of each operand per thread and slice: rows r and r + 64, k 8 c..8 c + 7
  const int f_row = tid >> 2;
  const int f_k = (tid & 3) * 8;
  const __nv_bfloat16* a_src[2];
  const __nv_bfloat16* b_src[2];
  bool a_valid[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = f_row + 64 * h;
    a_valid[h] = m0 + row < T_out;
    a_src[h] = x_clip + (size_t)(m0 + row) * 2 * kC + f_k;
    b_src[h] = w + (size_t)(n0 + row) * K + f_k;
  }
  uint4 a_reg[2], b_reg[2];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      a_reg[h] = a_valid[h] ? *reinterpret_cast<const uint4*>(a_src[h] + k0) : make_uint4(0u, 0u, 0u, 0u);
      b_reg[h] = *reinterpret_cast<const uint4*>(b_src[h] + k0);
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<uint4*>(&a_s[buf][f_row + 64 * h][f_k]) = a_reg[h];
      *reinterpret_cast<uint4*>(&b_s[buf][f_row + 64 * h][f_k]) = b_reg[h];
    }
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;  // the warp's tile
  const int g = lane >> 2, t = lane & 3;                  // the fragment's row / column group and k pair
  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  fetch(0);
  stash(0);
  __syncthreads();
  const int n_slices = K / kMmaBK;
  for (int s = 0; s < n_slices; ++s) {
    const int buf = s & 1;
    if (s + 1 < n_slices) fetch((s + 1) * kMmaBK);
#pragma unroll
    for (int kk = 0; kk < kMmaBK; kk += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const __nv_bfloat16* lo = &a_s[buf][wm + 16 * mi + g][kk + 2 * t];
        const __nv_bfloat16* hi = lo + 8 * kMmaLd;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(lo);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(hi);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(lo + 8);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(hi + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const __nv_bfloat16* col = &b_s[buf][wn + 8 * ni + g][kk + 2 * t];
        b[ni][0] = *reinterpret_cast<const uint32_t*>(col);
        b[ni][1] = *reinterpret_cast<const uint32_t*>(col + 8);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16_16816(acc[mi][ni], a[mi], b[ni]);
    }
    if (s + 1 < n_slices) stash(buf ^ 1);  // the other buffer: nobody reads it during this slice
    __syncthreads();
  }

  // accumulator fragment: c0, c1 at (row g, columns 2 t, 2 t + 1), c2, c3 at row g + 8
  __nv_bfloat16* out_clip = out + (size_t)blockIdx.z * T_out * kC;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm + 16 * mi + g + 8 * half;
      if (row >= T_out) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        *reinterpret_cast<__nv_bfloat162*>(out_clip + (size_t)row * kC + n0 + wn + 8 * ni + 2 * t) =
            __floats2bfloat162_rn(gelu_exact(acc[mi][ni][2 * half]), gelu_exact(acc[mi][ni][2 * half + 1]));
    }
}

void run_layer(dim3 grid, cudaStream_t s, const float* x, const float* w, float* out, int t_in, int t_out, int K) {
  w2v_conv_s2_gelu_kernel<<<grid, kThreads, 0, s>>>(x, w, out, t_in, t_out, K);
}
void run_layer(dim3 grid, cudaStream_t s, const __nv_bfloat16* x, const __nv_bfloat16* w, __nv_bfloat16* out,
               int t_in, int t_out, int K) {
  w2v_conv_s2_gelu_mma_kernel<<<grid, kThreads, 0, s>>>(x, w, out, t_in, t_out, K);
}

template <typename T>
int launch(const void* x, const void* w3, const void* w2, void* buf_a, void* buf_b, void* out, int B, int T0,
           cudaStream_t stream) {
  const int taps[kLayers] = {3, 3, 3, 3, 2, 2};
  void* dst_of[kLayers] = {buf_a, buf_b, buf_a, buf_b, buf_a, out};
  const T* src = static_cast<const T*>(x);
  int t_in = T0;
  for (int layer = 0; layer < kLayers; ++layer) {
    const int k = taps[layer];
    const int t_out = (t_in - k) / 2 + 1;
    if (t_in < k || t_out <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const T* w = layer < 4 ? static_cast<const T*>(w3) + (size_t)layer * 3 * kC * kC
                           : static_cast<const T*>(w2) + (size_t)(layer - 4) * 2 * kC * kC;
    T* dst = static_cast<T*>(dst_of[layer]);
    const dim3 grid(kC / kBN, (t_out + kBM - 1) / kBM, B);
    run_layer(grid, stream, src, w, dst, t_in, t_out, k * kC);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src = dst;
    t_in = t_out;
  }
  return 0;
}

}  // namespace

// dtype 0 = float32, 1 = bfloat16 (x, w3, w2, buf_a, buf_b, out). buf_a holds
// [B, T_1, 512] and buf_b [B, T_2, 512] values; the six launches alternate
// between them and the last writes out [B, T_6, 512]. Returns the cudaError_t
// of the first launch that failed, or 0.
extern "C" int mer_w2v_conv_tail(int dtype, const void* x, const void* w3, const void* w2, void* buf_a, void* buf_b,
                                 void* out, int B, int T0, void* stream) {
  if (B <= 0 || B > 65535 || T0 <= 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(x, w3, w2, buf_a, buf_b, out, B, T0, s)
                    : launch<__nv_bfloat16>(x, w3, w2, buf_a, buf_b, out, B, T0, s);
}
